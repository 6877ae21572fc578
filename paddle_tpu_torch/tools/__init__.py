"""Command-line tools that drive the port on the card."""
