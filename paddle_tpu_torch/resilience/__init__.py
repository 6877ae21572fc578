"""Resilience (counterpart of paddle_tpu/resilience/): so far only the
seeded fault-injection framework the serving engine's sites fire."""
from . import faultinject

__all__ = ["faultinject"]
