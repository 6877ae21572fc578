"""Random state (counterpart of paddle_tpu/framework/random.py).

The reference splits one process-wide JAX key per draw; the port keeps
explicit ``torch.Generator``s instead: one for the CPU and one a card,
made when first asked for, all seeded from the one seed that ``seed``
sets (0 until then). Every random op of the port (``ops.creation``'s
random family, ``poisson``, ``randint_like``, the dropouts) draws from
``generator(device)`` unless the caller hands it a generator; no module
draws from torch's global RNG. The streams are PyTorch's, not JAX's:
the same seed gives the same numbers run after run, not the
reference's numbers.

``get_rng_state`` / ``set_rng_state`` save and restore the seed and every
generator's state. ``RNGStatesTracker`` keeps named states (the
model-parallel dropout states of the reference's ``mpu/random.py``): inside
``rng_state(name)``, ``generator`` hands out that state's generators. A
state other than ``global_seed`` is rank-local: ``set_mp_rank(r)`` folds
the rank into its seed. A name used before ``add`` is registered from the
global seed and the name's crc32, as the reference does.
"""
from __future__ import annotations

import threading
import zlib

import torch

_lock = threading.Lock()


class _Stream:
    """One seed and its generators, one a device (made lazily)."""

    def __init__(self, seed):
        self.seed = int(seed)
        self.gens = {}

    def generator(self, device):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        key = str(device)
        gen = self.gens.get(key)
        if gen is None:
            with _lock:
                gen = self.gens.get(key)
                if gen is None:
                    gen = torch.Generator(device=device)
                    gen.manual_seed(self.seed)
                    self.gens[key] = gen
        return gen

    def state(self):
        return (self.seed, {k: g.get_state() for k, g in self.gens.items()})

    def restore(self, state):
        self.seed, states = int(state[0]), state[1]
        for key, gen in self.gens.items():
            if key not in states:
                gen.manual_seed(self.seed)
        for key, st in states.items():
            self.generator(key).set_state(st)


_global = _Stream(0)


def seed(s: int):
    """Reseed every generator (``paddle.seed``); returns ``s``."""
    global _global
    with _lock:
        _global = _Stream(int(s))
    return s


def get_rng_state():
    """The seed and the state of every generator made so far."""
    return _global.state()


def set_rng_state(state):
    """Restore a ``get_rng_state()``."""
    _global.restore(state)


# -- named RNG states (model-parallel dropout) -------------------------------

_tracker_states = {}   # name -> _Stream
_state_stack = []      # active rng_state(...) names (innermost last)
_process_mp_rank = []  # [rank] when set


def _stream_seed(seed, name):
    if name != "global_seed" and _process_mp_rank:
        return int(seed) + 1009 * _process_mp_rank[0]
    return int(seed)


class RNGStatesTracker:
    def add(self, name, seed):
        if name in _tracker_states:
            raise ValueError("rng state %r already added" % name)
        _tracker_states[name] = _Stream(_stream_seed(seed, name))

    def reset(self):
        _tracker_states.clear()
        _process_mp_rank.clear()

    def get_states_tracker(self):
        return {n: s.state() for n, s in _tracker_states.items()}

    def set_states_tracker(self, states):
        for name, st in states.items():
            _tracker_states.setdefault(name, _Stream(st[0])).restore(st)

    class _Ctx:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            if self.name not in _tracker_states:
                derived = (_global.seed * 1000003
                           + (zlib.crc32(self.name.encode()) & 0x7FFFFFFF))
                _tracker_states[self.name] = _Stream(
                    _stream_seed(derived % (2 ** 63), self.name))
            _state_stack.append(self.name)
            return self

        def __exit__(self, *exc):
            _state_stack.pop()
            return False

    def rng_state(self, name="global_seed"):
        return self._Ctx(name)

    def set_mp_rank(self, rank):
        """The model-parallel rank folded into rank-local states added
        after this call."""
        _process_mp_rank.clear()
        if rank:
            _process_mp_rank.append(int(rank))


_tracker = RNGStatesTracker()


def get_rng_state_tracker():
    return _tracker


def in_tracked_rng_state():
    return bool(_state_stack)


def generator_or(gen, device):
    """``gen``, or when None the generator ``device`` draws from."""
    return generator(device) if gen is None else gen


def generator(device="cpu"):
    """The generator a random op on ``device`` draws from: the innermost
    ``rng_state(name)``'s, else the global one's."""
    if _state_stack:
        return _tracker_states[_state_stack[-1]].generator(device)
    return _global.generator(device)
