"""Activation recomputation with explicit dropout generators — what the JAX
package's ``jax.checkpoint`` / ``nn.remat`` give for free.

`checkpoint` runs ``fn`` under a non-reentrant ``torch.utils.checkpoint``:
the forward keeps only the inputs, and the backward runs ``fn`` again to
rebuild what it needs. JAX's recompute draws the same dropout masks
because its keys are values; the port's dropout draws from explicit
``torch.Generator`` objects, which checkpoint does not replay (it replays
only the default CPU and CUDA generators). So the recompute here starts
each of ``generators`` from the state it had when the forward began, and
afterwards puts it back where the recompute found it. ``buffers`` (a
model's BatchNorm running statistics) are restored after the recompute
too, so the recomputed forward does not update them a second time: JAX's
functional model state is updated once.

`checkpoint`'s recompute runs on autograd's device thread. cuDNN's pick
of a conv's algorithm is cached per thread, so that recompute makes its
own pick (by timing under ``torch.backends.cudnn.benchmark``, else by
heuristics, or from a pick an earlier timed call left in that thread's
cache); where it differs from the forward's, the recomputed activations
round apart from the forward's. With cuDNN off the recompute is the
forward bit for bit.

`recompute_whole` is the train step's ``remat="full"``: the recompute of
a WHOLE forward, whose first unpack in the backward would rebuild every
activation at the backward's start anyway. It runs that recompute on the
calling thread instead, before the backward: the forward once under
``no_grad`` (keeping nothing), then again with the generators replayed
and the buffers kept, building the graph the backward runs. Both passes
and the forward of a run without remat then share one thread's cuDNN
cache, so every conv takes the forward's algorithm, under any cuDNN
setting: the result is the run without remat's, bit for bit. The work is
`checkpoint`'s (two forwards, one backward) and so is the peak memory
(the recompute's activations held through the backward).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import torch
from torch.utils import checkpoint as _ckpt

__all__ = ["checkpoint", "recompute_whole", "recomputing"]

#: recomputes under way (nested checkpoints nest them)
_depth = 0


def recomputing() -> bool:
    """Whether a forward pass whose activations no backward reads is
    running (a checkpoint's recompute, or `recompute_whole`'s first
    pass): a ring projection counts the forward calls it makes again
    (`ops.collective_matmul`)."""
    return _depth > 0


@contextlib.contextmanager
def _replaying(generators, states, buffers):
    """The recompute's context: the generators at their forward-time
    states, and everything it changes undone on the way out (also when
    checkpoint stops the recompute early)."""
    global _depth
    found = [g.get_state() for g in generators]
    kept = [b.detach().clone() for b in buffers]
    for g, state in zip(generators, states):
        g.set_state(state)
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1
        for g, state in zip(generators, found):
            g.set_state(state)
        with torch.no_grad():
            for b, k in zip(buffers, kept):
                b.copy_(k)


def checkpoint(fn: Callable, *args,
               generators: Sequence[torch.Generator] = (),
               buffers: Sequence[torch.Tensor] = (), **kwargs):
    """``fn(*args, **kwargs)``, recomputed in the backward: the recompute
    replays ``generators`` and leaves ``buffers`` as the forward left
    them."""
    gens = [g for g in generators if g is not None]
    states = [g.get_state() for g in gens]
    bufs = list(buffers)
    return _ckpt.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(),
                            _replaying(gens, states, bufs)),
        **kwargs)


def recompute_whole(fn: Callable, *args,
                    generators: Sequence[torch.Generator] = (),
                    buffers: Sequence[torch.Tensor] = ()):
    """``fn(*args)`` for a backward that recomputes the whole forward: a
    first pass under ``no_grad`` (no activation kept; it updates
    ``buffers`` and advances ``generators``, as the forward does), then
    the recompute on this thread, from the generators' states at the
    first pass's start and with ``buffers`` put back as the first pass
    left them. Returns the recompute's output, whose graph the backward
    runs (module docstring)."""
    global _depth
    gens = [g for g in generators if g is not None]
    states = [g.get_state() for g in gens]
    _depth += 1
    try:
        with torch.no_grad():
            fn(*args)
    finally:
        _depth -= 1
    kept = [b.detach().clone() for b in buffers]
    for g, state in zip(gens, states):
        g.set_state(state)
    try:
        return fn(*args)
    finally:
        with torch.no_grad():
            for b, k in zip(buffers, kept):
                b.copy_(k)
