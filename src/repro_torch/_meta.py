"""Shape-only runs of the port on the meta device, as the dry run makes them.

On the meta device nothing computes and a tensor has no values.  A kernel
wrapper handed meta tensors returns empty outputs of the shapes and dtypes
its kernel would write, launches nothing and counts no launch; it reports
the FLOPs its kernel would execute through ``kernel_flops``.  A loop over
time steps that would dispatch thousands of trips (the Mamba recurrence,
``common.time_scan``) runs one trip under ``trips`` and has every operation
in it counted as many times as the loop has trips.  That holds for the
trip's backward too, which autograd runs after the loop has closed: a trip
notes the range of autograd sequence numbers its graph nodes took, and an
operation that the backward of such a node dispatches is counted as many
times as the closed trips around that node have trips, times the trips
open now.  A region run under ``checkpoint`` is recomputed in the backward
once for each time its forward ran, so its recompute is counted as its
forward was.  On any other device ``trips`` is ``range`` and
``checkpoint`` is torch's: what a loop computes there does not change.

``launch.flopcount`` listens: ``listening(fn)`` calls ``fn(name, flops)``
for each kernel's report, ``listening(fn, on_trip=g)`` also calls
``g(None)`` when a trip opens and ``g(n)`` when a trip of a loop of ``n``
closes, and ``repeat()`` is the multiplier of an operation dispatched now.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint as _torch_checkpoint

_LISTENERS: list = []
_TRIP_LISTENERS: list = []
_REPEAT = [1]
_RECOMPUTING = [0]
# [first, end, n]: the autograd sequence numbers [first, end) that the graph
# nodes of a trip of a loop of n took; end is None while the trip is open
_RANGES: list = []


def is_meta(t) -> bool:
    return isinstance(t, torch.Tensor) and t.device.type == "meta"


def repeat() -> int:
    """How many times an operation dispatched now is to be counted: the
    trips open now, times, inside a backward, the trips that have closed
    around the graph node it runs."""
    r = _REPEAT[0]
    if _RANGES and not _RECOMPUTING[0]:
        node = torch._C._current_autograd_node()
        if node is not None:
            seq = node._sequence_nr()
            for first, end, n in _RANGES:
                if end is not None and first <= seq < end:
                    r *= n
    return r


def forget_trips() -> None:
    """Drop the sequence ranges of closed trips (a new step begins)."""
    _RANGES[:] = [r for r in _RANGES if r[1] is None]


def kernel_flops(name: str, flops: int) -> None:
    """Report that kernel ``name`` would execute ``flops`` here (on meta
    tensors: no launch)."""
    for fn in _LISTENERS:
        fn(name, int(flops) * repeat())


@contextlib.contextmanager
def listening(fn, on_trip=None):
    """Call ``fn(name, flops)`` for every ``kernel_flops`` report inside,
    and ``on_trip`` (if given) as a trip opens and closes."""
    _LISTENERS.append(fn)
    if on_trip is not None:
        _TRIP_LISTENERS.append(on_trip)
    try:
        yield
    finally:
        _LISTENERS.remove(fn)
        if on_trip is not None:
            _TRIP_LISTENERS.remove(on_trip)


def trips(n: int, like):
    """The trips of a loop over ``range(n)``: ``range(n)`` itself unless
    ``like`` is a meta tensor; there one trip, index 0, counted ``n``
    times.  A loop that collects one result a trip must then repeat it to
    ``n`` results itself."""
    if not is_meta(like):
        return range(n)
    return _one_trip(n)


def _one_trip(n):
    if n <= 0:
        return
    span = [torch.autograd._get_sequence_nr(), None, n]
    _RANGES.append(span)
    _REPEAT[0] *= n
    for g in _TRIP_LISTENERS:
        g(None)
    try:
        yield 0
    finally:
        _REPEAT[0] //= n
        span[1] = torch.autograd._get_sequence_nr()
        for g in _TRIP_LISTENERS:
            g(n)


def checkpoint(fn, *args):
    """``torch.utils.checkpoint.checkpoint(fn, *args,
    use_reentrant=False)``, whose recompute in the backward is counted with
    the trips that were open around the forward, as the forward was."""
    at = _REPEAT[0]

    def run(*a):
        if torch._C._current_autograd_node() is None:
            return fn(*a)
        saved, _REPEAT[0] = _REPEAT[0], at      # the recompute
        _RECOMPUTING[0] += 1
        try:
            return fn(*a)
        finally:
            _REPEAT[0] = saved
            _RECOMPUTING[0] -= 1

    return _torch_checkpoint(run, *args, use_reentrant=False)
