# Port of repro/launch/flopcount.py and repro/launch/hloparse.py: FLOPs, bytes and collectives of a step, counted by one dispatch mode.
"""FLOP, byte, kernel and collective counts of one step, in one pass.

The counterpart of two JAX modules: ``launch/flopcount.py``, which walks a
step's jaxpr for its FLOPs and bytes (scan bodies times their trip count),
and ``launch/hloparse.py``, which parses the compiled HLO's collectives
(while bodies times their trip count).  Eager PyTorch dispatches every trip
of every loop, so a ``TorchDispatchMode`` that sees each operation is
loop-aware by construction, and there is no compiled program text to
parse: ``Counter`` is both.  On the meta device a loop over time steps runs
one trip counted for all (``_meta.trips``), so a cell stays tractable.

It counts, each operation as many times as the trips around it:

- ``dot_flops``: matmuls (mm, bmm, addmm, baddbmm, convolutions, attention
  ops), with ``torch.utils.flop_counter``'s formulas (2 M N K), and every
  two-operand ``torch.einsum`` as the one ``dot_general`` JAX makes of it:
  2 times the product of the sizes of its indices that both operands or the
  output carry (an einsum whose summed index has size 1 is a ``mul`` in
  aten, a dot in JAX; the aten ops inside an einsum count no FLOPs or
  bytes of their own);
- ``flops``: those plus 1 a output element of every pointwise op, and the
  kernels' FLOPs;
- ``bytes``: by the JAX module's rules -- the output of a pointwise op,
  operands and output of a matmul, a reduction, an indexing op or a copy,
  nothing for a view, the output of anything else.  Aten ops are not jaxpr
  primitives, so these are the same kind of estimate, not the same numbers;
- ``kernel_flops``: by kernel, what each hand-written kernel would execute
  (the wrappers report it on meta tensors, ``_meta.kernel_flops``), apart
  from the aten counts;
- ``collective_bytes`` and ``collective_counts``: by the JAX kinds
  (all-reduce, all-gather, reduce-scatter, all-to-all, collective-permute),
  the result-shape bytes of each functional collective that DTensor (or the
  sharded flash-decode) issues, on this rank: the JAX module's per-device
  figure;
- ``peak_temp_bytes``: the peak, over the step, of the bytes of the local
  storages alive that the step made (a storage is counted from the op that
  first returns it until it is freed), beyond the ``arguments`` given.  A
  storage that a meta loop's one trip made and that outlives the trip (an
  output, a carry, what the backward keeps) stands for one a trip, so it
  is counted as many times as the loop has trips from then on.
"""

from __future__ import annotations

import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch import _meta

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# functional collectives (and DTensor's own) -> the JAX kind
_KIND = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
}
_COLLECTIVE_NS = ("_c10d_functional", "_dtensor")

# the JAX module's bytes-heavy primitives, as aten ops (reductions by tag)
_BYTES_HEAVY = {
    "gather", "scatter", "scatter_add", "scatter_reduce", "index",
    "index_select", "index_put", "index_add", "embedding", "cat", "stack",
    "copy", "copy_", "_to_copy", "clone", "sort", "topk", "cumsum",
    "cumprod", "_softmax", "_log_softmax", "constant_pad_nd", "slice_scatter",
    "select_scatter", "_unsafe_view", "contiguous", "flip", "roll",
    "repeat", "repeat_interleave", "_softmax_backward_data",
    "embedding_dense_backward",
}


def _nbytes(t) -> int:
    if isinstance(t, DTensor):
        t = t._local_tensor
    return t.numel() * t.element_size()


def _local(t):
    return t._local_tensor if isinstance(t, DTensor) else t


def _einsum_flops(args):
    """The FLOPs of ``torch.einsum(equation, a, b)`` as one dot_general, or
    None for another form (more operands, an ellipsis)."""
    if not args or not isinstance(args[0], str):
        return None
    eq, ops = args[0].replace(" ", ""), args[1:]
    if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
        ops = tuple(ops[0])
    if len(ops) != 2 or "..." in eq or "->" not in eq:
        return None
    lhs, out = eq.split("->")
    ins = lhs.split(",")
    sizes = {}
    for idx, t in zip(ins, ops):
        for c, n in zip(idx, t.shape):
            sizes[c] = n
    kept = (set(ins[0]) & set(ins[1])) | set(out)
    flops = 2
    for c in kept:
        flops *= sizes[c]
    return flops


class _Einsums(TorchFunctionMode):
    """Counts each two-operand ``torch.einsum`` as a dot (see the module)
    into ``counter``, whose dispatch mode then counts no FLOPs or bytes for
    the aten ops inside it."""

    def __init__(self, counter):
        super().__init__()
        self.counter = counter

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flops = _einsum_flops(args) if func is torch.einsum else None
        if flops is None:
            return func(*args, **kwargs)
        c = self.counter
        c._quiet += 1
        try:
            out = func(*args, **kwargs)
        finally:
            c._quiet -= 1
        rep = _meta.repeat()
        ops = [t for t in tree_leaves(args[1:]) if isinstance(t, torch.Tensor)]
        c.dot_flops += flops * rep
        c.bytes += (_nbytes(out) + sum(_nbytes(t) for t in ops)) * rep
        return out


class Counter(TorchDispatchMode):
    """Counts the operations dispatched inside it (see the module)."""

    def __init__(self, arguments=()):
        super().__init__()
        self.dot_flops = 0
        self.pointwise_flops = 0
        self.bytes = 0
        self.kernel_flops: dict = {}
        self.collective_bytes = {c: 0 for c in COLLECTIVES}
        self.collective_counts = {c: 0 for c in COLLECTIVES}
        self.collective_shapes: list = []
        self._seen: set = set()
        # storage -> (bytes, trips it stands for, serial)
        self._weight: dict = {}
        self._made: list = []    # (storage, serial) each open trip made
        self._serial = 0
        self._live = 0
        self.peak_temp_bytes = 0
        for t in tree_leaves(arguments):
            if isinstance(t, torch.Tensor):
                self._seen.add(id(_local(t).untyped_storage()))
        self._listen = None
        self._einsums = None
        self._quiet = 0          # inside a counted einsum

    @property
    def flops(self) -> int:
        return (self.dot_flops + self.pointwise_flops
                + sum(self.kernel_flops.values()))

    def _kernel(self, name, flops):
        self.kernel_flops[name] = self.kernel_flops.get(name, 0) + flops

    def _trip(self, n):
        """A meta trip opens (``n`` None) or closes as the one trip of
        ``n``: what it made and is still alive stands for ``n`` trips."""
        if n is None:
            self._made.append([])
            return
        alive = [(key, serial) for key, serial in self._made.pop()
                 if self._weight.get(key, (0, 0, None))[2] == serial]
        for key, _ in alive:
            b, w, serial = self._weight[key]
            self._weight[key] = (b, w * n, serial)
            self._live += b * w * (n - 1)
        self.peak_temp_bytes = max(self.peak_temp_bytes, self._live)
        if self._made:
            self._made[-1].extend(alive)

    def __enter__(self):
        _meta.forget_trips()
        self._listen = _meta.listening(self._kernel, on_trip=self._trip)
        self._listen.__enter__()
        self._einsums = _Einsums(self)
        self._einsums.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._einsums.__exit__(*exc)
            self._listen.__exit__(*exc)

    def _track(self, outs):
        """Count the storages of ``outs`` first seen here as live until
        they are freed."""
        for t in outs:
            st = _local(t).untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            n = st.nbytes()
            self._seen.add(key)
            self._serial += 1   # an id is reused once its storage is freed
            self._weight[key] = (n, 1, self._serial)
            if self._made:
                self._made[-1].append((key, self._serial))
            self._live += n
            self.peak_temp_bytes = max(self.peak_temp_bytes, self._live)
            weakref.finalize(st, self._free, key)

    def _free(self, key):
        self._seen.discard(key)
        b, w, _ = self._weight.pop(key)
        self._live -= b * w

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        rep = _meta.repeat()
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns in _COLLECTIVE_NS:
            kind = _KIND.get(name)
            if kind is not None:
                b = sum(_nbytes(t) for t in outs)
                self.collective_bytes[kind] += b * rep
                self.collective_counts[kind] += rep
                self.collective_shapes.append(
                    (kind, [tuple(_local(t).shape) for t in outs]))
            self._track(outs)
            return out
        out_b = sum(_nbytes(t) for t in outs)
        packet = func.overloadpacket
        if self._quiet:
            pass
        elif packet in flop_registry:
            self.dot_flops += flop_registry[packet](
                *args, **kwargs, out_val=out) * rep
            self.bytes += (out_b + sum(_nbytes(t) for t in ins)) * rep
        elif func.is_view:
            pass
        elif torch.Tag.pointwise in func.tags:
            # a DTensor's numel is its global size
            self.pointwise_flops += sum(t.numel() for t in outs) * rep
            self.bytes += out_b * rep
        elif (torch.Tag.reduction in func.tags
              or packet.__name__ in _BYTES_HEAVY):
            self.bytes += (out_b + sum(_nbytes(t) for t in ins)) * rep
        else:
            self.bytes += out_b * rep
        if not func.is_view:
            self._track(outs)
        return out

    def summary(self) -> dict:
        return {"flops": int(self.flops), "dot_flops": int(self.dot_flops),
                "pointwise_flops": int(self.pointwise_flops),
                "kernel_flops": dict(self.kernel_flops),
                "bytes": int(self.bytes),
                "collective_bytes": dict(self.collective_bytes),
                "collective_counts": dict(self.collective_counts),
                "peak_temp_bytes": int(self.peak_temp_bytes)}


def analyze(fn, *args) -> dict:
    """Run ``fn(*args)`` (plain meta tensors: the global counts) under a
    ``Counter``; its ``summary()``."""
    with Counter(arguments=args) as c:
        fn(*args)
    return c.summary()
