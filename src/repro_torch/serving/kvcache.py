# Port of repro/serving/kvcache.py: the same utilities on torch, writing in place.
"""Cache utilities: buffer extension, size accounting."""

from __future__ import annotations

from torch.distributed.tensor import DTensor

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.distributed.sharding import local_offset, local_part


def pad_cache(caches, template):
    """Embed prefill-produced caches into decode-sized buffers.

    ``template`` comes from ``model.init_cache(B, buf_len)`` and is written
    in place: leaves whose shapes already match (ring buffers, cross-attention
    caches, and the RWKV state and token shifts, which have no sequence axis)
    are copied whole, sequence buffers at offset 0; where ``caches`` has
    None, the template's leaves stay as they are.  Returns ``template``.
    A DTensor template (a cache laid out by ``sharding.cache_pspecs``) is
    written on each rank's own shard.
    """

    def one(c, t):
        if c is None:
            return t
        assert c.dim() == t.dim(), (c.shape, t.shape)
        if isinstance(t, DTensor):
            return _pad_sharded(c, t)
        t[tuple(slice(0, n) for n in c.shape)].copy_(c)
        return t

    return tree_map(one, caches, template)


def _pad_sharded(c, t):
    """``c`` into the first ``c.shape`` positions of DTensor ``t``, each rank
    writing the part its shard holds: ``c`` is laid out as ``t``, whole on
    the dims where the two differ (DTensor's sliced write would
    redistribute a sharded dim into a copy and write that)."""
    grown = {d for d in range(t.dim()) if c.shape[d] != t.shape[d]}
    src, local = local_part(c, t, grown), t.to_local()
    dst_ix, src_ix = [], []
    for d in range(t.dim()):
        lo = local_offset(t, d) if d in grown else 0
        hi = min(lo + local.shape[d], src.shape[d])
        if hi <= lo:
            return t        # this rank's shard lies past c
        src_ix.append(slice(lo, hi))
        dst_ix.append(slice(0, hi - lo))
    local[tuple(dst_ix)].copy_(src[tuple(src_ix)])
    return t


def cache_bytes(caches) -> int:
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(caches)))
