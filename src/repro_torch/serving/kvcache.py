# Port of repro/serving/kvcache.py: the same utilities on torch, writing in place.
"""Cache utilities: buffer extension, size accounting."""

from __future__ import annotations

from repro_torch._tree import tree_leaves, tree_map


def pad_cache(caches, template):
    """Embed prefill-produced caches into decode-sized buffers.

    ``template`` comes from ``model.init_cache(B, buf_len)`` and is written
    in place: leaves whose shapes already match (ring buffers, cross-attention
    caches, and the RWKV state and token shifts, which have no sequence axis)
    are copied whole, sequence buffers at offset 0; where ``caches`` has
    None, the template's leaves stay as they are.  Returns ``template``.
    """

    def one(c, t):
        if c is None:
            return t
        assert c.dim() == t.dim(), (c.shape, t.shape)
        t[tuple(slice(0, n) for n in c.shape)].copy_(c)
        return t

    return tree_map(one, caches, template)


def cache_bytes(caches) -> int:
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(caches)))
