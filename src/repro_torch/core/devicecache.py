# Port of repro/core/devicecache.py: the same cache, its pools on torch.
"""Device-resident mirror of the cross-tick score cache.

``ScoreCache`` keeps the Eq. 2 rows on the host; ``DeviceScoreCache`` also
mirrors every written row into float32 pools on ``device`` that persist
across ticks, and applies the host cache's invalidation rules to them
incrementally:

* **arrivals** append: the new rows ship in one copy and are scattered into
  the pools in place (``index_copy_``) — O(churn * W) bytes;
* **placements / finishes** reclaim lazily as on the host: a departed row is
  simply no longer gathered, with no device traffic;
* **elastic clones** widen the worker axis in padded column blocks: the old
  block moves device to device, and only the new columns of live rows ship;
* **failure generations mask instead of flushing**: failure state never
  enters the Eq. 2 rows, so a pure ``fail_gen`` bump keeps every resident
  row; a ``profile_gen`` bump re-ships exactly the refreshed engines' rows;
  other membership changes flush.

``device_tick`` runs the whole decision — the row gather, the fused scoring
kernel, the urgency order and the greedy placement — through
``repro_torch.kernels.scheduler_score.scheduler_tick``.  A tick ships its
O(J + W) vectors in one host-to-device copy from a pinned staging buffer and
reads ``(assign, order)`` back in one copy.  ``bytes_to_device`` counts the
same logical payload as the reference, array by array, so the two caches'
counters compare.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.estimator import profile_gen
from repro_torch.core.scorecache import ScoreCache
from repro_torch.kernels.scheduler_score import scheduler_tick

_COL_BLOCK = 128      # worker-axis padding block
_ROW_BLOCK = 256      # slot-pool row padding block (matches _GROW)
_UP_BLOCK = 8         # upload-batch padding block
_ALIGN = 16           # byte alignment of each array in a staging buffer
_POOL_ATTR = {"t": "_dt", "pre": "_dpre", "dec": "_ddec", "ene": "_dene"}


def _bucket(n: int, block: int) -> int:
    """Smallest power-of-two multiple of ``block`` >= n — pool and batch
    shapes stay in a small set."""
    b = block
    while b < n:
        b *= 2
    return b


_TORCH_DTYPE = {np.dtype(np.float32): torch.float32,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.bool_): torch.bool}


def _ship(arrays, device: torch.device):
    """Copy numpy ``arrays`` (float32 / int32 / bool) to ``device`` in one
    host-to-device copy: pack them into one (pinned, on a card) byte buffer
    at ``_ALIGN``-byte offsets, copy it, and return typed views of the copy
    in the arrays' shapes."""
    offsets, end = [], 0
    for a in arrays:
        offsets.append(end)
        end += -(-a.nbytes // _ALIGN) * _ALIGN
    stage = torch.empty(max(end, 1), dtype=torch.uint8,
                        pin_memory=device.type == "cuda")
    host = stage.numpy()
    for a, off in zip(arrays, offsets):
        host[off:off + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(
            np.uint8)
    dev = stage.to(device, non_blocking=True)
    return [dev[off:off + a.nbytes].view(_TORCH_DTYPE[a.dtype]).view(a.shape)
            for a, off in zip(arrays, offsets)]


class DeviceScoreCache(ScoreCache):
    """A ``ScoreCache`` whose Eq. 2 rows are also resident on ``device``
    (the card by default; ``"cpu"`` runs the kernels' plain versions), plus
    the one-call tick entry point."""

    def __init__(self, use_default: bool = False, profile: int = 0,
                 bj: int = 128, device=None):
        # device pools (created lazily on first upload)
        self._dt = self._dpre = self._ddec = self._dene = None
        self._d_cap = 0
        self._d_Wp = 0
        self.device = resolve_device(device)
        super().__init__(use_default, profile)
        self.bj = int(bj)
        # transfer accounting (tests assert the O(churn * W) bound)
        self.fail_masks = 0          # fail_gen bumps absorbed by masking
        self.rows_uploaded = 0       # matrix rows shipped host -> device
        self.bytes_to_device = 0     # every host -> device payload byte
        self.ticks = 0

    # ------------------------------------------------------------------
    # invalidation overrides

    def sync(self, cd, queue, cluster) -> np.ndarray:
        key = (cluster.serial, cluster.worker_token, cluster.fail_gen,
               profile_gen(cd, self.profile))
        old = self._key
        if (old is not None and key != old and old[0] == key[0]
                and old[1] == key[1] and old[3] == key[3]):
            # pure failure-generation bump: same cluster, same workers and
            # same profile mean a recompute would give every row bit for
            # bit, so adopt the new generation and keep host + device rows
            self._key = key
            self.fail_masks += 1
        return super().sync(cd, queue, cluster)

    def _flush(self, W: int):
        super()._flush(W)
        self._dt = self._dpre = self._ddec = self._dene = None
        self._d_cap = 0
        self._d_Wp = 0

    def _insert(self, jobs, cd, cluster, slots, miss):
        super()._insert(jobs, cd, cluster, slots, miss)
        self._upload_rows(np.asarray(slots[miss], dtype=np.int64))

    def _pools(self):
        """(name, device pool, host rows) of every active pool."""
        names = ["t"]
        if self._have_phase:
            names += ["pre", "dec"]
        if self._have_energy:
            names.append("ene")
        return [(n, getattr(self, _POOL_ATTR[n]), getattr(self, "_" + n))
                for n in names]

    def _extend_columns(self, cd, queue, cluster, names):
        old_W = self._W
        super()._extend_columns(cd, queue, cluster, names)
        if self._dt is None:
            return
        # widen the pools (the old block moves device to device), then ship
        # only the new columns of the live rows
        Wp = _bucket(self._W, _COL_BLOCK)
        if Wp > self._d_Wp:
            self._d_Wp = Wp
            for attr in _POOL_ATTR.values():
                p = getattr(self, attr)
                if p is not None:
                    wide = torch.full((self._d_cap, Wp), torch.inf,
                                      dtype=torch.float32,
                                      device=self.device)
                    wide[:, :p.shape[1]] = p
                    setattr(self, attr, wide)
        sl = np.fromiter(self._slot.values(), np.int64, len(self._slot))
        n, width = len(sl), self._W - old_W
        if not n or not width:
            return
        nb = _bucket(n, _UP_BLOCK)
        idx = np.empty(nb, np.int32)
        idx[:n] = sl
        idx[n:] = sl[-1]
        pools = self._pools()
        blocks = []
        for _, _, host in pools:
            block = np.empty((nb, width), np.float32)
            block[:n] = host[sl, old_W:self._W]
            block[n:] = block[n - 1]
            blocks.append(block)
            self.bytes_to_device += block.nbytes + idx.nbytes
        didx, *dblocks = _ship([idx] + blocks, self.device)
        didx = didx.long()
        for (_, pool, _), block in zip(pools, dblocks):
            pool[didx, old_W:self._W] = block

    def ensure_phase_rows(self, cd, queue, slots, cluster):
        fresh = not self._have_phase
        super().ensure_phase_rows(cd, queue, slots, cluster)
        if fresh and len(queue):
            # one-time materialization: ship the live prefill/decode rows;
            # later inserts keep them current
            live = np.fromiter(self._slot.values(), np.int64,
                               len(self._slot))
            self._upload_rows(live, which=("pre", "dec"))

    def ensure_energy_rows(self, cd, queue, slots, cluster):
        fresh = not self._have_energy
        super().ensure_energy_rows(cd, queue, slots, cluster)
        if fresh and len(queue):
            live = np.fromiter(self._slot.values(), np.int64,
                               len(self._slot))
            self._upload_rows(live, which=("ene",))

    # ------------------------------------------------------------------
    # device pool maintenance

    def _ensure_pools(self):
        """Size every active pool to (padded cap, padded W); freshly exposed
        regions hold inf and are only ever read after an upload writes them
        (stale slots are never gathered)."""
        cap = max(self._d_cap, _bucket(max(self._cap, 1), _ROW_BLOCK))
        Wp = max(self._d_Wp, _bucket(max(self._W, 1), _COL_BLOCK))
        for name, p, _ in self._pools():
            if p is not None and tuple(p.shape) == (cap, Wp):
                continue
            fresh = torch.full((cap, Wp), torch.inf, dtype=torch.float32,
                               device=self.device)
            if p is not None:
                fresh[:p.shape[0], :p.shape[1]] = p
            setattr(self, _POOL_ATTR[name], fresh)
        self._d_cap, self._d_Wp = cap, Wp

    def _upload_rows(self, dest: np.ndarray, which=("t", "pre", "dec",
                                                    "ene")):
        """Scatter freshly written host rows into the device pools:
        O(rows * W) bytes in one copy, the only matrix traffic a steady
        tick pays.  The index batch is padded with its last row repeated, so
        a duplicate index writes identical values."""
        n = len(dest)
        if not n:
            return
        self._ensure_pools()
        Wp = self._d_Wp
        nb = _bucket(n, _UP_BLOCK)
        idx = np.empty(nb, np.int32)
        idx[:n] = dest
        idx[n:] = dest[-1]
        self.bytes_to_device += idx.nbytes
        pools = [p for p in self._pools() if p[0] in which]
        blocks = []
        for _, _, host in pools:
            rows = np.full((nb, Wp), np.inf, np.float32)
            rows[:n, :self._W] = host[dest]
            rows[n:] = rows[n - 1]
            blocks.append(rows)
            self.bytes_to_device += rows.nbytes
        didx, *drows = _ship([idx] + blocks, self.device)
        didx = didx.long()
        for (_, pool, _), rows in zip(pools, drows):
            pool.index_copy_(0, didx, rows)
        if "t" in which:
            self.rows_uploaded += n

    # ------------------------------------------------------------------
    # the one-call tick

    def device_tick(self, slots, t_rem, ttft_rem, tpot_qos, dtok,
                    has_ttft, has_tpot, phase, ekey, emask, pen,
                    busy_wait, avail, escale=None):
        """Run one whole scheduling decision on the device.  All inputs are
        host vectors over the live queue ([J]) or the fleet ([W] / [K, W]);
        Eq. 1 decay (t_rem, ttft_rem) is computed on the host in float64
        from the cached scalars and cast to f32 here.  Returns (assign [Jp],
        order [Jp]) as numpy int32."""
        self._ensure_pools()
        J, W = len(slots), self._W
        Wp = self._d_Wp
        Jp = _bucket(max(J, 1), self.bj)
        use_energy = escale is not None

        def padj(a, fill, dt):
            out = np.full(Jp, fill, dt)
            out[:J] = a
            return out

        def padw(a, fill, dt):
            out = np.full(Wp, fill, dt)
            out[:W] = a
            return out

        K = emask.shape[0]
        em = np.zeros((_bucket(K, 1), Wp), bool)
        em[:K, :W] = emask
        args = (padj(slots, -1, np.int32),
                padj(t_rem, -1.0, np.float32),
                padj(ttft_rem, -1.0, np.float32),
                padj(tpot_qos, 1.0, np.float32),
                padj(dtok, 1.0, np.float32),
                padj(has_ttft, 0, np.int32),
                padj(has_tpot, 0, np.int32),
                padj(phase, 0, np.int32),
                padj(ekey, 0, np.int32),
                em,
                padw(pen, 1.0, np.float32),
                padw(busy_wait, 0.0, np.float32),
                padw(escale if use_energy else np.zeros(W), 0.0,
                     np.float32),
                padw(avail, False, bool))
        self.bytes_to_device += sum(a.nbytes for a in args)
        self.ticks += 1
        pool_pre = self._dpre if self._have_phase else self._dt
        pool_dec = self._ddec if self._have_phase else self._dt
        assign, order = scheduler_tick(
            self._dt, pool_pre, pool_dec, self._dene if use_energy else None,
            *_ship(args, self.device), use_energy=use_energy)
        out = torch.cat((assign, order)).cpu().numpy()
        return out[:Jp], out[Jp:]
