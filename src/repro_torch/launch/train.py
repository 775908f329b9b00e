# Port of repro/launch/train.py: the same launcher on torch, plus --device.
"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Trains the reduced config of the selected architecture with
checkpoint/restart, as the JAX launcher does on the CPU:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b
        [--steps 100] [--batch 8] [--seq 64] [--lr 1e-3]
        [--ckpt-dir DIR] [--ckpt-every 50] [--device cpu]

It runs on the card (attention on the flash kernel and its backward, the
MoE router and the RWKV WKV scan on theirs) unless ``--device cpu`` asks
for the CPU (their plain versions).  Every family trains (dense, MoE with
MLA too, RWKV, hymba, the VLM, encoder-decoder).  Params
come from ``torch.Generator(...).manual_seed(0)``; the batches from the
``DataLoader`` copy, seeded with the step it starts from, and the
encoder-decoder's ``audio_embeds`` (the VLM's ``vision_embeds``) from the
JAX launcher's numpy stubs, cast to the model's dtype.  Every 10 steps it
prints ``[arch] step N loss L (R it/s)``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import reduced
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.models.common import dtype_of
from repro_torch.models.registry import build_model
from repro_torch.training import checkpoint
from repro_torch.training.data import DataLoader
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import init_train_state, make_train_step


def extra_fn_of(cfg):
    """The JAX launcher's frontend stubs: 0.02 x a standard normal from a
    numpy seed of 0, f32 (None for a family without one)."""
    if cfg.family not in ("vlm", "audio"):
        return None

    def extra_fn(batch, seq):
        out = {}
        if cfg.family == "vlm":
            out["vision_embeds"] = 0.02 * np.random.default_rng(0) \
                .standard_normal((batch, cfg.vision.n_vision_tokens,
                                  cfg.d_model)).astype("float32")
        if cfg.family == "audio":
            out["audio_embeds"] = 0.02 * np.random.default_rng(0) \
                .standard_normal((batch, seq, cfg.d_model)).astype("float32")
        return out

    return extra_fn


def to_device(batch, cfg, device):
    """A numpy batch as tensors on ``device``: float arrays in the model's
    dtype, integer arrays as they are."""
    out = {}
    for key, a in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        out[key] = t.to(dtype_of(cfg)) if t.is_floating_point() else t
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the kernels' plain PyTorch versions; "
                         "default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = reduced(get_config(args.arch))
    model = build_model(cfg, device=args.device)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10),
                          total_steps=args.steps)
    state = init_train_state(
        model, torch.Generator(device=model.device).manual_seed(0), opt_cfg)
    start = 0
    if args.ckpt_dir and checkpoint.latest_step(args.ckpt_dir) is not None:
        start = checkpoint.latest_step(args.ckpt_dir)
        state = checkpoint.restore(args.ckpt_dir, state)
        print(f"resumed from step {start}")

    step_fn = make_train_step(model, opt_cfg)
    dl = DataLoader(cfg.vocab, args.batch, args.seq, seed=start,
                    extra_fn=extra_fn_of(cfg))
    losses = []
    t0 = time.time()
    try:
        for step in range(start, args.steps):
            batch = to_device(next(dl), cfg, model.device)
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            if (step + 1) % 10 == 0:
                print(f"[{args.arch}] step {step + 1:4d} "
                      f"loss {losses[-1]:.3f} "
                      f"({(step + 1 - start) / (time.time() - t0):.2f} it/s)")
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                checkpoint.save(args.ckpt_dir, step + 1, state)
    finally:
        dl.close()
    return {"start": start, "losses": losses, "state": state}


if __name__ == "__main__":
    main()
