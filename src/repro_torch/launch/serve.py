# Port of repro/launch/serve.py: the same launcher on torch, plus --device.
"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Brings up a reduced-config replica of the selected architecture and serves
a batch of synthetic requests through the SynergAI scheduler (worker
selection via Eq. 1-4 against the offline Configuration Dictionary).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b
        [--batch 2] [--prompt-len 16] [--gen 8] [--requests 3] [--device cpu]

It runs on the card (the attention kernels, the WKV scan, the MoE router)
unless ``--device cpu`` asks for the CPU (their plain versions).  Every
family of the registry serves: dense, RWKV, MoE (phi3.5-moe, and
deepseek-v2 with MLA), hybrid (hymba), VLM (llama-3.2-vision) and
encoder-decoder (seamless-m4t).  The VLM's vision embeddings and the
encoder-decoder's audio frame embeddings are stubs of 0.02 x a standard
normal, as the JAX launcher makes them, in the model's dtype.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import reduced
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.core.engines import default_engines
from repro_torch.core.estimator import candidate_order, estimate_matrix
from repro_torch.core.job import Job
from repro_torch.core.offline import characterize
from repro_torch.models.common import dtype_of
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import InferenceEngine

WORKERS = ["cloud-pod", "edge-large", "edge-small"]


def place(cd, arch: str, rid: int) -> str:
    """The SynergAI plan for request ``rid`` of ``arch``: the first
    candidate worker of Eq. 1-4 and its optimal configuration."""
    engine_name = next((n for n, e in default_engines().items()
                        if e.arch == arch), None)
    if not engine_name:
        return "local"
    job = Job(rid, engine_name, queries=100, t_qos=120.0, arrival=0.0)
    score = estimate_matrix(cd, [job], WORKERS, now=0.0)
    order = candidate_order(score, 0)
    worker = WORKERS[order[0]] if order else "cloud-pod"
    ent = cd.optimal(engine_name, worker)
    return f"{worker} (c*={ent.mode}/r{ent.chips_per_replica})"


def vision_embeds(cfg, batch: int, generator, device):
    """The vision frontend's stub: 0.02 x a standard normal of [batch,
    n_vision_tokens, d_model] from ``generator``, in the model's dtype."""
    x = torch.randn((batch, cfg.vision.n_vision_tokens, cfg.d_model),
                    generator=generator, device=device)
    return (0.02 * x).to(dtype_of(cfg))


def audio_embeds(cfg, batch: int, frames: int, generator, device):
    """The speech frontend's stub: 0.02 x a standard normal of [batch,
    frames, d_model] from ``generator``, in the model's dtype."""
    x = torch.randn((batch, frames, cfg.d_model), generator=generator,
                    device=device)
    return (0.02 * x).to(dtype_of(cfg))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the kernels' plain PyTorch versions; "
                         "default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = reduced(get_config(args.arch))
    model = build_model(cfg, device=args.device)
    params = model.init_params(
        torch.Generator(device=model.device).manual_seed(0))
    eng = InferenceEngine(model, params,
                          max_len=args.prompt_len + args.gen + 8)
    cd = characterize()

    gen = torch.Generator(device=model.device).manual_seed(1)
    for rid in range(args.requests):
        plan = place(cd, args.arch, rid)
        toks = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                             generator=gen, device=model.device)
        batch = {"tokens": toks}
        if cfg.family == "vlm":
            batch["vision_embeds"] = vision_embeds(cfg, args.batch, gen,
                                                   model.device)
        if cfg.family == "audio":
            batch["audio_embeds"] = audio_embeds(cfg, args.batch,
                                                 args.prompt_len, gen,
                                                 model.device)
        t0 = time.perf_counter()
        out = eng.generate(batch, args.gen)
        print(f"req {rid} -> {plan}: generated {out.shape[1]} tokens "
              f"x batch {out.shape[0]} in {time.perf_counter() - t0:.2f}s")
    s = eng.stats
    print(f"stats: prefill {s.prefill_tokens} tok ({s.prefill_s:.2f}s), "
          f"decode {s.decoded_tokens} tok ({s.decode_s:.2f}s)")
    return s


if __name__ == "__main__":
    main()
