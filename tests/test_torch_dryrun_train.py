"""The dry run's matmul FLOPs on a train, a prefill and a long-decode cell
against the JAX package's ``dot_general`` count of the same cell.

The port runs attention (where ``common.attention`` routes to the flash
or decode kernel), the MoE router and the WKV recurrence as hand-written
kernels, whose FLOPs it reports apart from the matmuls; the JAX package
runs them as XLA dots.  So the JAX side replaces exactly those calls, for
the test only, by shape-only stand-ins that do no dot and still pass a
gradient to their inputs (a sum times zero): ``common.attention`` as
``layers`` imports it (only where the port would take a kernel),
``_route_grouped`` and, for rwkv6, ``common.chunked_time_scan`` (the WKV
step's scan; the cell has no other).  What is left -- projections, MLPs
and experts, the unembedding and chunked loss, their gradients and remat's
recompute, the Mamba scan and the attention that no kernel takes -- must
count the same FLOPs on both sides, exactly, but for two differences of
program that deepseek-v2's cell shows and the test reckons by hand.

The meta loops' counts are held apart, on small shapes: one trip counted
for all, its backward and its recompute included, against the same
functions run with every trip on the CPU.
"""

import contextlib

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models import common as jcommon
from repro.models import layers as jlayers
from repro_torch import _meta
from repro_torch.configs.registry import SHAPES, get_config
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.launch.flopcount import Counter
from repro_torch.models import common, layers
from repro_torch.models.registry import build_model
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.train_step import make_train_step
from test_torch_dryrun import jax_cell, jax_dot_flops, port_counts


def _port_takes_a_kernel(q, k, v, causal, window, q_offset, k_valid):
    """``repro_torch.models.common.attention``'s routing to the kernels."""
    fits = (q.ndim == 4 and k.shape == v.shape and q.shape[0] == k.shape[0]
            and q.shape[-1] == k.shape[-1] and q.shape[-1] in HEAD_DIMS
            and k.shape[1] > 0 and q.shape[2] % k.shape[2] == 0)
    if q_offset != 0 or not fits:
        return False
    if q.shape[1] == k.shape[1] and k_valid is None:
        return True
    return (q.shape[1] == 1 and k_valid is not None and not causal
            and window is None)


@contextlib.contextmanager
def jax_kernels_stood_in(wkv=True):
    attention, route, scan = (jlayers.attention, jlayers._route_grouped,
                              jcommon.chunked_time_scan)

    def attention_standin(cfg, q, k, v, *, causal=True, window=None,
                          q_offset=0, k_valid=None):
        if not _port_takes_a_kernel(q, k, v, causal, window, q_offset,
                                    k_valid):
            return attention(cfg, q, k, v, causal=causal, window=window,
                             q_offset=q_offset, k_valid=k_valid)
        kv = (k.sum(1, keepdims=True) + v.sum(1, keepdims=True)) * 0
        return q * 0 + jnp.repeat(kv, q.shape[2] // k.shape[2], axis=2)

    def route_standin(p, cfg, xg):
        z = (xg.astype(jnp.float32).sum(-1, keepdims=True) * 0
             + p["router"].sum(0) * 0)
        return z, jax.lax.stop_gradient(z)

    def scan_standin(step, init, xs, length, chunk=64):
        x0 = jax.tree.leaves(xs)[0]
        return (jax.tree.map(lambda a: a * 1, init),
                x0 * 0 + xs[2].sum() * 0)

    jlayers.attention = attention_standin
    jlayers._route_grouped = route_standin
    if wkv:
        jcommon.chunked_time_scan = scan_standin
    try:
        yield
    finally:
        jlayers.attention = attention
        jlayers._route_grouped = route
        jcommon.chunked_time_scan = scan


@pytest.mark.parametrize("arch,shape_name,kernels", [
    ("qwen3-4b", "train_4k", {"flash_attention", "flash_attention_bwd"}),
    ("phi3.5-moe-42b-a6.6b", "prefill_32k",
     {"flash_attention", "moe_routing"}),
    ("rwkv6-1.6b", "long_500k", {"rwkv_scan"})],
    ids=["train_4k", "prefill_32k", "long_500k"])
def test_dot_flops_equal_jax_with_the_kernels_stood_in(arch, shape_name,
                                                       kernels):
    port = port_counts(arch, shape_name)
    with jax_kernels_stood_in():
        want = jax_dot_flops(*jax_cell(arch, shape_name))
    assert port["dot_flops"] == want, (port["dot_flops"], want)
    assert set(port["kernel_flops"]) == kernels
    assert all(v > 0 for v in port["kernel_flops"].values())
    assert port["flops"] > port["dot_flops"] and port["bytes"] > 0


def test_dot_flops_equal_jax_through_meta_loops_and_their_backward():
    """hymba's train step runs its Mamba scan as a meta loop of 64 chunks
    (each under ``checkpoint``) and its attention on the flash kernels:
    the forward, the backward and the recompute of every chunk count."""
    port = port_counts("hymba-1.5b", "train_4k")
    with jax_kernels_stood_in(wkv=False):
        want = jax_dot_flops(*jax_cell("hymba-1.5b", "train_4k"))
    assert port["dot_flops"] == want, (port["dot_flops"], want)
    assert set(port["kernel_flops"]) == {"flash_attention",
                                         "flash_attention_bwd"}


def test_dot_flops_of_mla_training_equal_jax_but_two_reckoned_terms():
    """deepseek-v2's train step runs 8 microbatches as a meta loop, MLA's
    attention (q and k 192 wide, v 128: no kernel takes it) as the chunked
    flash loop, its router on the kernels.  The two programs differ in two
    places, each reckoned by hand: the JAX chunk step is rematerialised
    (``nothing_saveable``), so its backward recomputes each chunk's scores,
    2 (nope + rope) B H S^2 a layer; and torch's recompute of a layer runs
    the MoE combine einsum, whose inputs its backward keeps, where JAX's
    remat drops the unused product: 2 T E C D a layer."""
    arch = "deepseek-v2-236b"
    port = port_counts(arch, "train_4k")
    with jax_kernels_stood_in():
        want = jax_dot_flops(*jax_cell(arch, "train_4k"))
    cfg, shape = get_config(arch), SHAPES["train_4k"]
    B, S, L, e = shape.global_batch, shape.seq_len, cfg.n_layers, cfg.moe
    scores = 2 * (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim) \
        * B * cfg.n_heads * S * S * L
    g = min(layers.MOE_CHUNK, S)
    C = max(e.top_k, int(g / e.n_experts * e.top_k * e.capacity_factor))
    combine = 2 * B * S * e.n_experts * C * cfg.d_model * L
    assert port["dot_flops"] == want - scores + combine, (
        port["dot_flops"], want, scores, combine)
    assert set(port["kernel_flops"]) == {"moe_routing", "moe_routing_bwd"}


def _counts(fn, device, *shapes):
    g = torch.Generator().manual_seed(0)
    args = [torch.randn(s, generator=g).to(device).requires_grad_()
            for s in shapes]
    with Counter(arguments=args) as c:
        sum(o.float().sum() for o in fn(*args)).backward()
    return c.summary()


def _mamba_scan(dt, Bt, Ct, x, A, h0):
    return common.chunked_time_scan(layers.mamba_step(A), h0,
                                    (dt, Bt, Ct, x), dt.shape[0], chunk=4)


def _remat_flash(q, k, v):
    return (_meta.checkpoint(lambda a, b, c: common.chunked_flash_attention(
        a, b, c, causal=True, chunk=4) * 2, q, k, v),)


@pytest.mark.parametrize("fn,shapes", [
    (_mamba_scan, [(16, 2, 5), (16, 2, 3), (16, 2, 3), (16, 2, 5), (5, 3),
                   (2, 5, 3)]),
    (_remat_flash, [(2, 8, 4, 8), (2, 16, 2, 8), (2, 16, 2, 8)])],
    ids=["chunked_time_scan", "remat_chunked_flash"])
def test_meta_trip_counts_equal_every_trip_run(fn, shapes):
    on_cpu, on_meta = _counts(fn, "cpu", *shapes), _counts(fn, "meta",
                                                           *shapes)
    assert on_meta["dot_flops"] == on_cpu["dot_flops"] > 0


def test_meta_train_step_counts_equal_every_trip_run():
    """A reduced deepseek-v2 step: 4 microbatches, the chunked flash loop
    under each layer's ``checkpoint``, the router kernel's backward."""
    cfg = get_config("deepseek-v2-236b")
    cfg = dataclasses.replace(
        cfg, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=32, vocab=128, attn_chunk=64, flash_threshold=64,
        mla=dataclasses.replace(cfg.mla, kv_lora_rank=16, q_lora_rank=24,
                                qk_nope_head_dim=16, qk_rope_head_dim=8,
                                v_head_dim=16),
        moe=dataclasses.replace(cfg.moe, n_experts=8, top_k=2, n_shared=1,
                                d_ff_expert=16))

    def counts(device):
        model = build_model(cfg, device=device)
        params = model.init_params(torch.Generator().manual_seed(0))
        state = {"params": params, "opt": init_opt_state(params)}
        tok = torch.randint(0, cfg.vocab, (4, 256),
                            generator=torch.Generator().manual_seed(1))
        tok = tok.to(device)
        with Counter(arguments=(state, tok)) as c:
            make_train_step(model, AdamWConfig(), accum_steps=4)(
                state, {"tokens": tok, "labels": tok})
        return c.summary()

    on_cpu, on_meta = counts("cpu"), counts("meta")
    assert on_meta["dot_flops"] == on_cpu["dot_flops"] > 0
    # on the CPU the router runs its plain version (dots); on meta the
    # kernel reports its forward and backward
    assert set(on_meta["kernel_flops"]) == {"moe_routing", "moe_routing_bwd"}
