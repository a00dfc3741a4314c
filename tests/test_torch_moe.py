"""The port's MoE layer and model against the JAX package's, and the grouped
expert kernel's plain version.

On the CPU the kernels run their plain versions (``kernels/moe_experts/
ref.py``).  Against the JAX ``moe_ffn`` on the same numpy weights and
inputs: output within 3e-2 of the output's largest magnitude (bf16; the
two frameworks accumulate the expert products in different orders, about
one bf16 step of the output), aux within 1e-3 relative.  The whole model is
held teacher-forced layer by layer: each port layer takes the JAX model's
hidden state and must give the JAX layer's output within 2.5% of its
scale, as ``test_torch_model`` holds the dense logits.  Free-running, a
one-step bf16 difference in a hidden state can move a near-tied gate past
another (on reduced moonshot a top-2 margin of 0.0026 meets 0.005 of gate
noise by layer 2) and flip a route; that is routing's discreteness, not a
fault of either side, so the models are not compared free-running.

The CUDA kernels run only on a card: their test skips here, and on the
card (which has no JAX) it runs alone with ``pytest -m gpu``.
"""

from __future__ import annotations

import dataclasses
import gc

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels.moe_experts import (moe_experts_kernel, moe_experts_plain,
                                             moe_router_kernel, moe_router_plain)
from repro_torch.models import build_model
from repro_torch.models import layers as tl
from repro_torch.models import moe as tmoe
from repro_torch.models.config import MoEConfig
from repro_torch.models.transformer import attn_residual_fwd
from repro_torch.weights import params_from_jax, params_to_numpy

try:    # the card's machine has no JAX: there only the gpu-marked tests run
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import build_model as jax_build_model
    from repro.models import layers as jl
    from repro.models import moe as jmoe
except ModuleNotFoundError:
    jax = None

torch.set_num_threads(2)

ARCHS = ["moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b"]
FFN_TOL = 3e-2
LAYER_TOL = 2.5e-2


def jax_and_port(arch, **over):
    """(jax model, jax params, port model) on the same weights."""
    jcfg = dataclasses.replace(jconfigs.get(arch).reduced(), **over)
    tcfg = dataclasses.replace(configs.get(arch).reduced(), **over)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.key(0))
    tm = build_model(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu"))
    return jm, jp, tm


def as_port(a) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).bfloat16()


def test_rank_within_expert_matches_reference_and_onehot():
    rng = np.random.default_rng(0)
    for n, E in ((64, 8), (48, 64), (200, 4)):
        e = rng.integers(0, E, size=n).astype(np.int32)
        got = tmoe._rank_within_expert(torch.from_numpy(e), E).numpy()
        ref = np.asarray(jmoe._rank_within_expert(jnp.asarray(e), E))
        onehot = np.eye(E, dtype=np.int64)[e]
        want = (np.cumsum(onehot, axis=0) * onehot).sum(-1) - 1
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, ref)


def test_top_k_breaks_ties_to_the_lower_index():
    gates = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    vals, idx = tmoe.top_k_lower_first(gates, 2)
    assert idx.tolist() == [[1, 2], [0, 1]]
    jv, ji = jax.lax.top_k(jnp.asarray(gates.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


# (arch, overrides, no_drop): moonshot (shared expert) and qwen3-moe (none),
# drop-free and with capacity factors 0.25 (many drops) and 1.25; a GELU
# expert variant
FFN_CASES = [
    ("moonshot-v1-16b-a3b", {}, True), ("moonshot-v1-16b-a3b", {"cf": 0.25}, False),
    ("moonshot-v1-16b-a3b", {"cf": 1.25}, False), ("qwen3-moe-235b-a22b", {}, True),
    ("qwen3-moe-235b-a22b", {"cf": 0.25}, False), ("qwen3-moe-235b-a22b", {"cf": 1.25}, False),
    ("qwen3-moe-235b-a22b", {"mlp": "gelu"}, True),
    ("qwen3-moe-235b-a22b", {"mlp": "gelu", "cf": 0.25}, False),
]


@pytest.mark.parametrize("arch,over,no_drop", FFN_CASES,
                         ids=[f"{a}-{o}-nodrop{n}" for a, o, n in FFN_CASES])
def test_moe_ffn_matches_jax(arch, over, no_drop):
    over = dict(over)
    kw = {}
    if "cf" in over:
        m = configs.get(arch).reduced().moe
        kw["moe"] = MoEConfig(n_experts=m.n_experts, top_k=m.top_k, d_expert=m.d_expert,
                              capacity_factor=over.pop("cf"))
    kw.update(over)
    jm, jp, tm = jax_and_port(arch, **kw)
    cfg = tm.cfg
    assert (tmoe.has_shared_expert(cfg)) == (arch.startswith("moonshot"))
    x = np.random.default_rng(1).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    for i, layer in enumerate(tm.layers):
        pj = jax.tree_util.tree_map(lambda a, i=i: a[i], jp["layers"]["moe"])
        want, aux_want = jmoe.moe_ffn(pj, jm.cfg, xj, no_drop=no_drop)
        got, aux = tmoe.moe_ffn(layer.moe, cfg, as_port(xj), no_drop=no_drop)
        assert got.shape == (2, 16, cfg.d_model) and got.dtype == torch.bfloat16
        want = np.asarray(want, np.float32)
        err = np.abs(got.float().numpy() - want).max()
        scale = np.abs(want).max()
        assert err <= FFN_TOL * scale, (i, err, scale)
        np.testing.assert_allclose(float(aux), float(aux_want), rtol=1e-3)


def test_capacity_drops_are_deterministic():
    """Capacity factor 0.25 forces drops: outputs are finite, repeatable,
    and a dropped pair contributes exactly zero (the sum of the kept pairs
    alone)."""
    cfg = configs.get("qwen3-moe-235b-a22b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.25))
    tm = build_model(cfg, device="cpu", seed=2)
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(2)).bfloat16()
    p = tm.layers[0].moe
    o1, _ = tmoe.moe_ffn(p, cfg, x)
    o2, _ = tmoe.moe_ffn(p, cfg, x)
    assert torch.isfinite(o1.float()).all()
    assert torch.equal(o1, o2)
    full, _ = tmoe.moe_ffn(p, cfg, x, no_drop=True)
    assert not torch.equal(o1, full)          # something was dropped
    cap = tmoe.capacity(32, cfg.moe)
    assert cap == 4
    # every expert keeps at most `cap` pairs: rebuild the output from the
    # kept pairs only
    xf = x.reshape(32, -1)
    gates = torch.softmax(moe_router_plain(xf, p.router["w"]), -1)
    w, idx = tmoe.top_k_lower_first(gates, cfg.moe.top_k)
    w = w / w.sum(-1, keepdim=True)
    rank = tmoe._rank_within_expert(idx.reshape(-1).int(), cfg.moe.n_experts).reshape(32, -1)
    want = torch.zeros(32, cfg.d_model)
    for t in range(32):
        for j in range(cfg.moe.top_k):
            if rank[t, j] < cap:
                e = int(idx[t, j])
                y, _ = moe_experts_plain("swiglu", xf[t:t + 1], torch.tensor([0, 1]),
                                         p.experts["w_gate"][e:e + 1], p.experts["w_up"][e:e + 1])
                y, _ = moe_experts_plain("plain", y, torch.tensor([0, 1]),
                                         p.experts["w_down"][e:e + 1])
                want[t] += (y[0] * w[t, j].bfloat16()).float()
    np.testing.assert_allclose(o1.reshape(32, -1).float().numpy(), want.numpy(),
                               atol=1e-2, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_and_loss_aux_match_jax_layer_forced(arch):
    """Every layer of ``MoELM`` (attention half, then the MoE half with
    capacity dropping) on the JAX model's hidden state gives the JAX
    layer's output; the summed aux and the head agree too; and ``apply``
    and ``loss_aux`` are that same stack run free."""
    jm, jp, tm = jax_and_port(arch)
    cfg = tm.cfg
    toks = np.random.default_rng(0).integers(0, cfg.vocab, size=(2, 12)).astype(np.int32)
    pos_j = jnp.broadcast_to(jnp.arange(12, dtype=jnp.int32)[None], (2, 12))
    pos_t = torch.arange(12, dtype=torch.int32)[None].expand(2, 12)
    h = jl.embed_tokens(jp["embedding"], jm.cfg, jnp.asarray(toks))
    aux_j = jnp.zeros((), jnp.float32)
    aux_t = 0.0
    for i, layer in enumerate(tm.layers):
        pj = jax.tree_util.tree_map(lambda a, i=i: a[i], jp["layers"])
        out_j, aux_j = jm._layer_fwd_aux(pj, h, pos_j, aux_j)
        x = attn_residual_fwd(layer, cfg, as_port(h), pos_t)
        out_t, a = tmoe.moe_residual(layer, cfg, x, no_drop=False)
        aux_t += float(a)
        want = np.asarray(out_j, np.float32)
        err = np.abs(out_t.float().numpy() - want).max()
        assert err <= LAYER_TOL * np.abs(want).max(), (i, err)
        h = out_j
    want = jl.lm_head(jp["embedding"], jm.cfg, jl.apply_norm(jm.cfg.norm, jp["final_norm"], h))
    got = tl.lm_head(tm.embedding, cfg, tl.apply_norm(cfg.norm, tm.final_norm, as_port(h)))
    want = np.asarray(want, np.float32)[..., :cfg.vocab]
    err = np.abs(got.float().numpy()[..., :cfg.vocab] - want).max()
    assert err <= LAYER_TOL * np.abs(want).max()
    _, jaux = jm.loss_aux(jp, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(aux_t * cfg.moe.router_aux_weight, float(jaux), rtol=2e-2)

    logits, aux = tm.loss_aux(torch.from_numpy(toks))
    assert logits.shape == (2, 12, cfg.padded_vocab) and logits.dtype == torch.bfloat16
    assert torch.isfinite(logits[..., :cfg.vocab].float()).all() and aux.dtype == torch.float32
    assert torch.equal(tm.apply(torch.from_numpy(toks)), logits)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0.25)


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_round_trip_and_router_stays_fp32(arch):
    jm, jp, tm = jax_and_port(arch)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    back = params_to_numpy(tm.state_dict(), tm.cfg)
    flat_t = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_t) == len(flat_b)
    for path, a in flat_t:
        name = jax.tree_util.keystr(path)
        fp32 = any(k in name for k in ("q_norm", "k_norm", "'router'"))
        expect = a if fp32 else np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                                           .astype(jnp.float32))
        np.testing.assert_array_equal(flat_b[path], expect, err_msg=name)
    sd = params_from_jax(back, tm.cfg, "cpu")
    for k, v in tm.state_dict().items():
        assert torch.equal(sd[k], v) and sd[k].dtype == v.dtype, k
    E, D, F = tm.cfg.moe.n_experts, tm.cfg.d_model, tm.cfg.moe.d_expert
    assert sd["layers.0.moe.router.w"].dtype == torch.float32
    assert sd["layers.0.moe.router.w"].shape == (D, E)
    assert sd["layers.0.moe.experts.w_up"].shape == (E, D, F)
    assert sd["layers.0.moe.experts.w_down"].dtype == torch.bfloat16
    assert ("layers.0.moe.shared.w_gate" in sd) == arch.startswith("moonshot")


def _per_pair(mode, x, offsets, w1, w2, shared):
    """Each row alone through its expert, one (1, K) product at a time."""
    rows = []
    bounds = offsets.tolist()
    for e in range(w1.shape[0]):
        for r in range(bounds[e], bounds[e + 1]):
            a = (x[r].float() @ w1[e].float()).bfloat16()
            if mode == "swiglu":
                a = torch.nn.functional.silu(a) * (x[r].float() @ w2[e].float()).bfloat16()
            elif mode == "gelu":
                a = torch.nn.functional.gelu(a, approximate="tanh")
            rows.append(a)
    out_s = None
    if shared is not None:
        xs, w1s, w2s = shared
        out_s = torch.stack([_per_pair(mode, xs[r:r + 1], torch.tensor([0, 1]), w1s[None],
                                       None if w2s is None else w2s[None], None)[0][0]
                             for r in range(xs.shape[0])])
    return torch.stack(rows), out_s


@pytest.mark.parametrize("mode", ["swiglu", "gelu", "plain"])
def test_plain_version_equals_a_per_pair_loop(mode):
    """Segments of 0, 1, 5 and 17 rows (an empty expert, a tile's worth
    and more), with a shared group of 3 rows: each output row equals that
    row alone through its expert (bf16 rounding, fp32 sums: within one bf16
    step)."""
    gen = torch.Generator().manual_seed(0)
    E, K, N = 4, 64, 32
    lens = [5, 0, 17, 1]
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(lens)]), dtype=torch.int32)
    x = torch.randn(sum(lens), K, generator=gen).bfloat16()
    w1 = (torch.randn(E, K, N, generator=gen) / 8).bfloat16()
    w2 = (torch.randn(E, K, N, generator=gen) / 8).bfloat16() if mode == "swiglu" else None
    shared = (torch.randn(3, K, generator=gen).bfloat16(),
              (torch.randn(K, 2 * N, generator=gen) / 8).bfloat16(),
              (torch.randn(K, 2 * N, generator=gen) / 8).bfloat16() if mode == "swiglu"
              else None)
    got, got_s = moe_experts_plain(mode, x, offsets, w1, w2, shared)
    want, want_s = _per_pair(mode, x, offsets, w1, w2, shared)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=1e-2)
    torch.testing.assert_close(got_s.float(), want_s.float(), atol=2e-2, rtol=1e-2)
    # the kernel's wrapper takes the plain version for CPU tensors
    again, again_s = moe_experts_kernel(mode, x, offsets, w1, w2, shared)
    assert torch.equal(again, got) and torch.equal(again_s, got_s)
    # row invariance on the CPU: one expert's rows alone equal them in the call
    lo, hi = int(offsets[2]), int(offsets[3])
    one, _ = moe_experts_plain(mode, x[lo + 3:lo + 4], torch.tensor([0, 0, 0, 1, 1], dtype=torch.int32),
                               w1, w2)
    assert torch.equal(one[0], got[lo + 3])
    assert moe_experts_kernel.launches == 0


def test_router_plain_is_fp32_and_row_invariant():
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(37, 64, generator=gen).bfloat16()
    w = torch.randn(64, 8, generator=gen)
    got = moe_router_kernel(x, w)
    assert got.dtype == torch.float32
    want = x.double() @ w.double()
    torch.testing.assert_close(got.double(), want, atol=1e-5, rtol=1e-5)
    for t in (0, 11, 36):
        assert torch.equal(moe_router_plain(x[t:t + 1], w)[0], got[t])
    assert moe_router_kernel.launches == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_is_row_invariant_on_the_cpu(arch):
    """Drop-free, a token's output is bitwise the same alone and inside a
    call of 24 tokens (what makes a decode step bitwise a chunk)."""
    cfg = configs.get(arch).reduced()
    tm = build_model(cfg, device="cpu", seed=4)
    x = torch.randn(1, 24, cfg.d_model, generator=torch.Generator().manual_seed(4)).bfloat16()
    p = tm.layers[1].moe
    whole, _ = tmoe.moe_ffn(p, cfg, x, no_drop=True)
    for t in (0, 7, 23):
        one, _ = tmoe.moe_ffn(p, cfg, x[:, t:t + 1], no_drop=True)
        assert torch.equal(one[0, 0], whole[0, t]), t


def test_model_builds_and_mesh_paths_raise():
    cfg = configs.get("moonshot-v1-16b-a3b")
    assert cfg.family == "moe" and (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_expert) == \
        (64, 6, 1408)
    # the JAX package's count leaves out the shared expert (3 x 2048 x 2816 x 48)
    assert cfg.param_count() == jconfigs.get("moonshot-v1-16b-a3b").param_count() == 28057796608
    small = cfg.reduced()
    tm = build_model(small, device="cpu")
    assert isinstance(tm, tmoe.MoELM)
    shared = 3 * small.d_model * 2 * small.moe.d_expert * small.n_layers
    norms = (2 * small.n_layers + 1) * small.d_model      # not counted there either
    assert sum(p.numel() for p in tm.parameters()) == small.param_count() + shared + norms
    with pytest.raises(NotImplementedError, match="not ported"):
        tmoe.moe_ffn(tm.layers[0].moe, small, torch.zeros(1, 2, small.d_model).bfloat16(),
                     mesh=object())


def _cuda_case(mode, gen, lens, K, N, shared_rows):
    """Routed rows in expert order with segments ``lens``, weights (E, K,
    N) and a shared expert (K, 2N) over ``shared_rows`` rows, on the card."""
    E = len(lens)
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(lens)]), dtype=torch.int32).cuda()
    x = torch.randn(sum(lens), K, generator=gen).bfloat16().cuda()
    w1 = (torch.randn(E, K, N, generator=gen) / 16).bfloat16().cuda()
    w2 = ((torch.randn(E, K, N, generator=gen) / 16).bfloat16().cuda()
          if mode == "swiglu" else None)
    shared = (torch.randn(shared_rows, K, generator=gen).bfloat16().cuda(),
              (torch.randn(K, 2 * N, generator=gen) / 16).bfloat16().cuda(),
              (torch.randn(K, 2 * N, generator=gen) / 16).bfloat16().cuda()
              if mode == "swiglu" else None)
    return offsets, x, w1, w2, shared


# segment lengths of the two tile shapes the kernel picks: 64-row tiles
# (segments average under 128 rows) and 128-row tiles
TILE_CASES = {64: [70, 0, 1, 129, 0, 64, 3, 40], 128: [300, 0, 129, 200]}


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["swiglu", "gelu", "plain"])
def test_cuda_kernel_matches_plain_version(mode):
    """On the card: the grouped kernel against its plain version (bf16
    3e-2), empty experts and segments that are not a multiple of the tile,
    at both tile shapes (64 and 128 rows, counted per route); rows alone
    (1-row calls on 64-row tiles, the shared rows too) bitwise the same rows
    inside both calls; and the router kernel within 1e-5 of the fp32
    product."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.moe_experts import library_plan

    gen = torch.Generator().manual_seed(3)
    K, N = 256, 96
    for bm, lens in TILE_CASES.items():
        E = len(lens)
        offsets, x, w1, w2, shared = _cuda_case(mode, gen, lens, K, N, 5)
        assert library_plan(mode, x.shape[0], E, N, 5, 2 * N).bm == bm
        before = moe_experts_kernel.launches
        route = dict(moe_experts_kernel.launches_by_route)
        got, got_s = moe_experts_kernel(mode, x, offsets, w1, w2, shared)
        want, want_s = moe_experts_plain(mode, x, offsets, w1, w2, shared)
        torch.cuda.synchronize()
        assert moe_experts_kernel.launches == before + 1
        assert moe_experts_kernel.launches_by_route[f"wgmma_bm{bm}"] == \
            route[f"wgmma_bm{bm}"] + 1
        assert (got.float() - want.float()).abs().max().item() <= 3e-2
        assert (got_s.float() - want_s.float()).abs().max().item() <= 3e-2
        bounds = np.concatenate([[0], np.cumsum(lens)])
        for r in (0, int(bounds[3]) + 77, int(bounds[-1]) - 1, int(bounds[2]) + 63):
            e = int(np.searchsorted(bounds, r, side="right")) - 1
            e_off = torch.zeros(E + 1, dtype=torch.int32)
            e_off[e + 1:] = 1
            t = r % 5
            on64 = moe_experts_kernel.launches_by_route["wgmma_bm64"]
            one, one_s = moe_experts_kernel(mode, x[r:r + 1].contiguous(), e_off.cuda(), w1, w2,
                                            (shared[0][t:t + 1].contiguous(), *shared[1:]))
            assert moe_experts_kernel.launches_by_route["wgmma_bm64"] == on64 + 1
            assert torch.equal(one[0], got[r]) and torch.equal(one_s[0], got_s[t]), (bm, r)
    xr = torch.randn(40, K, generator=gen).bfloat16().cuda()
    wr = torch.randn(K, 64, generator=gen).cuda()
    lr = moe_router_kernel(xr, wr)
    ref = (xr.double() @ wr.double())
    assert (lr.double() - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    assert torch.equal(moe_router_kernel(xr[7:8].contiguous(), wr)[0], lr[7])


@pytest.mark.gpu
@pytest.mark.parametrize("bm", sorted(TILE_CASES))
def test_cuda_kernel_replays_bitwise_from_a_graph(bm):
    """A launch captured in a CUDA graph (tensor maps by value, grid from
    shapes alone) replays bitwise the eager launch, and again after the
    inputs change in place (the graph reads the captured addresses)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    gen = torch.Generator().manual_seed(5)
    offsets, x, w1, w2, shared = _cuda_case("swiglu", gen, TILE_CASES[bm], 256, 96, 5)
    eager, eager_s = moe_experts_kernel("swiglu", x, offsets, w1, w2, shared)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        moe_experts_kernel("swiglu", x, offsets, w1, w2, shared)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    before = moe_experts_kernel.launches
    gc.collect()        # no garbage CUDAGraph freed (and destroyed) mid-capture
    with torch.cuda.graph(graph):
        out, out_s = moe_experts_kernel("swiglu", x, offsets, w1, w2, shared)
    out.zero_()
    out_s.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager) and torch.equal(out_s, eager_s)
    x.copy_(x.flip(0))
    graph.replay()
    again, again_s = moe_experts_kernel("swiglu", x, offsets, w1, w2, shared)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(out_s, again_s)
    assert moe_experts_kernel.launches == before + 2      # the capture and the eager call
