"""Each ported ``models/layers.py`` function against its JAX function.

Inputs are numpy arrays from a seed, handed to both frameworks.  Where the
output is bf16, the tolerance is about one bf16 step (2^-7 relative, so
``1e-2`` of the output's magnitude): the two frameworks accumulate the
same products in different orders, so an element near a rounding boundary
may land one bf16 step apart.  fp32 paths are held to ``1e-5``.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jl
from repro_torch import configs
from repro_torch.models import layers as tl

torch.set_num_threads(2)


def rng_of(seed):
    return np.random.default_rng(seed)


def bf16_pair(a):
    """The same bf16 values in both frameworks (cast once from fp32)."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy(), jnp.bfloat16), t


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def assert_close_bf16(got, want, rel=1e-2):
    got, want = np32(got), np32(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=rel)


def cfg_pair(arch, **over):
    return (dataclasses.replace(jconfigs.get(arch).reduced(), **over),
            dataclasses.replace(configs.get(arch).reduced(), **over))


def params_pair(tree):
    """A JAX param dict (fp32 masters) and the same values as torch fp32."""
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in tree.items()})


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(kind):
    r = rng_of(0)
    xj, xt = bf16_pair(3 * r.standard_normal((2, 5, 64)))
    pj, pt = params_pair({"scale": r.standard_normal(64).astype(np.float32),
                          "bias": r.standard_normal(64).astype(np.float32)})
    assert_close_bf16(tl.apply_norm(kind, pt, xt), jl.apply_norm(kind, pj, xj))


def test_rms_norm_head():
    r = rng_of(1)
    xj, xt = bf16_pair(2 * r.standard_normal((2, 3, 4, 16)))
    scale = r.standard_normal(16).astype(np.float32)
    got = tl.rms_norm_head(torch.from_numpy(scale), xt)
    assert got.dtype == torch.bfloat16
    assert_close_bf16(got, jl.rms_norm_head(jnp.asarray(scale), xj))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope(dtype, theta):
    r = rng_of(2)
    x = r.standard_normal((2, 6, 4, 16)).astype(np.float32)
    pos = r.integers(0, 50, size=(2, 6)).astype(np.int32)
    if dtype == "bfloat16":
        xj, xt = bf16_pair(x)
    else:
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
    got = tl.apply_rope(xt, torch.from_numpy(pos), theta)
    want = jl.apply_rope(xj, jnp.asarray(pos), theta)
    if dtype == "float32":
        np.testing.assert_allclose(np32(got), np32(want), atol=1e-5, rtol=1e-5)
    else:
        assert_close_bf16(got, want)


@pytest.mark.parametrize("arch", ["minicpm-2b", "qwen1.5-110b", "qwen3-14b"])
def test_qkv_project(arch):
    """Plain, qkv-bias and qk-norm branches (biases and norm scales drawn
    non-trivial so their branch shows)."""
    jcfg, tcfg = cfg_pair(arch)
    r = rng_of(3)
    d, hd = tcfg.d_model, tcfg.the_head_dim()
    qd, kvd = tcfg.n_heads * hd, tcfg.n_kv_heads * hd
    tree = {"wq": r.standard_normal((d, qd)) / 8, "wk": r.standard_normal((d, kvd)) / 8,
            "wv": r.standard_normal((d, kvd)) / 8, "wo": r.standard_normal((qd, d)) / 8}
    if tcfg.qkv_bias:
        tree.update(bq=r.standard_normal(qd), bk=r.standard_normal(kvd),
                    bv=r.standard_normal(kvd))
    if tcfg.qk_norm:
        tree.update(q_norm=1 + r.standard_normal(hd) / 4, k_norm=1 + r.standard_normal(hd) / 4)
    pj, pt = params_pair({k: np.asarray(v, np.float32) for k, v in tree.items()})
    xj, xt = bf16_pair(r.standard_normal((2, 7, d)))
    pos = np.broadcast_to(np.arange(7, dtype=np.int32) + 3, (2, 7)).copy()
    got = tl.qkv_project(pt, tcfg, xt, torch.from_numpy(pos))
    want = jl.qkv_project(pj, jcfg, xj, jnp.asarray(pos))
    for g, w in zip(got, want, strict=True):
        assert tuple(g.shape) == tuple(w.shape) and g.dtype == torch.bfloat16
        assert_close_bf16(g, w)


def attn_inputs(seed, B, S, T, H, Hkv, D):
    r = rng_of(seed)
    q = bf16_pair(r.standard_normal((B, S, H, D)))
    k = bf16_pair(r.standard_normal((B, T, Hkv, D)))
    v = bf16_pair(r.standard_normal((B, T, Hkv, D)))
    return q, k, v


@pytest.mark.parametrize("window,decode", [(None, False), (4, False), (None, True),
                                           (5, True)])
def test_sdpa(window, decode):
    """Causal / windowed self-attention, and the decode form: queries at an
    offset against a cache with invalid lanes."""
    B, S, T, H, Hkv, D = 2, 6, 6, 4, 2, 16
    kw_j, kw_t = {}, {}
    if decode:
        S, T = 3, 12
        r = rng_of(9)
        qpos = np.broadcast_to(np.arange(S, dtype=np.int32) + 7, (B, S)).copy()
        kpos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
        valid = r.random((B, T)) > 0.3
        kw_j = dict(q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kpos),
                    kv_valid=jnp.asarray(valid))
        kw_t = dict(q_positions=torch.from_numpy(qpos), kv_positions=torch.from_numpy(kpos),
                    kv_valid=torch.from_numpy(valid))
    (qj, qt), (kj, kt), (vj, vt) = attn_inputs(4, B, S, T, H, Hkv, D)
    got = tl.sdpa(qt, kt, vt, causal=True, window=window, **kw_t)
    want = jl.sdpa(qj, kj, vj, causal=True, window=window, **kw_j)
    assert got.dtype == torch.bfloat16
    assert_close_bf16(got, want, rel=2e-2)   # probabilities are rounded to bf16 too


def test_sdpa_streaming_branch():
    """S > 1 over T >= 4096 takes the streaming-softmax branch in both
    packages; fp32 inputs, so the two must agree to fp32 summation noise."""
    B, S, T, H, Hkv, D = 1, 2, 4096, 2, 1, 8
    r = rng_of(5)
    q, k, v = (r.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, D), (B, T, Hkv, D), (B, T, Hkv, D)))
    qpos = np.asarray([[T - 2, T - 1]], np.int32)
    got = tl.sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                  causal=True, window=3000, q_positions=torch.from_numpy(qpos))
    want = jl.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                   window=3000, q_positions=jnp.asarray(qpos))
    np.testing.assert_allclose(np32(got), np32(want), atol=1e-5, rtol=1e-5)


def test_sdpa_append():
    B, T, H, Hkv, D = 2, 10, 4, 2, 16
    (qj, qt), (kj, kt), (vj, vt) = attn_inputs(6, B, 1, T, H, Hkv, D)
    r = rng_of(7)
    knj, knt = bf16_pair(r.standard_normal((B, 1, Hkv, D)))
    vnj, vnt = bf16_pair(r.standard_normal((B, 1, Hkv, D)))
    qpos = np.asarray([[7], [9]], np.int32)
    kpos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    valid = kpos < qpos
    got = tl.sdpa_append(qt, kt, vt, knt, vnt, window=6,
                         q_positions=torch.from_numpy(qpos),
                         kv_positions=torch.from_numpy(kpos),
                         kv_valid=torch.from_numpy(valid))
    want = jl.sdpa_append(qj, kj, vj, knj, vnj, window=6, q_positions=jnp.asarray(qpos),
                          kv_positions=jnp.asarray(kpos), kv_valid=jnp.asarray(valid))
    assert_close_bf16(got, want)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 3), (False, 5)])
def test_attn_mask_is_identical(causal, window):
    r = rng_of(8)
    qpos = r.integers(0, 12, size=(2, 4)).astype(np.int32)
    kpos = r.integers(-1, 12, size=(2, 9)).astype(np.int32)
    valid = r.random((2, 9)) > 0.2
    got = tl._attn_mask(torch.from_numpy(qpos), torch.from_numpy(kpos),
                        torch.from_numpy(valid), causal, window)
    want = jl._attn_mask(jnp.asarray(qpos), jnp.asarray(kpos), jnp.asarray(valid),
                         causal, window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["minicpm-2b", "starcoder2-3b"])
def test_apply_mlp(arch):
    """SwiGLU, and the biased tanh-GELU MLP (jax.nn.gelu's default)."""
    jcfg, tcfg = cfg_pair(arch)
    r = rng_of(10)
    d, f = tcfg.d_model, tcfg.d_ff
    tree = ({"w_gate": r.standard_normal((d, f)) / 8, "w_up": r.standard_normal((d, f)) / 8,
             "w_down": r.standard_normal((f, d)) / 11} if tcfg.mlp == "swiglu" else
            {"w_up": r.standard_normal((d, f)) / 8, "b_up": r.standard_normal(f),
             "w_down": r.standard_normal((f, d)) / 11, "b_down": r.standard_normal(d)})
    pj, pt = params_pair({k: np.asarray(v, np.float32) for k, v in tree.items()})
    xj, xt = bf16_pair(r.standard_normal((2, 5, d)))
    assert_close_bf16(tl.apply_mlp(pt, tcfg, xt), jl.apply_mlp(pj, jcfg, xj), rel=2e-2)


def test_embed_tokens_is_exact():
    jcfg, tcfg = cfg_pair("minicpm-2b")
    r = rng_of(11)
    emb = (r.standard_normal((tcfg.padded_vocab, tcfg.d_model)) * 0.02).astype(np.float32)
    toks = r.integers(0, tcfg.vocab, size=(2, 9)).astype(np.int32)
    got = tl.embed_tokens({"embed": torch.from_numpy(emb)}, tcfg, torch.from_numpy(toks))
    want = jl.embed_tokens({"embed": jnp.asarray(emb)}, jcfg, jnp.asarray(toks))
    np.testing.assert_array_equal(np32(got), np32(want))


@pytest.mark.parametrize("arch", ["minicpm-2b", "qwen3-14b"])
def test_lm_head_with_padded_vocab(arch):
    """Tied (minicpm, logit scale) and untied heads; vocab 250 pads to 256,
    and the pad columns are masked to -1e30 (times the logit scale)."""
    jcfg, tcfg = cfg_pair(arch, vocab=250)
    assert tcfg.padded_vocab == 256
    r = rng_of(12)
    tree = {"embed": (r.standard_normal((256, tcfg.d_model)) * 0.02)}
    if not tcfg.tie_embeddings:
        tree["head"] = r.standard_normal((tcfg.d_model, 256)) / 8
    pj, pt = params_pair({k: np.asarray(v, np.float32) for k, v in tree.items()})
    xj, xt = bf16_pair(r.standard_normal((2, 3, tcfg.d_model)))
    got, want = np32(tl.lm_head(pt, tcfg, xt)), np32(jl.lm_head(pj, jcfg, xj))
    assert_close_bf16(got[..., :250], want[..., :250])
    np.testing.assert_array_equal(got[..., 250:], want[..., 250:])
    assert (got[..., 250:] < -1e28).all()


def test_initializers_follow_the_jax_distributions():
    gen = torch.Generator().manual_seed(0)
    w = tl.dense_init(gen, 256, 512, scale=2.0)
    assert w.dtype == torch.float32 and w.shape == (256, 512)
    assert abs(w.std().item() - 2.0 / 16) < 0.01 and abs(w.mean().item()) < 0.01
    e = tl.embed_init(gen, 1000, 64)
    assert abs(e.std().item() - 0.02) < 0.002
    n = tl.init_norm("layernorm", 8, "cpu")
    assert torch.equal(n["scale"], torch.ones(8)) and torch.equal(n["bias"], torch.zeros(8))
    assert set(tl.init_norm("rmsnorm", 8, "cpu")) == {"scale"}
