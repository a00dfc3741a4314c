"""Paged-attention decode in the PyTorch port against the JAX package.

The same numpy inputs (from a seed) go through the JAX oracle
(``reference_paged_attention``), the JAX Pallas kernel in interpret mode
(as the JAX kernel tests run it on the CPU) and the port's plain version
and wrapper.  Tolerances are the JAX kernel tests' (``tests/test_kernels.py``):
fp32 2e-4 (summation order only), bf16 3e-2 (the output is rounded to bf16).
The CUDA kernel itself runs only on a card: its test skips here.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attention as jax_paged_attention
from repro.kernels.paged_attention import reference_paged_attention as jax_reference
from repro.kernels.paged_attention.kernel import paged_attention_kernel as jax_kernel
from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_kernel,
                                                 paged_attention_plain,
                                                 reference_paged_attention)

torch.set_num_threads(2)

ATOL = {"float32": 2e-4, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def paged_inputs(seed, B, Hkv, G, D, ps, mp, n_pages, fill=0.8, holes=0):
    """numpy fp32 pool + scrambled per-slot tables with ragged live lengths
    and optional unmapped holes (the layout of ``test_kernels.paged_inputs``)."""
    rng = np.random.default_rng(seed)
    arrs = dict(q=rng.standard_normal((B, 1, Hkv * G, D), np.float32),
                kp=rng.standard_normal((n_pages, ps, Hkv, D), np.float32),
                vp=rng.standard_normal((n_pages, ps, Hkv, D), np.float32),
                k_new=rng.standard_normal((B, 1, Hkv, D), np.float32),
                v_new=rng.standard_normal((B, 1, Hkv, D), np.float32))
    lengths = rng.integers(1, max(2, int(mp * ps * fill)), size=B).astype(np.int32)
    pt = np.full((B, mp), -1, np.int32)
    for b in range(B):
        need = -(-int(lengths[b]) // ps)
        pt[b, :need] = rng.choice(n_pages, size=need, replace=False)
        for _ in range(holes):
            pt[b, rng.integers(0, mp)] = -1
    return arrs, pt, lengths


def to_jax(arrs, dtype):
    return {k: jnp.asarray(v, JDT[dtype]) for k, v in arrs.items()}


def to_torch(arrs, dtype):
    return {k: torch.from_numpy(v).to(TDT[dtype]) for k, v in arrs.items()}


def close(a, b, dtype):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               atol=ATOL[dtype], rtol=ATOL[dtype])


APPEND_CASES = [
    (1, 1, 1, 8, 4, 4, 8, 0),      # MQA/MHA minimal
    (3, 2, 3, 16, 8, 6, 32, 1),    # GQA, scrambled pages + a hole per slot
    (2, 4, 2, 32, 16, 8, 64, 2),   # wider pool, more holes
]


@pytest.mark.parametrize("B,Hkv,G,D,ps,mp,n_pages,holes", APPEND_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 12])
def test_append_matches_jax_reference(B, Hkv, G, D, ps, mp, n_pages, holes, dtype,
                                      window):
    arrs, pt, lengths = paged_inputs(B * 7 + mp, B, Hkv, G, D, ps, mp, n_pages,
                                     holes=holes)
    j, t = to_jax(arrs, dtype), to_torch(arrs, dtype)
    want = jax_reference(j["q"], j["kp"], j["vp"], jnp.asarray(pt),
                         jnp.asarray(lengths), k_new=j["k_new"], v_new=j["v_new"],
                         window=window)
    kw = dict(k_new=t["k_new"], v_new=t["v_new"], window=window)
    pt_t, len_t = torch.from_numpy(pt), torch.from_numpy(lengths)
    ref = reference_paged_attention(t["q"], t["kp"], t["vp"], pt_t, len_t, **kw)
    got = paged_attention(t["q"], t["kp"], t["vp"], pt_t, len_t, **kw)
    assert got.dtype == TDT[dtype] and got.shape == t["q"].shape
    close(ref.float(), want, dtype)
    close(got.float(), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_post_update_matches_jax_reference(dtype):
    """No-append mode: the token is already in the pool, the query sits at
    the last live lane (the JAX post-update sweep's case)."""
    B, Hkv, G, D, ps, mp = 3, 2, 2, 16, 8, 5
    arrs, pt, lengths = paged_inputs(11, B, Hkv, G, D, ps, mp, 24, holes=1)
    j, t = to_jax(arrs, dtype), to_torch(arrs, dtype)
    want = jax_reference(j["q"], j["kp"], j["vp"], jnp.asarray(pt), jnp.asarray(lengths),
                         q_pos=jnp.asarray(lengths - 1), window=8)
    got = paged_attention(t["q"], t["kp"], t["vp"], torch.from_numpy(pt),
                          torch.from_numpy(lengths),
                          q_pos=torch.from_numpy(lengths - 1), window=8)
    close(got.float(), want, dtype)


def test_fully_unmapped_slot_attends_new_token_only():
    """A slot with no mapped page attends the new token alone (softmax over
    one logit), as in the JAX package — never NaN."""
    B, Hkv, G, D, ps, mp = 2, 1, 2, 8, 4, 3
    arrs, pt, _ = paged_inputs(5, B, Hkv, G, D, ps, mp, 8)
    pt[1] = -1
    lengths = np.asarray([6, 0], np.int32)
    t = to_torch(arrs, "float32")
    out = paged_attention(t["q"], t["kp"], t["vp"], torch.from_numpy(pt),
                          torch.from_numpy(lengths), k_new=t["k_new"], v_new=t["v_new"])
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(
        out[1, 0].reshape(Hkv, G, D).numpy(),
        np.broadcast_to(arrs["v_new"][1, 0][:, None, :], (Hkv, G, D)),
        atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype,window,post", [("float32", 12, False),
                                               ("bfloat16", None, True)])
def test_wrapper_matches_pallas_interpret(dtype, window, post):
    """The port's wrapper against the JAX wrapper running the Pallas kernel
    in interpret mode on the same inputs."""
    B, Hkv, G, D, ps, mp = 3, 2, 3, 16, 8, 6
    arrs, pt, lengths = paged_inputs(23, B, Hkv, G, D, ps, mp, 32, holes=1)
    j, t = to_jax(arrs, dtype), to_torch(arrs, dtype)
    q_pos = lengths - 1 if post else lengths
    new_j = {} if post else dict(k_new=j["k_new"], v_new=j["v_new"])
    new_t = {} if post else dict(k_new=t["k_new"], v_new=t["v_new"])
    want = jax_paged_attention(j["q"], j["kp"], j["vp"], jnp.asarray(pt),
                               jnp.asarray(lengths), q_pos=jnp.asarray(q_pos),
                               window=window, interpret=True, **new_j)
    got = paged_attention(t["q"], t["kp"], t["vp"], torch.from_numpy(pt),
                          torch.from_numpy(lengths), q_pos=torch.from_numpy(q_pos),
                          window=window, **new_t)
    close(got.float(), want, dtype)


@pytest.mark.parametrize("lane_base,pos_stride", [(0, None), (8, 16)])
def test_plain_contract_matches_pallas_kernel(lane_base, pos_stride):
    """The kernel contract — unnormalized fp32 (acc, m, l), empty rows as
    (0, -1e30, 0) — against the Pallas kernel in interpret mode, including
    the lane decomposition's ``lane_base``/``pos_stride`` placement."""
    B, Hkv, G, D, ps, mp = 3, 2, 2, 16, 8, 6
    arrs, pt, lengths = paged_inputs(31, B, Hkv, G, D, ps, mp, 24, holes=1)
    pt[2] = -1                                     # one row with no live lane
    qg = arrs["q"].reshape(B, Hkv, G, D)
    want = jax_kernel(jnp.asarray(qg), jnp.asarray(arrs["kp"]), jnp.asarray(arrs["vp"]),
                      jnp.asarray(pt), jnp.asarray(lengths), jnp.asarray(lengths),
                      lane_base=jnp.asarray([lane_base], jnp.int32),
                      pos_stride=pos_stride, window=20, interpret=True)
    got = paged_attention_kernel(torch.from_numpy(qg), torch.from_numpy(arrs["kp"]),
                                 torch.from_numpy(arrs["vp"]), torch.from_numpy(pt),
                                 torch.from_numpy(lengths), torch.from_numpy(lengths),
                                 lane_base=lane_base, pos_stride=pos_stride, window=20)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4, rtol=2e-4)
    acc, m, l = got
    assert (acc[2] == 0).all() and (m[2] == -1e30).all() and (l[2] == 0).all()


def test_plain_version_matches_model_gather_path():
    """Wrapper == the gather formulation of the port's decode path:
    ``cache_kv_view`` (logical-order page gather) + ``sdpa_append``."""
    from repro_torch.models import kvcache
    from repro_torch.models.layers import sdpa_append

    B, Hkv, G, D, ps, mp = 2, 2, 4, 16, 4, 6
    arrs, pt, lengths = paged_inputs(3, B, Hkv, G, D, ps, mp, 16, holes=1)
    t = to_torch(arrs, "float32")
    pt_t, len_t = torch.from_numpy(pt), torch.from_numpy(lengths)
    got = paged_attention(t["q"], t["kp"], t["vp"], pt_t, len_t,
                          k_new=t["k_new"], v_new=t["v_new"])
    lc = {"kp": t["kp"], "vp": t["vp"], "page_table": pt_t}
    ck, cv, kv_pos, kv_valid = kvcache.cache_kv_view(lc, upto=len_t)
    want = sdpa_append(t["q"], ck, cv, t["k_new"], t["v_new"],
                       q_positions=kvcache.decode_positions(len_t, B, 1),
                       kv_positions=kv_pos, kv_valid=kv_valid)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4, rtol=2e-4)


def test_cpu_tensors_take_plain_version_without_counting():
    arrs, pt, lengths = paged_inputs(1, 2, 1, 2, 8, 4, 3, 8)
    qg = torch.from_numpy(arrs["q"].reshape(2, 1, 2, 8))
    before = paged_attention_kernel.launches
    args = (torch.from_numpy(arrs["kp"]), torch.from_numpy(arrs["vp"]),
            torch.from_numpy(pt), torch.from_numpy(lengths), torch.from_numpy(lengths))
    got = paged_attention_kernel(qg, *args)
    want = paged_attention_plain(qg, *args)
    assert paged_attention_kernel.launches == before
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="cpu or cuda"):
        paged_attention_kernel(qg.to("meta"), *args)


def test_build_names_library_by_source_hash_and_needs_nvcc(monkeypatch, tmp_path):
    assert "paged_attention" in build.sources()
    lib = build.library_path("paged_attention")
    assert lib.parent == build.BUILD_DIR and lib.suffix == ".so"
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["paged_attention"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(dtype):
    """Kernel vs plain version on the card, in the working type."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for seed, (B, Hkv, G, D, ps, mp, n_pages, holes) in enumerate(APPEND_CASES):
        arrs, pt, lengths = paged_inputs(seed, B, Hkv, G, D, ps, mp, n_pages, holes=holes)
        t = {k: v.cuda() for k, v in to_torch(arrs, dtype).items()}
        qg = t["q"].reshape(B, Hkv, G, D).contiguous()
        pt_t, len_t = torch.from_numpy(pt).cuda(), torch.from_numpy(lengths).cuda()
        n0 = paged_attention_kernel.launches
        acc, m, l = paged_attention_kernel(qg, t["kp"], t["vp"], pt_t, len_t, len_t,
                                           window=12)
        racc, rm, rl = paged_attention_plain(qg, t["kp"], t["vp"], pt_t, len_t, len_t,
                                             window=12)
        torch.cuda.synchronize()
        assert paged_attention_kernel.launches == n0 + 1
        close((acc / l.clamp(min=1e-30)[..., None]).cpu(),
              (racc / rl.clamp(min=1e-30)[..., None]).cpu(), dtype)
        close(m.cpu(), rm.cpu(), dtype)
