"""Paged-attention decode in the PyTorch port against the JAX package.

The same numpy inputs (from a seed) go through the JAX oracle
(``reference_paged_attention``), the JAX Pallas kernel in interpret mode
(as the JAX kernel tests run it on the CPU) and the port's plain version
and wrapper.  Tolerances are the JAX kernel tests' (``tests/test_kernels.py``):
fp32 2e-4 (summation order only), bf16 3e-2 (the output is rounded to bf16).

The kernel splits each slot's live pages when few (slot, kv head) rows
would leave the card idle, and merges the splits' states in the same
launch.  Its plan (``plan.py``: the split count, the window's first page,
the live page range, each split's share) is held against brute force here,
and the plain split-and-merge version against the unsplit plain version and
the JAX oracle.  The CUDA kernel itself runs only on a card: its tests skip
here, and on the card (which has no JAX) they run alone with ``pytest -m gpu``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import (merge_partials, paged_attention,
                                                 paged_attention_kernel,
                                                 paged_attention_plain,
                                                 paged_attention_split_plain,
                                                 reference_paged_attention)
from repro_torch.kernels.paged_attention import plan

try:    # the card's machine has no JAX: there only the gpu-marked tests run
    import jax.numpy as jnp

    from repro.kernels.paged_attention import paged_attention as jax_paged_attention
    from repro.kernels.paged_attention import reference_paged_attention as jax_reference
    from repro.kernels.paged_attention.kernel import paged_attention_kernel as jax_kernel
except ModuleNotFoundError:
    jnp = None

torch.set_num_threads(2)

ATOL = {"float32": 2e-4, "bfloat16": 3e-2}
JDT = {"float32": "float32", "bfloat16": "bfloat16"}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def paged_inputs(seed, B, Hkv, G, D, ps, mp, n_pages, fill=0.8, holes=0, min_len=1):
    """numpy fp32 pool + scrambled per-slot tables with ragged live lengths
    and optional unmapped holes (the layout of ``test_kernels.paged_inputs``)."""
    rng = np.random.default_rng(seed)
    arrs = dict(q=rng.standard_normal((B, 1, Hkv * G, D), np.float32),
                kp=rng.standard_normal((n_pages, ps, Hkv, D), np.float32),
                vp=rng.standard_normal((n_pages, ps, Hkv, D), np.float32),
                k_new=rng.standard_normal((B, 1, Hkv, D), np.float32),
                v_new=rng.standard_normal((B, 1, Hkv, D), np.float32))
    lengths = rng.integers(min_len, max(min_len + 1, int(mp * ps * fill)),
                           size=B).astype(np.int32)
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


PLACEMENTS = [  # (page_size, pos_stride, lane_base): defaults and lane decompositions
    (4, 4, 0), (8, 8, 0), (16, 16, 0), (4, 8, 0), (4, 8, 4), (8, 32, 16), (3, 5, 2),
]


@pytest.mark.parametrize("ps,stride,lane_base", PLACEMENTS)
def test_live_pages_match_brute_force(ps, stride, lane_base):
    """Every live lane lies on a page of ``live_pages``'s range, and at the
    decode query positions (``q_pos`` = length or length - 1) the range is
    exactly the pages that hold a live lane; ``window_first_page`` is the
    first page with a lane inside the window."""
    mp = 12
    pos = np.arange(mp)[:, None] * stride + lane_base + np.arange(ps)[None]   # (page, lane)
    for length in range(0, mp * stride + lane_base + 2):
        for q_pos in {length, max(length - 1, 0), length + 7}:
            for window in (None, 1, 2, 5, 17, 40):
                live = pos < length
                if window is not None:
                    live &= pos > q_pos - window
                    first = np.flatnonzero((pos > q_pos - window).any(axis=1))
                    got = plan.window_first_page(q_pos, window, lane_base, stride, ps)
                    assert got == first[0] if len(first) else got >= mp
                pages = np.flatnonzero(live.any(axis=1))
                lo, hi = plan.live_pages(length, q_pos, window, lane_base, stride, ps, mp)
                assert 0 <= lo <= hi <= mp
                assert all(lo <= j < hi for j in pages)
                if len(pages) and q_pos <= length and stride >= ps:
                    assert (lo, hi) == (pages[0], pages[-1] + 1)


@pytest.mark.parametrize("n_split", [1, 2, 3, 7, 33, 64])
def test_split_pages_partition_the_live_range(n_split):
    """The splits' shares are ordered, disjoint, of near-equal size and
    cover ``[lo, hi)``; a range shorter than the split count leaves the
    last splits empty."""
    for lo in range(0, 9):
        for hi in range(lo, lo + 150, 7):
            runs = [plan.split_pages(lo, hi, n_split, s) for s in range(n_split)]
            assert runs[0][0] == lo and runs[-1][1] == hi
            for (a0, a1), (b0, b1) in zip(runs, runs[1:]):
                assert a0 <= a1 == b0 <= b1
            sizes = [b - a for a, b in runs]
            assert max(sizes) == -(-(hi - lo) // n_split)
            if hi - lo < n_split:
                assert sizes[-1] == 0


def test_split_count_from_shapes():
    """One split once B x Hkv rows fill the SMs (minicpm-2b: 8 x 36 = 288);
    recurrentgemma-2b's decode (8 slots x 1 kv head, 145 pages) gets ~2
    blocks per SM; splits keep >= 4 pages each and stay <= 64."""
    assert plan.split_count(8, 36, 34) == 1
    assert plan.split_count(132, 1, 1000) == 1
    assert plan.split_count(8, 1, 145) == 33
    assert plan.split_count(1, 1, 145) == 37
    assert plan.split_count(1, 1, 10_000) == plan.MAX_SPLITS
    assert plan.split_count(2, 1, 3) == 1
    for B in range(1, 140, 3):
        for mp in (1, 4, 5, 50, 500):
            n = plan.split_count(B, 1, mp)
            assert 1 <= n <= plan.MAX_SPLITS
            assert n == 1 or (B < plan.H100_SMS and (mp - 1) // (n - 1) >= 4)


SPLIT_CASES = [  # (B, Hkv, G, D, ps, mp, n_pages, holes, window, lane_base, stride, post)
    (3, 2, 3, 16, 8, 12, 48, 1, None, 0, None, False),
    (2, 1, 5, 8, 4, 30, 70, 2, 20, 0, None, True),
    (3, 1, 10, 16, 8, 20, 70, 0, 40, 0, None, False),
    (2, 2, 2, 8, 8, 10, 24, 1, 30, 8, 16, True),
]


@pytest.mark.parametrize("case", SPLIT_CASES)
@pytest.mark.parametrize("n_split", [1, 3, 8, 50])
def test_split_merge_matches_unsplit_and_jax(case, n_split):
    """The plain version run over each split's pages and merged equals the
    unsplit plain version (fp32 summation order: 2e-4), with empty splits
    (more splits than live pages, pages before the window) and a row with
    no live lane, which stays ``(0, -1e30, 0)``; normalized, it equals the
    JAX oracle (default placement) or the Pallas kernel in interpret mode
    (``lane_base``/``pos_stride``)."""
    B, Hkv, G, D, ps, mp, n_pages, holes, window, lane_base, stride, post = case
    arrs, pt, lengths = paged_inputs(40 + n_split, B, Hkv, G, D, ps, mp, n_pages,
                                     holes=holes, fill=1.0)
    pt[-1] = -1                                          # a row with no live lane
    q_pos = lengths - 1 if post else lengths
    qg = torch.from_numpy(arrs["q"].reshape(B, Hkv, G, D))
    args = (qg, torch.from_numpy(arrs["kp"]), torch.from_numpy(arrs["vp"]),
            torch.from_numpy(pt), torch.from_numpy(lengths), torch.from_numpy(q_pos))
    kw = dict(lane_base=lane_base, pos_stride=stride, window=window)
    got = paged_attention_split_plain(*args, n_split=n_split, **kw)
    want = paged_attention_plain(*args, **kw)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-4, rtol=2e-4)
    acc, m, l = got
    assert (acc[-1] == 0).all() and (m[-1] == -1e30).all() and (l[-1] == 0).all()
    out = (acc / l.clamp(min=1e-30)[..., None]).numpy()
    if lane_base == 0 and stride is None:
        ref = np.asarray(jax_reference(jnp.asarray(arrs["q"]), jnp.asarray(arrs["kp"]),
                                       jnp.asarray(arrs["vp"]), jnp.asarray(pt),
                                       jnp.asarray(lengths), q_pos=jnp.asarray(q_pos),
                                       window=window), np.float32).reshape(B, Hkv, G, D)
    else:
        jacc, _, jl = jax_kernel(jnp.asarray(qg.numpy()), jnp.asarray(arrs["kp"]),
                                 jnp.asarray(arrs["vp"]), jnp.asarray(pt),
                                 jnp.asarray(lengths), jnp.asarray(q_pos),
                                 lane_base=jnp.asarray([lane_base], jnp.int32),
                                 pos_stride=stride, window=window, interpret=True)
        ref = np.asarray(jacc) / np.maximum(np.asarray(jl), 1e-30)[..., None]
    np.testing.assert_allclose(out[:-1], ref[:-1], atol=2e-4, rtol=2e-4)


def test_merge_of_empty_states_is_empty():
    """Merging only ``(0, -1e30, 0)`` states gives ``(0, -1e30, 0)``; an
    empty state beside a live one changes nothing."""
    empty = (torch.zeros(2, 3, 4), torch.full((2, 3), -1e30), torch.zeros(2, 3))
    acc, m, l = merge_partials([empty, empty, empty])
    assert (acc == 0).all() and (m == -1e30).all() and (l == 0).all()
    live = (torch.randn(2, 3, 4), torch.randn(2, 3), torch.rand(2, 3) + 0.5)
    for g, w in zip(merge_partials([empty, live, empty]), live, strict=True):
        assert torch.equal(g, w)


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


GPU_SPLIT_CASES = [  # (B, ps, mp, n_pages, holes, window, lane_base, stride, post, min_len)
    (1, 16, 145, 150, 0, 2048, 0, None, True, 2100),    # past the window, ~37 splits
    (8, 16, 145, 1200, 3, 2048, 0, None, True, 2100),   # the hybrid's decode, 33 splits
    (8, 16, 145, 1200, 0, 2048, 0, None, False, 2100),  # append mode
    (3, 16, 40, 130, 0, 100, 0, None, False, 1),        # a 3-token slot, an unmapped slot
    (2, 8, 60, 130, 2, 200, 8, 16, True, 1),            # lane_base / pos_stride
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_splits_match_plain_version(dtype):
    """recurrentgemma-2b's head shape (Hkv 1, G 10, D 256) at few slots, so
    the kernel splits each slot's pages and merges in the launch: long
    contexts past the window, scrambled tables with holes, splits with no
    live lane and a row with none, lane_base / pos_stride off the default."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for seed, (B, ps, mp, n_pages, holes, window, lane_base, stride, post,
               min_len) in enumerate(GPU_SPLIT_CASES):
        arrs, pt, lengths = paged_inputs(seed, B, 1, 10, 256, ps, mp, n_pages, holes=holes,
                                         fill=1.0, min_len=min_len)
        if seed == 3:
            lengths[0], pt[1] = 3, -1
        q_pos = lengths - 1 if post else lengths
        t = {k: v.cuda() for k, v in to_torch(arrs, dtype).items()}
        qg = t["q"].reshape(B, 1, 10, 256).contiguous()
        pt_t, len_t = torch.from_numpy(pt).cuda(), torch.from_numpy(lengths).cuda()
        qp_t = torch.from_numpy(q_pos).cuda()
        kw = dict(lane_base=lane_base, pos_stride=stride, window=window)
        acc, m, l = paged_attention_kernel(qg, t["kp"], t["vp"], pt_t, len_t, qp_t, **kw)
        racc, rm, rl = paged_attention_plain(qg, t["kp"], t["vp"], pt_t, len_t, qp_t, **kw)
        torch.cuda.synchronize()
        close((acc / l.clamp(min=1e-30)[..., None]).cpu(),
              (racc / rl.clamp(min=1e-30)[..., None]).cpu(), dtype)
        close(m.cpu(), rm.cpu(), dtype)
        close((l / rl.clamp(min=1.0)).cpu(), (rl / rl.clamp(min=1.0)).cpu(), dtype)


@pytest.mark.gpu
def test_cuda_split_launches_on_two_streams_keep_their_own_scratch():
    """Split launches of one shape on two streams at once each merge through
    their own partials and tickets, and both agree with the plain version;
    the wrapper reports the split count it launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.paged_attention import kernel as paged_kernel

    B, ps, mp, n_pages = 8, 16, 145, 1200
    runs = []
    for seed in (0, 1):
        arrs, pt, lengths = paged_inputs(seed, B, 1, 10, 256, ps, mp, n_pages, fill=1.0,
                                         min_len=2100)
        t = {k: v.cuda() for k, v in to_torch(arrs, "float32").items()}
        qg = t["q"].reshape(B, 1, 10, 256).contiguous()
        pt_t, len_t = torch.from_numpy(pt).cuda(), torch.from_numpy(lengths).cuda()
        runs.append((qg, t["kp"], t["vp"], pt_t, len_t, len_t - 1))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = []
    for _ in range(20):
        for s, args in zip(streams, runs):
            with torch.cuda.stream(s):
                outs.append(paged_attention_kernel(*args, window=2048))
    torch.cuda.synchronize()
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_split = paged_attention_kernel.last_splits
    assert n_split == plan.split_count(B, 1, mp, n_sms) > 1
    used = {k[1] for k in paged_kernel._scratch if k[2:] == (B, 1, 10, 256, n_split)}
    assert used >= {s.cuda_stream for s in streams}
    for i, (acc, m, l) in enumerate(outs):
        racc, rm, rl = paged_attention_plain(*runs[i % 2], window=2048)
        close((acc / l.clamp(min=1e-30)[..., None]).cpu(),
              (racc / rl.clamp(min=1e-30)[..., None]).cpu(), "float32")
        close(m.cpu(), rm.cpu(), "float32")
