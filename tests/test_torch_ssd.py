"""The SSD chunked scan in the PyTorch port against the JAX package.

The same numpy inputs (from a seed) go through the JAX oracle
(``reference_ssd``, the token-by-token recurrence), the JAX Pallas kernel in
interpret mode (as the JAX kernel tests run it on the CPU), the JAX model's
``ssd_chunked`` and ``ssd_decode_step``, and the port's plain version and
wrapper.  Tolerances:

* the sweep of ``tests/test_kernels.py::test_ssd_scan_sweep``, fp32 and
  bf16: ``ATOL[dtype] * 5`` (the JAX sweep's own);
* against ``ssd_chunked`` (with and without ``h0``, the final state
  included) and ``ssd_decode_step``: 1e-5, absolute and relative; the port
  follows the same fp32 chunked algorithm and differs only in the order
  torch and XLA sum the einsums;
* against the Pallas kernel on the JAX kernel-vs-model case: 1e-4 (that
  test's tolerance).

The port's own contract: a sequence split anywhere into calls that carry
the final state as the next ``h0`` equals the whole sequence, to 1e-5.

The kernel's limits (``ref.bf16_rounding_bound`` for bf16,
``ref.fp32_rounding_bound`` for fp32 where |A dt| is large): the plain
version's own ``y`` lies within each of the float64 oracle, and on the row
of the token whose input moves that row the most the limit is smaller than
that move.  The CUDA kernel and the route rule (the built library's) run
only on a card: their tests skip here.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

try:    # the card's machine has no JAX: there only the gpu-marked tests run
    import jax.numpy as jnp

    from repro.kernels.ssd_scan import reference_ssd
    from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
    from repro.models.mamba2 import ssd_chunked, ssd_decode_step
except ModuleNotFoundError:
    jnp = None
from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_kernel, ssd_scan_plain
from repro_torch.kernels.ssd_scan.kernel import ROUTES, route
from repro_torch.kernels.ssd_scan.ref import (KERNEL_CHUNK, bf16_rounding_bound,
                                              dropped_token_effect, fp32_rounding_bound)

torch.set_num_threads(2)

ATOL = {"float32": 2e-4, "bfloat16": 3e-2}
JDT = {"float32": "float32", "bfloat16": "bfloat16"}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
EXACT = 1e-5

# the sweep of tests/test_kernels.py::test_ssd_scan_sweep: (B, L, H, P, N, chunk, bh)
SWEEP = [(1, 16, 2, 4, 8, 8, 2), (2, 37, 6, 8, 16, 8, 2), (1, 64, 4, 16, 32, 16, 4)]


def ssd_inputs(seed, B, L, H, P, N, *, h0=False, big_decay=False):
    """x normal, dt = softplus(normal), A = -exp(0.3 normal), B and C
    0.5 normal (the JAX sweep's distributions); ``big_decay``: A from -1 to
    -16 (mamba2's init range) and dt up to ~10, so dt * A reaches -160 in
    one step; every fifth token has dt = 0."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    if big_decay:
        dt = dt * 4
        dt[:, ::5] = 0.0
        A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    Bm = (rng.standard_normal((B, L, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, L, N)) * 0.5).astype(np.float32)
    out = [x, dt, A, Bm, Cm]
    if h0:
        out.append(rng.standard_normal((B, H, P, N)).astype(np.float32))
    return out


def to_torch(*arrays, dtype=torch.float32):
    """x, B and C in ``dtype``; dt, A and h0 stay fp32."""
    out = [torch.from_numpy(a) for a in arrays]
    for i in (0, 3, 4):
        out[i] = out[i].to(dtype)
    return out


@pytest.mark.parametrize("B,L,H,P,N,chunk,bh", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_and_wrapper_match_jax_sweep(B, L, H, P, N, chunk, bh, dtype):
    x, dt, A, Bm, Cm = ssd_inputs(B * 100 + L, B, L, H, P, N)
    jx, jdt, jB, jC = (jnp.asarray(a, JDT[dtype]) for a in (x, dt, Bm, Cm))
    jA = jnp.asarray(A)
    oracle = np.asarray(reference_ssd(*(a.astype(jnp.float32) for a in (jx, jdt)), jA,
                                      jB.astype(jnp.float32), jC.astype(jnp.float32)))
    pallas = np.asarray(jax_ssd_scan(jx, jdt, jA, jB, jC, chunk=chunk, bh=bh,
                                     interpret=True), np.float32)
    # the port's dt is fp32: hand it the JAX sweep's dt as rounded to dtype
    tx, tdt, tA, tB, tC = to_torch(x, np.array(jdt, np.float32), A, Bm, Cm,
                                   dtype=TDT[dtype])
    y, h = ssd_scan_plain(tx, tdt, tA, tB, tC, chunk=chunk)
    yw, hw = ssd_scan(tx, tdt, tA, tB, tC, chunk=chunk)
    assert y.dtype == TDT[dtype] and y.shape == (B, L, H, P)
    assert h.dtype == torch.float32 and h.shape == (B, H, P, N)
    assert torch.equal(y, yw) and torch.equal(h, hw)
    tol = ATOL[dtype] * 5
    for want in (oracle, pallas):
        np.testing.assert_allclose(y.float().numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("L,chunk", [(24, 8), (37, 8), (5, 16)])
def test_plain_matches_ssd_chunked_with_final_state(with_h0, L, chunk):
    arrays = ssd_inputs(L + 7 * with_h0, 2, L, 4, 8, 16, h0=with_h0)
    jy, jh = ssd_chunked(*(jnp.asarray(a) for a in arrays[:5]), chunk,
                         h0=jnp.asarray(arrays[5]) if with_h0 else None)
    y, h = ssd_scan_plain(*to_torch(*arrays), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=EXACT, rtol=EXACT)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=EXACT, rtol=EXACT)


@pytest.mark.parametrize("big_decay", [False, True])
def test_one_token_with_h0_is_ssd_decode_step(big_decay):
    x, dt, A, Bm, Cm, h0 = ssd_inputs(3, 3, 1, 6, 8, 16, h0=True, big_decay=big_decay)
    jy, jh = ssd_decode_step(jnp.asarray(h0), jnp.asarray(x[:, 0]), jnp.asarray(dt[:, 0]),
                             jnp.asarray(A), jnp.asarray(Bm[:, 0]), jnp.asarray(Cm[:, 0]))
    y, h = ssd_scan(*to_torch(x, dt, A, Bm, Cm, h0))
    np.testing.assert_allclose(y[:, 0].numpy(), np.asarray(jy), atol=EXACT, rtol=EXACT)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=EXACT, rtol=EXACT)


def test_jax_pallas_kernel_equals_port_plain():
    """The JAX kernel-vs-model case (``test_ssd_kernel_matches_model_chunked``):
    the Pallas kernel in interpret mode against the port's plain version."""
    x, dt, A, Bm, Cm = ssd_inputs(11, 2, 24, 4, 8, 16)
    want = np.asarray(jax_ssd_scan(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk=8,
                                   bh=2, interpret=True))
    y, _ = ssd_scan_plain(*to_torch(x, dt, A, Bm, Cm), chunk=8)
    np.testing.assert_allclose(y.numpy(), want, atol=1e-4, rtol=1e-4)


def test_large_decay_and_zero_steps_stay_finite():
    """dt * A down to -160 in one step and dt = 0 rows: no overflow (the
    mask stays inside the exponential), and the oracle agrees."""
    x, dt, A, Bm, Cm = ssd_inputs(4, 1, 40, 6, 4, 8, big_decay=True)
    y, h = ssd_scan_plain(*to_torch(x, dt, A, Bm, Cm), chunk=16)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    want = np.asarray(reference_ssd(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm))))
    np.testing.assert_allclose(y.numpy(), want, atol=1e-4, rtol=1e-4)


def test_plain_in_float64_is_an_oracle_at_large_decay():
    """Float64 inputs run the same arithmetic in float64 (what
    ``chip_smoke.py`` holds the kernel against at |A dt| ~ 100): it matches
    a float64 token-by-token recurrence to 1e-9 where fp32 is off by more."""
    x, dt, A, Bm, Cm, h0 = (a.astype(np.float64) for a in
                            ssd_inputs(12, 1, 70, 4, 4, 8, h0=True, big_decay=True))
    h, ys = h0.copy(), []
    for t in range(x.shape[1]):
        h = (h * np.exp(dt[:, t] * A)[:, :, None, None]
             + np.einsum("bh,bn,bhp->bhpn", dt[:, t], Bm[:, t], x[:, t]))
        ys.append(np.einsum("bn,bhpn->bhp", Cm[:, t], h))
    want = np.stack(ys, 1)
    y64, h64 = ssd_scan_plain(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, h0)), chunk=64)
    assert y64.dtype == h64.dtype == torch.float64
    np.testing.assert_allclose(y64.numpy(), want, atol=1e-9, rtol=1e-9)
    np.testing.assert_allclose(h64.numpy(), h, atol=1e-9, rtol=1e-9)
    y32, _ = ssd_scan_plain(*to_torch(*(a.astype(np.float32) for a in (x, dt, A, Bm, Cm, h0))),
                            chunk=64)
    assert np.abs(y32.numpy() - want).max() > 1e-6


@pytest.mark.parametrize("cuts", [(1,), (5, 6), (16,), (3, 11, 20, 21)])
def test_state_carried_across_calls_equals_whole_sequence(cuts):
    """What chunked prefill and decode rely on: calls that hand their final
    state on as the next ``h0`` give the whole sequence's y and state."""
    x, dt, A, Bm, Cm, h0 = (torch.from_numpy(a) for a in
                            ssd_inputs(sum(cuts), 2, 24, 3, 4, 8, h0=True))
    whole_y, whole_h = ssd_scan(x, dt, A, Bm, Cm, h0, chunk=8)
    ys, h, lo = [], h0, 0
    for hi in cuts + (24,):
        y, h = ssd_scan(x[:, lo:hi], dt[:, lo:hi], A, Bm[:, lo:hi], Cm[:, lo:hi], h, chunk=8)
        ys.append(y)
        lo = hi
    torch.testing.assert_close(torch.cat(ys, 1), whole_y, atol=EXACT, rtol=EXACT)
    torch.testing.assert_close(h, whole_h, atol=EXACT, rtol=EXACT)


def test_cpu_tensors_take_plain_version_without_counting():
    x, dt, A, Bm, Cm, h0 = to_torch(*ssd_inputs(9, 2, 5, 3, 4, 8, h0=True))
    before = ssd_scan_kernel.launches
    got = ssd_scan_kernel(x, dt, A, Bm, Cm, h0)
    want = ssd_scan_plain(x, dt, A, Bm, Cm, h0)
    assert ssd_scan_kernel.launches == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    y, h = ssd_scan_kernel(x[:, :0], dt[:, :0], A, Bm[:, :0], Cm[:, :0], h0)
    assert y.shape == (2, 0, 3, 4) and torch.equal(h, h0)
    assert ssd_scan_kernel.launches == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        ssd_scan_kernel(*(t.to("meta") for t in (x, dt, A, Bm, Cm)))


def test_build_knows_the_ssd_source():
    assert {"paged_attention", "rglru_scan", "ssd_scan"} <= set(build.sources())
    lib = build.library_path("ssd_scan")
    assert lib.parent == build.BUILD_DIR and lib.name.startswith("ssd_scan.")
    src = (build.CSRC / "ssd_scan.cu").read_text()
    assert "extern \"C\"" in src and "ssd_scan_launch" in src and "ssd_scan_route" in src
    # the four contractions live in the kernel, not in a library call: on
    # the CUDA cores through tile_product, on the tensor cores through mma.sync
    assert "cublas" not in src.lower() and src.count("tile_product(") >= 4
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,P,N,want", [
    (torch.bfloat16, 64, 128, "tensor_core"),      # mamba2-1.3b
    (torch.bfloat16, 16, 64, "tensor_core"), (torch.bfloat16, 48, 256, "tensor_core"),
    (torch.float32, 64, 128, "cuda_core"),         # fp32 stays on the CUDA cores
    (torch.bfloat16, 4, 8, "cuda_core"), (torch.bfloat16, 64, 96, "cuda_core"),
    (torch.bfloat16, 24, 128, "cuda_core")])
def test_route_is_chosen_from_dtype_and_dims(dtype, P, N, want):
    """The rule lives once, in the library (``ssd_scan_route``), so this
    needs the card's build."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the route rule is the built library's")
    assert route(dtype, P, N) == want and want in ROUTES


def test_entry_point_copies_views_off_16_byte_boundary():
    """The tensor-core route copies x, B, C and h0 by 16 bytes: the entry
    point hands it a copy of any view that starts elsewhere, same values."""
    x, dt, A, Bm, Cm, h0 = to_torch(*ssd_inputs(5, 1, 6, 2, 16, 64, h0=True),
                                    dtype=torch.bfloat16)
    wide = torch.cat([torch.zeros(1, 6, 2, 16, dtype=x.dtype), x], dim=-1)[..., 16:]
    view = torch.cat([torch.zeros(1, 6, 1, dtype=Bm.dtype), Bm], dim=-1)[..., 1:]
    assert view.data_ptr() % 16 and not view.is_contiguous()
    got = ssd_scan(wide, dt, A, view, Cm, h0)
    want = ssd_scan(x, dt, A, Bm, Cm, h0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


BOUND_CASES = [  # (B, L, H, P, N, h0, big_decay)
    (1, 1, 6, 4, 8, True, False), (2, 37, 6, 16, 64, True, False),
    (2, 37, 4, 16, 64, True, True), (1, 160, 3, 16, 64, False, False),
    (1, 300, 2, 16, 32, True, False)]


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("B,L,H,P,N,with_h0,big_decay", BOUND_CASES)
def test_bf16_rounding_bound_holds_and_sees_one_token(B, L, H, P, N, with_h0, big_decay,
                                                      split):
    """bf16 ``y`` of the plain version (fp32 math, one rounding) lies within
    ``bf16_rounding_bound`` of the float64 oracle, and the fp32 state within
    its state bound, with the hi + lo split terms (the tensor-core chunk
    kernel) and without (the decode kernel, the CUDA-core route); the limit
    on the row of the token whose input moves that row the most is smaller
    than that move."""
    arrays = ssd_inputs(L * 10 + H, B, L, H, P, N, h0=with_h0, big_decay=big_decay)
    args = to_torch(*arrays, dtype=torch.bfloat16)
    want_y, bound_y, want_h, bound_h = bf16_rounding_bound(
        *args, kernel_chunk=KERNEL_CHUNK if split else None)
    y, h = ssd_scan_plain(*args)
    assert torch.equal(y.float(), want_y.to(torch.bfloat16).float())
    y64, h64 = ssd_scan_plain(*(None if a is None else a.double() for a in args))
    assert ((y.double() - y64).abs() <= bound_y.double()).all()
    assert ((want_h.double() - h64).abs() <= bound_h.double()).all()
    assert torch.equal(h, want_h)
    t, effect = dropped_token_effect(*args)
    assert bound_y[:, t].max().item() < effect


@pytest.mark.parametrize("B,L,H,P,N,with_h0,big_decay", BOUND_CASES)
def test_fp32_rounding_bound_holds_and_sees_one_token(B, L, H, P, N, with_h0, big_decay):
    """fp32 ``y`` of the plain version on the CUDA-core route's chunks (64
    tokens) lies within ``fp32_rounding_bound`` of the float64 oracle, and
    the limit on the row of the token whose input moves that row the most
    is smaller than that move."""
    args = to_torch(*ssd_inputs(L * 10 + H + 1, B, L, H, P, N, h0=with_h0,
                                big_decay=big_decay))
    want_y, bound_y = fp32_rounding_bound(*args)
    y64, _ = ssd_scan_plain(*(None if a is None else a.double() for a in args))
    assert torch.equal(want_y, y64)
    y, _ = ssd_scan_plain(*args, chunk=KERNEL_CHUNK)
    assert ((y.double() - y64).abs() <= bound_y).all()
    t, effect = dropped_token_effect(*args)
    assert bound_y[:, t].max().item() < effect


def test_dropped_token_is_the_one_that_moves_its_row_most():
    """The witness token is the one whose own term, dt_t (C_t . B_t) x_t,
    is largest, and leaving its input out moves its row by that term."""
    x, dt, A, Bm, Cm, h0 = to_torch(*ssd_inputs(9, 2, 40, 3, 8, 16, h0=True))
    own = (dt * (Cm * Bm).sum(-1)[..., None])[..., None] * x
    t, effect = dropped_token_effect(x, dt, A, Bm, Cm, h0)
    per_token = own.abs().amax(dim=(0, 2, 3))
    assert t == int(per_token.argmax())
    np.testing.assert_allclose(effect, per_token[t].item(), rtol=1e-4)


GPU_CASES = [  # (B, L, H, P, N, h0, kind)
    (1, 1, 2, 4, 8, True, "plain"), (2, 37, 6, 8, 16, True, "plain"),
    (8, 1, 64, 64, 128, True, "plain"), (1, 252, 64, 64, 128, True, "plain"),
    (1, 256, 64, 64, 128, False, "plain"), (1, 256, 64, 64, 128, True, "big_decay"),
    (2, 37, 6, 16, 64, True, "plain"), (1, 130, 3, 48, 256, False, "plain"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(dtype):
    """Kernel vs plain version on the card, per element.  fp32: ``y`` and
    the state within 1e-4 (absolute and relative, the JAX kernel-vs-model
    tolerance); in the big-decay case (|A dt| ~ 100, where the plain
    version's own fp32 cumsums miss float64 by more than that) ``y`` within
    ``fp32_rounding_bound`` of the plain version in float64 instead.  bf16:
    ``y`` and state within ``bf16_rounding_bound``, with the split terms on
    the tensor-core chunk kernel only (the P = 8, N = 16 case takes the
    CUDA cores, the rest the tensor cores)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for seed, (B, L, H, P, N, with_h0, kind) in enumerate(GPU_CASES):
        arrays = ssd_inputs(seed, B, L, H, P, N, h0=with_h0, big_decay=kind == "big_decay")
        args = [t.cuda() for t in to_torch(*arrays, dtype=TDT[dtype])]
        path = route(TDT[dtype], P, N)
        n0 = dict(ssd_scan_kernel.launches_by_route)
        y, h = ssd_scan_kernel(*args)
        torch.cuda.synchronize()
        assert ssd_scan_kernel.launches_by_route[path] == n0[path] + 1
        if dtype == "float32":
            yr, hr = ssd_scan_plain(*args)
            torch.testing.assert_close(h, hr, atol=1e-4, rtol=1e-4)
            if kind != "big_decay":
                torch.testing.assert_close(y, yr, atol=1e-4, rtol=1e-4)
                continue
            y64, bound = fp32_rounding_bound(*args)
            assert ((y.double() - y64).abs() <= bound).all(), (B, L, H, P, N, kind)
        else:
            split = path == "tensor_core" and L > 1
            want_y, bound_y, want_h, bound_h = bf16_rounding_bound(
                *args, kernel_chunk=KERNEL_CHUNK if split else None)
            assert ((y.float() - want_y).abs() <= bound_y).all(), (B, L, H, P, N, kind)
            assert ((h - want_h).abs() <= bound_h).all(), (B, L, H, P, N, kind)


@pytest.mark.gpu
def test_cuda_serving_shapes_take_the_tensor_core_route():
    """mamba2-1.3b's prefill chunk and decode step, bf16: one tensor-core
    launch each, within the bound, and a chunk split into two calls that
    carry the state agrees with the whole chunk within the bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for B, L in ((1, 256), (8, 1), (1, 300)):
        arrays = ssd_inputs(B + L, B, L, 64, 64, 128, h0=True)
        args = [t.cuda() for t in to_torch(*arrays, dtype=torch.bfloat16)]
        n0 = ssd_scan_kernel.launches_by_route["tensor_core"]
        y, h = ssd_scan(*args)
        torch.cuda.synchronize()
        assert ssd_scan_kernel.launches_by_route["tensor_core"] == n0 + 1
        want_y, bound_y, want_h, bound_h = bf16_rounding_bound(
            *args, kernel_chunk=KERNEL_CHUNK if L > 1 else None)
        assert ((y.float() - want_y).abs() <= bound_y).all(), (B, L)
        assert ((h - want_h).abs() <= bound_h).all(), (B, L)
        if L > 1:
            x, dt, A, Bm, Cm, h0 = args
            cut = L // 3
            y1, h1 = ssd_scan(x[:, :cut], dt[:, :cut], A, Bm[:, :cut], Cm[:, :cut], h0)
            y2, h2 = ssd_scan(x[:, cut:], dt[:, cut:], A, Bm[:, cut:], Cm[:, cut:], h1)
            y12 = torch.cat([y1, y2], 1).float()
            assert ((y12 - want_y).abs() <= bound_y).all(), (B, L, cut)
            assert ((h2 - want_h).abs() <= bound_h).all(), (B, L, cut)
