"""The SSD scan's backward: the plain chunked adjoint
(``ssd_scan/ref.py::ssd_scan_backward_plain``) against float64 autograd
through the plain forward (1e-10 relative), against ``jax.vjp`` of the JAX
package's ``models/mamba2.py::ssd_chunked`` on the same numpy inputs (fp32,
2e-4 of each gradient's largest magnitude), and through
``torch.autograd.gradcheck`` of ``ops.ssd_scan`` (the ``SSDScan``
Function) in float64.  ``bf16_backward_rounding_bound`` holds the fp32
plain backward against the float64 one, and leaving out one chunk's share
of the state's adjoint moves some gradient by more than it; its
tensor-core term holds an emulation of that route's hi + lo splits.
``plan.py`` models the tensor-core route's grid, chunk, head order and
shared memory.  The CUDA kernel (``ssd_scan.cu``'s backward) runs only on
a card: its tests skip here.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

try:    # the card's machine has no JAX: there only the gpu-marked tests run
    import jax
    import jax.numpy as jnp

    from repro.models.mamba2 import ssd_chunked
except ModuleNotFoundError:
    jax = None
from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan import (SSDScan, bf16_backward_rounding_bound,
                                          dropped_chunk_effects, plan, ssd_scan,
                                          ssd_scan_backward_kernel, ssd_scan_backward_plain,
                                          ssd_scan_backward_split_emulation, ssd_scan_kernel,
                                          ssd_scan_plain)
from repro_torch.kernels.ssd_scan.ref import BACKWARD_NAMES

torch.set_num_threads(2)

needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX (the CPU reference)")


def inputs(seed, B, L, H, P, N, *, h0=False, dh_final=False, big_decay=False,
           dtype=np.float32):
    """``tests/test_torch_ssd.py``'s distributions (x normal, dt =
    softplus(normal), A = -exp(0.3 normal), B and C 0.5 normal; big decay:
    A from -1 to -16, dt x 4, every fifth dt 0), then dy normal and
    dh_final normal or None."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P))
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H))))
    A = -np.exp(rng.standard_normal(H) * 0.3)
    if big_decay:
        dt = dt * 4
        dt[:, ::5] = 0.0
        A = -np.linspace(1.0, 16.0, H)
    Bm = rng.standard_normal((B, L, N)) * 0.5
    Cm = rng.standard_normal((B, L, N)) * 0.5
    h = rng.standard_normal((B, H, P, N)) if h0 else None
    dy = rng.standard_normal((B, L, H, P))
    dh = rng.standard_normal((B, H, P, N)) if dh_final else None
    return [None if a is None else np.asarray(a, dtype) for a in (x, dt, A, Bm, Cm, h, dy, dh)]


def to_torch(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


CASES = [  # (B, L, H, P, N, chunk, h0, dh_final, big_decay)
    (2, 37, 3, 4, 8, 8, False, False, False),
    (2, 37, 3, 4, 8, 8, True, True, False),
    (1, 70, 4, 16, 32, 16, True, False, False),
    (1, 70, 4, 16, 32, 16, False, True, True),
    (2, 24, 6, 8, 16, 8, True, True, True),
    (3, 1, 2, 4, 8, 16, True, True, False),
    (1, 5, 2, 4, 8, 16, False, False, True),
]


@pytest.mark.parametrize("B,L,H,P,N,chunk,with_h0,with_dh,big_decay", CASES)
def test_plain_backward_is_float64_autograd(B, L, H, P, N, chunk, with_h0, with_dh, big_decay):
    x, dt, A, Bm, Cm, h0, dy, dh = to_torch(inputs(
        L * 7 + H, B, L, H, P, N, h0=with_h0, dh_final=with_dh, big_decay=big_decay,
        dtype=np.float64))
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    leaves.append(None if h0 is None else h0.clone().requires_grad_())
    y, h = ssd_scan_plain(*leaves, chunk=chunk)
    loss = (y * dy).sum() + ((h * dh).sum() if dh is not None else 0.0)
    loss.backward()
    got = ssd_scan_backward_plain(x, dt, A, Bm, Cm, h0, dy, dh, chunk=chunk)
    for name, g, leaf in zip(BACKWARD_NAMES, got, leaves, strict=True):
        if leaf is None:
            assert g is None
            continue
        assert g.dtype == torch.float64 and g.shape == leaf.shape, name
        torch.testing.assert_close(g, leaf.grad, rtol=1e-10,
                                   atol=1e-10 * leaf.grad.abs().max().item(), msg=name)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("L,chunk", [(13, 4), (8, 8), (1, 8)])
def test_gradcheck_through_ssd_scan(with_h0, L, chunk):
    """``ops.ssd_scan`` goes through ``SSDScan`` when an input requires
    grad; on the CPU its backward is the plain adjoint, checked against
    finite differences in float64 on both outputs."""
    x, dt, A, Bm, Cm, h0, _, _ = to_torch(inputs(L + chunk, 1, L, 2, 3, 4, h0=with_h0,
                                                 dtype=np.float64))
    args = [t.requires_grad_() for t in (x, dt, A, Bm, Cm)]
    if with_h0:
        args.append(h0.requires_grad_())
    assert torch.autograd.gradcheck(lambda *a: ssd_scan(*a, chunk=chunk), tuple(args))


def test_ssd_scan_takes_the_function_only_under_grad():
    """Serving calls (no grad, or no input that requires it) launch the
    forward alone; a call that autograd needs goes through ``SSDScan``, with
    the same values."""
    x, dt, A, Bm, Cm, h0, dy, _ = to_torch(inputs(3, 2, 19, 3, 4, 8, h0=True))
    y0, h_0 = ssd_scan(x, dt, A, Bm, Cm, h0, chunk=8)
    assert y0.grad_fn is None
    xr = x.clone().requires_grad_()
    y1, h1 = ssd_scan(xr, dt, A, Bm, Cm, h0, chunk=8)
    assert type(y1.grad_fn).__name__ == "SSDScanBackward" and torch.equal(y0, y1.detach())
    assert torch.equal(h_0, h1.detach())
    with torch.no_grad():
        y2, _ = ssd_scan(xr, dt, A, Bm, Cm, h0, chunk=8)
    assert y2.grad_fn is None and torch.equal(y0, y2)
    # a loss on y alone: no gradient reaches the final state, none is made up
    y1.backward(dy)
    want = ssd_scan_backward_plain(x, dt, A, Bm, Cm, h0, dy, None, chunk=8)[0]
    assert torch.equal(xr.grad, want)


def test_backward_wrapper_takes_plain_on_cpu_without_counting():
    x, dt, A, Bm, Cm, h0, dy, dh = to_torch(inputs(5, 2, 9, 3, 4, 8, h0=True, dh_final=True))
    before = ssd_scan_backward_kernel.launches
    got = ssd_scan_backward_kernel(x, dt, A, Bm, Cm, h0, dy, dh, chunk=4)
    want = ssd_scan_backward_plain(x, dt, A, Bm, Cm, h0, dy, dh, chunk=4)
    assert ssd_scan_backward_kernel.launches == before
    assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True))
    assert got[-1].shape == h0.shape
    got = ssd_scan_backward_kernel(x[:, :0], dt[:, :0], A, Bm[:, :0], Cm[:, :0], h0, dy[:, :0],
                                   dh)
    assert got[0].shape == (2, 0, 3, 4) and torch.equal(got[-1], dh)
    assert not got[2].any()
    with pytest.raises(ValueError, match="cpu or cuda"):
        ssd_scan_backward_kernel(*(None if t is None else t.to("meta")
                                   for t in (x, dt, A, Bm, Cm, h0, dy, dh)))


@needs_jax
@pytest.mark.parametrize("B,L,H,P,N,chunk,big_decay", [
    (2, 37, 3, 4, 8, 8, False), (1, 70, 4, 16, 32, 16, False), (2, 24, 6, 8, 16, 8, True),
    (1, 1, 2, 4, 8, 8, False)])
def test_plain_backward_matches_jax_vjp_of_ssd_chunked(B, L, H, P, N, chunk, big_decay):
    """The same fp32 numpy inputs (h0 given, a cotangent on both outputs)
    through ``jax.vjp`` of the JAX model's ``ssd_chunked`` and through the
    port's plain backward: each gradient within 2e-4 of its largest
    magnitude."""
    arrays = inputs(L * 3 + N, B, L, H, P, N, h0=True, dh_final=True, big_decay=big_decay)
    x, dt, A, Bm, Cm, h0, dy, dh = arrays
    _, vjp = jax.vjp(lambda *a: ssd_chunked(*a[:5], chunk, h0=a[5]),
                     *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm, h0)))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    got = ssd_scan_backward_plain(*to_torch(arrays), chunk=chunk)
    for name, g, w in zip(BACKWARD_NAMES, got, want, strict=True):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2e-4 * scale, err_msg=name)


BOUND_CASES = [  # (B, L, H, P, N, h0, dh_final, big_decay)
    (2, 37, 3, 4, 8, True, True, False), (2, 70, 4, 16, 32, True, False, True),
    (1, 1, 3, 4, 8, True, True, False), (1, 150, 4, 64, 128, False, False, False),
    (2, 130, 6, 16, 64, False, True, False)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,L,H,P,N,with_h0,with_dh,big_decay", BOUND_CASES)
def test_bf16_backward_bound_holds_and_sees_a_dropped_chunk(B, L, H, P, N, with_h0, with_dh,
                                                            big_decay, dtype):
    """The fp32 plain backward (on bf16 or fp32 values) lies within
    ``bf16_backward_rounding_bound`` of the float64 one, and a backward
    that left out one 64-token chunk's share of the state's adjoint would
    break the bound somewhere, where there is an earlier chunk or an h0 to
    reach.  Not at big decay: there the share reaching across the chunk
    boundary is scaled by exp(cums) of -10 and below, under bf16's
    resolution of the gradient it joins."""
    arrays = to_torch(inputs(L * 11 + P, B, L, H, P, N, h0=with_h0, dh_final=with_dh,
                             big_decay=big_decay))
    args = [None if a is None else (a.to(dtype) if i in (0, 3, 4, 6) else a)
            for i, a in enumerate(arrays)]
    want, bound = bf16_backward_rounding_bound(*args, chunk=64)
    g64 = ssd_scan_backward_plain(*(None if a is None else a.double() for a in args), chunk=64)
    for name, w, b, g in zip(BACKWARD_NAMES, want, bound, g64, strict=True):
        if w is None:
            assert b is None and g is None
            continue
        assert ((w.double() - g).abs() <= b.double()).all(), name
    effects = dropped_chunk_effects(*args, chunk=64)
    assert "dCm" not in effects         # dC reads the forward's states, not their adjoint
    if (L > 64 or with_h0) and not big_decay:
        ratio = {k: (e.double() / bound[BACKWARD_NAMES.index(k)].double()).max().item()
                 for k, e in effects.items()}
        assert max(ratio.values()) > 1.0, ratio
        if L > 64:
            assert ratio["dx"] > 1.0, ratio


def kernel_chunk_of(N):
    """The tensor-core route's chunk at this N (64 where the route does not
    take N: the emulation's arithmetic holds at any dims)."""
    return plan.chunk_len(N) if N in plan.STATE_DIMS else 64


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,L,H,P,N,with_h0,with_dh,big_decay", BOUND_CASES)
def test_split_emulation_within_the_tensor_core_bound(B, L, H, P, N, with_h0, with_dh,
                                                      big_decay, dtype):
    """The plain backward with the tensor-core route's hi + lo splits (x
    wend dt and dy exp(cums) in the passes, h_prev, dh, W and the sum of dG
    over heads) on the route's chunks lies within
    ``bf16_backward_rounding_bound(kernel_route="tensor_core")`` of the
    float64 backward, and leaving out one chunk's share of the state's
    adjoint still breaks that bound where the CUDA-core test requires it."""
    arrays = to_torch(inputs(L * 11 + P, B, L, H, P, N, h0=with_h0, dh_final=with_dh,
                             big_decay=big_decay))
    args = [None if a is None else (a.to(dtype) if i in (0, 3, 4, 6) else a)
            for i, a in enumerate(arrays)]
    kc = kernel_chunk_of(N)
    want, bound = bf16_backward_rounding_bound(*args, chunk=64, kernel_chunk=kc,
                                               kernel_route="tensor_core")
    _, bound_cc = bf16_backward_rounding_bound(*args, chunk=64, kernel_chunk=kc)
    emu = ssd_scan_backward_split_emulation(*args, kernel_chunk=kc)
    g64 = ssd_scan_backward_plain(*(None if a is None else a.double() for a in args), chunk=64)
    for name, e, b, bc, g in zip(BACKWARD_NAMES, emu, bound, bound_cc, g64, strict=True):
        if e is None:
            assert b is None and g is None
            continue
        assert e.dtype == torch.float32 and e.shape == g.shape, name
        assert ((e.double() - g).abs() <= b.double()).all(), name
        assert (b >= bc).all(), name            # the split term only adds
    effects = dropped_chunk_effects(*args, chunk=64)
    if (L > 64 or with_h0) and not big_decay:
        ratio = {k: (v.double() / bound[BACKWARD_NAMES.index(k)].double()).max().item()
                 for k, v in effects.items()}
        assert max(ratio.values()) > 1.0, ratio
        if L > 64:
            assert ratio["dx"] > 1.0, ratio


def test_cuda_core_bound_is_the_default_and_the_split_term_grows_with_chunks():
    """``kernel_route="cuda_core"`` is the bound as it was (no split term);
    the tensor-core term is (nc + 3) u^2 of the magnitudes, so it grows with
    the kernel's chunk count."""
    args = to_torch(inputs(9, 1, 200, 3, 16, 64, h0=True, dh_final=True))
    base = bf16_backward_rounding_bound(*args, chunk=64)
    same = bf16_backward_rounding_bound(*args, chunk=64, kernel_route="cuda_core")
    assert all(a is None and b is None or torch.equal(a, b)
               for a, b in zip(base[1], same[1], strict=True))
    short = bf16_backward_rounding_bound(*args, chunk=64, kernel_route="tensor_core")[1]
    long_ = bf16_backward_rounding_bound(*args, chunk=64, kernel_chunk=16,
                                         kernel_route="tensor_core")[1]
    for b, s, g in zip(base[1], short, long_, strict=True):
        assert (s >= b).all() and (s > b).any() and (g >= s).all()
    with pytest.raises(ValueError, match="kernel_route"):
        bf16_backward_rounding_bound(*args, kernel_route="wgmma")


@pytest.mark.parametrize("N", plan.STATE_DIMS)
@pytest.mark.parametrize("P", [16, 48, 64, 128])
def test_tensor_core_backward_plan_fits_a_block(P, N):
    """Every (P, N) the route takes: both kernels' shared memory within the
    H100's 232,448 bytes a block; the chunk kernel one block of 8 warps per
    (chunk, batch row), walking the heads in ascending order; the passes one
    block of 4 warps per (head, slab of state rows, batch row) and
    direction."""
    B, L, H = 2, 4096, 64
    pl = plan.plan(B, L, H, P, N)
    assert pl.chunk_smem <= plan.SMEM_LIMIT and pl.pass_smem <= plan.SMEM_LIMIT, pl
    assert pl.chunk == (32 if N == 256 else 64) and pl.head_order == "ascending"
    assert pl.chunk_grid == (L // pl.chunk, B, 1) and pl.chunk_threads == 256
    assert P % pl.pass_rows == 0 and pl.pass_grid == (H * P // pl.pass_rows, B, 2)
    assert pl.p_slab in (32, 64) and pl.pass_threads == 128
    with pytest.raises(ValueError):
        plan.plan(B, L, H, P + 8, N)
    with pytest.raises(ValueError):
        plan.plan(B, L, H, P, 32)


def test_tensor_core_plan_at_mamba2s_training_shape():
    """x (2, 4096, 64, 64), N 128: 64-token chunks, 128 chunk blocks (one
    wave on 132 SMs), 512 pass blocks of 32 state rows."""
    pl = plan.plan(2, 4096, 64, 64, 128)
    assert pl.chunk_grid == (64, 2, 1) and pl.pass_grid == (128, 2, 2)
    assert pl.p_slab == 32 and pl.pass_rows == 32
    assert pl.chunk_smem == 147232 and pl.pass_smem == 55312


def test_dropped_chunk_moves_only_earlier_chunks():
    """The dropped share reaches tokens before the chunk, not the chunk's
    own or later ones."""
    args = to_torch(inputs(2, 1, 40, 2, 4, 8, h0=True, dh_final=True))
    effects = dropped_chunk_effects(*args, chunk=8, drop=2)
    dx = effects["dx"]
    assert dx[:, :16].max() > 0 and dx[:, 16:].max() == 0
    assert effects["dh0"].max() > 0


def test_mamba2_gradients_reach_every_parameter_through_the_function():
    """A reduced mamba2 on the CPU: the loss's gradient through ``SSDScan``
    equals autograd through the plain forward (the model's ``ssd_scan``
    swapped for ``ssd_scan_plain``), and reaches dt_bias and in_proj
    through the softplus and A_log through A = -exp(A_log)."""
    import repro_torch.kernels.ssd_scan as pkg
    from repro_torch import configs
    from repro_torch.models import build_model

    cfg = configs.get("mamba2-1.3b").reduced()
    model = build_model(cfg, device="cpu", seed=0, train=True)
    tokens = torch.randint(0, cfg.vocab, (2, 24), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens}

    def grads():
        logits, _ = model.loss_aux(batch)
        torch.nn.functional.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]).float(),
                                          tokens[:, 1:].reshape(-1)).backward()
        out = {k: p.grad.clone() for k, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return out

    got = grads()
    orig = pkg.ssd_scan
    pkg.ssd_scan = lambda *a, chunk=256: ssd_scan_plain(*a, chunk=chunk)
    try:
        want = grads()
    finally:
        pkg.ssd_scan = orig
    for k, w in want.items():
        torch.testing.assert_close(got[k], w, rtol=1e-4, atol=1e-4 * w.abs().max().item(),
                                   msg=k)
    for leaf in ("ssm.dt_bias", "ssm.A_log", "ssm.in_proj"):
        g = got[f"layers.0.{leaf}"]
        assert torch.isfinite(g).all() and g.abs().max() > 0, leaf


def test_backward_source_is_hand_written_and_deterministic():
    src = (build.CSRC / "ssd_scan.cu").read_text()
    bwd = src[src.index("namespace bwd {"):src.index("}  // namespace bwd")]
    assert "ssd_scan_backward_launch" in src and "ssd_scan_backward_chunk" in src
    assert "atomic" not in bwd.lower() and "cublas" not in bwd.lower()
    assert bwd.count("tile_product(") == 7     # G, dW, dx, and two each for dC and dB


def test_tensor_core_backward_source_has_no_per_head_partials():
    """The tensor-core route's kernels (the state passes and the chunk
    kernel of namespace bwd) take no pB or pC scratch, use no atomics, and
    run their products on mma.sync; the library exports its plan."""
    src = (build.CSRC / "ssd_scan.cu").read_text()
    bwd = src[src.index("namespace bwd {"):src.index("}  // namespace bwd")]
    tc = bwd[bwd.index("// Tensor-core route of the backward"):]
    assert "tc_state_pass_kernel" in tc and "tc_chunk_kernel" in tc
    assert "pB" not in tc and "pC" not in tc
    assert "atomic" not in tc.lower() and "mma_bf16(" in tc
    assert "ssd_scan_backward_plan" in src


def cuda_args(seed, B, L, H, P, N, h0, dh, big, dtype):
    arrays = to_torch(inputs(seed, B, L, H, P, N, h0=h0, dh_final=dh, big_decay=big))
    return [None if a is None else (a.to(dtype) if i in (0, 3, 4, 6) else a).cuda()
            for i, a in enumerate(arrays)]


def route_bound(args):
    """``bf16_backward_rounding_bound`` on the route and chunk the library
    gives these inputs."""
    from repro_torch.kernels.ssd_scan.kernel import backward_chunk, backward_route

    x, Bm = args[0], args[3]
    _, L, _, P = x.shape
    N = Bm.shape[-1]
    return bf16_backward_rounding_bound(
        *args, kernel_chunk=backward_chunk(x.dtype, L, P, N) or 64,
        kernel_route=backward_route(x.dtype, P, N))[1]


@pytest.mark.gpu
def test_cuda_backward_within_bound_and_bitwise_repeatable():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for seed, (B, L, H, P, N, h0, dh, big, dtype) in enumerate([
            (2, 300, 64, 64, 128, False, False, False, torch.bfloat16),
            (1, 130, 8, 64, 128, True, True, True, torch.bfloat16),
            (2, 37, 6, 16, 64, True, True, False, torch.float32),
            (3, 1, 4, 4, 8, True, False, False, torch.bfloat16)]):
        args = cuda_args(seed, B, L, H, P, N, h0, dh, big, dtype)
        n0 = ssd_scan_backward_kernel.launches
        got = ssd_scan_backward_kernel(*args)
        again = ssd_scan_backward_kernel(*args)
        assert ssd_scan_backward_kernel.launches == n0 + 2
        bound = route_bound(args)
        want = ssd_scan_backward_plain(*(None if a is None else a.float() if i in (0, 3, 4, 6)
                                         else a for i, a in enumerate(args)))
        for name, g, g2, w, b in zip(BACKWARD_NAMES, got, again, want, bound, strict=True):
            if w is None:
                assert g is None
                continue
            assert torch.equal(g, g2), name
            assert ((g.double() - w.double()).abs() <= b.double()).all(), name


@pytest.mark.gpu
def test_cuda_tensor_core_backward_small_within_bound_and_bitwise():
    """The tensor-core route at small shapes (two and three chunks, a ragged
    one, P slabs of 16 and 32, N 64 and 256, L = 1): every gradient within
    the route's bound, two launches bitwise equal, counted on that route,
    and its plan the library's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.ssd_scan.kernel import backward_route, library_plan

    for seed, (B, L, H, P, N, h0, dh) in enumerate([
            (1, 150, 4, 64, 128, True, True), (2, 70, 3, 16, 64, False, True),
            (1, 40, 2, 48, 256, True, False), (2, 1, 3, 32, 64, True, True)]):
        assert backward_route(torch.bfloat16, P, N) == "tensor_core"
        assert library_plan(B, L, H, P, N) == plan.plan(B, L, H, P, N)._asdict()
        args = cuda_args(seed, B, L, H, P, N, h0, dh, False, torch.bfloat16)
        n0 = ssd_scan_backward_kernel.launches_by_route["tensor_core"]
        got = ssd_scan_backward_kernel(*args)
        again = ssd_scan_backward_kernel(*args)
        assert ssd_scan_backward_kernel.launches_by_route["tensor_core"] == n0 + 2
        bound = route_bound(args)
        want = ssd_scan_backward_plain(*(None if a is None else a.float() if i in (0, 3, 4, 6)
                                         else a for i, a in enumerate(args)))
        for name, g, g2, w, b in zip(BACKWARD_NAMES, got, again, want, bound, strict=True):
            if w is None:
                assert g is None
                continue
            assert torch.equal(g, g2), name
            assert ((g.double() - w.double()).abs() <= b.double()).all(), (name, seed)


@pytest.mark.gpu
def test_cuda_direct_forward_call_with_grad_still_refuses():
    """Nothing drops a gradient silently: the model path reaches the kernel
    through ``SSDScan``; a direct call of the forward kernel with an input
    that requires grad raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the refusal is the CUDA path's")
    x, dt, A, Bm, Cm, *_ = (None if a is None else a.cuda()
                            for a in to_torch(inputs(0, 1, 8, 2, 16, 64)))
    x = x.to(torch.bfloat16).requires_grad_()
    with pytest.raises(NotImplementedError, match="SSDScan"):
        ssd_scan_kernel(x, dt, A, Bm.to(torch.bfloat16), Cm.to(torch.bfloat16))
    y, _ = SSDScan.apply(x, dt, A, Bm.to(torch.bfloat16), Cm.to(torch.bfloat16), None, 256)
    y.float().sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad.float()).all()


def test_refuse_grad_names_the_function_that_carries_the_backward():
    from repro_torch.kernels.grad_guard import refuse_grad

    x = torch.ones(3, requires_grad=True)
    with pytest.raises(NotImplementedError, match=r"item 1\.7\.1\) runs through ops\.SSDScan"):
        refuse_grad("k", "1.7.1", x, via="ops.SSDScan")
    refuse_grad("k", "1.7.1", x.detach(), via="ops.SSDScan")
