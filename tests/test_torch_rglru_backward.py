"""The RG-LRU scan's backward: one reverse-mode launch of the forward's
kernels (the plain reverse fold on the CPU), bitwise equal to autograd through the
plain left fold, within 1e-6 of ``jax.vjp`` of the JAX package's
``reference_rglru``, and carrying the gradient to the initial state ``h0``
through the model's fold of it into ``b_0``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.rglru_scan import (RGLRUScan, rglru_scan, rglru_scan_backward_kernel,
                                            rglru_scan_backward_plain, rglru_scan_plain)
from repro_torch.models import rglru as trg

try:    # the card's machine has no JAX
    import jax
    import jax.numpy as jnp

    from repro.kernels.rglru_scan import reference_rglru
except ModuleNotFoundError:
    jax = None

SHAPES = [(1, 1, 8), (2, 17, 24), (1, 64, 33), (3, 100, 5)]


def inputs(seed, B, L, W, resets=False):
    rng = np.random.default_rng(seed)
    a = (1 / (1 + np.exp(-rng.standard_normal((B, L, W))))) * 0.98 + 0.01
    if resets:
        a = np.where(rng.random((B, L, W)) < 0.1, 0.0, a)
    b, g = rng.standard_normal((2, B, L, W))
    return [torch.from_numpy(x.astype(np.float32)) for x in (a, b, g)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("resets", [False, True])
def test_backward_is_bitwise_autograd_of_the_plain_fold(shape, resets):
    a, b, g = inputs(0, *shape, resets=resets)
    leaves = [a.clone().requires_grad_(), b.clone().requires_grad_()]
    rglru_scan(*leaves).backward(g)
    ref = [a.clone().requires_grad_(), b.clone().requires_grad_()]
    rglru_scan_plain(*ref).backward(g)
    assert torch.equal(leaves[0].grad, ref[0].grad) and torch.equal(leaves[1].grad, ref[1].grad)
    assert torch.equal(rglru_scan_backward_kernel(a, g), rglru_scan_backward_plain(a, g))
    # the reverse fold is the forward fold over reversed inputs
    a_rev = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1).flip(1)
    assert torch.equal(rglru_scan_plain(a_rev, g.flip(1)).flip(1),
                       rglru_scan_backward_plain(a, g))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_backward_matches_jax_vjp(shape):
    a, b, g = inputs(1, *shape)
    _, vjp = jax.vjp(reference_rglru, jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
    ja, jb = (np.asarray(x) for x in vjp(jnp.asarray(g.numpy())))
    leaves = [a.clone().requires_grad_(), b.clone().requires_grad_()]
    RGLRUScan.apply(*leaves).backward(g)
    for got, want in ((leaves[0].grad, ja), (leaves[1].grad, jb)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_h0_gets_a_gradient():
    """The model's ``rglru_scan(x, a, h0)`` folds h0 into b_0: dh0 = a_0 db_0."""
    a, b, g = inputs(2, 2, 9, 6)
    h0 = torch.randn(2, 6, requires_grad=True)
    bb, aa = b.clone().requires_grad_(), a.clone().requires_grad_()
    trg.rglru_scan(bb, aa, h0=h0).backward(g)
    assert h0.grad is not None
    torch.testing.assert_close(h0.grad, a[:, 0] * bb.grad[:, 0], rtol=0, atol=0)
    # against the fold from h0 written out
    h = h0.detach().clone().requires_grad_()
    state, outs = h, []
    for t in range(9):
        state = a[:, t] * state + b[:, t]
        outs.append(state)
    torch.stack(outs, 1).backward(g)
    torch.testing.assert_close(h0.grad, h.grad, rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
def test_cuda_backward_is_bitwise_the_plain_reverse_fold():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for seed, shape in enumerate([(1, 1, 8), (2, 17, 2560), (1, 300, 2560), (8, 29, 8)]):
        a, b, g = (t.cuda() for t in inputs(seed, *shape, resets=True))
        n0 = rglru_scan_backward_kernel.launches
        got = rglru_scan_backward_kernel(a, g)
        assert rglru_scan_backward_kernel.launches == n0 + 1
        assert torch.equal(got, rglru_scan_backward_plain(a, g))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,kernel", [
    ((1, 4096, 2560), torch.float32, "staged"),
    ((2, 33, 64), torch.float32, "staged"),      # a tail stage of one step
    ((1, 31, 2560), torch.float32, "direct"),    # shorter than a stage
    ((2, 70, 35), torch.float32, "direct"),      # rows not whole 16-byte chunks
    ((1, 300, 2560), torch.bfloat16, "staged"),
], ids=["train", "tail", "short", "ragged", "bf16"])
def test_cuda_reverse_mode_reads_a_in_place(shape, dtype, kernel):
    """The reverse mode on each of its kernels: one launch, on the kernel
    the library names, no copy of a or g (their storage is read where it
    lies), bitwise the plain reverse fold."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    a, b, g = (t.cuda().to(dtype) for t in inputs(7, *shape, resets=True))
    n0 = dict(rglru_scan_backward_kernel.launches_by_kernel)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        got = rglru_scan_backward_kernel(a, g)
        torch.cuda.synchronize()
    n1 = rglru_scan_backward_kernel.launches_by_kernel
    assert {k: n1[k] - n0[k] for k in n1} == {k: int(k == kernel) for k in n1}
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert not any("copy" in n.lower() or "cat" in n.lower() or "flip" in n.lower()
                   for n in names), names
    assert torch.equal(got, rglru_scan_backward_plain(a, g))
