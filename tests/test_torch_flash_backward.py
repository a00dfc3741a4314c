"""The flash-attention backward: the plain version (``ref.py``) against
torch autograd through ``flash_attention_plain`` and against ``jax.vjp`` of
the JAX package's ``reference_attention``; the autograd Function on the
CPU against autograd; the kernel's refusals; and, on the card, the CUDA
backward against the plain version.

Same numpy inputs in every framework.  Tolerances (relative to the
largest |gradient| of the reference, per dq, dk and dv): fp32 2e-4, bf16
3e-2, the forward's.  The sweep covers D 8/16/64, G 1/2/5, windows and S
off every tile.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (FlashAttention, flash_attention,
                                                 flash_attention_backward_kernel,
                                                 flash_attention_backward_plain,
                                                 flash_attention_kernel, flash_attention_plain)
from repro_torch.kernels.grad_guard import refuse_grad

try:    # the card's machine has no JAX: there only the gpu-marked tests run
    import jax
    import jax.numpy as jnp

    from repro.kernels.flash_attention import reference_attention
except ModuleNotFoundError:
    jax = None

torch.set_num_threads(2)

TOL = {"float32": 2e-4, "bfloat16": 3e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CASES = [  # (B, S, H, Hkv, D, window)
    (1, 16, 1, 1, 8, None),
    (2, 37, 4, 2, 16, 8),
    (1, 50, 5, 1, 64, None),
    (2, 29, 10, 2, 16, 5),
    (1, 70, 2, 2, 8, 100),
]


def inputs(seed, B, S, H, Hkv, D, dtype):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, S, H, D))]
    return [torch.from_numpy(a).to(TDT[dtype]) for a in arrays]


def rel_err(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def autograd_plain(q, k, v, do, window):
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    flash_attention_plain(*leaves, window=window).backward(do)
    return [t.grad for t in leaves]


def plain_backward(q, k, v, do, window):
    o, lse = flash_attention_plain(q, k, v, window=window, return_lse=True)
    return flash_attention_backward_plain(q, k, v, o, lse, do, window=window)


def jax_vjp(q, k, v, do, window):
    """jax.vjp of reference_attention over (B*H, S, D), each kv head repeated
    over its group (the vjp sums the group back)."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    qj, kj, vj, doj = (jnp.asarray(t.float().numpy()) for t in (q, k, v, do))

    def fn(q, k, v):
        def bh(x):
            return jnp.transpose(x, (0, 2, 1, 3)).reshape(-1, S, D)
        kr, vr = jnp.repeat(k, G, axis=2), jnp.repeat(v, G, axis=2)
        o = reference_attention(bh(q), bh(kr), bh(vr), causal=True, window=window)
        return jnp.transpose(o.reshape(B, H, S, D), (0, 2, 1, 3))

    _, vjp = jax.vjp(fn, qj, kj, vj)
    return [torch.from_numpy(np.array(g)) for g in vjp(doj)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_autograd_and_jax(case, dtype):
    B, S, H, Hkv, D, window = case
    q, k, v, do = inputs(1, B, S, H, Hkv, D, dtype)
    got = plain_backward(q, k, v, do, window)
    for g, t in zip(got, (q, k, v), strict=True):
        assert g.dtype == t.dtype and g.shape == t.shape
    for g, w in zip(got, autograd_plain(q, k, v, do, window), strict=True):
        assert rel_err(g, w) <= TOL[dtype]
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    for g, w in zip(got, jax_vjp(q32, k32, v32, do32, window), strict=True):
        assert rel_err(g, w) <= TOL[dtype]


@pytest.mark.parametrize("case", CASES[:3], ids=lambda c: "-".join(map(str, c)))
def test_function_on_cpu_equals_autograd(case):
    """``ops.flash_attention`` with grad: the Function's forward is bitwise
    the plain forward and its backward the plain backward's values."""
    B, S, H, Hkv, D, window = case
    q, k, v, do = inputs(2, B, S, H, Hkv, D, "float32")
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = flash_attention(*leaves, window=window)
    assert o.grad_fn is not None and type(o.grad_fn).__name__.startswith("FlashAttention")
    assert torch.equal(o, flash_attention_plain(q, k, v, window=window))
    o.backward(do)
    for t, w in zip(leaves, autograd_plain(q, k, v, do, window), strict=True):
        assert rel_err(t.grad, w) <= TOL["float32"]
    with torch.no_grad():       # no grad: the forward alone, no Function
        assert flash_attention(*leaves, window=window).grad_fn is None


def test_lse_and_the_forward_with_it():
    q, k, v, _ = inputs(3, 2, 33, 4, 2, 16, "float32")
    o, lse = flash_attention_plain(q, k, v, window=6, return_lse=True)
    assert torch.equal(o, flash_attention_plain(q, k, v, window=6))
    assert lse.shape == (2, 4, 33) and lse.dtype == torch.float32
    s = torch.einsum("bshd,bthd->bhst", q, k.repeat_interleave(2, dim=2)) / 4.0
    i = torch.arange(33)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - 6)
    want = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
    assert (lse - want).abs().max().item() <= 1e-5
    o2, lse2 = flash_attention_kernel(q, k, v, window=6, return_lse=True)    # CPU: plain
    assert torch.equal(o2, o) and torch.equal(lse2, lse)


def test_backward_scope_and_plain_mode():
    q, k, v, do = inputs(4, 1, 12, 2, 1, 8, "float32")
    o, lse = flash_attention_plain(q, k, v, return_lse=True)
    with pytest.raises(NotImplementedError, match="causal"):
        flash_attention_backward_kernel(q, k, v, o, lse, do, causal=False)
    with pytest.raises(NotImplementedError, match="S == T"):
        flash_attention_backward_kernel(q, k[:, :6], v[:, :6], o, lse, do)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    FlashAttention.apply(*leaves, True, None).backward(do)     # CPU: the plain backward
    for t, w in zip(leaves, plain_backward(q, k, v, do, None), strict=True):
        assert torch.equal(t.grad, w)


def test_refuse_grad():
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(NotImplementedError, match="ROADMAP item 9.9"):
        refuse_grad("some_kernel", "9.9", None, x)
    with torch.no_grad():
        refuse_grad("some_kernel", "9.9", x)
    refuse_grad("some_kernel", "9.9", x.detach(), None)


GPU_CASES = [  # (B, S, H, Hkv, D, window)
    (1, 16, 1, 1, 8, None), (2, 77, 4, 2, 16, 8), (1, 130, 10, 1, 256, 8),
    (2, 300, 40, 8, 128, None), (1, 700, 36, 36, 64, None), (1, 900, 10, 1, 256, 256),
    # the wgmma design: D 64 without GQA, D 128 with G 5, D 256 windowed
    (2, 333, 8, 8, 64, None), (1, 257, 10, 2, 128, None), (1, 515, 10, 1, 256, 100),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_backward_matches_plain_version(dtype):
    """The kernel's backward on the card against the plain fp32 backward on
    the same values, and two launches bitwise equal; bf16 at D 64, 128 and
    256 on the wgmma design."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    bwd = flash_attention_backward_kernel
    for seed, (B, S, H, Hkv, D, window) in enumerate(GPU_CASES):
        q, k, v, do = (t.cuda() for t in inputs(seed, B, S, H, Hkv, D, dtype))
        o, lse = flash_attention_kernel(q, k, v, window=window, return_lse=True)
        before = dict(bwd.launches_by_design)
        got = bwd(q, k, v, o, lse, do, window=window)
        again = bwd(q, k, v, o, lse, do, window=window)
        wgmma = dtype == "bfloat16" and D in (64, 128, 256)
        assert bwd.launches_by_design["wgmma"] - before["wgmma"] == 2 * wgmma
        want = plain_backward(*(t.float() for t in (q, k, v, do)), window)
        for g, a, w in zip(got, again, want, strict=True):
            assert torch.equal(g, a) and rel_err(g, w) <= TOL[dtype]


@pytest.mark.gpu
def test_cuda_kernels_without_backward_refuse_grad():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.moe_experts import kernel as mk
    from repro_torch.kernels.ssd_scan import ssd_scan_kernel

    x = torch.randn(1, 8, 2, 16, device="cuda", requires_grad=True)
    dt = torch.rand(1, 8, 2, device="cuda")
    A = -torch.rand(2, device="cuda")
    Bm = torch.randn(1, 8, 16, device="cuda")
    with pytest.raises(NotImplementedError, match="1.7.1"):
        ssd_scan_kernel(x, dt, A, Bm, Bm)
    xr = torch.randn(4, 32, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(32, 4, device="cuda", requires_grad=True)
    with pytest.raises(NotImplementedError, match="1.7.2.*runs through ops.MoEFFN"):
        mk.moe_route_kernel(xr, w, 2)
