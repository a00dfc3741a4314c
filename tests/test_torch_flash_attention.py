"""Flash attention in the PyTorch port against the JAX package.

The same numpy inputs (from a seed) go through the JAX Pallas kernel in
interpret mode with ``bq = bk = 16`` (as the JAX kernel tests run it on the
CPU), the JAX oracle ``reference_attention`` and the port's plain version,
on the sweep of ``tests/test_kernels.py::test_flash_attention_sweep``.
Tolerances are the JAX sweep's: fp32 2e-4, bf16 3e-2, absolute and
relative.

``layers.sdpa`` sends an aligned self-attention of 4096 tokens or more to
the flash kernel's entry point, and must then agree with the JAX ``sdpa``
(which streams the same softmax over kv blocks of 1024 in XLA) to fp32
summation noise, 1e-5; below 4096 tokens the call is bitwise what it was.
On the CPU the wrapper runs the plain version and counts no launch.  The
CUDA kernel runs only on a card: its tests skip here, and on the card
(which has no JAX) they run alone with ``pytest -m gpu``.  bf16 at a head
dim that is a multiple of 16 takes the tensor-core route, which rounds the
probabilities to bf16 before P.V; its card test also holds it against the
fp32 plain version on the same bf16 values, within the bound of its two bf16
roundings (P, and o at the store).
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_kernel,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_attention.kernel import ROUTES, route
from repro_torch.kernels.flash_attention.ref import bf16_rounding_bound
from repro_torch.models import layers as tl

try:    # the card's machine has no JAX: there only the gpu-marked tests run
    import jax.numpy as jnp

    from repro.kernels.flash_attention import flash_attention as jax_flash_attention
    from repro.kernels.flash_attention import reference_attention
    from repro.models import layers as jl
except ModuleNotFoundError:
    jnp = None

torch.set_num_threads(2)

ATOL = {"float32": 2e-4, "bfloat16": 3e-2}
JDT = {"float32": "float32", "bfloat16": "bfloat16"}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def inputs(seed, B, S, T, H, Hkv, D, dtype):
    """(jax q, k, v), (torch q, k, v): the same values in both frameworks
    (numpy fp32, cast once to the working type)."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, S, H, D), (B, T, Hkv, D), (B, T, Hkv, D))]
    ts = [torch.from_numpy(a).to(TDT[dtype]) for a in arrays]
    js = [jnp.asarray(t.float().numpy(), JDT[dtype]) for t in ts] if jnp is not None else None
    return js, ts


def jax_reference(q, k, v, window):
    """``reference_attention`` in the model layout (kv heads repeated)."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qf = q.transpose(0, 2, 1, 3).reshape(B * H, S, D)
    kf = jnp.repeat(k.transpose(0, 2, 1, 3), G, 1).reshape(B * H, T, D)
    vf = jnp.repeat(v.transpose(0, 2, 1, 3), G, 1).reshape(B * H, T, D)
    ref = reference_attention(qf, kf, vf, causal=True, window=window)
    return ref.reshape(B, H, S, D).transpose(0, 2, 1, 3)


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,S,T,H,Hkv,D", [
    (1, 16, 16, 4, 4, 8),      # MHA square
    (2, 32, 32, 8, 2, 16),     # GQA
    (1, 24, 40, 4, 1, 32),     # MQA, S != T, non-multiples of block
    (2, 128, 128, 4, 4, 64),   # block-aligned
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 8])
def test_plain_matches_jax_kernel_and_reference(B, S, T, H, Hkv, D, dtype, window):
    (qj, kj, vj), (qt, kt, vt) = inputs(0, B, S, T, H, Hkv, D, dtype)
    got = flash_attention_plain(qt, kt, vt, causal=True, window=window)
    assert got.dtype == TDT[dtype] and got.shape == (B, S, H, D)
    tol = dict(atol=ATOL[dtype], rtol=ATOL[dtype])
    kernel = jax_flash_attention(qj, kj, vj, causal=True, window=window, bq=16, bk=16,
                                 interpret=True)
    np.testing.assert_allclose(np32(got), np32(kernel), **tol)
    np.testing.assert_allclose(np32(got), np32(jax_reference(qj, kj, vj, window)), **tol)
    # the entry point and the wrapper take the plain version for CPU tensors
    np.testing.assert_array_equal(np32(flash_attention(qt, kt, vt, window=window)),
                                  np32(got))


@pytest.mark.parametrize("t_real", [None, 29])
def test_plain_blocks_and_padded_rows(t_real):
    """The kv-block size changes only the rounding, and kv rows at or past
    ``t_real`` are masked exactly as if they were cut off."""
    B, S, T, H, Hkv, D = 2, 40, 40, 6, 2, 16
    _, (q, k, v) = inputs(3, B, S, T, H, Hkv, D, "float32")
    for window in (None, 7):
        one = flash_attention_plain(q, k, v, window=window, t_real=t_real)
        blocked = flash_attention_plain(q, k, v, window=window, t_real=t_real, block=7)
        np.testing.assert_allclose(np32(blocked), np32(one), atol=1e-6, rtol=1e-6)
        if t_real is not None:
            cut = flash_attention_plain(q, k[:, :t_real], v[:, :t_real], window=window)
            np.testing.assert_allclose(np32(one), np32(cut), atol=1e-6, rtol=1e-6)


def test_rows_with_no_valid_key_take_the_mean_of_v():
    """S > T under a window: rows i >= T + window - 1 see no key and come
    out as the uniform average over the T kv rows, as ``reference_attention``
    gives them."""
    B, S, T, H, Hkv, D, window = 1, 12, 4, 2, 1, 8, 2
    (qj, kj, vj), (qt, kt, vt) = inputs(1, B, S, T, H, Hkv, D, "float32")
    got = np32(flash_attention_plain(qt, kt, vt, causal=True, window=window))
    want = np32(jax_reference(qj, kj, vj, window))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    mean = np32(vt).mean(axis=1)                                   # (B, Hkv, D)
    empty = got[:, T + window - 1:]                                 # rows 5..11
    np.testing.assert_allclose(empty, np.broadcast_to(mean[:, None], empty.shape),
                               atol=1e-6, rtol=1e-6)
    assert not np.allclose(got[:, T + window - 2], mean)           # row 4 sees key 3


@pytest.mark.parametrize("window", [None, 3000])
def test_sdpa_sends_long_aligned_calls_to_flash(monkeypatch, window):
    """S = T = 4096: ``sdpa(aligned=True)`` reaches ``flash_attention`` and
    agrees with the JAX ``sdpa`` streaming branch to fp32 summation noise."""
    calls = []

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return flash_attention(*args, **kw)

    monkeypatch.setattr(tl, "flash_attention", spy)
    B, S, H, Hkv, D = 1, 4096, 2, 1, 8
    _, (q, k, v) = inputs(5, B, S, S, H, Hkv, D, "float32")
    got = tl.sdpa(q, k, v, causal=True, window=window, aligned=True)
    want = jl.sdpa(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
                   causal=True, window=window)
    assert calls == [(B, S, H, D)]
    np.testing.assert_allclose(np32(got), np32(want), atol=1e-5, rtol=1e-5)


def test_sdpa_below_the_threshold_is_unchanged(monkeypatch):
    """Below 4096 tokens an aligned call is bitwise the call it was, and the
    flash entry point is never reached."""
    monkeypatch.setattr(tl, "flash_attention", lambda *a, **k: pytest.fail("flash called"))
    assert not tl.takes_flash(4095, True) and not tl.takes_flash(4096, False)
    assert tl.takes_flash(4096, True)
    for dtype in ("float32", "bfloat16"):
        _, (q, k, v) = inputs(6, 2, 300, 300, 4, 2, 16, dtype)
        for window in (None, 40):
            a = tl.sdpa(q, k, v, causal=True, window=window, aligned=True)
            b = tl.sdpa(q, k, v, causal=True, window=window)
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="aligned"):
        tl.sdpa(q, k[:, :5], v[:, :5], aligned=True)


def test_cpu_dispatch_counts_no_launch():
    _, (q, k, v) = inputs(7, 1, 20, 20, 4, 2, 16, "bfloat16")
    n0 = flash_attention_kernel.launches
    by_route = dict(flash_attention_kernel.launches_by_route)
    out = flash_attention(q, k, v, window=5)
    flash_attention_kernel(q, k, v, causal=False, t_real=11)
    assert flash_attention_kernel.launches == n0
    assert flash_attention_kernel.launches_by_route == by_route
    assert set(by_route) == set(ROUTES)
    assert out.dtype == torch.bfloat16 and out.device.type == "cpu"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [8, 16, 24, 64, 128, 200, 256])
def test_route_by_dtype_and_head_dim(dtype, D):
    """bf16 at a multiple of 16 runs on the tensor cores (every main-path
    shape: D 64, 128, 256); fp32 and other head dims on the CUDA cores."""
    want = "tensor_core" if dtype == "bfloat16" and D % 16 == 0 else "cuda_core"
    assert route(TDT[dtype], D) == want


def test_bf16_rounding_bound_holds_for_rounded_probabilities():
    """The bound's arithmetic on the CPU: attention whose probabilities and
    output are rounded to bf16 (what the tensor-core route does) stays
    inside it, and leaving out one 64-key tile of a long row does not."""
    B, S, H, Hkv, D = 1, 600, 4, 2, 32
    _, ts = inputs(9, B, S, S, H, Hkv, D, "bfloat16")
    q, k, v = (t.float() for t in ts)
    want, bound = bf16_rounding_bound(q, k, v)
    G = H // Hkv
    s = torch.einsum("bshgd,bthd->bhgst", q.reshape(B, S, Hkv, G, D), k) / math.sqrt(D)
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgst,bthd->bhgsd", p.bfloat16().float(), v) / l
    o = o.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).bfloat16().float()
    assert ((o - want).abs() <= bound).all()
    keep = torch.ones(S, dtype=torch.bool)
    keep[256:320] = False
    dropped = torch.einsum("bhgt,bthd->bhgd", torch.softmax(s[..., -1, keep], -1), v[:, keep])
    assert (dropped.reshape(B, H, D) - want[:, -1]).abs().max() > bound[:, -1].max()


GPU_CASES = [  # (B, S, T, H, Hkv, D, window)
    (1, 16, 16, 1, 1, 8, None), (2, 77, 77, 4, 2, 16, 8), (1, 200, 130, 10, 1, 64, None),
    (2, 100, 300, 40, 8, 128, 2048), (1, 130, 70, 10, 1, 256, 8), (1, 300, 300, 5, 1, 128, None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(dtype):
    """Kernel vs plain version on the card at the JAX tolerances: D 8..256,
    G 1/2/5/10, S = T, S < T and S > T under a window (rows that see no
    key), T not a multiple of the tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    tol = ATOL[dtype]
    for seed, (B, S, T, H, Hkv, D, window) in enumerate(GPU_CASES):
        _, ts = inputs(seed, B, S, T, H, Hkv, D, dtype)
        q, k, v = (t.cuda() for t in ts)
        n0 = flash_attention_kernel.launches
        got = flash_attention_kernel(q, k, v, causal=True, window=window)
        want = flash_attention_plain(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        assert flash_attention_kernel.launches == n0 + 1
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


GPU_TC_CASES = [  # (B, S, T, H, Hkv, D, window, extra): several 128-row q tiles and kv stages
    (2, 700, 700, 8, 2, 64, None, {"t_real": 650}),
    (1, 1000, 1000, 40, 8, 128, 300, {}),
    (1, 900, 900, 10, 1, 256, 256, {"t_real": 870}),
    (1, 520, 600, 4, 1, 128, None, {"causal": False, "t_real": 555}),
    (1, 400, 200, 2, 1, 64, 40, {}),
    (1, 300, 300, 4, 2, 80, 100, {}),          # head dims known only at run time
    (1, 200, 200, 2, 2, 192, None, {}),
]


@pytest.mark.gpu
def test_cuda_tensor_core_route_matches_plain_versions():
    """bf16 at D 64/128/256 takes the tensor-core route and agrees with the
    bf16 plain version at 3e-2 and with the fp32 plain version on the same
    values within the bound of its bf16 roundings."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for seed, (B, S, T, H, Hkv, D, window, extra) in enumerate(GPU_TC_CASES):
        _, ts = inputs(seed, B, S, T, H, Hkv, D, "bfloat16")
        q, k, v = (t.cuda() for t in ts)
        kw = dict(causal=extra.get("causal", True), window=window, t_real=extra.get("t_real"))
        n0 = flash_attention_kernel.launches_by_route["tensor_core"]
        got = flash_attention_kernel(q, k, v, **kw)
        torch.cuda.synchronize()
        assert flash_attention_kernel.launches_by_route["tensor_core"] == n0 + 1
        want = flash_attention_plain(q, k, v, **kw)
        torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)
        want32, bound = bf16_rounding_bound(q, k, v, **kw)
        assert ((got.float() - want32).abs() <= bound).all()
