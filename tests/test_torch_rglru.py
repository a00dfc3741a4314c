"""The RG-LRU scan in the PyTorch port against the JAX package.

The same numpy inputs (from a seed) go through the JAX oracle
(``reference_rglru``), the JAX Pallas kernel in interpret mode (as the JAX
kernel tests run it on the CPU), the JAX model's ``rglru_scan`` and the
port's plain version, wrapper and model scan.  Tolerances are the JAX kernel
tests' (``tests/test_kernels.py``): ``ATOL[dtype] * 5`` on the sweep, 1e-4 on
the near-one decay case.  Against the JAX model scan: 1e-6 for S <= 16,
where both are a left fold and differ only in whether ``b_0 + a_0 * h0`` is
fused, and 1e-4 beyond, where JAX reassociates through its associative scan.
The port's own contracts are exact: the plain fold equals S=1 steps that
fold their state in, bitwise, at every length.  The block-diagonal gate
products in both forms (per token on the CPU, one batched product per
block on the card) agree with each other and with the JAX einsum to
``GATE_TOL`` (fp32 sums of Wb <= 16 products in another order).  The CUDA
kernel runs only on a card: its test skips here.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

try:    # the card's machine has no JAX: there only the gpu-marked tests run
    import jax.numpy as jnp

    from repro.kernels.rglru_scan import reference_rglru
    from repro.kernels.rglru_scan import rglru_scan as jax_rglru_scan
    from repro.models.rglru import rglru_gates as jax_rglru_gates
    from repro.models.rglru import rglru_scan as jax_model_scan
except ModuleNotFoundError:
    jnp = None
from repro_torch.kernels import build
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_kernel, rglru_scan_plain
from repro_torch.models import rglru as torch_rglru
from repro_torch.models.rglru import block_diag_batched, block_diag_rows
from repro_torch.models.rglru import rglru_scan as model_scan

torch.set_num_threads(2)

ATOL = {"float32": 2e-4, "bfloat16": 3e-2}
JDT = {"float32": "float32", "bfloat16": "bfloat16"}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

GATE_TOL = 1e-5

# the sweep of tests/test_kernels.py::test_rglru_scan_sweep
SWEEP = [(1, 16, 8, 8, 8), (2, 29, 24, 8, 8), (1, 128, 64, 32, 32)]


def scan_inputs(seed, B, L, W):
    """a in (0.01, 0.99) (the JAX sweep's sigmoid range), b standard normal."""
    rng = np.random.default_rng(seed)
    a = (1 / (1 + np.exp(-rng.standard_normal((B, L, W))))) * 0.98 + 0.01
    return a.astype(np.float32), rng.standard_normal((B, L, W)).astype(np.float32)


@pytest.mark.parametrize("B,L,W,bq,bw", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_and_wrapper_match_jax_sweep(B, L, W, bq, bw, dtype):
    a, b = scan_inputs(B * 100 + L, B, L, W)
    ja, jb = jnp.asarray(a, JDT[dtype]), jnp.asarray(b, JDT[dtype])
    oracle = np.asarray(reference_rglru(ja.astype(jnp.float32), jb.astype(jnp.float32)))
    pallas = np.asarray(jax_rglru_scan(ja, jb, block_q=bq, block_w=bw, interpret=True),
                        np.float32)
    ta, tb = torch.from_numpy(a).to(TDT[dtype]), torch.from_numpy(b).to(TDT[dtype])
    plain = rglru_scan_plain(ta, tb)
    wrapped = rglru_scan(ta, tb)
    assert plain.dtype == TDT[dtype] and plain.shape == (B, L, W)
    assert torch.equal(plain, wrapped)
    tol = ATOL[dtype] * 5
    for want in (oracle, pallas):
        np.testing.assert_allclose(plain.float().numpy(), want, atol=tol, rtol=tol)


def test_near_one_decay_stability():
    """a = 0.999 as in trained RG-LRU; a long block, no drift."""
    B, L, W = 1, 256, 8
    a = np.full((B, L, W), 0.999, np.float32)
    b = np.full((B, L, W), 0.01, np.float32)
    want = np.asarray(jax_rglru_scan(jnp.asarray(a), jnp.asarray(b), block_q=128,
                                     block_w=8, interpret=True))
    got = rglru_scan(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, np.asarray(reference_rglru(jnp.asarray(a),
                                                               jnp.asarray(b))),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("S,tol", [(1, 1e-6), (7, 1e-6), (16, 1e-6), (17, 1e-4),
                                   (40, 1e-4)])
def test_model_scan_with_h0_matches_jax(S, tol):
    """``models.rglru.rglru_scan(x_in, a, h0)`` against the JAX model's."""
    rng = np.random.default_rng(S)
    B, W = 2, 24
    a = rng.uniform(0.5, 0.999, (B, S, W)).astype(np.float32)
    x = rng.standard_normal((B, S, W)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    want = np.asarray(jax_model_scan(jnp.asarray(x), jnp.asarray(a), h0=jnp.asarray(h0)))
    got = model_scan(torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(h0))
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("S", [2, 16, 17, 64])
def test_model_scan_chunk_is_bitwise_token_steps(S):
    """A chunk of any length equals S=1 steps threading h exactly (the JAX
    package guarantees this only up to RGLRU_LEFT_FOLD_MAX = 16), and a
    chunk split anywhere equals the whole chunk."""
    rng = np.random.default_rng(100 + S)
    a = torch.from_numpy(rng.uniform(0.0, 1.0, (2, S, 12)).astype(np.float32))
    a[:, S // 2, 3] = 0.0                                  # a reset
    x = torch.from_numpy(rng.standard_normal((2, S, 12)).astype(np.float32))
    h0 = torch.from_numpy(rng.standard_normal((2, 12)).astype(np.float32))
    whole = model_scan(x, a, h0)
    h, steps = h0, []
    for t in range(S):
        h = model_scan(x[:, t:t + 1], a[:, t:t + 1], h)[:, 0]
        steps.append(h)
    assert torch.equal(torch.stack(steps, 1), whole)
    cut = S // 3 + 1
    first = model_scan(x[:, :cut], a[:, :cut], h0)
    rest = model_scan(x[:, cut:], a[:, cut:], first[:, -1])
    assert torch.equal(torch.cat([first, rest], 1), whole)


def test_jax_pallas_kernel_equals_model_scan_through_port():
    """The Pallas kernel (interpret mode) and the port's scan agree on the
    JAX test's case (``test_rglru_kernel_matches_model_scan``)."""
    rng = np.random.default_rng(5)
    a = (1 / (1 + np.exp(-rng.standard_normal((2, 20, 16))))) * 0.9 + 0.05
    a = a.astype(np.float32)
    b = rng.standard_normal((2, 20, 16)).astype(np.float32)
    want = np.asarray(jax_rglru_scan(jnp.asarray(a), jnp.asarray(b), block_q=8,
                                     block_w=8, interpret=True))
    got = model_scan(torch.from_numpy(b), torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_cpu_tensors_take_plain_version_without_counting():
    a, b = scan_inputs(9, 2, 5, 40)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    before = rglru_scan_kernel.launches
    got = rglru_scan_kernel(ta, tb)
    assert rglru_scan_kernel.launches == before
    assert torch.equal(got, rglru_scan_plain(ta, tb))
    empty = rglru_scan_kernel(ta[:, :0], tb[:, :0])
    assert empty.shape == (2, 0, 40) and rglru_scan_kernel.launches == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        rglru_scan_kernel(ta.to("meta"), tb.to("meta"))


def test_build_knows_the_rglru_source():
    assert {"paged_attention", "rglru_scan"} <= set(build.sources())
    lib = build.library_path("rglru_scan")
    assert lib.parent == build.BUILD_DIR and lib.name.startswith("rglru_scan.")
    src = (build.CSRC / "rglru_scan.cu").read_text()
    assert "__fadd_rn(__fmul_rn(" in src      # no FMA contraction of the update


def gate_params(rng, nb, Wb):
    """Gate weights as the JAX init draws them (normal / sqrt(Wb)), with
    nonzero biases so both terms of each gate are held."""
    f32 = np.float32
    return {"gate_w_a": (rng.standard_normal((nb, Wb, Wb)) / np.sqrt(Wb)).astype(f32),
            "gate_b_a": (0.1 * rng.standard_normal((nb, Wb))).astype(f32),
            "gate_w_x": (rng.standard_normal((nb, Wb, Wb)) / np.sqrt(Wb)).astype(f32),
            "gate_b_x": (0.1 * rng.standard_normal((nb, Wb))).astype(f32),
            "a_param": rng.standard_normal(nb * Wb).astype(f32)}


GATE_SHAPES = [(1, 1, 4, 8), (2, 23, 4, 8), (1, 64, 10, 16)]   # (B, S, nb, Wb)


@pytest.mark.parametrize("B,S,nb,Wb", GATE_SHAPES)
def test_batched_gate_form_matches_rows_and_jax(B, S, nb, Wb, monkeypatch):
    """The batched block-diagonal product (the card's form) against the
    per-token form (the CPU's) and the JAX einsum, and the whole gate
    computation through the batched form against JAX ``rglru_gates``."""
    rng = np.random.default_rng(1000 * nb + S)
    p = gate_params(rng, nb, Wb)
    x = rng.standard_normal((B, S, nb * Wb)).astype(np.float32)
    xb = torch.from_numpy(x).reshape(B, S, nb, Wb)
    for name in ("gate_w_a", "gate_w_x"):
        w = torch.from_numpy(p[name])
        batched, rows = block_diag_batched(xb, w), block_diag_rows(xb, w)
        assert batched.shape == rows.shape == (B, S, nb, Wb)
        want = np.asarray(jnp.einsum("bskw,kwv->bskv", jnp.asarray(xb.numpy()),
                                     jnp.asarray(p[name])))
        np.testing.assert_allclose(batched.numpy(), rows.numpy(), atol=GATE_TOL, rtol=GATE_TOL)
        np.testing.assert_allclose(batched.numpy(), want, atol=GATE_TOL, rtol=GATE_TOL)
    ja, jg = jax_rglru_gates({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), nb)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    monkeypatch.setattr(torch_rglru, "block_diag_rows", block_diag_batched)
    a, g = torch_rglru.rglru_gates(tp, torch.from_numpy(x), nb)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=GATE_TOL, rtol=GATE_TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=GATE_TOL, rtol=GATE_TOL)


@pytest.mark.parametrize("form", ["batched", "rows"])
def test_gate_forms_weight_copies(form):
    """The batched form copies no gate weight; the per-token form clones the
    (nb, Wb, Wb) weight once per token (its known cost, kept for the CPU's
    bitwise decode == chunked-prefill contract)."""
    from torch.profiler import ProfilerActivity, profile

    B, S, nb, Wb = 1, 12, 4, 8
    rng = np.random.default_rng(7)
    xb = torch.from_numpy(rng.standard_normal((B, S, nb, Wb)).astype(np.float32))
    w = torch.from_numpy(gate_params(rng, nb, Wb)["gate_w_a"])
    fn = block_diag_batched if form == "batched" else block_diag_rows
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        fn(xb, w)
    copied = [int(np.prod(shape)) for e in prof.events() if e.name == "aten::clone"
              for shape in e.input_shapes[:1] if shape]
    weight_copies = max(copied, default=0) // w.numel()
    if form == "batched":
        assert weight_copies == 0, copied
    else:
        assert weight_copies == B * S, copied


GPU_CASES = [(1, 1, 8), (2, 16, 24), (2, 17, 2560), (8, 1, 2560), (1, 29, 24),
             (1, 256, 2560), (2, 33, 10), (1, 100, 2560)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(dtype):
    """Kernel vs plain version on the card: bitwise in fp32 (no FMA, same
    order), and in bf16 too up to the shared final rounding.  L < 32, W = 10
    (rows that are not whole 16-byte chunks) and a and b that start off a
    16-byte boundary take the direct kernel, the rest the staged one, as
    ``launches_by_kernel`` counts; L = 100 ends inside a stage of the
    staged kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for seed, (B, L, W) in enumerate(GPU_CASES):
        a, b = scan_inputs(seed, B, L, W)
        for offset in (0, 1):
            ta, tb = (torch.zeros(offset + t.size, dtype=TDT[dtype], device="cuda")[offset:]
                      .view(B, L, W).copy_(torch.from_numpy(t)) for t in (a, b))
            whole = W * ta.element_size() % 16 == 0
            kernel = "staged" if L >= 32 and whole and not offset else "direct"
            n0, k0 = rglru_scan_kernel.launches, rglru_scan_kernel.launches_by_kernel[kernel]
            got = rglru_scan_kernel(ta, tb)
            want = rglru_scan_plain(ta, tb)
            torch.cuda.synchronize()
            assert rglru_scan_kernel.launches == n0 + 1
            assert rglru_scan_kernel.launches_by_kernel[kernel] == k0 + 1, (B, L, W, offset)
            if dtype == "float32":
                assert torch.equal(got, want), (B, L, W)
            else:
                torch.testing.assert_close(got.float(), want.float(), atol=ATOL[dtype],
                                           rtol=ATOL[dtype])

