"""The MoE layer's routing and combine: plain versions against the JAX
package's routing, rank and sort, and the CUDA kernels against them.

On the CPU the wrappers take the plain versions (``kernels/moe_experts/
ref.py``), the torch sequence ``moe_ffn`` ran before the two kernels
existed.  Against the JAX routing (``src/repro/models/moe.py::moe_ffn``:
fp32 einsum, ``jax.nn.softmax``, ``jax.lax.top_k``, the renormalisation)
on the same numpy inputs: the experts equal, ties to the lower index, the
weights within 1e-6 (the two sides sum the product in different orders,
about 1e-7 of a gate).  The sort against ``jmoe._rank_within_expert`` and
numpy's stable argsort, exactly; the combine bitwise the old sequence.

The CUDA kernels run only on a card: their tests skip here, and on the
card (which has no JAX) they run alone with ``pytest -m gpu``.  There the
kernel's product sums in another order than the fp32 matmul (its logits
are held within 1e-5 of the fp64 product) and its softmax rounds otherwise
than ``torch.softmax``, so an expert may differ only where the plain
gates' k-th and (k+1)-th lie within 1e-6, and the weights are held within
1e-6 relative of the plain routing of the kernel's own logits.
"""

from __future__ import annotations

import gc

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels.moe_experts import (moe_combine_kernel, moe_combine_plain,
                                             moe_route_kernel, moe_route_plain,
                                             route_logits_plain, route_sort_plain)
from repro_torch.kernels.moe_experts import ops as moe_ops
from repro_torch.kernels.moe_experts.ref import _sum_in_order
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe

try:    # the card's machine has no JAX: there only the gpu-marked tests run
    import jax
    import jax.numpy as jnp

    from repro.models import moe as jmoe
except ModuleNotFoundError:
    jax = None

torch.set_num_threads(2)

WEIGHT_TOL = 1e-6
TIE_GAP = 1e-6


def router_inputs(seed: int, T: int, D: int, E: int):
    """x (T, D) bf16 and w (D, E) fp32 as numpy float32 (x already bf16
    values), w scaled as the model draws it."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((T, D), dtype=np.float32)).bfloat16()
    w = rng.standard_normal((D, E), dtype=np.float32) / np.sqrt(D)
    return x.float().numpy(), w


def jax_routing(x: np.ndarray, w: np.ndarray, k: int):
    """The JAX package's routing (``moe_ffn``'s first four lines)."""
    logits = jnp.einsum("td,de->te", jnp.asarray(x), jnp.asarray(w))
    gates = jax.nn.softmax(logits, axis=-1)
    weights, idx = jax.lax.top_k(gates, k)
    weights = weights / jnp.clip(weights.sum(-1, keepdims=True), 1e-9)
    return np.asarray(gates), np.asarray(weights), np.asarray(idx)


ROUTE_CASES = [(16, 64, 8, 2), (37, 256, 64, 6), (24, 128, 128, 8), (5, 64, 4, 4)]


@pytest.mark.parametrize("T,D,E,k", ROUTE_CASES)
def test_route_plain_matches_jax_routing(T, D, E, k):
    x, w = router_inputs(T + E, T, D, E)
    route = moe_route_plain(torch.from_numpy(x).bfloat16(), torch.from_numpy(w), k)
    gates, weights, idx = jax_routing(x, w, k)
    np.testing.assert_array_equal(route.idx.numpy(), idx)
    np.testing.assert_allclose(route.weights.numpy(), weights, atol=WEIGHT_TOL, rtol=0)
    np.testing.assert_allclose(route.gates.numpy(), gates, atol=WEIGHT_TOL, rtol=0)
    assert route.idx.dtype == torch.int32 and route.weights.dtype == torch.float32
    # the wrapper takes the plain version for CPU tensors
    again = moe_route_kernel(torch.from_numpy(x).bfloat16(), torch.from_numpy(w), k)
    assert all(torch.equal(a, b) for a, b in zip(again, route))
    assert moe_route_kernel.launches == 0


def test_route_breaks_ties_to_the_lower_index():
    """Every gate of a row tied, and ties among the top gates: the lower
    expert first, as ``jax.lax.top_k`` picks."""
    D, E, k = 64, 8, 3
    x = np.ones((3, D), np.float32)
    w = np.zeros((D, E), np.float32)
    w[:, 5] = w[:, 6] = 0.01                     # rows 1-2: experts 5 and 6 tie on top
    x[0] = 0.0                                   # row 0: every logit 0
    route = moe_route_plain(torch.from_numpy(x).bfloat16(), torch.from_numpy(w), k)
    _, weights, idx = jax_routing(x, w, k)
    assert route.idx[0].tolist() == [0, 1, 2]
    assert route.idx[1].tolist() == [5, 6, 0]
    np.testing.assert_array_equal(route.idx.numpy(), idx)
    np.testing.assert_allclose(route.weights.numpy(), weights, atol=WEIGHT_TOL, rtol=0)


def random_experts(seed: int, T: int, E: int, k: int) -> torch.Tensor:
    """(T, k) int32: k distinct experts a token, uniform."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.argsort(rng.random((T, E)), axis=-1)[:, :k].astype(np.int32))


# (T, E, k): P = 48, 1536 and 24576 pairs at moonshot's 64 experts top-6,
# and qwen3-moe's 128 top-8
SORT_CASES = [(8, 64, 6), (256, 64, 6), (4096, 64, 6), (64, 128, 8), (700, 128, 8)]


@pytest.mark.parametrize("T,E,k", SORT_CASES)
def test_sort_matches_jax_rank_and_numpy_argsort(T, E, k):
    idx = random_experts(T, T, E, k)
    if T == 700:
        idx[::3] = idx[0]                        # a hot set of experts
    offsets, order, tok, pos, rank = route_sort_plain(idx, E)
    e = idx.reshape(-1).numpy()
    want_order = np.argsort(e, kind="stable")
    np.testing.assert_array_equal(order.numpy(), want_order)
    np.testing.assert_array_equal(offsets.numpy(),
                                  np.searchsorted(e[want_order], np.arange(E + 1), side="left"))
    np.testing.assert_array_equal(tok.numpy(), want_order // k)
    np.testing.assert_array_equal(pos.numpy()[want_order], np.arange(T * k))
    np.testing.assert_array_equal(rank.numpy(), np.asarray(jmoe._rank_within_expert(
        jnp.asarray(e), E)))
    np.testing.assert_array_equal(rank.numpy(), pos.numpy() - offsets.numpy()[e])
    assert all(t.dtype == torch.int32 for t in (offsets, order, tok, pos, rank))


def old_combine(ys, order, weights, kept, y_shared):
    """``moe_ffn``'s combine as it stood before the combine kernel: back to
    pair order by ``index_copy``, the mask, the bf16 product, the in-order
    fp32 sum, the cast, the shared expert's add."""
    T, k = weights.shape
    picked = torch.empty_like(ys).index_copy_(0, order.long(), ys)
    if kept is not None:
        picked = torch.where(kept[:, None], picked, torch.zeros((), dtype=picked.dtype))
    picked = picked * weights.reshape(-1)[:, None].to(ys.dtype)
    out = _sum_in_order(picked.reshape(T, k, -1)).to(ys.dtype)
    return out if y_shared is None else out + y_shared


@pytest.mark.parametrize("drops,shared", [(False, False), (False, True), (True, False),
                                          (True, True)])
def test_combine_plain_is_bitwise_the_old_sequence(drops, shared):
    T, E, k, D = 37, 16, 4, 64
    gen = torch.Generator().manual_seed(7)
    idx = random_experts(9, T, E, k)
    _, order, _, pos, rank = route_sort_plain(idx, E)
    ys = torch.randn(T * k, D, generator=gen).bfloat16()
    weights = torch.softmax(torch.randn(T, k, generator=gen), -1)
    kept = rank < 5 if drops else None
    y_shared = torch.randn(T, D, generator=gen).bfloat16() if shared else None
    got = moe_combine_plain(ys, pos, weights, kept, y_shared)
    assert got.shape == (T, D) and got.dtype == torch.bfloat16
    assert torch.equal(got, old_combine(ys, order, weights, kept, y_shared))
    assert torch.equal(moe_combine_kernel(ys, pos, weights, kept, y_shared), got)
    if drops:
        assert not bool(kept.all())
    assert moe_combine_kernel.launches == 0


def test_forced_route_takes_the_gates_at_the_forced_experts():
    T, D, E, k = 12, 64, 16, 3
    x, w = router_inputs(3, T, D, E)
    xt, wt = torch.from_numpy(x).bfloat16(), torch.from_numpy(w)
    free = moe_route_plain(xt, wt, k)
    same = moe_route_plain(xt, wt, k, forced=free.idx)
    assert all(torch.equal(a, b) for a, b in zip(same, free))
    forced = random_experts(4, T, E, k)
    route = moe_route_plain(xt, wt, k, forced=forced)
    assert torch.equal(route.idx, forced)
    picked = free.gates.gather(-1, forced.long())
    torch.testing.assert_close(route.weights, picked / picked.sum(-1, keepdim=True),
                               atol=1e-7, rtol=0)
    assert torch.equal(route.offsets, route_sort_plain(forced, E)[0])


def test_switch_aux_is_the_index_add_form():
    """The aux loss from the route's offsets is bitwise the count of each
    expert's pairs by ``index_add`` (the form before the route kernel)."""
    T, E, k = 40, 16, 4
    gates = torch.softmax(torch.randn(T, E, generator=torch.Generator().manual_seed(1)), -1)
    idx = random_experts(5, T, E, k)
    offsets = route_sort_plain(idx, E)[0]
    counts = torch.zeros(E).index_add_(0, idx.reshape(-1).long(), torch.ones(T * k))
    want = E * torch.sum(counts / (T * k) * gates.mean(dim=0))
    assert torch.equal(tmoe.switch_aux(gates, offsets, k), want)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b"])
def test_moe_ffn_is_route_gather_experts_combine(arch, monkeypatch):
    """``moe_ffn`` makes one route call and one combine call (and the
    capacity mask from the route's ranks); decode steps ask for no aux."""
    cfg = configs.get(arch).reduced()
    tm = build_model(cfg, device="cpu", seed=1)
    calls = {"route": 0, "combine": 0}

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(moe_ops, "route", counted("route", moe_ops.route))
    monkeypatch.setattr(moe_ops, "combine", counted("combine", moe_ops.combine))
    x = torch.randn(2, 6, cfg.d_model, generator=torch.Generator().manual_seed(2)).bfloat16()
    p = tm.layers[0].moe
    out, aux = tmoe.moe_ffn(p, cfg, x, no_drop=False)
    assert calls == {"route": 1, "combine": 1} and aux.dtype == torch.float32
    same, none = tmoe.moe_ffn(p, cfg, x, no_drop=False, with_aux=False)
    assert none is None and torch.equal(same, out)
    aux_seen = []
    orig = tmoe.moe_ffn

    def spy(*a, **kw):
        aux_seen.append(kw.get("with_aux", True))
        return orig(*a, **kw)

    monkeypatch.setattr(tmoe, "moe_ffn", spy)
    from repro_torch.models import kvcache
    cache = kvcache.paged_cache(tm, 1, page_size=4, n_pages=4, max_pages=4)
    cache["page_table"][0] = torch.arange(4, dtype=torch.int32)
    tm.decode_step(cache, torch.zeros(1, 5, dtype=torch.int32))
    assert aux_seen == [False] * cfg.n_layers


# -- on the card --------------------------------------------------------------------


def cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def near_tie_rows(gates: torch.Tensor, k: int) -> torch.Tensor:
    """Rows whose k-th and (k+1)-th largest gates lie within TIE_GAP."""
    if k >= gates.shape[1]:
        return torch.zeros(gates.shape[0], dtype=torch.bool, device=gates.device)
    top = torch.sort(gates, dim=-1, descending=True)[0]
    return (top[:, k - 1] - top[:, k]) <= TIE_GAP


def check_route(got, want, x, w, k) -> None:
    """Kernel against plain: logits within 1e-5 of the fp64 product; the
    experts equal to the plain version's outside near-ties, and to the
    plain routing of the kernel's own logits outside theirs, the weights
    within 1e-6 relative of the latter's where the experts agree; the sort
    exactly the plain argsort's of the kernel's own experts."""
    ref = x.double() @ w.double()
    assert (got.logits.double() - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    assert bool(((got.idx == want.idx).all(-1) | near_tie_rows(want.gates, k)).all())
    own = route_logits_plain(got.logits, k)
    same = (got.idx == own.idx).all(-1)
    assert bool((same | near_tie_rows(own.gates, k)).all())
    err = (got.weights - own.weights).abs()[same]
    assert bool((err <= WEIGHT_TOL * own.weights[same]).all())
    for a, b in zip(got[4:], route_sort_plain(got.idx, w.shape[1])):
        assert torch.equal(a, b)


# moonshot's decode, chunk and ring prefill; qwen3-moe's widths; 8192 tokens
# (the sort scatters to device memory: `order` outgrows shared memory); E
# not a multiple of 4 (w staged by 4-byte copies) and a tiny E
CUDA_ROUTE_CASES = [(1, 2048, 64, 6), (8, 2048, 64, 6), (37, 4096, 128, 8),
                    (256, 2048, 64, 6), (4096, 2048, 64, 6), (8192, 2048, 64, 6),
                    (33, 512, 10, 3), (40, 256, 4, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("T,D,E,k", CUDA_ROUTE_CASES)
def test_cuda_route_matches_plain(T, D, E, k):
    cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(T + E)
    x = torch.randn(T, D, generator=gen, device="cuda").bfloat16()
    w = torch.randn(D, E, generator=gen, device="cuda") * D ** -0.5
    before = moe_route_kernel.launches
    got = moe_route_kernel(x, w, k)
    want = moe_route_plain(x, w, k)
    torch.cuda.synchronize()
    assert moe_route_kernel.launches == before + 1
    check_route(got, want, x, w, k)
    one = moe_route_kernel(x[T - 1:T].contiguous(), w, k)
    for a, b in zip(one[:4], got[:4]):
        assert torch.equal(a[0], b[T - 1])


@pytest.mark.gpu
def test_cuda_route_ties_and_forced():
    """Every token tied (a zero router): experts 0..k-1, weights 1/k; then
    forced experts, taken at their gates and renormalised."""
    cuda_or_skip()
    T, D, E, k = 300, 2048, 64, 6
    x = torch.randn(T, D, device="cuda").bfloat16()
    tied = moe_route_kernel(x, torch.zeros(D, E, device="cuda"), k)
    assert bool((tied.idx == torch.arange(k, device="cuda", dtype=torch.int32)).all())
    assert torch.equal(tied.weights, moe_route_plain(x, torch.zeros(D, E, device="cuda"),
                                                     k).weights)
    w = torch.randn(D, E, device="cuda") * D ** -0.5
    forced = random_experts(1, T, E, k).cuda()
    got = moe_route_kernel(x, w, k, forced=forced)
    assert torch.equal(got.idx, forced)
    picked = got.gates.gather(-1, forced.long())
    torch.testing.assert_close(got.weights, picked / picked.sum(-1, keepdim=True),
                               atol=1e-6, rtol=0)
    for a, b in zip(got[4:], route_sort_plain(forced, E)):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("drops,shared", [(False, False), (False, True), (True, True)])
def test_cuda_combine_is_bitwise_plain(drops, shared):
    cuda_or_skip()
    T, E, k, D = 256, 64, 6, 2048
    gen = torch.Generator(device="cuda").manual_seed(11)
    idx = random_experts(2, T, E, k).cuda()
    _, _, _, pos, rank = route_sort_plain(idx, E)
    ys = torch.randn(T * k, D, generator=gen, device="cuda").bfloat16()
    weights = torch.softmax(torch.randn(T, k, generator=gen, device="cuda"), -1)
    kept = rank < 20 if drops else None
    y_shared = torch.randn(T, D, generator=gen, device="cuda").bfloat16() if shared else None
    before = moe_combine_kernel.launches
    got = moe_combine_kernel(ys, pos, weights, kept, y_shared)
    torch.cuda.synchronize()
    assert moe_combine_kernel.launches == before + 1
    assert torch.equal(got, moe_combine_plain(ys, pos, weights, kept, y_shared))


@pytest.mark.gpu
@pytest.mark.parametrize("T", [8, 256])
def test_cuda_route_and_combine_replay_bitwise_twice(T):
    """Route and combine captured in one CUDA graph: two replays in a row
    (the counters left at 0 by the first) bitwise the eager launches."""
    cuda_or_skip()
    D, E, k = 2048, 64, 6
    gen = torch.Generator(device="cuda").manual_seed(T)
    x = torch.randn(T, D, generator=gen, device="cuda").bfloat16()
    w = torch.randn(D, E, generator=gen, device="cuda") * D ** -0.5
    ys = torch.randn(T * k, D, generator=gen, device="cuda").bfloat16()
    ysh = torch.randn(T, D, generator=gen, device="cuda").bfloat16()

    def layer():
        r = moe_route_kernel(x, w, k)
        return r, moe_combine_kernel(ys, r.pos, r.weights, None, ysh)

    eager = layer()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        layer()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    gc.collect()        # no garbage CUDAGraph freed (and destroyed) mid-capture
    with torch.cuda.graph(graph):
        captured = layer()
    for _ in range(2):
        for t in (*captured[0], captured[1]):
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(captured[0], eager[0]))
        assert torch.equal(captured[1], eager[1])
