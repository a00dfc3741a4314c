"""The MoE layer's backward: the plain backwards of ``kernels/moe_experts/
ref.py`` and ``ops.MoEFFN`` against float64 autograd, ``torch.autograd.
gradcheck`` and ``jax.vjp`` of the JAX package's ``moe_ffn``.

Tolerances, and why:

* A plain backward against float64 autograd of its plain forward, both in
  float64: ``F64_TOL`` (1e-10) of the gradient's largest magnitude; the two
  sum in other orders, nothing else differs.
* ``MoEFFN`` (the plain backwards on the CPU) against ``jax.vjp`` of
  ``repro.models.moe.moe_ffn`` on the same weights, inputs and cotangents,
  bf16 as both frameworks run it: each leaf's gradient within ``VJP_REL``
  (2e-2) of its norm.  Both round each product to bf16, but in other
  orders (about one bf16 step, 2^-8, of an element), and the JAX package
  takes the combine's weight gradient through the bf16 cast of the weights
  and sums it over D in bf16, where the port sums in fp32: the router's
  gradient inherits that (measured at most 0.83% of its norm at these
  sizes, qwen3-moe with capacity factor 0.25; every other leaf 0.6%).
* The CUDA kernels (``gpu``-marked, skipped without a card) against their
  plain versions on the same inputs: the combine's dys and the gather's
  backward bitwise, dweights bitwise (the plain version sums in the
  kernel's order, ``ref.lane_dot``), the grouped products and the route
  backward within ``GROUPED_TOL`` and ``ROUTE_TOL`` of the largest
  magnitude (below), two launches bitwise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels.moe_experts import kernel as mk
from repro_torch.kernels.moe_experts import ops, ref
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe
from repro_torch.models.config import MoEConfig
from repro_torch.weights import params_from_jax

try:    # the card's machine has no JAX: there only the gpu-marked tests run
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import build_model as jax_build_model
    from repro.models import moe as jmoe
except ModuleNotFoundError:
    jax = None

torch.set_num_threads(2)

F64_TOL = 1e-10
VJP_REL = 2e-2
# bf16 outputs of fp32 sums taken in two orders: one bf16 step (2^-8) of the
# largest element where a rounding falls the other way, and the SwiGLU
# epilogue's three chained roundings (dh, dh b, the products) at most 4 steps
GROUPED_TOL = 4 * 2.0 ** -8
# the router's dx (bf16, one rounding: 2 steps) and dw (fp32 sums over T
# tokens in two orders, far below)
ROUTE_TOL = 2 * 2.0 ** -8


def rng_tensor(rng, shape, dtype=torch.float64, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape) * scale).to(dtype)


def route_case(rng, T, E, k, empty=(), one_row=None):
    """Experts (T, k), distinct within a token, expert ``empty`` given no
    pair and ``one_row`` exactly one (token 0's last); the plain sort of
    the pairs."""
    allowed = [e for e in range(E) if e not in empty and e != one_row]
    idx = np.stack([rng.choice(allowed, size=k, replace=False) for _ in range(T)])
    if one_row is not None:
        idx[0, -1] = one_row
    idx = torch.from_numpy(idx.astype(np.int32))
    offsets, order, tok, pos, rank = ref.route_sort_plain(idx, E)
    return idx, offsets, tok, pos, rank


# -- plain backwards against float64 autograd -------------------------------------------


def max_err(a, b):
    return (a - b).abs().max().item()


def assert_close64(got, want):
    assert got.dtype == want.dtype
    assert max_err(got, want) <= F64_TOL * max(want.abs().max().item(), 1.0)


@pytest.mark.parametrize("drops,shared", [(False, False), (True, False), (False, True),
                                          (True, True)])
def test_combine_backward_plain_matches_autograd(drops, shared):
    rng = np.random.default_rng(1)
    T, k, D, E = 7, 3, 40, 5
    idx, offsets, tok, pos, rank = route_case(rng, T, E, k)
    ys = rng_tensor(rng, (T * k, D)).requires_grad_(True)
    weights = torch.from_numpy(rng.random((T, k))).requires_grad_(True)
    kept = torch.from_numpy(rng.random(T * k) > 0.3) if drops else None
    y_s = rng_tensor(rng, (T, D)).requires_grad_(True) if shared else None
    out = ref.moe_combine_plain(ys, pos, weights, kept, y_s)
    dout = rng_tensor(rng, (T, D))
    out.backward(dout)
    dys, dw = ref.moe_combine_backward_plain(dout, ys.detach(), pos, weights.detach(), kept)
    assert_close64(dys, ys.grad)
    assert_close64(dw, weights.grad)
    if shared:
        assert torch.equal(y_s.grad, dout)      # the shared expert's gradient is dout itself


def test_lane_dot_is_the_dot_product_in_its_stated_order():
    rng = np.random.default_rng(2)
    for D in (8, 40, 256, 264, 2048):
        a, b = rng_tensor(rng, (5, D), torch.float32), rng_tensor(rng, (5, D), torch.float32)
        got = ref.lane_dot(a, b)
        want = (a.double() * b.double()).sum(-1)
        assert (got.double() - want).abs().max().item() <= 1e-5 * (a.abs() * b.abs()).sum().item()
        # the stated order, lane by lane, as a loop
        for r in range(5):
            lanes = torch.zeros(32, dtype=torch.float32)
            for c in range(D // 8):
                for i in range(8):
                    lanes[c % 32] = lanes[c % 32] + a[r, 8 * c + i] * b[r, 8 * c + i]
            for m in (16, 8, 4, 2, 1):
                lanes = lanes + lanes[torch.arange(32) ^ m]
            assert torch.equal(got[r], lanes[0])


def test_gather_backward_plain_matches_autograd():
    rng = np.random.default_rng(3)
    T, k, D, E = 9, 2, 16, 4
    idx, offsets, tok, pos, rank = route_case(rng, T, E, k)
    x = rng_tensor(rng, (T, D)).requires_grad_(True)
    dxs, dx_s = rng_tensor(rng, (T * k, D)), rng_tensor(rng, (T, D))
    (x.index_select(0, tok.long()) * dxs).sum().add((x * dx_s).sum()).backward()
    assert_close64(ref.moe_gather_backward_plain(dxs, pos, k, dx_s), x.grad)
    assert torch.equal(ref.moe_gather_backward_plain(dxs, pos, k),
                       ref.moe_combine_plain(dxs, pos, torch.ones(T, k), None, None))


# (mode, shared, empty expert, one-row expert)
EXPERT_CASES = [("swiglu", True, (), None), ("swiglu", False, (1,), 2),
                ("gelu", False, (0,), 3), ("swiglu", True, (2,), 0)]


def expert_inputs(rng, mode, shared, empty, one_row, dtype=torch.float64, T=10, k=2, D=24,
                  F=16, E=4):
    idx, offsets, tok, pos, rank = route_case(rng, T, E, k, empty, one_row)
    x_t = rng_tensor(rng, (T, D), dtype)
    xs = x_t[tok.long()].contiguous()
    w1 = rng_tensor(rng, (E, D, F), dtype, 0.3)
    w2 = rng_tensor(rng, (E, D, F), dtype, 0.3) if mode == "swiglu" else None
    wd = rng_tensor(rng, (E, F, D), dtype, 0.3)
    sh = None
    if shared:
        sh = (x_t, rng_tensor(rng, (D, 2 * F), dtype, 0.3), rng_tensor(rng, (D, 2 * F), dtype, 0.3),
              rng_tensor(rng, (2 * F, D), dtype, 0.3))
    return offsets, xs, w1, w2, wd, sh


@pytest.mark.parametrize("mode,shared,empty,one_row", EXPERT_CASES)
def test_experts_backward_plain_matches_autograd(mode, shared, empty, one_row):
    rng = np.random.default_rng(4)
    offsets, xs, w1, w2, wd, sh = expert_inputs(rng, mode, shared, empty, one_row)
    counts = (offsets[1:] - offsets[:-1]).tolist()
    assert all(counts[e] == 0 for e in empty) and (one_row is None or counts[one_row] == 1)
    for t in (xs, w1, w2, wd, *(sh or ())):
        if t is not None:
            t.requires_grad_(True)
    pre = [torch.empty(xs.shape[0], w1.shape[-1], dtype=xs.dtype),
           None if w2 is None else torch.empty(xs.shape[0], w1.shape[-1], dtype=xs.dtype),
           None, None]
    if sh:
        pre[2:] = [torch.empty(sh[0].shape[0], sh[1].shape[1], dtype=xs.dtype) for _ in range(2)]
    h, h_s = ref.moe_experts_plain(mode, xs, offsets, w1, w2, sh[:3] if sh else None, pre)
    y, y_s = ref.moe_experts_plain("plain", h, offsets, wd,
                                   shared=(h_s, sh[3], None) if sh else None)
    dy = rng_tensor(rng, y.shape)
    dy_s = rng_tensor(rng, y_s.shape) if sh else None
    torch.autograd.backward([y] + ([y_s] if sh else []), [dy] + ([dy_s] if sh else []))
    shared_args = None
    if sh:
        shared_args = (sh[0].detach(), sh[1].detach(), sh[2].detach(), pre[2], pre[3], dy_s,
                       sh[3].detach(), h_s.detach())
    g = ref.moe_experts_backward_plain(mode, xs.detach(), offsets, w1.detach(),
                                       None if w2 is None else w2.detach(), pre[0], pre[1], dy,
                                       wd.detach(), h.detach(), shared_args)
    assert_close64(g.dx, xs.grad)
    assert_close64(g.dw1, w1.grad)
    assert_close64(g.dw_down, wd.grad)
    if w2 is not None:
        assert_close64(g.dw2, w2.grad)
    for e in empty:
        assert not g.dw1[e].any() and not g.dw_down[e].any()
    if sh:
        dx_s, dw1_s, dw2_s, dwd_s = g.shared
        assert_close64(dx_s, sh[0].grad)
        assert_close64(dw1_s, sh[1].grad)
        assert_close64(dw2_s, sh[2].grad)
        assert_close64(dwd_s, sh[3].grad)


def test_pre_activations_are_the_forward_products():
    """The gate/up launch's saved a and b are its bf16 products x.W1 and
    x.W2, and the output is bitwise the same with or without saving them."""
    rng = np.random.default_rng(5)
    offsets, xs, w1, w2, wd, sh = expert_inputs(rng, "swiglu", True, (1,), None, torch.bfloat16)
    pre = [torch.empty(xs.shape[0], w1.shape[-1], dtype=torch.bfloat16),
           torch.empty(xs.shape[0], w1.shape[-1], dtype=torch.bfloat16),
           torch.empty(sh[0].shape[0], sh[1].shape[1], dtype=torch.bfloat16),
           torch.empty(sh[0].shape[0], sh[1].shape[1], dtype=torch.bfloat16)]
    h, h_s = mk.moe_experts_kernel("swiglu", xs, offsets, w1, w2, sh[:3], pre=pre)
    h2, h_s2 = mk.moe_experts_kernel("swiglu", xs, offsets, w1, w2, sh[:3])
    assert torch.equal(h, h2) and torch.equal(h_s, h_s2)
    for e, lo, hi in ref._segments(offsets, w1.shape[0]):
        assert torch.equal(pre[0][lo:hi], ref.row_products(xs[lo:hi], w1[e], torch.bfloat16))
        assert torch.equal(pre[1][lo:hi], ref.row_products(xs[lo:hi], w2[e], torch.bfloat16))
    assert torch.equal(pre[2], ref.row_products(sh[0], sh[1], torch.bfloat16))
    assert torch.equal(torch.nn.functional.silu(pre[0]) * pre[1], h)


@pytest.mark.parametrize("forced_small_sum", [False, True])
def test_route_backward_plain_matches_autograd(forced_small_sum):
    """The routing's plain backward against autograd of ``moe_route_plain``
    (float64); with forced experts at tiny gates the renormalisation's sum
    falls below 1e-9 for some tokens (the clamp's branch)."""
    rng = np.random.default_rng(6)
    T, D, E, k = 11, 20, 6, 3
    x = rng_tensor(rng, (T, D)).requires_grad_(True)
    w = rng_tensor(rng, (D, E), scale=0.5 if not forced_small_sum else 8.0).requires_grad_(True)
    forced = None
    if forced_small_sum:
        logits = (x @ w).detach()
        forced = torch.argsort(logits, dim=-1)[:, :k].to(torch.int32)   # the k smallest gates
    r = ref.moe_route_plain(x, w, k, forced)
    if forced_small_sum:
        assert (ref._sum_in_order(r.gates.gather(1, r.idx.long())) < 1e-9).any()
    dwt, dg = rng_tensor(rng, (T, k)), rng_tensor(rng, (T, E))
    torch.autograd.backward([r.weights, r.gates], [dwt, dg])
    dx, dw = ref.moe_route_backward_plain(x.detach(), w.detach(), r.gates.detach(),
                                          r.weights.detach(), r.idx, dwt, dg)
    assert_close64(dx, x.grad)
    assert_close64(dw, w.grad)
    x.grad = w.grad = None
    r = ref.moe_route_plain(x, w, k, forced)
    r.weights.backward(dwt)       # no gradient on the gates: dgates None
    dx, dw = ref.moe_route_backward_plain(x.detach(), w.detach(), r.gates.detach(),
                                          r.weights.detach(), r.idx, dwt, None)
    assert_close64(dx, x.grad)
    assert_close64(dw, w.grad)


# -- MoEFFN: gradcheck, the dispatch, drops -----------------------------------------------


def ffn_leaves(rng, mlp, shared, T=6, D=16, E=4, F=8, dtype=torch.float64):
    x = rng_tensor(rng, (T, D), dtype)
    w_r = rng_tensor(rng, (D, E), dtype)
    exp = {"w_up": rng_tensor(rng, (E, D, F), dtype, 0.4),
           "w_down": rng_tensor(rng, (E, F, D), dtype, 0.4)}
    if mlp == "swiglu":
        exp["w_gate"] = rng_tensor(rng, (E, D, F), dtype, 0.4)
    sh = None
    if shared:
        sh = {"w_gate": rng_tensor(rng, (D, 2 * F), dtype, 0.4),
              "w_up": rng_tensor(rng, (D, 2 * F), dtype, 0.4),
              "w_down": rng_tensor(rng, (2 * F, D), dtype, 0.4)}
    return x, w_r, exp, sh


@pytest.mark.parametrize("mlp,shared,cap", [("swiglu", True, None), ("swiglu", True, 2),
                                            ("gelu", False, None), ("gelu", False, 2)])
def test_moe_ffn_function_gradcheck(mlp, shared, cap):
    """``torch.autograd.gradcheck`` of MoEFFN in float64: every input's
    gradient (x, the router, every expert and shared weight) and both
    differentiable outputs (out and the gates)."""
    rng = np.random.default_rng(7)
    x, w_r, exp, sh = ffn_leaves(rng, mlp, shared)
    names = [n for n in ("w_gate", "w_up", "w_down") if n in exp]
    sh_names = [] if sh is None else ["w_gate", "w_up", "w_down"]
    k = 2

    def fn(x, w_r, *ws):
        e = dict(zip(names, ws[:len(names)]))
        s = dict(zip(sh_names, ws[len(names):])) or None
        out, gates, _ = ops.moe_layer(mlp, x, w_r, e, s, k, cap)
        return out, gates

    leaves = [x, w_r] + [exp[n] for n in names] + [sh[n] for n in sh_names]
    leaves = [t.requires_grad_(True) for t in leaves]
    assert torch.autograd.gradcheck(fn, leaves, eps=1e-6, atol=1e-7, rtol=1e-5, fast_mode=True)


def test_dropped_pair_gets_no_gradient():
    """With capacity dropping, a dropped pair's row of dys is zero, its
    dweight is zero, and its expert's weight gradients take nothing from it
    (changing the pair's rows of x and h changes no dW)."""
    rng = np.random.default_rng(8)
    T, k, D, E, F = 12, 2, 16, 3, 8
    idx, offsets, tok, pos, rank = route_case(rng, T, E, k)
    kept = rank < 2
    assert (~kept).any()
    ys = rng_tensor(rng, (T * k, D))
    weights = torch.from_numpy(rng.random((T, k)))
    dout = rng_tensor(rng, (T, D))
    dys, dwt = ref.moe_combine_backward_plain(dout, ys, pos, weights, kept)
    drop_rows = pos[~kept].long()
    assert not dys[drop_rows].any() and not dwt.reshape(-1)[~kept].any()
    xs = rng_tensor(rng, (T * k, D))
    w1, w2 = rng_tensor(rng, (E, D, F)), rng_tensor(rng, (E, D, F))
    wd = rng_tensor(rng, (E, F, D))
    a, b, h = rng_tensor(rng, (T * k, F)), rng_tensor(rng, (T * k, F)), rng_tensor(rng, (T * k, F))
    g = ref.moe_experts_backward_plain("swiglu", xs, offsets, w1, w2, a, b, dys, wd, h)
    assert not g.dx[drop_rows].any()
    xs2, h2, a2, b2 = xs.clone(), h.clone(), a.clone(), b.clone()
    for t in (xs2, h2, a2, b2):
        t[drop_rows] = rng_tensor(rng, (len(drop_rows), t.shape[1]))
    g2 = ref.moe_experts_backward_plain("swiglu", xs2, offsets, w1, w2, a2, b2, dys, wd, h2)
    for n in ("dw1", "dw2", "dw_down"):
        assert torch.equal(getattr(g, n), getattr(g2, n)), n


def test_moe_ffn_takes_moeffn_only_under_grad(monkeypatch):
    """Under grad (a model built for training) moe_ffn runs MoEFFN, whose
    output is bitwise the serving path's; without grad it never does."""
    cfg = configs.get("moonshot-v1-16b-a3b").reduced()
    tm = build_model(cfg, device="cpu", seed=3, train=True)
    p = tm.layers[1].moe
    x = torch.randn(2, 7, cfg.d_model, generator=torch.Generator().manual_seed(3)).bfloat16()
    calls = []
    orig = ops.MoEFFN.apply
    monkeypatch.setattr(ops.MoEFFN, "apply", lambda *a: calls.append(1) or orig(*a))
    with torch.no_grad():
        want, aux_want = tmoe.moe_ffn(p, cfg, x, no_drop=False)
    assert not calls
    got, aux = tmoe.moe_ffn(p, cfg, x, no_drop=False)
    assert calls == [1] and got.requires_grad and aux.requires_grad
    assert torch.equal(got, want) and torch.equal(aux, aux_want)


def test_moe_train_model_gives_every_leaf_a_gradient():
    cfg = configs.get("moonshot-v1-16b-a3b").reduced()
    tm = build_model(cfg, device="cpu", seed=4, train=True)
    tokens = torch.randint(0, cfg.vocab, (2, 12), generator=torch.Generator().manual_seed(4))
    logits, aux = tm.loss_aux({"tokens": tokens})
    (logits.float().logsumexp(-1).mean() + aux).backward()
    missing = [n for n, q in tm.named_parameters() if q.grad is None]
    assert not missing, missing


def _data_grad_call(which, P, R, shared, E=4, D=16, F=8, Fs=16):
    meta = dict(dtype=torch.bfloat16, device="meta")
    offsets = torch.empty(E + 1, dtype=torch.int32, device="meta")
    if which == "down":
        sh = (torch.empty(R, D, **meta), torch.empty(Fs, D, **meta), torch.empty(R, Fs, **meta),
              torch.empty(R, Fs, **meta)) if shared else None
        mk.moe_down_grad_kernel("swiglu", torch.empty(P, D, **meta), offsets,
                                torch.empty(E, F, D, **meta), torch.empty(P, F, **meta),
                                torch.empty(P, F, **meta), sh)
    else:
        sh = (torch.empty(R, Fs, **meta), torch.empty(R, Fs, **meta), torch.empty(D, Fs, **meta),
              torch.empty(D, Fs, **meta)) if shared else None
        mk.moe_up_grad_kernel(torch.empty(P, F, **meta), torch.empty(P, F, **meta), offsets,
                              torch.empty(E, D, F, **meta), torch.empty(E, D, F, **meta), sh)


@pytest.mark.parametrize("which", ["down", "up"])
@pytest.mark.parametrize("P,R,shared,launched", [(0, 0, False, 0), (0, 0, True, 0),
                                                 (5, 0, False, 1), (0, 3, True, 1),
                                                 (5, 3, True, 1)])
def test_data_grad_wrappers_count_only_their_launches(which, P, R, shared, launched,
                                                      monkeypatch):
    """``moe_down_grad_kernel`` and ``moe_up_grad_kernel`` add one to their
    count where they launch and nowhere else: a call with no rows (P = 0
    and no shared rows) launches nothing and leaves the count as it was;
    a call with rows in either group launches once and counts one.  The
    wrapper's card path runs on meta tensors with the launch replaced by a
    recorder, so no card is needed."""
    launches = []
    monkeypatch.setattr(mk, "_on_card", lambda name, t: None)
    monkeypatch.setattr(mk, "_data_grad_launch",
                        lambda epi, groups, dev: launches.append([g[9] for g in groups]))
    fn = mk.moe_down_grad_kernel if which == "down" else mk.moe_up_grad_kernel
    monkeypatch.setattr(fn, "launches", 7)
    _data_grad_call(which, P, R, shared)
    assert len(launches) == launched and fn.launches == 7 + launched
    if launched:    # the routed group, and the shared group where it has rows
        assert launches[0] == [P] + ([R] if R else [])


def test_data_grad_wrappers_refuse_a_shared_expert_beside_gelu():
    """No configuration has a shared expert beside GELU experts, and the
    forward (``expert_ffn``) refuses one: so do the two data-gradient
    wrappers, on the CPU as on the card."""
    T, E, D, F = 4, 2, 8, 8
    t = torch.zeros
    offsets = torch.tensor([0, 2, 4], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="shared expert beside GELU"):
        mk.moe_down_grad_kernel("gelu", t(T, D), offsets, t(E, F, D), t(T, F), None,
                                (t(T, D), t(F, D), t(T, F), None))
    with pytest.raises(NotImplementedError, match="shared expert beside GELU"):
        mk.moe_up_grad_kernel(t(T, F), None, offsets, t(E, D, F), None,
                              (t(T, F), None, t(D, F), None))


# -- against jax.vjp of the JAX package's moe_ffn --------------------------------------

VJP_CASES = [  # (arch, overrides, no_drop)
    ("moonshot-v1-16b-a3b", {}, True), ("moonshot-v1-16b-a3b", {"cf": 0.5}, False),
    ("moonshot-v1-16b-a3b", {"cf": 1.25}, False), ("qwen3-moe-235b-a22b", {"cf": 0.25}, False),
    ("qwen3-moe-235b-a22b", {"mlp": "gelu"}, True),
    ("qwen3-moe-235b-a22b", {"mlp": "gelu", "cf": 0.5}, False),
]


def jax_and_port_train(arch, **over):
    jcfg = dataclasses.replace(jconfigs.get(arch).reduced(), **over)
    tcfg = dataclasses.replace(configs.get(arch).reduced(), **over)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.key(0))
    tm = build_model(tcfg, device="cpu", train=True)
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu",
                                       master=True))
    return jm, jp, tm


@pytest.mark.parametrize("arch,over,no_drop", VJP_CASES,
                         ids=[f"{a}-{o}-nodrop{n}" for a, o, n in VJP_CASES])
def test_moe_ffn_gradients_match_jax_vjp(arch, over, no_drop):
    """The gradients of out and aux (cotangents from a seed) with respect to
    x, the router and every expert and shared leaf, one layer, against
    ``jax.vjp`` of ``repro.models.moe.moe_ffn`` on the same weights."""
    over = dict(over)
    kw = {}
    if "cf" in over:
        m = configs.get(arch).reduced().moe
        kw["moe"] = MoEConfig(n_experts=m.n_experts, top_k=m.top_k, d_expert=m.d_expert,
                              capacity_factor=over.pop("cf"))
    kw.update(over)
    jm, jp, tm = jax_and_port_train(arch, **kw)
    cfg = tm.cfg
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    dout = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    daux = np.float32(0.75)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    doj = jnp.asarray(dout).astype(jnp.bfloat16)
    layer = 1
    pj = jax.tree_util.tree_map(lambda a: a[layer], jp["layers"]["moe"])
    (_, aux_j), vjp = jax.vjp(lambda p, x: jmoe.moe_ffn(p, jm.cfg, x, no_drop=no_drop), pj, xj)
    gp_j, gx_j = vjp((doj, jnp.asarray(daux)))
    p = tm.layers[layer].moe
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).bfloat16().requires_grad_(True)
    out, aux = tmoe.moe_ffn(p, cfg, xt, no_drop=no_drop)
    torch.autograd.backward([out, aux], [torch.from_numpy(np.asarray(doj.astype(jnp.float32)))
                                         .bfloat16(), torch.tensor(daux)])
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=1e-3)
    pairs = [("x", xt.grad, gx_j)]
    for name, q in p.named_parameters():
        group, leaf = name.split(".")
        pairs.append((name, q.grad, gp_j[group][leaf]))
    for name, got, want in pairs:
        want = np.asarray(jnp.asarray(want).astype(jnp.float32))
        got = got.float().numpy()
        err = np.linalg.norm(got - want)
        assert err <= VJP_REL * np.linalg.norm(want), (name, err, np.linalg.norm(want))


# -- on the card ------------------------------------------------------------------------


def cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max() /
            want.float().abs().max().clamp_min(1e-30)).item()


def card_route(T, E, k, seed, drops):
    rng = np.random.default_rng(seed)
    idx, offsets, tok, pos, rank = route_case(rng, T, E, k)
    kept = (rank < max(1, (T * k) // (2 * E))) if drops else None
    return rng, idx, offsets, tok, pos, kept


@pytest.mark.gpu
@pytest.mark.parametrize("T,E,k,D,F,shared,mode,drops", [
    (37, 8, 2, 64, 48, True, "swiglu", True), (1, 4, 2, 128, 64, False, "gelu", False),
    (300, 64, 6, 256, 176, True, "swiglu", False), (96, 16, 4, 136, 40, False, "swiglu", True)])
def test_cuda_backward_kernels_match_plain(T, E, k, D, F, shared, mode, drops):
    """Each backward kernel against its plain version on the same inputs,
    and twice bitwise: combine (dys, dweights) and the gather's backward
    bitwise; the grouped products within GROUPED_TOL; the route backward
    within ROUTE_TOL."""
    cuda_or_skip()
    dev = torch.device("cuda")
    rng, idx, offsets, tok, pos, kept = card_route(T, E, k, T, drops)
    P = T * k

    def t(shape, dtype=torch.bfloat16, scale=1.0):
        return rng_tensor(rng, shape, torch.float32, scale).to(dtype).to(dev)

    offsets, pos, idx = offsets.to(dev), pos.to(dev), idx.to(dev)
    kept = None if kept is None else kept.to(dev)
    ys, dout, weights = t((P, D)), t((T, D)), t((T, k), torch.float32).abs()
    for _ in range(2):
        got = mk.moe_combine_backward_kernel(dout, ys, pos, weights, kept)
    again = mk.moe_combine_backward_kernel(dout, ys, pos, weights, kept)
    want = ref.moe_combine_backward_plain(dout, ys, pos, weights, kept)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a) and torch.equal(g, w)
    dxs, dx_s = t((P, D)), t((T, D))
    ones = torch.ones(T, k, device=dev)
    g1 = mk.moe_combine_kernel(dxs, pos, ones, None, dx_s)
    assert torch.equal(g1, ref.moe_gather_backward_plain(dxs, pos, k, dx_s))
    w_down, a = t((E, F, D), scale=0.1), t((P, F))
    b = t((P, F)) if mode == "swiglu" else None
    sh = (dout, t((2 * F, D), scale=0.1), t((T, 2 * F)),
          t((T, 2 * F)) if mode == "swiglu" else None) if shared else None
    got = mk.moe_down_grad_kernel(mode, ys, offsets, w_down, a, b, sh)
    again = mk.moe_down_grad_kernel(mode, ys, offsets, w_down, a, b, sh)
    want = ref.moe_down_grad_plain(mode, ys, offsets, w_down, a, b, sh)
    flat = lambda r: [x for x in (r[0], r[1], *(r[2] or ())) if x is not None]  # noqa: E731
    for g, a_, w in zip(flat(got), flat(again), flat(want)):
        assert torch.equal(g, a_) and rel(g, w) <= GROUPED_TOL
    w1, w2 = t((E, D, F), scale=0.1), (t((E, D, F), scale=0.1) if mode == "swiglu" else None)
    da, db = t((P, F)), (t((P, F)) if mode == "swiglu" else None)
    got = mk.moe_up_grad_kernel(da, db, offsets, w1, w2)
    want = ref.moe_up_grad_plain(da, db, offsets, w1, w2)
    assert torch.equal(got[0], mk.moe_up_grad_kernel(da, db, offsets, w1, w2)[0])
    assert rel(got[0], want[0]) <= GROUPED_TOL
    jobs = [(t((P, D)), t((P, F)), offsets), (t((T, D)), t((T, F)), None)]
    got = mk.moe_weight_grad_kernel(jobs)
    again = mk.moe_weight_grad_kernel(jobs)
    for g, a_, (x, y, off) in zip(got, again, jobs):
        assert torch.equal(g, a_) and rel(g, ref.moe_weight_grad_plain(x, y, off)) <= GROUPED_TOL
    x, w = t((T, D)), t((D, E), torch.float32, 0.1)
    r = ref.moe_route_plain(x, w, k)
    dwt, dg = t((T, k), torch.float32), t((T, E), torch.float32)
    got = mk.moe_route_backward_kernel(x, w, r.gates, r.weights, r.idx, dwt, dg)
    again = mk.moe_route_backward_kernel(x, w, r.gates, r.weights, r.idx, dwt, dg)
    want = ref.moe_route_backward_plain(x, w, r.gates, r.weights, r.idx, dwt, dg)
    for g, a_, w_ in zip(got, again, want):
        assert torch.equal(g, a_) and rel(g, w_) <= ROUTE_TOL
