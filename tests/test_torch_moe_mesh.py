"""The MoE layer on an expert shard (``moe_ffn`` under a mesh policy), in one
process, against the port's ``mesh=None`` layer and the JAX ``moe_ffn``.

Each rank of a ``model`` group of m ranks holds E/m experts
(``ExpertShard``), routes all T tokens, runs its experts' segment of the
sorted pairs and combines them into an fp32 partial; the partials' SUM
over ``model`` is cast once, then the shared expert's rows are added.  Here
the m ranks are threads (the all-reduce a barrier, the partials summed in
rank order) and the plain in-process form is ``ref.moe_shards_plain``:

* at m = 1 the layer is bitwise the ``mesh=None`` layer; at m = 2 and 4 the
  routed sum (after the cast, before the shared rows) is within one bf16
  ulp of ``mesh=None``'s at every element, and the output within one ulp
  of the routed sum plus one ulp of the output; top-6 of 8 experts makes
  the partials reassociate (top-2, as the reduced configs route, sums a
  pair with an exact zero and stays bitwise);
* the threaded collective form is bitwise the plain in-process form;
* the layer against the JAX ``moe_ffn`` on the same weights (``weights.py``)
  under a 1x1 JAX mesh policy, through both of its mesh branches, the
  stationary-weights decode (T <= 2048) and the ``shard_map`` path (T >
  2048), at ``tests/test_moe_paths.py``'s tolerance of 2e-2;
* a rank's expert leaves, from ``build_model(..., mesh=)`` or an
  ``ExpertShard``, are bitwise the slice of the whole model's at the same
  seed, and ``params_from_jax(..., mesh=)``'s;
* the refusals: ``moe_ffn`` under grad on a mesh names ROADMAP 1.8c; a
  layer runs only under the policy of the experts it holds;
  ``params_to_numpy`` refuses a shard; training under a mesh is refused;
* every layer and model holds one ``ExpertShard`` (whole without a mesh);
  the scheduler names the step kind (decode, chunk, ring prefill) the MoE
  wrappers count each launch under, and a route observer sees every
  route within its scope.
"""

from __future__ import annotations

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro import configs as jconfigs
from repro.dist import sharding as jshd
from repro.models import build_model as jax_build_model
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.dist import sharding as shd
from repro_torch.dist.compat import AbstractMesh
from repro_torch.kernels.moe_experts import layer_forward_shard, moe_shards_plain
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe
from repro_torch.models.config import MoEConfig
from repro_torch.weights import params_from_jax, params_to_numpy

torch.set_num_threads(2)

JAX_TOL = 2e-2      # tests/test_moe_paths.py


def tiny(arch, n_experts=None, top_k=None, cf=None, seed=0):
    """A reduced config of ``arch`` with one or two layers' worth of
    overrides, and its port model on the CPU."""
    cfg = configs.get(arch).reduced()
    m = cfg.moe
    cfg = dataclasses.replace(cfg, n_layers=1, moe=MoEConfig(
        n_experts=n_experts or m.n_experts, top_k=top_k or m.top_k, d_expert=m.d_expert,
        capacity_factor=cf or m.capacity_factor))
    return cfg, build_model(cfg, device="cpu", seed=seed)


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 step at each element's magnitude (the smallest normal's
    step at zero)."""
    a = t.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


class _Group:
    """m ranks of ``model`` as threads: an all-reduce is a barrier and the
    operands summed in rank order."""

    def __init__(self, m: int):
        self.barrier = threading.Barrier(m)
        self.parts = [None] * m

    def all_reduce(self, rank: int, t: torch.Tensor) -> torch.Tensor:
        self.parts[rank] = t.clone()
        self.barrier.wait()
        total = self.parts[0].clone()
        for p in self.parts[1:]:
            total = total + p
        self.barrier.wait()
        return t.copy_(total)


def threaded_shards(cfg, p, x, m, cap=None):
    """The layer's collective form on m thread ranks: each runs
    ``layer_forward_shard`` on its own experts; returns rank 0's output
    and whether every rank's output and route are the same."""
    E = cfg.moe.n_experts
    group, outs, errs = _Group(m), [None] * m, []
    shared = dict(p.shared) if hasattr(p, "shared") else None

    def rank(r):
        try:
            lo, hi = r * E // m, (r + 1) * E // m
            local = {k: w[lo:hi] for k, w in p.experts.items()}
            with torch.no_grad():
                outs[r] = layer_forward_shard(cfg.mlp, x, p.router["w"], local, shared,
                                              cfg.moe.top_k, cap, lo, hi,
                                              lambda t: group.all_reduce(r, t))
        except BaseException as e:      # surfaced below
            errs.append(e)
            group.barrier.abort()

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(m)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    if errs:
        raise errs[0]
    same = all(torch.equal(o[0], outs[0][0]) and torch.equal(o[1].idx, outs[0][1].idx)
               for o in outs)
    return outs[0][0], same


# (arch, n_experts, top_k): the reduced configs (top-2 of 4) and a top-6 of
# 8 variant of each, whose partials reassociate
LAYER_CASES = [("moonshot-v1-16b-a3b", None, None), ("moonshot-v1-16b-a3b", 8, 6),
               ("qwen3-moe-235b-a22b", None, None), ("qwen3-moe-235b-a22b", 8, 6)]


@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("arch,E,k", LAYER_CASES,
                         ids=[f"{a.split('-')[0]}-E{E or 4}-k{k or 2}" for a, E, k in LAYER_CASES])
def test_shard_partials_against_the_unsharded_layer(arch, E, k, m):
    cfg, model = tiny(arch, E, k, seed=m)
    p = model.layers[0].moe
    g = torch.Generator().manual_seed(7 + m)
    x = torch.randn(48, cfg.d_model, generator=g).bfloat16()
    with torch.no_grad():
        want, _ = tmoe.moe_ffn(p, cfg, x[None], no_drop=True)
        want = want[0]
        shared = dict(p.shared) if hasattr(p, "shared") else None
        out, routed, _ = moe_shards_plain(cfg.mlp, x, p.router["w"], dict(p.experts), shared,
                                          cfg.moe.top_k, m)
        _, routed1, _ = moe_shards_plain(cfg.mlp, x, p.router["w"], dict(p.experts), shared,
                                         cfg.moe.top_k, 1)
    threaded, same = threaded_shards(cfg, p, x, m)
    assert same, "the thread ranks' outputs or routes differ"
    assert torch.equal(threaded, out), "the collective form differs from the in-process form"
    if m == 1:
        assert torch.equal(out, want) and torch.equal(threaded, want)
        return
    d_routed = (routed.float() - routed1.float()).abs()
    assert (d_routed <= bf16_ulp(routed1)).all(), d_routed.max()
    d_out = (out.float() - want.float()).abs()
    assert (d_out <= bf16_ulp(routed1) + bf16_ulp(want)).all(), d_out.max()
    print(f"{arch} E={cfg.moe.n_experts} k={cfg.moe.top_k} m={m}: routed sum "
          f"{int((d_routed > 0).sum())} of {d_routed.numel()} elements differ, output "
          f"{int((d_out > 0).sum())}")


def test_shard_partials_with_capacity_drops():
    """With capacity dropping (factor 0.25), a dropped pair contributes
    zero on the rank that holds its expert, as in the unsharded layer."""
    cfg, model = tiny("qwen3-moe-235b-a22b", 8, 6, cf=0.25)
    p = model.layers[0].moe
    x = torch.randn(40, cfg.d_model, generator=torch.Generator().manual_seed(3)).bfloat16()
    cap = tmoe.capacity(40, cfg.moe)
    with torch.no_grad():
        want, _ = tmoe.moe_ffn(p, cfg, x[None], no_drop=False)
        out, _, r = moe_shards_plain(cfg.mlp, x, p.router["w"], dict(p.experts), None,
                                     cfg.moe.top_k, 2, cap)
    assert bool((r.rank >= cap).any()), "no pair dropped"
    threaded, same = threaded_shards(cfg, p, x, 2, cap)
    assert same and torch.equal(threaded, out)
    d = (out.float() - want[0].float()).abs()
    assert (d <= 2 * bf16_ulp(want[0])).all(), d.max()


# ---------------------------------------------------------------------------
# Against the JAX moe_ffn's two mesh branches
# ---------------------------------------------------------------------------


def jax_and_port(arch, n_experts=8, top_k=6):
    over = dict(n_layers=1)
    jm = jconfigs.get(arch).reduced()
    mcfg = dict(n_experts=n_experts, top_k=top_k, d_expert=jm.moe.d_expert,
                capacity_factor=jm.moe.capacity_factor)
    jcfg = dataclasses.replace(jm, moe=type(jm.moe)(**mcfg), **over)
    tcfg = dataclasses.replace(configs.get(arch).reduced(), moe=MoEConfig(**mcfg), **over)
    jp = jax_build_model(jcfg).init(jax.random.key(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tm = build_model(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(tree, tcfg, "cpu"))
    return jcfg, jp, tcfg, tm, tree


@pytest.mark.parametrize("T", [24, jmoe.DECODE_TOKEN_THRESHOLD + 8],
                         ids=["stationary", "shard_map"])
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b"])
def test_mesh_layer_matches_the_jax_mesh_branches(arch, T):
    """The port's layer over 2 expert shards (threads) against the JAX
    ``moe_ffn`` under a 1x1 JAX mesh policy, which takes its stationary
    decode at T <= 2048 and its ``shard_map`` path above."""
    jcfg, jp, tcfg, tm, _ = jax_and_port(arch)
    layer0 = jax.tree_util.tree_map(lambda a: a[0], jp["layers"])
    x = np.random.default_rng(T).standard_normal((1, T, tcfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    policy = jshd.ShardingPolicy.default(mesh, decode_stationary=True)

    def run(x):
        with jshd.activation_sharding(policy):
            return jmoe.moe_ffn(layer0["moe"], jcfg, x)[0]

    want = np.asarray(jax.jit(run)(xj), np.float32)[0]
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()[0]
    cap = tmoe.capacity(T, tcfg.moe)
    got, same = threaded_shards(tcfg, tm.layers[0].moe, xt, 2, cap)
    assert same
    np.testing.assert_allclose(got.float().numpy(), want, atol=JAX_TOL, rtol=JAX_TOL)


def test_rank_experts_are_the_slice_of_the_whole_model():
    """Each rank's expert leaves are bitwise the slice of the ``mesh=None``
    model's at the same seed (drawn whole, sliced, freed leaf by leaf),
    every other leaf whole; ``params_from_jax(..., mesh=)`` slices the
    JAX tree the same way; the model's parameters come to the whole
    model's less (m - 1)/m of its experts."""
    for arch in ("moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b"):
        cfg = dataclasses.replace(configs.get(arch).reduced(), n_layers=2)
        whole = build_model(cfg, device="cpu", seed=3)
        E = cfg.moe.n_experts
        for m in (2, 4):
            for r in range(m):
                shard = shd.ExpertShard("expert", r, m, E)
                gen = torch.Generator().manual_seed(3)
                part = tmoe.MoELM(cfg, device="cpu", generator=gen, expert_shard=shard)
                lo, hi = shard.experts()
                for (name, a), (_, b) in zip(part.named_parameters(), whole.named_parameters(),
                                             strict=True):
                    want = b[lo:hi] if ".moe.experts." in name else b
                    assert torch.equal(a, want), (arch, m, r, name)
        on_mesh = build_model(cfg, device="cpu", seed=3,
                              mesh=AbstractMesh((1, 2), ("data", "model")))
        assert on_mesh.expert_shard == shd.ExpertShard("expert", 0, 2, E)
        n_exp = sum(p.numel() for n, p in whole.named_parameters() if ".moe.experts." in n)
        assert sum(p.numel() for p in on_mesh.parameters()) == \
            sum(p.numel() for p in whole.parameters()) - n_exp // 2
        tree = params_to_numpy(whole.state_dict(), cfg)
        sd = params_from_jax(tree, cfg, "cpu", mesh=AbstractMesh((1, 2), ("data", "model")))
        for name, t in on_mesh.state_dict().items():
            assert torch.equal(sd[name], t), name
    # the JAX tree itself, rank 0 of (1, 2) and (2, 2)
    _, _, tcfg, tm, tree = jax_and_port("moonshot-v1-16b-a3b")
    for mesh in (AbstractMesh((1, 2), ("data", "model")), AbstractMesh((2, 2), ("data", "model"))):
        sd = params_from_jax(tree, tcfg, "cpu", mesh=mesh)
        for name, t in tm.state_dict().items():
            assert torch.equal(sd[name], t[:4] if ".moe.experts." in name else t), name


def test_expert_shard_follows_the_serving_spec():
    """Experts on ``model``, whole in D, replicated over ``data``; every
    expert on every rank where E does not divide (the reference's guard)."""
    mesh = AbstractMesh((2, 4), ("data", "model"))
    assert shd.expert_serving_spec((64, 2048, 1408), mesh) == shd.P("model", None, None)
    assert shd.expert_serving_spec((6, 2048, 1408), mesh) == shd.P(None, None, None)
    assert shd.ExpertShard.for_mesh(mesh, 64) == shd.ExpertShard("expert", 0, 4, 64)
    assert not shd.ExpertShard.for_mesh(mesh, 6).split
    assert not shd.ExpertShard.for_mesh(AbstractMesh((2, 1), ("data", "model")), 64).split
    assert shd.ExpertShard("expert", 3, 4, 64).experts() == (48, 64)


def test_refusals():
    cfg, model = tiny("moonshot-v1-16b-a3b")
    p = model.layers[0].moe
    x = torch.zeros(1, 2, cfg.d_model).bfloat16()
    mesh = AbstractMesh((1, 2), ("data", "model"))
    policy = shd.ShardingPolicy.default(mesh, experts=shd.ExpertShard.for_mesh(mesh, 4))
    train = build_model(cfg, device="cpu", train=True)
    with shd.activation_sharding(policy), \
            pytest.raises(NotImplementedError, match="under grad on a mesh.*ROADMAP 1.8c"):
        tmoe.moe_ffn(train.layers[0].moe, cfg, x)
    with pytest.raises(NotImplementedError, match="training under a mesh.*ROADMAP 1.8c"):
        build_model(cfg, device="cpu", train=True, mesh=mesh)
    part = build_model(cfg, device="cpu", mesh=mesh)
    with torch.no_grad(), pytest.raises(ValueError, match="holds experts"):
        tmoe.moe_ffn(part.layers[0].moe, cfg, x)          # a shard without its policy
    with torch.no_grad(), shd.activation_sharding(policy), \
            pytest.raises(ValueError, match="holds experts"):
        tmoe.moe_ffn(p, cfg, x)                           # every expert under a shard's policy
    with pytest.raises(ValueError, match="gather the experts"):
        params_to_numpy(part.state_dict(), cfg)


def test_layers_and_models_hold_one_expert_shard():
    """Every MoE layer and model holds an ``ExpertShard``: whole without a
    mesh, the rank's split one under a mesh; a policy that places no
    experts runs the whole layer, bitwise the layer with no policy."""
    cfg, model = tiny("moonshot-v1-16b-a3b")
    E = cfg.moe.n_experts
    whole = shd.ExpertShard.whole(E)
    assert model.expert_shard == whole
    assert all(layer.moe.shard == whole for layer in model.layers)
    mesh = AbstractMesh((1, 2), ("data", "model"))
    part = build_model(cfg, device="cpu", mesh=mesh)
    assert part.expert_shard == shd.ExpertShard.for_mesh(mesh, E)
    assert all(layer.moe.shard == part.expert_shard for layer in part.layers)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(1, 3, cfg.d_model, generator=gen).bfloat16()
    with torch.no_grad():
        want = tmoe.moe_ffn(model.layers[0].moe, cfg, x)[0]
        with shd.activation_sharding(shd.ShardingPolicy.default(mesh)):
            got = tmoe.moe_ffn(model.layers[0].moe, cfg, x)[0]
    assert torch.equal(got, want)


@pytest.mark.parametrize("kv_mode", ["paged", "ring"])
def test_scheduler_steps_label_the_moe_launches(kv_mode):
    """The scheduler names the step kind the MoE wrappers count each launch
    under (``launches_by_kind`` on the card): every route of a decode step
    under "decode", of a prefill chunk under "chunk", of a ring prefill
    under "prefill", and "other" outside the scheduler ("draft" and
    "verify" are speculation's kinds; any other name raises); a route
    observer sees every call, and only within its scope."""
    from collections import Counter

    from repro_torch.kernels.moe_experts import ROUTE_OBSERVERS
    from repro_torch.kernels.moe_experts import kernel as mk
    from repro_torch.launch.sharded_smoke import RouteDigests
    from repro_torch.serve.scheduler import DecodeScheduler

    cfg = dataclasses.replace(configs.get("moonshot-v1-16b-a3b").reduced(), n_layers=2)
    model = build_model(cfg, device="cpu", seed=1)
    sched = DecodeScheduler(model, n_slots=2, max_seq=32, page_size=4, prefill_chunk=4,
                            kv_mode=kv_mode, device="cpu")
    seen = []

    def observe(x, r):
        seen.append(mk._KIND.get())

    rng = np.random.default_rng(1)
    with RouteDigests(3) as digests:
        ROUTE_OBSERVERS.append(observe)
        try:
            for i in range(2):
                sched.submit(f"s{i}", f"r{i}", rng.integers(0, cfg.vocab, 6).astype(np.int32), 3)
            while sched.busy():
                sched.step()
        finally:
            ROUTE_OBSERVERS.remove(observe)
    assert ROUTE_OBSERVERS == [] and len(digests.digests) == 3
    kinds, L = Counter(seen), cfg.n_layers
    fill = "chunk" if kv_mode == "paged" else "prefill"
    assert set(kinds) == {"decode", fill}, kinds
    assert kinds[fill] == L * (sched.prefill_chunks if kv_mode == "paged" else 2)
    assert kinds["decode"] > 0 and kinds["decode"] % L == 0
    assert mk._KIND.get() == "other"
    with mk.launch_kind("decode"):
        with mk.launch_kind("chunk"):
            assert mk._KIND.get() == "chunk"
        assert mk._KIND.get() == "decode"
    assert mk._KIND.get() == "other"
    for kind in ("draft", "verify"):     # speculation's steps (tests/test_torch_sharded_spec.py)
        with mk.launch_kind(kind):
            assert mk._KIND.get() == kind
    with pytest.raises(ValueError, match="launch kind"), mk.launch_kind("sample"):
        pass
