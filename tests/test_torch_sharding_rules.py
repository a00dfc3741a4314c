"""The port's sharding rules against the JAX package's, leaf for leaf.

``repro_torch.dist.sharding`` resolves every placement through the
reference's named rules.  For each of the ten configs at their published
widths, on the abstract (16, 16), (2, 16, 16), (2, 4) and (1, 1) meshes,
these tests hold the port's spec of every parameter leaf to the
reference's ``param_shardings(...).spec`` of the JAX leaf that stacks it
(the port's per-layer leaf carries the spec without the layer axis), and
the same for the paged cache of every decoder family and every config's
rings (whisper's cross-attention rings included), the offload
staging buffers, the batch and the activation policy's tables.  The port's
models are built on fake tensors (no memory); the JAX trees are
``jax.eval_shape``'d.  A single-axis tuple entry is the axis name itself
(JAX normalizes ``("data",)`` to ``"data"``).

The reference's own rule checks (``tests/test_sharding.py``) have port
counterparts here, and on a 2-rank gloo CPU mesh ``local_shard`` is held
to ``distribute_tensor(...).to_local()``.  (``tests/test_torch_isolation.py``
imports every module of the package, the new ``dist`` and ``launch`` ones
included, and finds no ``jax`` and no ``repro``.)
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh
from jax.sharding import PartitionSpec as JP
from torch._subclasses.fake_tensor import FakeTensorMode

import repro.dist  # noqa: F401  (installs the reference's jax shims)
from repro import configs as jconfigs
from repro.dist import sharding as jshd
from repro.models import build_model as jax_build
from repro.models import kvcache as jkv
from repro_torch import configs
from repro_torch.dist import sharding as shd
from repro_torch.dist.compat import AbstractMesh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model, kvcache

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
ARCHS = configs.list_archs()
DECODERS = [a for a in ARCHS if configs.get(a).family in ("dense", "moe", "hybrid", "ssm")]


def meshes(name):
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names), JaxAbstractMesh(sizes, names)


def norm(spec) -> tuple:
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


@functools.lru_cache(maxsize=None)
def port_model(arch):
    with FakeTensorMode():
        return build_model(configs.get(arch), device="cpu")


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    model = jax_build(jconfigs.get(arch))
    return model, jax.eval_shape(model.init, jax.random.key(0))


def _jax_leaves(tree):
    return [(tuple(str(k.key) for k in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_references(arch, mesh_name):
    pmesh, jmesh = meshes(mesh_name)
    model = port_model(arch)
    cfg = model.cfg
    port = shd.param_shardings(model, pmesh)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    jmodel, p_abs = jax_params(arch)
    ref = {keys: (tuple(leaf.shape), norm(sh.spec)) for (keys, leaf), (_, sh) in zip(
        _jax_leaves(p_abs), _jax_leaves(jshd.param_shardings(p_abs, jmesh)))}
    groups = {}
    for name in port:
        keys, stacked = shd.jax_path(name, cfg)
        groups.setdefault(keys, []).append((name, stacked))
    assert set(groups) == set(ref), (set(groups) ^ set(ref))
    for keys, members in groups.items():
        jshape, jspec = ref[keys]
        for name, stacked in members:
            if stacked:
                assert jshape[1:] == shapes[name], name
                assert not jspec or jspec[0] is None, (name, jspec)
                want = jspec[1:] if jspec else jspec
            else:
                assert jshape == shapes[name], name
                want = jspec
            assert norm(port[name]) == want, (name, port[name], jspec)


def test_param_rules_cover_all_weights_on_16x16():
    """The reference's coverage rule on the port's leaves: every big matrix
    is sharded on some axis (a per-layer leaf counts at the size of the
    stacked JAX leaf it belongs to)."""
    mesh = make_production_mesh()
    for arch in ARCHS:
        model = port_model(arch)
        specs = shd.param_shardings(model, mesh)
        members = {}
        for name, p in model.named_parameters():
            members.setdefault(shd.jax_path(name, model.cfg)[0], []).append((name, p))
        for group in members.values():
            for name, p in group:
                if p.ndim >= 2 and p.numel() * len(group) > 1_000_000:
                    assert any(e is not None for e in specs[name]), f"{arch}: {name}"


def _port_cache(arch, kind, n_slots, page_size, max_seq):
    model = port_model(arch)
    with FakeTensorMode():
        if kind == "ring":
            cache = kvcache.batched_cache(model, n_slots, max_seq)
        else:
            max_pages = -(-max_seq // page_size)
            cache = kvcache.paged_cache(model, n_slots, page_size=page_size,
                                        n_pages=n_slots * max_pages, max_pages=max_pages)
    return {k: tuple(v.shape) for k, v in cache.items()}


def _jax_cache(arch, kind, n_slots, page_size, max_seq):
    jmodel, _ = jax_params(arch)
    if kind == "ring":
        return jax.eval_shape(lambda: jkv.batched_cache(jmodel, n_slots, max_seq))
    max_pages = -(-max_seq // page_size)
    return jax.eval_shape(lambda: jkv.paged_cache(jmodel, n_slots, page_size=page_size,
                                                  n_pages=n_slots * max_pages,
                                                  max_pages=max_pages))


def _meta(shapes):
    return {k: torch.empty(s, device="meta") for k, s in shapes.items()}


CACHE_CASES = ([(arch, "paged", ps) for arch in DECODERS for ps in (16, 8, 3)]
               + [(arch, "ring", None) for arch in ARCHS])


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,kind,page_size", CACHE_CASES)
def test_cache_specs_equal_the_references(arch, kind, page_size, mesh_name):
    """Leaf by key: the rules index dims from the right, so the port's
    stacked leaf and the JAX package's per-block leaves share their trailing
    entries, and every leading entry is None.  The port's pool has one
    scratch page past the allocatable ones; the page rule divides the
    allocatable count, as the reference's."""
    pmesh, jmesh = meshes(mesh_name)
    n_slots, max_seq = 32, 1024
    port = shd.cache_shardings(_meta(_port_cache(arch, kind, n_slots, page_size, max_seq)),
                               pmesh)
    jc = _jax_cache(arch, kind, n_slots, page_size, max_seq)
    jspecs = _jax_leaves(jax.tree_util.tree_map(lambda s: s.spec,
                                                jshd.cache_shardings(jc, jmesh),
                                                is_leaf=lambda x: hasattr(x, "spec")))
    seen = set()
    for keys, jspec in jspecs:
        key = keys[-1]
        seen.add(key)
        assert key in port, key
        got, want = norm(port[key]), norm(jspec)
        k = min(len(got), len(want))
        assert got[len(got) - k:] == want[len(want) - k:], (key, got, want)
        assert all(e is None for e in got[:len(got) - k] + want[:len(want) - k]), (key, got,
                                                                                   want)
    # an SSM's paged cache keeps a page table and no pool; the reference's
    # builds its table only beside a pool
    extra = {"page_table"} if kind == "paged" and configs.get(arch).family == "ssm" else set()
    assert seen == set(port) - extra, set(port) ^ seen


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape", [(4, 5, 16, 8, 128), (4, 3, 8, 36, 64), (2, 1, 3, 1, 256)])
def test_offload_stage_specs_equal_the_references(shape, mesh_name):
    pmesh, jmesh = meshes(mesh_name)
    stage = {"kp": shape, "vp": shape}
    port = shd.offload_stage_shardings(_meta(stage), pmesh)
    ref = jshd.offload_stage_shardings(
        {k: jax.ShapeDtypeStruct(s, jnp.bfloat16) for k, s in stage.items()}, jmesh)
    for key in stage:
        assert norm(port[key]) == norm(ref[key].spec), key


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_specs_equal_the_references(mesh_name):
    pmesh, jmesh = meshes(mesh_name)
    batch = {"tokens": (256, 4096), "frames": (6, 1500, 80), "one": (1, 32768)}
    port = shd.batch_shardings(_meta(batch), pmesh)
    ref = jshd.batch_shardings({k: jax.ShapeDtypeStruct(s, jnp.int32)
                                for k, s in batch.items()}, jmesh)
    for key in batch:
        assert norm(port[key]) == norm(ref[key].spec), key


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("kw", [dict(attn_mode="head"), dict(attn_mode="seq"),
                                dict(attn_mode="head", batch_shardable=False),
                                dict(attn_mode="seq", overrides="q")])
def test_policy_tables_equal_the_references(kw, mesh_name):
    pmesh, jmesh = meshes(mesh_name)
    kw = dict(kw)
    jkw = dict(kw)
    if kw.pop("overrides", None):
        kw["overrides"] = {"q_heads": shd.P(None, "model", None, None), "extra": shd.P("data")}
        jkw["overrides"] = {"q_heads": JP(None, "model", None, None), "extra": JP("data")}
    port = shd.ShardingPolicy.default(pmesh, **kw)
    ref = jshd.ShardingPolicy.default(jmesh, **jkw)
    assert {k: norm(v) for k, v in port.specs.items()} == \
        {k: norm(v) for k, v in ref.specs.items()}
    assert (port.rules.dp, port.rules.model) == (ref.rules.dp, ref.rules.model)
    assert (port.batch_shardable, port.attn_mode) == (ref.batch_shardable, ref.attn_mode)


# -- the reference's own checks (tests/test_sharding.py), on the port ---------------


def test_divisibility_guard_degrades_to_replication():
    mesh = make_production_mesh()
    # kv-head dim 8 does not divide 16 -> the ring rule falls back to time
    spec = shd.cache_shardings(_meta({"k": (4, 16, 4096, 8, 128)}), mesh)["k"]
    assert spec[2] == "model" and spec[3] is None
    spec = shd.cache_shardings(_meta({"k": (4, 16, 4096, 16, 128)}), mesh)["k"]
    assert spec[3] == "model"
    # the pool: lanes, then heads, then pages (the scratch page set aside)
    for shape, dim in (((2, 65, 16, 8, 64), 2), ((2, 65, 8, 16, 64), 3),
                       ((2, 33, 8, 8, 64), 1), ((2, 34, 8, 8, 64), None)):
        spec = shd.cache_shardings(_meta({"kp": shape}), mesh)["kp"]
        assert [i for i, e in enumerate(spec) if e is not None] == ([] if dim is None
                                                                    else [dim]), shape
    assert shd._fit_spec(shd.P("model", "data"), (15, 32), mesh) == (None, "data")


def test_multipod_dp_axes():
    mesh = make_production_mesh(multi_pod=True)
    rules = shd.MeshRules.for_mesh(mesh)
    assert rules.dp == ("pod", "data") and rules.dp_size(mesh) == 32
    spec = shd.batch_shardings(_meta({"tokens": (256, 4096)}), mesh)["tokens"]
    assert spec[0] == ("pod", "data")
    assert mesh.shape == {"pod": 2, "data": 16, "model": 16}


def test_head_weight_not_contraction_sharded():
    specs = shd.param_shardings(port_model("qwen3-14b"), make_production_mesh())
    assert specs["embedding.head"] == (None, "model")


def test_constrain_identity_without_policy_and_on_plain_tensors():
    x = torch.ones(4, 8)
    assert shd.constrain(x, "activation") is x
    with shd.activation_sharding(shd.ShardingPolicy.default(make_production_mesh())):
        assert shd.constrain(x, "activation") is x
        assert shd.current_policy() is not None
        assert shd.constrain_tree({"a": x}, {"a": shd.P("data", None)})["a"] is x
    assert shd.current_policy() is None


def test_production_meshes_touch_no_device():
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (single.axis_names, single.size) == (("data", "model"), 256)
    assert (multi.axis_names, multi.size) == (("pod", "data", "model"), 512)


def test_pool_shard_layouts():
    mesh = AbstractMesh((1, 4), ("data", "model"))
    for shape, mode in (((2, 9, 16, 8, 64), "lane"), ((2, 9, 6, 8, 64), "head"),
                        ((2, 10, 6, 2, 64), "replicated")):
        spec = shd.cache_shardings(_meta({"kp": shape}), mesh)["kp"]
        pool = shd.PoolShard.for_pool(spec, shape, mesh)
        assert pool.mode == mode and pool.count == (1 if mode == "replicated" else 4)
    spec = shd.cache_shardings(_meta({"kp": (2, 5, 6, 2, 64)}), mesh)["kp"]
    with pytest.raises(NotImplementedError, match="page-sharded"):
        shd.PoolShard.for_pool(spec, (2, 5, 6, 2, 64), mesh)
    one = AbstractMesh((2, 1), ("data", "model"))     # a model axis of 1 splits nothing
    spec = shd.cache_shardings(_meta({"kp": (2, 9, 16, 8, 64)}), one)["kp"]
    assert shd.PoolShard.for_pool(spec, (2, 9, 16, 8, 64), one).mode == "replicated"
    lane = shd.PoolShard("lane", 2, 4, 16, 8)
    assert lane.lanes() == (8, 12) and lane.heads() == (0, 8)
    head = shd.PoolShard("head", 1, 4, 16, 8)
    assert head.lanes() == (0, 16) and head.heads() == (2, 4)


LOCAL_SHARD_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.compat import distribute_tensor
    from repro_torch.launch.sharded_smoke import spawn_ranks

    SPECS = [shd.P("data", None), shd.P(None, "model"), shd.P(("data", "model"), None),
             shd.P("model", "data"), shd.P(None, None), shd.P(None, ("data", "model"))]

    def rank(mesh):
        t = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
        out = []
        for spec in SPECS:
            want = distribute_tensor(t, mesh, shd.to_placements(spec, mesh)).to_local()
            got = shd.local_shard(t, spec, mesh)
            out.append(bool(torch.equal(got, want)) and got.shape == want.shape)
        try:        # DTensor nests one dim's shards in mesh order only
            shd.to_placements(shd.P(None, ("model", "data")), mesh)
            out.append(False)
        except ValueError:
            out.append(True)
        return out

    if __name__ == "__main__":
        print(json.dumps(spawn_ranks(rank, dp=1, mp=2, device="cpu", timeout_s=120)))
""")


def test_local_shard_is_distribute_tensors_local_part(tmp_path):
    script = tmp_path / "local_shard.py"
    script.write_text(LOCAL_SHARD_SCRIPT)
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         cwd=ROOT, timeout=240,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-3000:]
    ranks = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(ranks) == 2 and all(all(r) for r in ranks), ranks
