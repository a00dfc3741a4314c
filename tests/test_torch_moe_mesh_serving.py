"""The MoE family under a mesh (``DecodeScheduler(mesh=...)``, each rank
holding only its experts) on spawned gloo ranks on the CPU.

The seeded event soup of the scheduler differential harness
(``launch/sharded_smoke.event_soup``: fresh, multi-turn and
shared-system-prompt admissions over five sessions, forced preemptions
with offload, parking with a TTL, prefix sharing) runs on every rank of a
(1, 2) and a (2, 2) mesh, with ``audit()`` after every step, for a small
moonshot-v1-16b-a3b (named ``moonshot-...``, so it has the shared expert)
and a small qwen3-moe-235b-a22b (none), paged on both attention backends
and in ring mode.  Each row must give its mesh-matched run's tokens (the
same sharded scheduler, eviction-free, one request at a time: the
reference's ``sched`` claim for moonshot,
``tests/test_sched_differential.py:381-410``); every rank's tokens agree;
each rank holds half the model's expert bytes; every rank of a ``model``
group routes the same inputs to the same experts (a digest of each MoE
layer's input and picks, first chunk and decode steps); the route,
expert and combine wrappers count no launch (their plain versions run
here); the storage
journals equal ``mesh=None``'s and a decode step's collective bytes are
the same at a pool 4x larger.

The layer's collective form over spawned (1, 2) and (2, 2) ranks: each
rank's expert leaves are bitwise the slice of the ``mesh=None`` model's at
the same seed and of ``params_from_jax(..., mesh=)``'s, the layer's output
is bitwise its in-process form (``ref.moe_shards_plain``, the partials
summed in rank order), and its collective bytes do not change when E
doubles.  The launchers run as their users run them: ``sharded_smoke
--arch moonshot-v1-16b-a3b --mesh-matched`` and ``serve --arch
moonshot-v1-16b-a3b --mesh 1x2``.  Every spawn bounds its collectives and
its join, and every subprocess its own run.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels.moe_experts import moe_shards_plain
from repro_torch.models import build_model
from repro_torch.models.config import MoEConfig

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
TIMEOUT_S = 240

SOUP = dict(n_slots=4, max_seq=32, page_size=4, prefill_chunk=3, n_layers=2,
            soup=dict(sessions=5))
FEATURES = dict(offload=True, prefix_sharing=True, park_sessions=True, park_ttl_steps=6)
MOON, QWEN = "moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b"
# every row against its mesh-matched run; each key is one spawn
ROWS = {
    "1x2": [
        dict(SOUP, arch=MOON, attn_backend="gather", seed=4, **FEATURES),
        dict(SOUP, arch=MOON, attn_backend="paged_kernel", seed=5, **FEATURES),
        dict(SOUP, arch=MOON, attn_backend="gather", kv_mode="ring", seed=3),
        dict(SOUP, arch=QWEN, attn_backend="paged_kernel", seed=4, **FEATURES),
    ],
    "2x2": [
        dict(SOUP, arch=MOON, attn_backend="paged_kernel", seed=2, **FEATURES),
        dict(SOUP, arch=QWEN, attn_backend="gather", kv_mode="ring", seed=3),
    ],
}

SOUP_MESH = """
import json, sys
import torch
from repro_torch.launch import sharded_smoke as ss
if __name__ == "__main__":
    torch.set_num_threads(1)
    dp, mp = (int(x) for x in sys.argv[1].split("x"))
    rows = json.loads(sys.argv[2])
    ws = [ss.Workload(**dict(w, soup=ss.Soup(**w["soup"]))) for w in rows]
    res = ss.run_smoke(ws, dp=dp, mp=mp, device="cpu", timeout_s=float(sys.argv[3]),
                       mesh_matched=True)
    for r in res:
        r.pop("completions")
    print(json.dumps(res))
"""

# (arch, E, top_k, T): each E and 2E at one T, so the collective bytes can
# be held flat in E
LAYER_CASES = [(MOON, 8, 6, 8), (MOON, 16, 6, 8), (MOON, 8, 6, 40), (MOON, 16, 6, 40),
               (QWEN, 4, 2, 24), (QWEN, 8, 2, 24)]

MOE_LAYER = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    from repro_torch import configs
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.sharded_smoke import expert_bytes, spawn_ranks
    from repro_torch.models import build_model
    from repro_torch.models import moe as tmoe
    from repro_torch.models.config import MoEConfig
    from repro_torch.weights import params_from_jax, params_to_numpy

    def rank(mesh):
        torch.set_num_threads(1)
        out = []
        for arch, E, k, T in CASES:
            cfg = case_cfg(arch, E, k)
            whole = build_model(cfg, device="cpu", seed=E)
            mine = build_model(cfg, device="cpu", seed=E, mesh=mesh)
            shard = mine.expert_shard
            lo, hi = shard.experts()
            sliced = all(torch.equal(a, b[lo:hi] if ".moe.experts." in n else b)
                         for (n, a), (_, b) in zip(mine.named_parameters(),
                                                   whole.named_parameters(), strict=True))
            sd = params_from_jax(params_to_numpy(whole.state_dict(), cfg), cfg, "cpu",
                                 mesh=mesh)
            from_jax = all(torch.equal(sd[n], t) for n, t in mine.state_dict().items())
            policy = shd.ShardingPolicy.default(mesh, experts=shard)
            with torch.no_grad(), shd.activation_sharding(policy):
                y, _ = tmoe.moe_ffn(mine.layers[0].moe, cfg, case_x(cfg, T), no_drop=True)
            out.append({"shard": [shard.mode, lo, hi], "sliced": sliced, "from_jax": from_jax,
                        "bits": y.view(torch.int16).flatten().tolist(),
                        "wire_bytes": policy.wire.bytes, "wire_calls": policy.wire.calls,
                        "expert_bytes": [expert_bytes(mine), expert_bytes(whole)]})
        return out

    if __name__ == "__main__":
        print(json.dumps({f"{dp}x{mp}": spawn_ranks(rank, dp=dp, mp=mp, device="cpu",
                                                    timeout_s=float(sys.argv[1]))
                          for dp, mp in ((1, 2), (2, 2))}))
""")


def case_cfg(arch, E, k):
    cfg = configs.get(arch).reduced()
    return dataclasses.replace(cfg, n_layers=1, moe=MoEConfig(
        n_experts=E, top_k=k, d_expert=cfg.moe.d_expert,
        capacity_factor=cfg.moe.capacity_factor))


def case_x(cfg, T):
    return torch.randn(1, T, cfg.d_model, generator=torch.Generator().manual_seed(T)).bfloat16()


def _helpers() -> str:
    import inspect

    return f"CASES = {LAYER_CASES!r}\n" + "\n".join(
        textwrap.dedent(inspect.getsource(f)) for f in (case_cfg, case_x))


def _start(args):
    return subprocess.Popen([sys.executable, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT, env=ENV)


def _finish(proc):
    try:
        out, err = proc.communicate(timeout=TIMEOUT_S + 60)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    return proc.returncode, out, err


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every spawn of this file at once: the two meshes' soups, the layer
    over both meshes and the two launchers."""
    tmp = tmp_path_factory.mktemp("moe_mesh")
    layer_script = tmp / "moe_layer.py"
    layer_script.write_text(MOE_LAYER.replace(
        "from repro_torch.weights import params_from_jax, params_to_numpy\n",
        "from repro_torch.weights import params_from_jax, params_to_numpy\n" + _helpers(), 1))
    out = tmp / "moe_smoke.json"
    procs = {mesh: _start(["-c", SOUP_MESH, mesh, json.dumps(rows), str(TIMEOUT_S)])
             for mesh, rows in ROWS.items()}
    procs["layer"] = _start([str(layer_script), str(TIMEOUT_S)])
    procs["smoke_cli"] = _start(["-m", "repro_torch.launch.sharded_smoke", "--device", "cpu",
                                 "--arch", MOON, "--mesh", "1x2", "--layers", "2",
                                 "--requests", "3", "--prompt-len", "8", "--max-new", "3",
                                 "--mesh-matched", "--out", str(out)])
    procs["serve_cli"] = _start(["-m", "repro_torch.launch.serve", "--arch", MOON,
                                 "--requests", "4", "--sessions", "2", "--batch-size", "2",
                                 "--prompt-len", "8", "--max-new", "4", "--page-size", "4",
                                 "--prefill-chunk", "4", "--mesh", "1x2",
                                 "--attn-backend", "paged_kernel", "--device", "cpu"])
    done = {name: _finish(p) for name, p in procs.items()}
    done["smoke_json"] = out
    return done


def _json_line(runs, name):
    rc, out, err = runs[name]
    assert rc == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


CASES = [(mesh, i) for mesh, rows in ROWS.items() for i in range(len(rows))]


@pytest.mark.parametrize("mesh,i", CASES,
                         ids=[f"{m}-{ROWS[m][i]['arch'].split('-')[0]}-"
                              f"{ROWS[m][i].get('kv_mode', 'paged')}-{ROWS[m][i]['attn_backend']}"
                              for m, i in CASES])
def test_moe_event_soup_on_the_mesh(runs, mesh, i):
    res = _json_line(runs, mesh)[i]
    w = ROWS[mesh][i]
    assert res["ranks_agree"], "the ranks' tokens differ"
    assert res["requests"] >= 5
    assert res["matched_identical"], "the mesh run differs from its mesh-matched run"
    assert res["experts"]["mode"] == "expert" and res["experts"]["count"] == 2
    assert res["expert_split"], (res["expert_bytes_rank"], res["expert_bytes_single"])
    assert all(2 * b == res["expert_bytes_single"] for b in res["expert_bytes_rank"])
    assert res["routes_agree"], "ranks of a model group routed differently"
    for n, modes in zip(res["launches_by_rank"], res["combine_launches_by_mode"]):
        # the wrappers count kernel launches only: none on the CPU, where
        # each takes its plain version (chip_smoke phase 48 counts them)
        assert n["moe_route"] == n["moe_experts"] == n["moe_combine"] == 0
        assert modes == {"bf16": 0, "fp32": 0}
    for verdict in ("pool_split", "ring_split"):
        assert res.get(verdict) in (None, True), (verdict, res)
    assert res["wire_flat"], (res["wire_per_step"], res["wire_per_step_big"])
    assert res["pages_move_no_bytes"], (res["page_wire_bytes"], res["preempt_wire"])
    assert res["journals_equal"], "a rank's storage journal differs from mesh=None's"
    if w.get("kv_mode") == "ring":
        assert res["ring"]["mode"] == "head"
    assert res["ok"]


def test_moe_soups_exercise_every_mechanism(runs):
    """Between them the soups preempt and restore, hit parked sessions and
    the prefix index, split shared pages and offload parked slots."""
    keys = ("preemptions", "restores", "park_hits", "index_hits", "cow_splits",
            "park_offloads")
    totals = dict.fromkeys(keys, 0)
    for mesh in ROWS:
        for res in _json_line(runs, mesh):
            for key in keys:
                totals[key] += res["stats"].get(key, 0)
    assert all(n > 0 for n in totals.values()), totals
    assert totals["restores"] == totals["preemptions"]


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_moe_layer_collective_form(runs, mesh):
    ranks = _json_line(runs, "layer")[mesh]
    by_flat = {}
    for c, (arch, E, k, T) in enumerate(LAYER_CASES):
        cfg = case_cfg(arch, E, k)
        whole = build_model(cfg, device="cpu", seed=E)
        p = whole.layers[0].moe
        shared = dict(p.shared) if hasattr(p, "shared") else None
        with torch.no_grad():
            want, _, _ = moe_shards_plain(cfg.mlp, case_x(cfg, T)[0], p.router["w"],
                                          dict(p.experts), shared, k, 2)
        bits = want.view(torch.int16).flatten().tolist()
        for r, rank in enumerate(ranks):
            got = rank[c]
            model_r = r % 2
            assert got["shard"] == ["expert", model_r * E // 2, (model_r + 1) * E // 2]
            assert got["sliced"] and got["from_jax"], (arch, E, r)
            assert 2 * got["expert_bytes"][0] == got["expert_bytes"][1]
            assert got["bits"] == bits, f"{arch} E={E} T={T}: rank {r} differs from the " \
                                        f"in-process form"
            assert got["wire_calls"] == 1 and got["wire_bytes"] == T * cfg.d_model * 4
            by_flat.setdefault((arch, T), set()).add(got["wire_bytes"])
    assert all(len(v) == 1 for v in by_flat.values()), "collective bytes grew with E"


def test_moe_sharded_smoke_cli(runs):
    rc, out, err = runs["smoke_cli"]
    assert rc == 0, err[-4000:]
    res = json.loads(runs["smoke_json"].read_text())
    assert res["matched_identical"] and res["expert_split"] and res["routes_agree"]
    assert res["wire_flat"] and res["pool_split"] and res["ok"]
    assert res["mesh"] == "1x2" and res["arch"] == MOON


def test_moe_serve_cli_mesh(runs):
    rc, out, err = runs["serve_cli"]
    assert rc == 0, err[-4000:]
    assert "served 4/4 requests" in out and "(mesh 1x2 of 2 ranks)" in out
