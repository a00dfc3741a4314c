"""The elastic fleet and its hand-over under a mesh on spawned gloo ranks
on the CPU.

Every rank of a (1, 2) mesh runs the same ``FleetController`` over
``DecodeScheduler(mesh=...)`` workers (``paged_kernel``, offload, prefix
sharing, parking and the index journal) sharing that rank's blob store,
over the fleet differential harness's seeded soup
(``launch/sharded_smoke.fleet_soup``, the draws of
``tests/test_torch_fleet_differential.py`` for the same (arch, seed)):
scale-up bursts, forced scale-downs, wedged workers reaped by heartbeat
eviction, crashes mid-decode, mid-restore and mid-park, a scale to zero,
and cold starts that adopt parked records and journaled index pages; the
fleet-wide ledger is audited after every tick on every rank.  Four of the
harness's ``TIER1_SEEDS``, each held so:

* two dense soups: every completion equals the port's solo ``generate``
  and ``mesh=None``'s fleet token for token, every rank's page blobs are
  its lane shard of ``mesh=None``'s, and every rank bills what
  ``mesh=None`` bills;
* a MoE and a hybrid soup: every completion equals the mesh-matched run
  (the same sharded scheduler serving each completed request alone).

On every rank the fleet's stats, its scheduler stats and its log of worker
events and adoptions agree (an all-reduced digest).  A parked record
carries the mesh shape that wrote it: adopting one written on another
shape (``mesh=None`` on a (1, 2) rank, (1, 2) here) raises, naming both.
The launcher runs as its users run it: ``serve --mesh 1x2 --fleet 2
--scale-to-zero --device cpu`` in a subprocess, rank 0 alone reporting.
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.models import build_model
from repro_torch.serve.engine import generate
from repro_torch.serve.scheduler import DecodeScheduler

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
TIMEOUT_S = 240
MAX_SEQ = 32

# the fleet differential harness's fleet: 3 workers of 2 slots, page 4, chunk 3
FLEET = dict(n_slots=2, max_seq=MAX_SEQ, page_size=4, prefill_chunk=3,
             attn_backend="paged_kernel", offload=True, fleet=dict(workers=3, soup=True))
# (arch, seed) of its TIER1_SEEDS, and the claim each is held to
ROWS = {"1x2-dense": [(dict(FLEET, arch="minicpm-2b", seed=0), "solo"),
                      (dict(FLEET, arch="minicpm-2b", seed=1), "solo")],
        "1x2-rec": [(dict(FLEET, arch="moonshot-v1-16b-a3b", seed=0), "sched"),
                    (dict(FLEET, arch="recurrentgemma-2b", seed=0), "sched")]}

FLEET_MESH = """
import json, sys
import torch
from repro_torch.launch import sharded_smoke as ss
if __name__ == "__main__":
    torch.set_num_threads(1)
    dp, mp = (int(x) for x in sys.argv[1].split("-")[0].split("x"))
    rows = json.loads(sys.argv[2])
    ws = [ss.Workload(**dict(w, fleet=ss.Fleet(**w["fleet"]))) for w, _ in rows]
    res = ss.run_smoke(ws, dp=dp, mp=mp, device="cpu", timeout_s=float(sys.argv[3]),
                       mesh_matched=[ref == "sched" for _, ref in rows])
    print(json.dumps(res))
"""

# a record parked on a (1, 2) mesh, adopted there from mesh=None and handed
# back to the test, which adopts it on mesh=None
OTHER_SHAPE = """
import pickle, sys
import numpy as np
import torch
from repro_torch.launch.sharded_smoke import spawn_ranks

def rank(mesh):
    from repro_torch import configs
    from repro_torch.models import build_model
    from repro_torch.serve.scheduler import DecodeScheduler
    model = build_model(configs.get("minicpm-2b").reduced(), device="cpu")
    kw = dict(n_slots=2, max_seq=24, page_size=4, prefill_chunk=4, device="cpu",
              park_sessions=True, prefix_sharing=True, index_journal=True)
    records = {}
    for name, m in (("mesh", mesh), ("none", None)):
        sched = DecodeScheduler(model, mesh=m, **kw)
        sched.submit("s0", "r0", np.arange(10, dtype=np.int32), 4)
        while sched.busy():
            sched.step()
        records[name] = sched.externalize_session("s0")
    other = DecodeScheduler(model, mesh=mesh, **kw)
    try:
        other.adopt_parked(records["none"])
        err = ["returned", ""]
    except Exception as e:
        err = [type(e).__name__, str(e)]
    return {"error": err, "record": records["mesh"]}

if __name__ == "__main__":
    torch.set_num_threads(1)
    out = spawn_ranks(rank, dp=1, mp=2, device="cpu", timeout_s=float(sys.argv[2]))
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
"""


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
    """Every spawn of this file at once: the soups (two spawns), the record
    of another mesh shape and the launcher."""
    tmp = tmp_path_factory.mktemp("fleet")
    procs = {key: _start(["-c", FLEET_MESH, key, json.dumps(rows), str(TIMEOUT_S)])
             for key, rows in ROWS.items()}
    script, records = tmp / "other_shape.py", tmp / "records.pkl"
    script.write_text(OTHER_SHAPE)
    procs["other_shape"] = _start([str(script), str(records), str(TIMEOUT_S)])
    procs["serve"] = _start(["-m", "repro_torch.launch.serve", "--arch", "minicpm-2b",
                             "--requests", "8", "--sessions", "4", "--batch-size", "2",
                             "--prompt-len", "8", "--max-new", "4", "--page-size", "4",
                             "--prefill-chunk", "4", "--fleet", "2", "--scale-to-zero",
                             "--mesh", "1x2", "--device", "cpu"])
    done = {name: _finish(p) for name, p in procs.items()}
    done["records"] = records
    return done


def _json_line(runs, name):
    rc, out, err = runs[name]
    assert rc == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        _MODELS[arch] = build_model(configs.get(arch).reduced(), device="cpu", seed=0)
    return _MODELS[arch]


CASES = [(key, i) for key, rows in ROWS.items() for i in range(len(rows))]


@pytest.mark.parametrize("key,i", CASES,
                         ids=[f"{ROWS[k][i][0]['arch']}-{ROWS[k][i][0]['seed']}" for k, i in CASES])
def test_fleet_soup_on_the_mesh(runs, key, i):
    res = _json_line(runs, key)[i]
    w, ref = ROWS[key][i]
    assert res["ranks_agree"], "the ranks' tokens differ"
    assert res["fleet_agrees"], "the ranks' fleets disagree (stats, events or adoptions)"
    assert res["requests"] >= 4
    if ref == "solo":
        model = _model(w["arch"])
        for session, name, prompt, max_new, tokens in res["completions"]:
            want = generate(model, torch.tensor([prompt], dtype=torch.int32), max_new,
                            seq_len=MAX_SEQ)[0].tolist()
            assert tokens == want, f"{name} ({session}) diverged from solo generate"
        assert res["identical_outputs"], "the mesh fleet differs from mesh=None's"
        assert res["fleet_record"]["log"] == res["single_fleet"]["log"]
        assert res["fleet_record"]["fleet"] == res["single_fleet"]["fleet"]
        assert res["journals_equal"], "a rank's storage journal differs from mesh=None's"
        assert res["blobs_bitwise"], "a rank's blob is not its shard of mesh=None's"
    else:
        assert res["matched_identical"], "the mesh fleet differs from its mesh-matched run"
    assert res["pool"]["mode"] == "lane" and res["pool_split"]
    assert res["pages_move_no_bytes"]
    assert res["wire_flat"], (res["wire_per_step"], res["wire_per_step_big"])
    assert res["ok"]


def test_fleet_soups_crash_park_and_cold_start(runs):
    """Between them the soups crash workers, evict wedged ones, scale to
    zero and cold start, journal and re-adopt index pages, and commit and
    adopt parked records."""
    keys = ("crashes", "evictions", "cold_starts_from_zero", "meta_puts", "meta_adoptions",
            "index_journal_puts", "index_adopted", "retires")
    totals = dict.fromkeys(keys, 0)
    for key in ROWS:
        for res in _json_line(runs, key):
            for k in keys:
                totals[k] += res["stats"][k]
            assert res["stats"]["workers_live"] == 0, "every soup ends scaled to zero"
    assert all(n > 0 for n in totals.values()), totals


def test_adopting_a_record_of_another_mesh_shape_raises(runs):
    rc, out, err = runs["other_shape"]
    assert rc == 0, err[-4000:]
    with open(runs["records"], "rb") as f:
        ranks = pickle.load(f)
    for r in ranks:
        kind, msg = r["error"]
        assert kind == "ValueError" and "None" in msg and "(1, 2)" in msg, r["error"]
        assert r["record"].mesh_shape == (1, 2) and r["record"].blob_key
    rec = ranks[0]["record"]
    model = build_model(configs.get("minicpm-2b").reduced(), device="cpu")
    sched = DecodeScheduler(model, n_slots=2, max_seq=24, page_size=4, device="cpu",
                            park_sessions=True)
    with pytest.raises(ValueError, match=r"mesh shape \(1, 2\).*mesh shape None"):
        sched.adopt_parked(rec)


def test_serve_cli_mesh_fleet(runs):
    rc, out, err = runs["serve"]
    assert rc == 0, err[-4000:]
    assert "served 8/8 requests" in out and "(mesh 1x2 of 2 ranks)" in out
    assert out.count("served 8/8") == 1, "only rank 0 reports"
    assert "fleet: " in out and "0/2 live at exit" in out
