"""The sharded scheduler (``DecodeScheduler(mesh=...)``) on spawned gloo
ranks on the CPU, against ``mesh=None``.

Each mesh is one spawn of ``dp * mp`` ranks (``file://`` rendezvous, one
thread each) that serves every workload of its row in turn: a small
minicpm-2b (2 layers, the reduced widths) on both attention backends (and
on (2, 2) at a page of 3 lanes, which splits kv heads), and on (1, 2) a
small recurrentgemma-2b held against its mesh-matched run (the
same sharded scheduler, one request at a time: the reference's ``sched``
claim).  The dense greedy tokens must equal the ``mesh=None`` scheduler's
token for token; every rank's tokens agree; each rank's pool is
``1/|model|`` of the whole pool's bytes; a decode step's collective bytes
are the same at a pool 4x larger.  Every spawn bounds its process group's
collectives and its join (``spawn_ranks(timeout_s=...)``), so a hang fails
here rather than running out the suite's clock.

The launchers run as their users run them, in subprocesses:
``python -m repro_torch.launch.sharded_smoke --device cpu`` and
``python -m repro_torch.launch.serve --mesh 1x2 --device cpu``.  The
constructor refuses an abstract mesh, naming the ROADMAP item that ports
it, and speculation on the paged kernel with the reference's
``ValueError``.  What a mesh once refused and now serves is held on a
live (1, 2) spawn: speculation (dense against solo ``generate``, the MoE
family against the same mesh without it), the index journal (each blob
this rank's lanes of a page), and the fleet's hand-over hooks
(``externalize_session``, ``adopt_parked``, ``adopt_index_journal``)
across schedulers sharing the rank's blob store.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.dist.compat import AbstractMesh
from repro_torch.models import build_model
from repro_torch.serve.engine import generate
from repro_torch.serve.scheduler import DecodeScheduler

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
TIMEOUT_S = 240

DENSE = dict(arch="minicpm-2b", n_layers=2, n_requests=5, sessions=3, prompt_len=10,
             max_new=5)
HYBRID = dict(arch="recurrentgemma-2b", n_layers=3, n_requests=3, sessions=2, prompt_len=9,
              max_new=4)
ROWS = {
    "1x2": [(dict(DENSE, attn_backend="paged_kernel"), False),
            (dict(DENSE, attn_backend="gather"), False),
            (dict(HYBRID, attn_backend="paged_kernel"), True)],
    "2x2": [(dict(DENSE, attn_backend="paged_kernel"), False),
            (dict(DENSE, attn_backend="gather"), False),
            # a page of 3 lanes: the model axis splits kv heads instead
            (dict(DENSE, attn_backend="paged_kernel", page_size=3, prefill_chunk=3), False)],
}

LIVE_SERVED = """
import json
import numpy as np
from repro_torch import configs
from repro_torch.core import PageBlobStore
from repro_torch.launch.sharded_smoke import spawn_ranks
from repro_torch.models import build_model
from repro_torch.serve.scheduler import DecodeScheduler

# two prompts sharing their first two pages
PROMPTS = [list(range(1, 11)), list(range(1, 9)) + [40, 41]]

def serve(sched, reqs):
    for session, name, prompt, n in reqs:
        sched.submit(session, name, np.asarray(prompt, np.int32), n)
    out = {}
    while sched.busy():
        for fin in sched.step():
            out[fin.request_id] = np.asarray(fin.tokens).tolist()
        sched.audit()
    return out

def rank(mesh):
    out = {}
    kw = dict(n_slots=2, max_seq=24, page_size=4, prefill_chunk=4, device="cpu", mesh=mesh)
    reqs = [("s0", "r0", PROMPTS[0], 6), ("s1", "r1", PROMPTS[1], 6)]
    for arch in ("minicpm-2b", "moonshot-v1-16b-a3b"):
        # speculation with a self-draft, beside the same mesh without it
        model = build_model(configs.get(arch).reduced(), device="cpu", mesh=mesh)
        spec = DecodeScheduler(model, draft_model=model, spec_k=3, **kw)
        out[arch] = {"spec": serve(spec, reqs), "plain": serve(DecodeScheduler(model, **kw), reqs),
                     "spec_stats": spec.spec_stats()}
    # the fleet's hand-over: three workers sharing this rank's blob store
    model = build_model(configs.get("minicpm-2b").reduced(), device="cpu", mesh=mesh)
    store = PageBlobStore()
    fkw = dict(kw, park_sessions=True, prefix_sharing=True, index_journal=True,
               blob_store=store)
    a = DecodeScheduler(model, **fkw)
    out["first"] = serve(a, [("s0", "r0", PROMPTS[0], 4)])
    out["index_journal_puts"] = a.index_journal_puts
    out["index_blob_shapes"] = [list(b["kp"].shape) for k, b in store.blobs.items()
                                if k.startswith("index/")]
    rec = a.externalize_session("s0")
    out["record"] = {"blob_key": rec.blob_key, "pages": rec.pages, "slot": rec.slot,
                     "mesh_shape": list(rec.mesh_shape), "state": sorted(rec.state),
                     "blob_lanes": store.blobs[rec.blob_key]["kp"].shape[2]}
    b = DecodeScheduler(model, **fkw)
    b.adopt_parked(rec)
    out["next"] = PROMPTS[0] + out["first"]["r0"] + [7, 8]
    out["adopted"] = serve(b, [("s0", "r2", out["next"], 4)])
    out["adopted_stats"] = b.sharing_stats()
    c = DecodeScheduler(model, **fkw)
    out["index_adopted"] = c.adopt_index_journal()
    out["after_index"] = serve(c, [("s1", "r3", PROMPTS[1], 4)])
    out["index_hits"] = c.index_hits
    try:            # the reference's refusal, on the live mesh
        DecodeScheduler(model, draft_model=model, spec_k=2, attn_backend="paged_kernel", **kw)
        out["paged_kernel_spec"] = ["returned", ""]
    except Exception as e:
        out["paged_kernel_spec"] = [type(e).__name__, str(e)]
    return out

if __name__ == "__main__":
    print(json.dumps(spawn_ranks(rank, dp=1, mp=2, device="cpu", timeout_s=120)))
"""

SERVE_MESH = """
import json, sys
import torch
from repro_torch.launch import sharded_smoke as ss
torch.set_num_threads(1)
dp, mp = (int(x) for x in sys.argv[1].split("x"))
jobs = [(ss.Workload(**w), m) for w, m in json.loads(sys.argv[2])]
res = ss.run_smoke([w for w, _ in jobs], dp=dp, mp=mp, device="cpu",
                   mesh_matched=[m for _, m in jobs], timeout_s=float(sys.argv[3]))
print(json.dumps(res))
"""


def _start(args):
    return subprocess.Popen([sys.executable, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT, env=ENV)


def _finish(proc):
    out, err = proc.communicate(timeout=TIMEOUT_S + 60)
    return proc.returncode, out, err


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every spawn of this file at once: the two meshes' rows and the two
    launchers."""
    out = tmp_path_factory.mktemp("smoke") / "smoke.json"
    procs = {mesh: _start(["-c", SERVE_MESH, mesh, json.dumps(rows), str(TIMEOUT_S)])
             for mesh, rows in ROWS.items()}
    procs["smoke"] = _start(["-m", "repro_torch.launch.sharded_smoke", "--device", "cpu",
                             "--mesh", "1x2", "--layers", "2", "--requests", "3",
                             "--prompt-len", "8", "--max-new", "3", "--out", str(out)])
    procs["serve"] = _start(["-m", "repro_torch.launch.serve", "--arch", "minicpm-2b",
                             "--requests", "4", "--prompt-len", "8", "--max-new", "4",
                             "--page-size", "4", "--prefill-chunk", "4", "--mesh", "1x2",
                             "--attn-backend", "paged_kernel", "--device", "cpu"])
    script = tmp_path_factory.mktemp("served") / "live_served.py"
    script.write_text(LIVE_SERVED)
    procs["live_served"] = _start([str(script)])
    done = {name: _finish(p) for name, p in procs.items()}
    done["smoke_json"] = out
    return done


def _row(runs, mesh):
    rc, out, err = runs[mesh]
    assert rc == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


CASES = [(mesh, i) for mesh, rows in ROWS.items() for i in range(len(rows))]


@pytest.mark.parametrize("mesh,i", CASES,
                         ids=[f"{m}-{ROWS[m][i][0]['arch']}-{ROWS[m][i][0]['attn_backend']}"
                              f"-page{ROWS[m][i][0].get('page_size', 4)}" for m, i in CASES])
def test_sharded_tokens_match(runs, mesh, i):
    res = _row(runs, mesh)[i]
    w, matched = ROWS[mesh][i]
    assert res["ranks_agree"], "the ranks' tokens differ"
    assert len(res["tokens_sharded"]) == w["n_requests"]
    if matched:     # the hybrid: the mesh run against itself one request at a time
        assert res["matched_identical"], "the batched mesh run differs from the mesh-matched one"
    else:           # dense: the strict claim, token for token against mesh=None
        assert res["tokens_sharded"] == res["tokens_single"]
    mode = "head" if w.get("page_size", 4) % 2 else "lane"
    assert res["pool"]["mode"] == mode and res["pool"]["count"] == 2
    assert res["pool_split"], (res["pool_bytes_rank"], res["pool_bytes_single"])
    assert res["wire_flat"], (res["wire_per_step"], res["wire_per_step_big"])
    assert all(len(w) == 1 and w[0] > 0 for w in res["wire_per_step"])
    assert res["ok"]


def test_sharded_smoke_cli(runs):
    rc, out, err = runs["smoke"]
    assert rc == 0, err[-4000:]
    res = json.loads(runs["smoke_json"].read_text())
    assert res["identical_outputs"] and res["wire_flat"] and res["pool_split"] and res["ok"]
    assert res["mesh"] == "1x2" and res["device"] == "cpu"
    assert "identical_outputs=True" in out


def test_serve_cli_mesh(runs):
    rc, out, err = runs["serve"]
    assert rc == 0, err[-4000:]
    assert "served 4/4 requests" in out and "(mesh 1x2 of 2 ranks)" in out
    assert out.count("served 4/4") == 1, "only rank 0 reports"


def _tiny(arch):
    cfg = configs.get(arch).reduced()
    return build_model(cfg, device="cpu")


PROMPTS = [list(range(1, 11)), list(range(1, 9)) + [40, 41]]     # LIVE_SERVED's


def _solo(model, prompt, max_new):
    return generate(model, torch.tensor([prompt], dtype=torch.int32), max_new,
                    seq_len=24)[0].tolist()


def _served(runs, case):
    """What the live (1, 2) spawn served for ``case`` (LIVE_SERVED), on
    every rank alike."""
    rc, out, err = runs["live_served"]
    assert rc == 0, err[-4000:]
    ranks = json.loads(out.strip().splitlines()[-1])
    assert all(r == ranks[0] for r in ranks), "the ranks disagree"
    r = ranks[0]
    dense = _tiny("minicpm-2b")
    if case == "moe speculation":
        got = r["moonshot-v1-16b-a3b"]
        assert got["spec"] == got["plain"] and len(got["spec"]) == 2
        assert got["spec_stats"]["spec_rounds"] > 0
    elif case == "speculation":
        got = r["minicpm-2b"]
        for rid, prompt in zip(("r0", "r1"), PROMPTS):
            assert got["spec"][rid] == _solo(dense, prompt, 6)
        assert got["spec_stats"]["spec_accepted"] > 0
    elif case == "index_journal":
        # every published full page journaled, as this rank's 2 of 4 lanes
        assert r["index_journal_puts"] > 0 and r["index_blob_shapes"]
        assert all(shape[2] == 2 for shape in r["index_blob_shapes"])
    elif case == "externalize_session":
        rec = r["record"]
        assert rec["blob_key"] and rec["pages"] == [] and rec["slot"] is None
        assert rec["mesh_shape"] == [1, 2] and "length" in rec["state"]
        assert rec["blob_lanes"] == 2
    elif case == "adopt_parked":
        assert r["adopted"]["r2"] == _solo(dense, r["next"], 4)
        assert r["adopted_stats"]["park_hits"] == 1
    elif case == "adopt_index_journal":
        assert r["index_adopted"] > 0 and r["index_hits"] == 1
        assert r["after_index"]["r3"] == _solo(dense, PROMPTS[1], 4)


# each case keeps the id it had while its path was refused under a mesh:
# the paths served since are held on the live (1, 2) spawn (LIVE_SERVED);
# the abstract mesh still raises, and so does speculation on the paged
# kernel, with the reference's ValueError
MESH_CASES = [
    ("the MoE family", "served", "moe speculation"),
    ("speculative decoding \\(s", "served", "speculation"),
    ("abstract mesh is ROADMAP", "raises", "abstract mesh is ROADMAP 1.9"),
    ("index_journal=True", "served", "index_journal"),
    ("externalize_session", "served", "externalize_session"),
    ("adopt_parked", "served", "adopt_parked"),
    ("adopt_index_journal", "served", "adopt_index_journal"),
    ("paged_kernel speculation", "raises",
     "speculative decoding needs attn_backend='gather'"),
]


@pytest.mark.parametrize("kind,case", [(k, c) for _, k, c in MESH_CASES],
                         ids=[i for i, _, _ in MESH_CASES])
def test_mesh_refusals_raise(runs, kind, case):
    """What ``mesh=`` refuses, it refuses as the reference does; what it
    once refused and now serves, it serves (the live (1, 2) spawn)."""
    if kind == "served":
        _served(runs, case)
        return
    model = _tiny("minicpm-2b")
    if case.startswith("abstract"):
        with pytest.raises(NotImplementedError, match=case):
            DecodeScheduler(model, device="cpu", mesh=AbstractMesh((1, 2), ("data", "model")))
        return
    rc, out, err = runs["live_served"]
    assert rc == 0, err[-4000:]
    for r in json.loads(out.strip().splitlines()[-1]):
        kind, msg = r["paged_kernel_spec"]
        assert kind == "ValueError" and re.search(case, msg), r["paged_kernel_spec"]
