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
``python -m repro_torch.launch.serve --mesh 1x2 --device cpu``.  Each
refusal of ``mesh=`` raises, naming the ROADMAP item that ports it: the
constructor's on an abstract mesh, the fleet's hand-over hooks on a live
(1, 1) mesh in a spawned rank.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch import configs
from repro_torch.dist.compat import AbstractMesh
from repro_torch.models import build_model
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

LIVE_REFUSALS = """
import json
from repro_torch import configs
from repro_torch.launch.sharded_smoke import spawn_ranks
from repro_torch.models import build_model
from repro_torch.serve.scheduler import DecodeScheduler, ParkedSession

def rank(mesh):
    model = build_model(configs.get("minicpm-2b").reduced(), device="cpu")
    sched = DecodeScheduler(model, device="cpu", mesh=mesh, prefix_sharing=True,
                            park_sessions=True)
    calls = {"externalize_session": lambda: sched.externalize_session("s0"),
             "adopt_parked": lambda: sched.adopt_parked(ParkedSession("s0", None, 0, None, [])),
             "adopt_index_journal": sched.adopt_index_journal}
    out = {}
    for name, fn in calls.items():
        try:
            fn()
            out[name] = ["returned", ""]
        except Exception as e:
            out[name] = [type(e).__name__, str(e)]
    return out

if __name__ == "__main__":
    print(json.dumps(spawn_ranks(rank, dp=1, mp=1, device="cpu", timeout_s=120)))
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
    script = tmp_path_factory.mktemp("refusals") / "live_refusals.py"
    script.write_text(LIVE_REFUSALS)
    procs["live_refusals"] = _start([str(script)])
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


REFUSALS = [
    # the MoE family is served on a mesh (tests/test_torch_moe_mesh_serving.py);
    # its speculation still raises
    ("moonshot-v1-16b-a3b", dict(spec_k=2, draft="self"),
     r"speculative decoding \(spec_k > 0\) under mesh=, ROADMAP 1\.8b-iii"),
    ("minicpm-2b", dict(spec_k=2, draft="self"),
     r"speculative decoding \(spec_k > 0\) under mesh=, ROADMAP 1\.8b-iii"),
    ("minicpm-2b", dict(), "abstract mesh is ROADMAP 1.9"),
    ("minicpm-2b", dict(index_journal=True, prefix_sharing=True),
     r"index_journal=True under mesh=, ROADMAP 1\.8b-iii"),
    # the fleet's hand-over hooks, on a live (1, 1) mesh (LIVE_REFUSALS)
    ("minicpm-2b", dict(call="externalize_session"),
     r"externalize_session under mesh=, ROADMAP 1\.8b-iii"),
    ("minicpm-2b", dict(call="adopt_parked"), r"adopt_parked under mesh=, ROADMAP 1\.8b-iii"),
    ("minicpm-2b", dict(call="adopt_index_journal"),
     r"adopt_index_journal under mesh=, ROADMAP 1\.8b-iii"),
]


@pytest.mark.parametrize("arch,kw,match", REFUSALS,
                         ids=["the MoE family" if a.startswith("moonshot") else
                              m.split(" under")[0][:24] for a, _, m in REFUSALS])
def test_mesh_refusals_raise(runs, arch, kw, match):
    kw = dict(kw)
    call = kw.pop("call", None)
    if call is not None:
        rc, out, err = runs["live_refusals"]
        assert rc == 0, err[-4000:]
        got = json.loads(out.strip().splitlines()[-1])[0][call]
        assert got[0] == "NotImplementedError" and re.search(match, got[1]), got
        return
    model = _tiny(arch)
    if kw.pop("draft", None):
        kw["draft_model"] = model
    with pytest.raises(NotImplementedError, match=match):
        DecodeScheduler(model, device="cpu", mesh=AbstractMesh((1, 2), ("data", "model")),
                        **kw)
