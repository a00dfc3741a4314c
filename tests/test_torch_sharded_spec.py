"""Speculative decoding under a mesh (``DecodeScheduler(mesh=...,
draft_model=..., spec_k=k)``) on spawned gloo ranks on the CPU.

The JAX package's four sharded speculation rows
(``tests/test_sched_differential.py``'s ``SHARDED_SPEC_SEEDS``: target,
(draft arch, draft seed, k), reference, seed) run the port's sharded event
soup (``launch/sharded_smoke.soup_events``: fresh, multi-turn and
shared-system-prompt admissions across five sessions, forced preemptions
with offload, parking with a TTL, prefix sharing) on every rank of a (1, 2)
and a (2, 2) mesh, ``audit()`` after every step on every rank, with the
gather backend and greedy sampling:

* the dense rows (a self-draft, and a draft reseeded +7 at k = 2): every
  completion equals the port's solo non-speculative ``generate`` token for
  token (the reference's ``solo`` claim);
* the MoE rows (a minicpm-2b draft that disagrees, and a self-draft):
  every completion equals the mesh-matched scheduler without speculation
  (the same sharded scheduler serving each request alone: the reference's
  ``sched`` claim).

Every row also holds: every rank's tokens agree, the soup on the mesh is
``mesh=None``'s speculative soup (its requests depend on when its streams
end), the billed storage journals are equal, page moves send no collective
bytes, and one round's collective bytes are the same at a pool 4x larger.

The hybrid row (recurrentgemma-2b with a minicpm-2b draft, on (1, 2)) is
not held to tokens.  The port's models compute in bf16 (the module
constant ``models.layers.COMPUTE_DTYPE``, not a config field), so the
reduced config cannot run in fp32; in bf16 the verify chunk scores k + 1
tokens in one call where the reference consumes them one S=1 step at a
time, the two shapes reassociate differently on a mesh, and the recurrence
feeds that drift back on itself (the reason the reference has no hybrid
row).  It holds the mechanism instead: ``audit()`` clean after every step
on every rank, the ranks' tokens equal, and at least one partial accept
rolled back and replayed.

Against the JAX package: one verify chunk on a (1, 2) mesh, teacher-forced
on a greedy stream after a chunked prefill, on the JAX model's weights
(``weights.params_from_jax``): its logits within 3e-2 of the logit scale of
the JAX model's verify scoring (``decode_step`` on the same k + 1 tokens,
which the JAX ``make_spec_verify_step`` argmaxes), and the accepted counts
the JAX verify derives from the port's argmax tokens; on a (1, 1) mesh the
same step is bitwise ``mesh=None``'s.  Every spawn bounds its collectives
and its join (``spawn_ranks(timeout_s=...)``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import kvcache as jkv
from repro.serve import engine as jengine
from repro_torch import configs
from repro_torch.models import build_model
from repro_torch.serve.engine import generate
from repro_torch.serve.scheduler import DecodeScheduler
from test_torch_model import assert_logits_agree, jax_and_port
from test_torch_spec import ForcedArgmax

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
TIMEOUT_S = 240
MAX_SEQ = 32
K = 3

SOUP = dict(n_slots=4, max_seq=MAX_SEQ, page_size=4, prefill_chunk=3, attn_backend="gather",
            offload=True, prefix_sharing=True, park_sessions=True, park_ttl_steps=6,
            soup=dict(sessions=5))
# the JAX package's SHARDED_SPEC_SEEDS: (target, (draft arch, draft seed, k), reference, seed)
SPEC_ROWS = [
    ("minicpm-2b", ("minicpm-2b", 0, 3), "solo", 0),
    ("minicpm-2b", ("minicpm-2b", 7, 2), "solo", 1),
    ("moonshot-v1-16b-a3b", ("minicpm-2b", 0, 3), "sched", 0),
    ("moonshot-v1-16b-a3b", ("moonshot-v1-16b-a3b", 0, 3), "sched", 2),
]
HYBRID_ROW = ("recurrentgemma-2b", ("minicpm-2b", 0, 3), "mechanism", 0)
N_LAYERS = {"minicpm-2b": 2}


def _workload(arch, spec, seed):
    return dict(SOUP, arch=arch, n_layers=N_LAYERS.get(arch), seed=seed, spec=list(spec))


# each key is one spawn (its mesh); all run at once
ROWS = {"1x2": [(_workload(a, sp, s), ref) for a, sp, ref, s in SPEC_ROWS + [HYBRID_ROW]],
        "2x2": [(_workload(a, sp, s), ref) for a, sp, ref, s in SPEC_ROWS]}

SOUP_MESH = """
import json, sys
import torch
from repro_torch.launch import sharded_smoke as ss
if __name__ == "__main__":
    torch.set_num_threads(1)
    dp, mp = (int(x) for x in sys.argv[1].split("x"))
    rows = json.loads(sys.argv[2])
    ws = [ss.Workload(**dict(w, soup=ss.Soup(**w["soup"]), spec=tuple(w["spec"])))
          for w, _ in rows]
    res = ss.run_smoke(ws, dp=dp, mp=mp, device="cpu", timeout_s=float(sys.argv[3]),
                       mesh_matched=[ref == "sched" for _, ref in rows])
    print(json.dumps(res))
"""

# one verify chunk on a mesh, teacher-forced: the ranks load the weights
# the test wrote, prefill each slot's prompt through the scheduler's chunk
# step on pages the test maps, and score the verify tokens
VERIFY_MESH = """
import json, sys
import torch
from repro_torch.launch.sharded_smoke import spawn_ranks

def rank(mesh, path):
    from repro_torch import configs
    from repro_torch.models import build_model
    from repro_torch.serve.scheduler import DecodeScheduler
    case = torch.load(path)
    model = build_model(configs.get("minicpm-2b").reduced(), device="cpu")
    model.load_state_dict(case["state"])
    sched = DecodeScheduler(model, n_slots=case["vt"].shape[0], max_seq=case["max_seq"],
                            page_size=case["page_size"], device="cpu", mesh=mesh,
                            draft_model=model, spec_k=case["vt"].shape[1] - 1)
    for b, (prompt, row) in enumerate(zip(case["prompts"], case["rows"])):
        sched._page_rows[b, :len(row)] = row
        sched._set_row(b)
        sched._chunk(sched.cache, prompt[None], b)
    rows = sched._rows
    y, a, logits = sched._verify(sched.cache, case["vt"][rows], case["active"][rows],
                                 case["k_eff"][rows], None, None, None)
    return {"logits": logits.float().tolist(), "y": y.tolist(), "a": a.tolist(),
            "length": sched.cache["length"].tolist()}

if __name__ == "__main__":
    torch.set_num_threads(1)
    out = {mesh: spawn_ranks(rank, (sys.argv[1],), dp=1, mp=int(mesh[-1]), device="cpu",
                             timeout_s=float(sys.argv[2])) for mesh in ("1x2", "1x1")}
    print(json.dumps(out))
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


PS, MP, PROMPTS = 4, 6, (13, 9)      # the verify case: page size, pages a slot, prompt lengths


def _verify_case(tmp):
    """The JAX model and params, the port model on the same weights, the
    verify inputs (each slot's newest token, then its greedy continuation
    as the drafts, slot 1's second draft wrong), and the JAX verify's
    logits over a prefill of the same prompts."""
    jm, jp, tm = jax_and_port("minicpm-2b")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tm.cfg.vocab, size=n).astype(np.int32) for n in PROMPTS]
    rows = [list(range(b * MP, (b + 1) * MP)) for b in range(len(PROMPTS))]
    jc = jkv.paged_cache(jm, len(PROMPTS), page_size=PS, n_pages=len(PROMPTS) * MP,
                         max_pages=MP)
    jchunk = jax.jit(jengine.make_chunk_step(jm))
    first = []
    for b, p in enumerate(prompts):
        jc = jkv.set_page_row(jc, b, rows[b])
        logits, jc = jchunk(jp, jc, jnp.asarray(p[None]), b)
        first.append(int(jnp.argmax(logits[0, -1])))
    jstep = jax.jit(jengine.make_decode_step(jm))
    tok, cont, c = jnp.asarray(first, jnp.int32), [], jc
    for _ in range(K):
        tok, _, c = jstep(jp, c, tok[:, None])
        cont.append(np.asarray(tok))
    drafts = np.stack(cont, axis=1)
    drafts[1, 1] = (drafts[1, 1] + 1) % tm.cfg.vocab
    vt = np.concatenate([np.asarray(first, np.int32)[:, None], drafts], axis=1).astype(np.int32)
    active, k_eff = np.asarray([True, True]), np.asarray([K, K], np.int32)
    want, _ = jax.jit(jm.decode_step)(jp, jc, jnp.asarray(vt))
    path = tmp / "verify_case.pt"
    torch.save({"state": tm.state_dict(), "prompts": [torch.from_numpy(p) for p in prompts],
                "rows": rows, "vt": torch.from_numpy(vt), "active": torch.from_numpy(active),
                "k_eff": torch.from_numpy(k_eff), "max_seq": MAX_SEQ, "page_size": PS}, path)
    return {"jm": jm, "jp": jp, "jc": jc, "tm": tm, "vt": vt, "active": active,
            "k_eff": k_eff, "want": np.asarray(want, np.float32), "path": path,
            "prompts": prompts, "rows": rows}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every spawn of this file at once: the two meshes' soups and the
    verify chunk on (1, 2) and (1, 1)."""
    tmp = tmp_path_factory.mktemp("spec")
    case = _verify_case(tmp)
    procs = {mesh: _start(["-c", SOUP_MESH, mesh, json.dumps(rows), str(TIMEOUT_S)])
             for mesh, rows in ROWS.items()}
    script = tmp / "verify_mesh.py"
    script.write_text(VERIFY_MESH)
    procs["verify"] = _start([str(script), str(case["path"]), str(TIMEOUT_S)])
    done = {name: _finish(p) for name, p in procs.items()}
    done["case"] = case
    return done


def _json_line(runs, name):
    rc, out, err = runs[name]
    assert rc == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


_MODELS = {}


def _model(arch, n_layers, seed):
    import dataclasses

    if (arch, n_layers, seed) not in _MODELS:
        cfg = configs.get(arch).reduced()
        if n_layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        _MODELS[(arch, n_layers, seed)] = build_model(cfg, device="cpu", seed=seed)
    return _MODELS[(arch, n_layers, seed)]


CASES = [(mesh, i) for mesh, rows in ROWS.items() for i in range(len(rows))]


@pytest.mark.parametrize(
    "mesh,i", CASES,
    ids=[f"{m}-{ROWS[m][i][0]['arch']}-draft_{ROWS[m][i][0]['spec'][0]}_{ROWS[m][i][0]['spec'][1]}"
         f"_k{ROWS[m][i][0]['spec'][2]}-{ROWS[m][i][1]}-{ROWS[m][i][0]['seed']}" for m, i in CASES])
def test_spec_soup_on_the_mesh(runs, mesh, i):
    res = _json_line(runs, mesh)[i]
    w, ref = ROWS[mesh][i]
    assert res["ranks_agree"], "the ranks' tokens differ"
    assert res["requests"] >= 5
    stats = res["stats"]
    assert stats["spec_rounds"] > 0 and stats["spec_proposed"] > 0
    if ref == "mechanism":
        # the hybrid: audit() ran clean after every step on every rank (the
        # soup raises otherwise), and a partial accept was rolled back
        assert stats["spec_rollbacks"] > 0, stats
        return
    if ref == "solo":
        model = _model(w["arch"], w["n_layers"], w["seed"])
        for session, name, prompt, max_new, tokens in res["completions"]:
            want = generate(model, torch.tensor([prompt], dtype=torch.int32), max_new,
                            seq_len=MAX_SEQ)[0].tolist()
            assert tokens == want, f"{name} ({session}) diverged from solo generate"
    else:
        assert res["matched_identical"], "the mesh run differs from its mesh-matched run"
    assert res["identical_outputs"], "the mesh soup differs from mesh=None's speculative soup"
    assert res["spec_matches"]
    assert res["journals_equal"] and res["pages_move_no_bytes"]
    # one round's collective bytes: the same first round at a pool 4x larger
    assert res["wire_flat"], (res["wire_one"], res["wire_per_step_big"])
    assert all(b > 0 for b in res["wire_one"])
    assert res["ok"]


def test_spec_soups_accept_and_reject(runs):
    """Between them the rows accept proposals (the self-drafts) and reject
    them (the other drafts), and the soups park, hit the prefix index and
    reclaim parked slots under speculation on the mesh."""
    rows = [(w, res) for mesh in ROWS for (w, _), res in zip(ROWS[mesh], _json_line(runs, mesh))]
    me = [res["stats"] for w, res in rows if tuple(w["spec"][:2]) == (w["arch"], 0)]
    other = [res["stats"] for w, res in rows if tuple(w["spec"][:2]) != (w["arch"], 0)]
    assert sum(s["spec_accepted"] for s in me) > 0
    assert sum(s["spec_accepted"] for s in other) < sum(s["spec_proposed"] for s in other)
    for key in ("park_hits", "index_hits", "park_evictions"):
        assert sum(res["stats"][key] for _, res in rows) > 0, key


def test_verify_chunk_on_the_mesh_matches_jax(runs):
    """The (1, 2) verify chunk's logits (each rank's, the slots whole on
    both) within 3e-2 of the logit scale of the JAX verify scoring, its
    argmax tokens where JAX is decisive, and the accepted counts and
    rewound lengths the JAX verify derives from the port's tokens."""
    case = runs["case"]
    out = _json_line(runs, "verify")
    vocab = case["tm"].cfg.vocab
    for r in out["1x2"]:
        assert_logits_agree(np.asarray(r["logits"], np.float32), case["want"], vocab)
    y = np.asarray(out["1x2"][0]["y"], np.int32)
    assert all(r["y"] == out["1x2"][0]["y"] and r["a"] == out["1x2"][0]["a"]
               for r in out["1x2"])
    n = len(PROMPTS)
    jverify = jax.jit(jengine.make_spec_verify_step(ForcedArgmax(case["jm"], y),
                                                    max_seq=MAX_SEQ))
    jc2, jy, ja, *_ = jverify(case["jp"], case["jc"], jnp.asarray(case["vt"]),
                              jnp.asarray(case["active"]), jnp.asarray(case["k_eff"]),
                              jnp.zeros((n, MAX_SEQ), jnp.int32), jnp.zeros((n,), jnp.int32),
                              jnp.zeros((n,), jnp.int32))
    np.testing.assert_array_equal(np.asarray(out["1x2"][0]["a"]), np.asarray(ja))
    assert out["1x2"][0]["a"][1] == 1, "slot 1's second draft is wrong"
    np.testing.assert_array_equal(np.asarray(out["1x2"][0]["length"]), np.asarray(jc2["length"]))


def test_verify_chunk_on_a_1x1_mesh_is_bitwise_mesh_none(runs):
    """Nothing split: the policy-bound verify chunk on a (1, 1) mesh is the
    ``mesh=None`` scheduler's step, bitwise, on the same cache."""
    case = runs["case"]
    tm = case["tm"]
    sched = DecodeScheduler(tm, n_slots=len(PROMPTS), max_seq=MAX_SEQ, page_size=PS,
                            device="cpu", draft_model=tm, spec_k=K)
    for b, (prompt, row) in enumerate(zip(case["prompts"], case["rows"])):
        sched._page_rows[b, :len(row)] = row
        sched._set_row(b)
        sched._chunk(sched.cache, torch.from_numpy(prompt)[None], b)
    y, a, logits = sched._verify(sched.cache, torch.from_numpy(case["vt"]),
                                 torch.from_numpy(case["active"]),
                                 torch.from_numpy(case["k_eff"]), None, None, None)
    got = _json_line(runs, "verify")["1x1"][0]
    assert torch.equal(torch.tensor(got["logits"], dtype=torch.float32), logits.float())
    assert got["y"] == y.tolist() and got["a"] == a.tolist()
    assert got["length"] == sched.cache["length"].tolist()
