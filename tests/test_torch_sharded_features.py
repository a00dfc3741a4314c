"""Ring mode, the SSM family, offload, prefix sharing and parking under a
mesh (``DecodeScheduler(mesh=...)``) on spawned gloo ranks on the CPU.

The seeded event soup of the scheduler differential harness (fresh,
multi-turn and shared-system-prompt admissions across five sessions,
forced preemptions with offload, parking with a TTL, prefix sharing and
its copy-on-write splits; ``launch/sharded_smoke.event_soup``) runs on
every rank of a (1, 2) and a (2, 2) mesh, with ``audit()`` after every step
on every rank, and on ``mesh=None`` in the parent:

* a small minicpm-2b on both attention backends: every completion equals
  the port's solo ``generate`` token for token (the reference's ``solo``
  claim);
* a small recurrentgemma-2b, paged and in ring mode, on (1, 2): every
  completion equals its mesh-matched eviction-free run (the reference's
  ``sched`` claim: the same sharded scheduler, one request at a time);
* a small mamba2-1.3b (its SSD state split on heads), paged on (1, 2) and
  (2, 2) and in ring mode on (1, 2): token for token ``mesh=None``'s.

Every row also holds: each rank's page blobs are its lane or head shard of
the ``mesh=None`` run's blobs, bitwise, the billed storage journals are
equal, the page moves send no collective bytes, each rank holds
``1/|model|`` of the pool, the rings and the SSD state, and a decode step's
collective bytes are the same at a pool 4x larger (twice ``max_seq`` for
rings).  In process: ``ssd_scan_shard``'s plain version over 2 and 4 head
shards against the JAX package's Pallas scan in interpret mode and its
``ssd_chunked`` (with ``h0`` and the final state); ring writes and
attention over a T-split and a head-split ring against the unsharded
calls, the collectives emulated by threads, and the same over 2 gloo ranks
against the in-process form to 1e-6.  The launchers run as their users run
them: ``sharded_smoke --device cpu --kv-mode ring`` and ``serve --mesh 1x2
--offload --park-sessions --device cpu``.  Every spawn bounds its
collectives and its join (``spawn_ranks(timeout_s=...)``), and every
subprocess its own run, so nothing here hangs past its timeout.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.models.mamba2 import ssd_chunked
from repro_torch import configs
from repro_torch.dist import sharding as shd
from repro_torch.dist.compat import AbstractMesh
from repro_torch.kernels.ssd_scan import ssd_scan_plain, ssd_scan_shard
from repro_torch.models import build_model, kvcache
from repro_torch.serve.engine import generate

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
TIMEOUT_S = 240
ATOL = {"float32": 2e-4, "bfloat16": 3e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MAX_SEQ = 32

SOUP = dict(n_slots=4, max_seq=MAX_SEQ, page_size=4, prefill_chunk=3,
            soup=dict(sessions=5))
FEATURES = dict(offload=True, prefix_sharing=True, park_sessions=True)
# (workload, reference): "solo" = solo generate, "sched" = the mesh-matched
# eviction-free run, "single" = mesh=None's tokens.  The seeds cover every
# mechanism between them (test_soups_exercise_every_mechanism).
# Each key is one spawn (its mesh before the dash); all run at once.
ROWS = {
    "1x2-dense": [
        (dict(SOUP, arch="minicpm-2b", n_layers=2, attn_backend="gather", seed=4,
              park_ttl_steps=6, **FEATURES), "solo"),
        (dict(SOUP, arch="minicpm-2b", n_layers=2, attn_backend="paged_kernel", seed=5,
              park_ttl_steps=6, **FEATURES), "solo"),
        (dict(SOUP, arch="recurrentgemma-2b", attn_backend="paged_kernel", seed=4,
              park_ttl_steps=18, **FEATURES), "sched"),
    ],
    "1x2-rec": [
        (dict(SOUP, arch="recurrentgemma-2b", attn_backend="gather", kv_mode="ring", seed=4),
         "sched"),
        (dict(SOUP, arch="mamba2-1.3b", n_layers=2, attn_backend="gather", seed=4,
              **FEATURES), "single"),
        (dict(SOUP, arch="mamba2-1.3b", n_layers=2, attn_backend="gather", kv_mode="ring",
              seed=3), "single"),
    ],
    "2x2": [
        (dict(SOUP, arch="minicpm-2b", n_layers=2, attn_backend="gather", seed=2,
              park_ttl_steps=6, **FEATURES), "solo"),
        (dict(SOUP, arch="minicpm-2b", n_layers=2, attn_backend="paged_kernel", seed=4,
              park_ttl_steps=6, **FEATURES), "solo"),
        (dict(SOUP, arch="mamba2-1.3b", n_layers=2, attn_backend="gather", seed=5,
              **FEATURES), "single"),
    ],
}

SOUP_MESH = """
import json, sys
import torch
from repro_torch.launch import sharded_smoke as ss
if __name__ == "__main__":
    torch.set_num_threads(1)
    dp, mp = (int(x) for x in sys.argv[1].split("-")[0].split("x"))
    rows = json.loads(sys.argv[2])
    ws = [ss.Workload(**dict(w, soup=ss.Soup(**w["soup"]))) for w, _ in rows]
    res = ss.run_smoke(ws, dp=dp, mp=mp, device="cpu", timeout_s=float(sys.argv[3]),
                       mesh_matched=[ref == "sched" for _, ref in rows])
    print(json.dumps(res))
"""

RING_ATTN = textwrap.dedent("""
    import json
    import torch
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.sharded_smoke import spawn_ranks
    from repro_torch.models import kvcache

    def rank(mesh):
        m, r = mesh.shape[1], mesh.get_coordinate()[1]
        out = {}
        for key, (mode, dtype, S, window) in CASES.items():
            whole, q, positions, upto = ring_case(mode, dtype, S)
            shard = shd.RingShard(mode, r, m, whole["k"].shape[1], whole["k"].shape[2])
            policy = shd.ShardingPolicy.default(mesh, ring=shard)
            with shd.activation_sharding(policy):
                got = kvcache.attend_cache(local_ring(whole, shard), q, positions, upto,
                                           window=window)
            out[key] = got.float().tolist()
        return out

    if __name__ == "__main__":
        print(json.dumps(spawn_ranks(rank, dp=1, mp=2, device="cpu", timeout_s=120)))
""")


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
    """Every spawn of this file at once: the two meshes' soups, the ring
    attention over two ranks and the two launchers."""
    tmp = tmp_path_factory.mktemp("features")
    ring_script = tmp / "ring_attn.py"
    ring_script.write_text(RING_ATTN.replace(
        "from repro_torch.models import kvcache\n",
        "from repro_torch.models import kvcache\n" + _ring_helpers(), 1))
    out = tmp / "ring_smoke.json"
    procs = {mesh: _start(["-c", SOUP_MESH, mesh, json.dumps(rows), str(TIMEOUT_S)])
             for mesh, rows in ROWS.items()}
    procs["ring_attn"] = _start([str(ring_script)])
    procs["ring_cli"] = _start(["-m", "repro_torch.launch.sharded_smoke", "--device", "cpu",
                                "--kv-mode", "ring", "--mesh", "1x2", "--layers", "2",
                                "--requests", "3", "--prompt-len", "8", "--max-new", "3",
                                "--out", str(out)])
    procs["serve_cli"] = _start(["-m", "repro_torch.launch.serve", "--arch", "minicpm-2b",
                                 "--requests", "6", "--sessions", "2", "--batch-size", "2",
                                 "--prompt-len", "8", "--max-new", "4", "--page-size", "4",
                                 "--prefill-chunk", "4", "--kv-pages", "4", "--mesh", "1x2",
                                 "--offload", "--park-sessions", "--device", "cpu"])
    done = {name: _finish(p) for name, p in procs.items()}
    done["ring_json"] = out
    return done


def _json_line(runs, name, line=-1):
    rc, out, err = runs[name]
    assert rc == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[line])


_MODELS = {}


def _model(arch, n_layers, seed):
    if (arch, n_layers, seed) not in _MODELS:
        cfg = dataclasses.replace(configs.get(arch).reduced(), n_layers=n_layers)
        _MODELS[(arch, n_layers, seed)] = build_model(cfg, device="cpu", seed=seed)
    return _MODELS[(arch, n_layers, seed)]


CASES = [(mesh, i) for mesh, rows in ROWS.items() for i in range(len(rows))]


@pytest.mark.parametrize("mesh,i", CASES,
                         ids=[f"{m}-{ROWS[m][i][0]['arch']}-{ROWS[m][i][0].get('kv_mode', 'paged')}"
                              f"-{ROWS[m][i][0]['attn_backend']}" for m, i in CASES])
def test_event_soup_on_the_mesh(runs, mesh, i):
    res = _json_line(runs, mesh)[i]
    w, ref = ROWS[mesh][i]
    assert res["ranks_agree"], "the ranks' tokens differ"
    assert res["requests"] >= 5
    if ref == "solo":
        model = _model(w["arch"], w["n_layers"], w["seed"])
        for session, name, prompt, max_new, tokens in res["completions"]:
            want = generate(model, torch.tensor([prompt], dtype=torch.int32), max_new,
                            seq_len=MAX_SEQ)[0].tolist()
            assert tokens == want, f"{name} ({session}) diverged from solo generate"
        assert res["identical_outputs"], "the mesh run differs from mesh=None"
    elif ref == "sched":
        assert res["matched_identical"], "the mesh run differs from its mesh-matched run"
    else:
        assert res["identical_outputs"], "the mesh run differs from mesh=None"
    for verdict in ("pool_split", "ring_split", "state_split"):
        assert res.get(verdict) in (None, True), (verdict, res)
    if w["arch"] == "mamba2-1.3b":
        assert res["ssm"]["mode"] == "head" and res["state_split"]
    if w.get("kv_mode") == "ring" and w["arch"] == "recurrentgemma-2b":
        assert res["ring"]["mode"] == "seq" and res["ring_split"]     # one kv head: T splits
    assert res["wire_flat"], (res["wire_per_step"], res["wire_per_step_big"])
    assert res["pages_move_no_bytes"], (res["page_wire_bytes"], res["preempt_wire"])
    assert res["journals_equal"], "a rank's storage journal differs from mesh=None's"
    if res["pool"] is not None:     # bitwise on the CPU, where the tokens agree too
        assert res["blobs_bitwise"], "a rank's blob is not its shard of mesh=None's"
    assert res["ok"]


def test_soups_exercise_every_mechanism(runs):
    """Between them the soups preempt and restore, hit parked sessions and
    the prefix index, split shared pages, reclaim and offload parked
    slots, expire journals, and move slot rows over data on (2, 2)."""
    keys = ("preemptions", "restores", "park_hits", "index_hits", "cow_splits",
            "park_evictions", "park_offloads", "park_expirations")
    totals = dict.fromkeys(keys, 0)
    blobs = 0
    for mesh in ROWS:
        for res in _json_line(runs, mesh):
            for key in keys:
                totals[key] += res["stats"].get(key, 0)
            blobs += res["blobs"]
    assert all(n > 0 for n in totals.values()), totals
    assert totals["restores"] == totals["preemptions"] and blobs > 0
    assert any(b > 0 for res in _json_line(runs, "2x2") for b in res["row_wire_bytes"])


# ---------------------------------------------------------------------------
# The SSD scan per head shard
# ---------------------------------------------------------------------------


def _ssd_inputs(seed, B, L, H, P, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    Bm = (rng.standard_normal((B, L, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, L, N)) * 0.5).astype(np.float32)
    h0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, h0


def _shards(x, dt, A, Bm, Cm, h0, m, chunk):
    w = x.shape[2] // m
    parts = [ssd_scan_shard(x, dt, A, Bm, Cm, None if h0 is None else h0[:, r * w:(r + 1) * w],
                            shard=r, n_shards=m, chunk=chunk) for r in range(m)]
    return torch.cat([p[0] for p in parts], 2), torch.cat([p[1] for p in parts], 1)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_shards_match_the_jax_pallas_scan(dtype, m):
    """The shards' y, concatenated over heads, against the JAX Pallas scan
    in interpret mode (as the JAX kernel tests run it), at the JAX kernel
    tests' tolerances; and against the port's unsharded plain call to fp32
    summation order."""
    x, dt, A, Bm, Cm, _ = _ssd_inputs(m * 10 + len(dtype), 2, 37, 8, 8, 16)
    jx, jdt, jB, jC = (jnp.asarray(a, dtype) for a in (x, dt, Bm, Cm))
    want = np.asarray(jax_ssd_scan(jx, jdt, jnp.asarray(A), jB, jC, chunk=8, bh=2,
                                   interpret=True), np.float32)
    tx, tB, tC = (torch.from_numpy(a).to(TDT[dtype]) for a in (x, Bm, Cm))
    tdt = torch.from_numpy(np.array(jdt, np.float32))
    y, h = _shards(tx, tdt, torch.from_numpy(A), tB, tC, None, m, 8)
    assert y.dtype == TDT[dtype] and y.shape == (2, 37, 8, 8) and h.shape == (2, 8, 8, 16)
    np.testing.assert_allclose(y.float().numpy(), want, atol=ATOL[dtype], rtol=ATOL[dtype])
    yw, hw = ssd_scan_plain(tx, tdt, torch.from_numpy(A), tB, tC, chunk=8)
    np.testing.assert_allclose(y.float().numpy(), yw.float().numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(h.numpy(), hw.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("L", [1, 24])
def test_ssd_shards_with_h0_match_ssd_chunked(m, L):
    """From a live state, a prefill chunk and a one-token decode step: the
    shards' y and final states, concatenated over heads, against the JAX
    model's ``ssd_chunked`` at fp32 2e-4."""
    arrays = _ssd_inputs(L + m, 3, L, 8, 8, 16)
    jy, jh = ssd_chunked(*(jnp.asarray(a) for a in arrays[:5]), 8, h0=jnp.asarray(arrays[5]))
    y, h = _shards(*(torch.from_numpy(a) for a in arrays), m, 8)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL["float32"],
                               rtol=ATOL["float32"])
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ATOL["float32"],
                               rtol=ATOL["float32"])


def test_ssd_shard_refuses_a_bad_split():
    x, dt, A, Bm, Cm, h0 = (torch.from_numpy(a) for a in _ssd_inputs(0, 1, 4, 6, 4, 8))
    with pytest.raises(ValueError, match="does not split"):
        ssd_scan_shard(x, dt, A, Bm, Cm, shard=0, n_shards=4)
    with pytest.raises(ValueError, match="the shard's state"):
        ssd_scan_shard(x, dt, A, Bm, Cm, h0, shard=0, n_shards=2)


# ---------------------------------------------------------------------------
# Split rings: writes and attention
# ---------------------------------------------------------------------------

RING_B, RING_T, RING_HKV, RING_G, RING_D = 2, 12, 2, 2, 16
RING_CASES = {f"{mode}/{dtype}/S{S}/w{window}": (mode, dtype, S, window)
              for mode in ("seq", "head") for dtype in ("float32", "bfloat16")
              for S, window in ((1, None), (1, 5), (3, None))}


def ring_case(mode, dtype, S):
    """A wrapped ring (its oldest lanes overwritten), an empty lane, and q
    at the positions after the ring's newest token."""
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    g = torch.Generator().manual_seed(len(mode) * 7 + S)
    k = torch.randn(RING_B, RING_T, RING_HKV, RING_D, generator=g).to(dt)
    v = torch.randn(RING_B, RING_T, RING_HKV, RING_D, generator=g).to(dt)
    length = torch.tensor([17, 9], dtype=torch.int32)     # slot 0 wrapped, slot 1 not full
    lane = torch.arange(RING_T, dtype=torch.int32)
    newest = length - 1
    positions = newest[:, None] - (newest[:, None] - lane[None]) % RING_T
    positions = torch.where(positions >= 0, positions, -1)
    positions[1, 10] = -1
    q = torch.randn(RING_B, S, RING_HKV * RING_G, RING_D, generator=g).to(dt)
    qpos = length[:, None] + torch.arange(S, dtype=torch.int32)
    whole = {"k": k, "v": v, "positions": positions}
    return whole, q, qpos, length + S


def local_ring(whole, shard):
    """This shard's part of a whole layer ring: its kv heads, or its lanes
    and a scratch lane holding a live-looking garbage token (never read)."""
    if shard.mode == "head":
        lo, hi = shard.heads()
        return {"k": whole["k"][:, :, lo:hi].clone(), "v": whole["v"][:, :, lo:hi].clone(),
                "positions": whole["positions"].clone()}
    lo, hi = shard.lanes()
    out = {}
    for key in ("k", "v", "positions"):
        part = whole[key][:, lo:hi]
        pad = part[:, :1].clone()
        pad.fill_(5 if key == "positions" else 100)
        out[key] = torch.cat([part, pad], dim=1)
    return out


def _ring_helpers() -> str:
    import inspect

    consts = (f"RING_B, RING_T, RING_HKV, RING_G, RING_D = "
              f"{(RING_B, RING_T, RING_HKV, RING_G, RING_D)}\nCASES = {RING_CASES!r}\n")
    return consts + "\n".join(textwrap.dedent(inspect.getsource(f))
                              for f in (ring_case, local_ring))


class _ThreadGroup:
    """The model axis of ``n`` ranks emulated by threads: an all-reduce is
    a barrier, the operands summed (or maxed) in rank order."""

    def __init__(self, n: int):
        self.n = n
        self.barrier = threading.Barrier(n)
        self.parts = [None] * n

    def reduce(self, rank: int, t: torch.Tensor, op: str) -> torch.Tensor:
        self.parts[rank] = t.clone()
        self.barrier.wait()
        stacked = torch.stack(self.parts)
        out = stacked.sum(0) if op == "sum" else stacked.amax(0)
        self.barrier.wait()
        return t.copy_(out)


@dataclasses.dataclass(frozen=True)
class _ThreadPolicy(shd.ShardingPolicy):
    group: _ThreadGroup = None
    rank: int = 0

    def all_reduce(self, t, op="sum", axis=None):
        self.wire.bytes += t.numel() * t.element_size()
        self.wire.calls += 1
        return self.group.reduce(self.rank, t, op)


def _in_process(mode, dtype, S, window, m=2):
    whole, q, qpos, upto = ring_case(mode, dtype, S)
    group = _ThreadGroup(m)
    outs = [None] * m

    def run(r):
        shard = shd.RingShard(mode, r, m, RING_T, RING_HKV)
        base = shd.ShardingPolicy.default(AbstractMesh((1, m), ("data", "model")), ring=shard)
        policy = _ThreadPolicy(**{f.name: getattr(base, f.name)
                                  for f in dataclasses.fields(shd.ShardingPolicy)},
                               group=group, rank=r)
        with shd.activation_sharding(policy):
            outs[r] = kvcache.attend_cache(local_ring(whole, shard), q, qpos, upto,
                                           window=window)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(m)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    want = kvcache.attend_cache(whole, q, qpos, upto, window=window)
    return outs, want


@pytest.mark.parametrize("key", list(RING_CASES))
def test_split_ring_attention_in_process(key):
    """A T-split and a head-split ring's ``attend_cache`` (the scratch
    lane's garbage left out), the model axis's collectives emulated by
    threads, against the unsharded call: fp32 to summation order, bf16 to
    one rounding; every rank's output the same."""
    mode, dtype, S, window = RING_CASES[key]
    outs, want = _in_process(mode, dtype, S, window)
    for got in outs:
        assert got.shape == want.shape and got.dtype == want.dtype
        assert torch.equal(got, outs[0])
        err = (got.float() - want.float()).abs().max().item()
        assert err <= (1e-5 if dtype == "float32" else ATOL["bfloat16"]), (key, err)
    if mode == "head":     # one rank computes each head: exact
        assert torch.equal(outs[0], want)


def test_split_ring_attention_over_gloo(runs):
    """Over 2 gloo ranks the split rings' attention equals the in-process
    form to 1e-6."""
    ranks = _json_line(runs, "ring_attn")
    assert len(ranks) == 2 and set(ranks[0]) == set(RING_CASES)
    for key, (mode, dtype, S, window) in RING_CASES.items():
        outs, _ = _in_process(mode, dtype, S, window)
        for r, res in enumerate(ranks):
            err = (torch.tensor(res[key]) - outs[r].float()).abs().max().item()
            assert err <= 1e-6, (key, r, err)


@pytest.mark.parametrize("mode", ["seq", "head"])
def test_split_ring_writes_are_the_whole_rings_slices(mode):
    """``cache_update_layer`` on a ring shard (a prefill longer than the
    ring, a wrapping chunk, S=1 steps) and ``cache_insert_slot`` of a whole
    B=1 cache leave each shard exactly its slice of what the unsharded
    calls leave."""
    m = 2
    T = RING_T
    g = torch.Generator().manual_seed(3)
    whole = {"k": torch.zeros(RING_B, T, RING_HKV, RING_D),
             "v": torch.zeros(RING_B, T, RING_HKV, RING_D),
             "positions": torch.full((RING_B, T), -1, dtype=torch.int32)}
    shards = [shd.RingShard(mode, r, m, T, RING_HKV) for r in range(m)]
    locals_ = [local_ring(whole, s) for s in shards]
    pos = torch.tensor([0, 3], dtype=torch.int32)
    for S in (T + 5, 7, 1, 1):
        k = torch.randn(RING_B, S, RING_HKV, RING_D, generator=g)
        v = torch.randn(RING_B, S, RING_HKV, RING_D, generator=g)
        kvcache.cache_update_layer(whole, k, v, pos)
        for s, lc in zip(shards, locals_):
            policy = shd.ShardingPolicy.default(AbstractMesh((1, m), ("data", "model")), ring=s)
            with shd.activation_sharding(policy):
                kvcache.cache_update_layer(lc, k, v, pos)
                assert kvcache.cache_capacity(lc) == T
        pos = pos + S
    for s, lc in zip(shards, locals_):
        want = local_ring(whole, s)
        n = lc["k"].shape[1] - s.scratch
        for key in ("k", "v", "positions"):
            assert torch.equal(lc[key][:, :n], want[key][:, :n]), (mode, key)
    # a whole B=1 cache (a ring prefill run whole) inserted into a slot row
    batch = {"k": torch.zeros(1, 3, locals_[0]["k"].shape[1], *locals_[0]["k"].shape[2:]),
             "v": torch.zeros(1, 3, locals_[0]["v"].shape[1], *locals_[0]["v"].shape[2:]),
             "positions": torch.full((1, 3, locals_[0]["positions"].shape[1]), -1,
                                     dtype=torch.int32),
             "length": torch.zeros(3, dtype=torch.int32)}
    one = {key: whole[key][None, :1] for key in ("k", "v", "positions")}
    one["length"] = torch.tensor(17, dtype=torch.int32)
    policy = shd.ShardingPolicy.default(AbstractMesh((1, m), ("data", "model")), ring=shards[1])
    with shd.activation_sharding(policy):
        kvcache.cache_insert_slot(batch, one, 2)
    want = local_ring({key: whole[key][:1] for key in ("k", "v", "positions")}, shards[1])
    n = batch["k"].shape[2] - shards[1].scratch
    for key in ("k", "v", "positions"):
        assert torch.equal(batch[key][0, 2, :n], want[key][0, :n]), key
    assert int(batch["length"][2]) == 17


def test_serving_cache_specs_place_rings_and_ssm_rows():
    """Rings: kv heads on model when they divide, else T (positions
    following it); the SSD state on heads; conv and h on dp alone; every
    slot axis on dp when the slots divide."""
    mesh = AbstractMesh((2, 2), ("data", "model"))
    meta = dict(device="meta")
    cache = {"k": torch.empty(3, 4, 8, 2, 16, **meta), "v": torch.empty(3, 4, 8, 2, 16, **meta),
             "positions": torch.empty(3, 4, 8, dtype=torch.int32, **meta),
             "length": torch.empty(4, **meta), "h": torch.empty(2, 4, 64, **meta),
             "conv": torch.empty(2, 4, 3, 64, **meta)}
    specs = shd.serving_cache_specs(cache, mesh, batch_shardable=True)
    assert specs["k"] == shd.P(None, ("data",), None, "model", None)
    assert specs["positions"] == shd.P(None, ("data",), None)
    assert specs["h"] == shd.P(None, ("data",), None)
    assert specs["conv"] == shd.P(None, ("data",), None, None)
    mqa = dict(cache, k=torch.empty(3, 4, 8, 1, 16, **meta), v=torch.empty(3, 4, 8, 1, 16, **meta))
    specs = shd.serving_cache_specs(mqa, mesh, batch_shardable=False)
    assert specs["k"] == shd.P(None, None, "model", None, None)
    assert specs["positions"] == shd.P(None, None, "model")
    assert shd.RingShard.for_ring(specs["k"], (3, 4, 8, 1, 16), mesh).mode == "seq"
    ssm = {"ssm": torch.empty(4, 4, 8, 16, 16, **meta), "conv": torch.empty(4, 4, 3, 96, **meta),
           "length": torch.empty(4, **meta), "page_table": torch.empty(4, 8, **meta)}
    specs = shd.serving_cache_specs(ssm, mesh, batch_shardable=True)
    assert specs["ssm"] == shd.P(None, ("data",), "model", None, None)
    assert specs["conv"] == shd.P(None, ("data",), None, None)
    shard = shd.SSMShard.for_state(specs["ssm"], (4, 4, 8, 16, 16), mesh)
    assert shard.mode == "head" and shard.heads() == (0, 4)
    ring = shd.RingShard("seq", 1, 2, 8, 1)
    assert ring.lanes() == (4, 8) and ring.heads() == (0, 1) and ring.scratch == 1
    assert shd.RingShard("head", 1, 2, 8, 4).heads() == (2, 4)


def test_blob_nbytes_bills_the_whole_blob():
    blob = {"kp": torch.zeros(2, 3, 2, 4, 8, dtype=torch.bfloat16),
            "vp": torch.zeros(2, 3, 2, 4, 8, dtype=torch.bfloat16)}
    rows = {"length": torch.zeros(1, dtype=torch.int32), "h": torch.zeros(1, 1, 8)}
    assert kvcache.blob_nbytes(blob, 2) == 2 * kvcache.blob_nbytes(blob) == 2 * 2 * 768
    assert kvcache.blob_nbytes(rows, 2) == kvcache.blob_nbytes(rows) == 36


@pytest.mark.parametrize("fault", ["none", "drift", "stale", "misrouted"])
def test_blob_agreement_reads_layer_zero_and_each_layers_scale(fault):
    """``sharded_smoke.blob_agreement`` on a rank holding lanes [2, 4) of a
    whole blob: a bf16 rounding past layer 0 keeps layer 0 bitwise and
    stays small over its layer's scale; a page from another slot past
    layer 0 is far off its layer's scale; a misrouted page breaks layer 0."""
    from repro_torch.launch.sharded_smoke import blob_agreement, blob_shard

    g = torch.Generator().manual_seed(0)
    whole = {k: torch.randn(3, 2, 4, 2, 8, generator=g).to(torch.bfloat16) for k in ("kp", "vp")}
    pool = {"mode": "lane", "index": 1, "count": 2}
    got = {k: v.clone() for k, v in blob_shard(whole, pool).items()}
    if fault == "drift":
        got["kp"][2] = (got["kp"][2].float() * (1 + 2 ** -8)).to(torch.bfloat16)
    elif fault == "stale":
        got["vp"][1, 0] = torch.randn(2, 2, 8, generator=g).to(torch.bfloat16)
    elif fault == "misrouted":
        got = {k: v.flip(1) for k, v in got.items()}
    res = blob_agreement([{"blobs": [("b", got)], "pool": pool}], {"blobs": [("b", whole)]})
    assert res["blobs_bitwise"] == (fault == "none")
    assert res["blob_layer0_bitwise"] == (fault != "misrouted")
    assert len(res["blob_rel_err_by_layer"]) == 3
    assert (res["blob_rel_err_by_layer"][0] == 0.0) == (fault != "misrouted")
    if fault in ("none", "drift"):
        assert res["blob_rel_err"] <= 2 ** -7 and res["blob_rel_err_whole"] <= 2 ** -7
    else:
        assert res["blob_rel_err"] > 0.1


# ---------------------------------------------------------------------------
# The launchers
# ---------------------------------------------------------------------------


def test_sharded_smoke_ring_cli(runs):
    rc, out, err = runs["ring_cli"]
    assert rc == 0, err[-4000:]
    res = json.loads(runs["ring_json"].read_text())
    assert res["kv_mode"] == "ring" and res["mesh"] == "1x2" and res["device"] == "cpu"
    assert res["ring"]["mode"] == "head" and res["ring_split"] and res["wire_flat"]
    assert res["identical_outputs"] and res["ok"]
    assert "identical_outputs=True" in out and "2x max_seq" in out


def test_serve_cli_mesh_offload_and_parking(runs):
    rc, out, err = runs["serve_cli"]
    assert rc == 0, err[-4000:]
    assert "served 6/6 requests" in out and "(mesh 1x2 of 2 ranks)" in out
    assert out.count("served 6/6") == 1, "only rank 0 reports"
    assert "kv offload:" in out and "prefix sharing:" in out
