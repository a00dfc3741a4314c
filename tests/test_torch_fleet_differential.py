"""Randomized fleet differential harness, in the port.

The JAX package's fleet event soup, the port's own copy — submits (fresh /
multi-turn extension / cross-session shared prefix), scale-up bursts,
forced scale-downs, worker crashes mid-decode / mid-park / mid-restore
through ``FaultPlan``, wedged workers reaped by heartbeat eviction on the
port's own ``FaaSKeeperService`` — drives the port's ``FleetController``
of disposable ``DecodeScheduler`` workers over one shared blob store.
Every completed request must equal the port's own eviction-free solo
``generate`` token for token; the fleet-wide ledger is audited after every
controller tick, and at quiescence the store holds only committed
journals and index blobs.  The seeds are the JAX package's tier-1 matrix
(``TIER1_SEEDS``: dense 4, moe 2, hybrid 2), seeded the same way, so a
soup here draws the events the JAX soup of the same (arch, seed) draws.

Against the JAX fleet itself: the same soups run on the port with the JAX
model's weights (``params_from_jax``) beside the JAX package's own run.
Where every completed stream is equal on both sides, the two fleets made
the same decisions — the ``WorkerEvent`` feed and the ``fleet_stats()``
gauges must be equal too.  bf16 near-ties may split a stream across the
frameworks; such a soup is not compared.  Every dense soup is covered
(asserted); the MoE and hybrid soups split (printed: 4 of the 8 soups
are compared).

The scale-to-zero round trip and its crash-during-drain fallback are
ported as dedicated scenarios.
"""

from __future__ import annotations

import dataclasses
import json
import zlib
from pathlib import Path
from typing import Optional

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.coord import MembershipService
from repro_torch.core import FaaSKeeperService, FaultPlan, PageBlobStore, SimCloud
from repro_torch.models import build_model
from repro_torch.serve.engine import generate
from repro_torch.serve.fleet import PARK_META_PREFIX, FleetController
from repro_torch.serve.scheduler import DecodeScheduler

torch.set_num_threads(2)

MAX_SEQ = 32
PAGE_SIZE = 4
N_SLOTS = 2
MAX_WORKERS = 3
PREFILL_CHUNK = 3
MAX_NEW = (2, 4)
FRESH_LEN = (5, 12)
EXTEND_LEN = (1, 4)
N_EVENTS = 22
CRASH_POINTS = ("mid-decode", "mid-restore", "mid-park")

TIER1_SEEDS = ([("minicpm-2b", s) for s in range(4)]
               + [("moonshot-v1-16b-a3b", s) for s in range(2)]
               + [("recurrentgemma-2b", s) for s in range(2)])

FAILURE_DIR = Path("artifacts/diff_failures")

_ARCH_CACHE = {}


class SoloRef:
    """Eviction-free solo greedy reference, memoized per (prompt, budget)."""

    def __init__(self, model):
        self.model = model
        self._memo = {}

    def run(self, prompt, max_new: int) -> np.ndarray:
        key = (np.asarray(prompt, np.int32).tobytes(), max_new)
        if key not in self._memo:
            toks = torch.from_numpy(np.asarray(prompt, np.int32))[None]
            self._memo[key] = generate(self.model, toks, max_new, seq_len=MAX_SEQ)[0].numpy()
        return self._memo[key]


def _fleet_of(model, n_workers=MAX_WORKERS, drain_idle_steps=3, **kw) -> FleetController:
    store = PageBlobStore()
    workers = [DecodeScheduler(model, n_slots=N_SLOTS, max_seq=MAX_SEQ, page_size=PAGE_SIZE,
                               prefill_chunk=PREFILL_CHUNK, offload=True,
                               prefix_sharing=True, park_sessions=True, blob_store=store,
                               index_journal=True, device="cpu")
               for _ in range(n_workers)]
    return FleetController(workers, min_workers=0, scale_to_zero=True,
                           drain_idle_steps=drain_idle_steps, **kw)


def _arch(name, weights: str = "port"):
    """(config, fleet, solo reference) for ``name``'s reduced config.  The
    fleet is built once and ``reset()`` between sequences — the same
    recycle path a worker death takes.  ``weights='port'`` draws the
    port's own seed-0 weights; ``'jax'`` carries the JAX model's
    ``init(key(0))`` across (the JAX harness's weights)."""
    if (name, weights) not in _ARCH_CACHE:
        cfg = configs.get(name).reduced()
        if weights == "port":
            model = build_model(cfg, device="cpu", seed=0)
        else:
            from test_torch_model import jax_and_port

            model = jax_and_port(name)[2]
        _ARCH_CACHE[(name, weights)] = (cfg, _fleet_of(model), SoloRef(model))
    return _ARCH_CACHE[(name, weights)]


def _quiesce_ledger(fleet: FleetController) -> None:
    """At quiescence the shared store may hold only committed state: park
    journals a ``park-meta`` record points at, the meta records, and
    content-addressed index blobs — no preempt spills, no orphans."""
    meta_blobs = {m["blob_key"] for m in fleet._iter_metas().values()}
    for key in fleet.blob_store.blobs:
        assert not key.startswith("kv/"), f"leaked preempt spill {key!r}"
        if key.startswith("park/"):
            assert key in meta_blobs, f"orphaned park journal {key!r}"


def _run_fleet_sequence(arch: str, seed: int, log: Optional[list] = None,
                        weights: str = "port") -> list:
    """One seeded fleet event sequence (the JAX harness's draws, in its
    order); appends every event to ``log`` and raises on any parity or
    ledger violation."""
    cfg, fleet, ref = _arch(arch, weights)
    tag = f"fleet-{arch}"
    rng = np.random.default_rng(zlib.crc32(tag.encode()) * 100003 + seed)

    crashes = {}
    for k in range(MAX_WORKERS):
        for point in CRASH_POINTS:
            if rng.random() < 0.25:
                crashes[(f"fleet:w{k}", point)] = int(rng.integers(0, 6))
    fleet.reset(faults=FaultPlan(crashes=crashes))
    cloud = SimCloud(seed=seed)
    svc = FaaSKeeperService(cloud, regions=("region-0",))
    fleet.membership = MembershipService(svc)

    def sweep():
        # one scheduled-heartbeat run: evicts failed sessions' ephemerals,
        # which is how the controller learns a wedged worker is dead
        svc.start_heartbeat(period=1.0, max_runs=1)
        cloud.run()

    sessions = [f"s{i}" for i in range(int(rng.integers(3, 6)))]
    history = {s: None for s in sessions}
    inflight = {}
    shared_sys = rng.integers(0, cfg.vocab, size=2 * PAGE_SIZE).astype(np.int32)
    log = log if log is not None else []
    log.append({"arch": arch, "seed": seed, "sessions": len(sessions),
                "crashes": [[f, p, n] for (f, p), n in crashes.items()]})
    rid = 0

    def submit(sess):
        nonlocal rid
        h = history[sess]
        roll = rng.random()
        if h is not None and roll < 0.6 and len(h) + 8 <= MAX_SEQ:
            prompt = np.concatenate(
                [h, rng.integers(0, cfg.vocab,
                                 int(rng.integers(*EXTEND_LEN))).astype(np.int32)])
            kind = "extend"
        elif roll < 0.8:
            prompt = np.concatenate(
                [shared_sys, rng.integers(0, cfg.vocab,
                                          int(rng.integers(*FRESH_LEN))).astype(np.int32)])
            kind = "shared"
        else:
            prompt = rng.integers(0, cfg.vocab, int(rng.integers(*FRESH_LEN))).astype(np.int32)
            kind = "fresh"
        max_new = int(rng.integers(MAX_NEW[0], MAX_NEW[1] + 1))
        max_new = min(max_new, MAX_SEQ - len(prompt))
        if max_new < 1:
            history[sess] = None
            return
        name = f"r{rid}"
        rid += 1
        fleet.submit(sess, name, prompt, max_new)
        inflight[sess] = (name, prompt, max_new)
        log.append({"ev": "submit", "session": sess, "rid": name, "kind": kind,
                    "prompt": prompt.tolist(), "max_new": max_new})

    def on_finished(fins):
        for fin in fins:
            name, prompt, max_new = inflight.pop(fin.session)
            assert fin.request_id == name, "per-session FIFO violated across the fleet"
            got = np.asarray(fin.tokens)
            log.append({"ev": "complete", "rid": name, "tokens": got.tolist()})
            np.testing.assert_array_equal(
                got, ref.run(prompt, max_new),
                err_msg=f"{arch} seed {seed} {name}: fleet diverged from the "
                        "eviction-free solo reference")
            history[fin.session] = np.concatenate([prompt, got.astype(np.int32)])

    for _ev in range(N_EVENTS):
        for sess in sessions:
            if sess not in inflight and rng.random() < 0.35:
                submit(sess)
        if rng.random() < 0.08:
            w = fleet.scale_up()
            log.append({"ev": "scale-up", "worker": w.worker_id if w else None})
        if rng.random() < 0.08:
            wid = fleet.scale_down()
            log.append({"ev": "scale-down", "worker": wid})
        if rng.random() < 0.06:
            live = [w.worker_id for w in fleet.workers.values() if w.state != "wedged"]
            if live:
                wid = live[int(rng.integers(len(live)))]
                fleet.fail_worker(wid)
                log.append({"ev": "wedge", "worker": wid})
        if rng.random() < 0.25:
            sweep()
        on_finished(fleet.step())
        fleet.audit()
    guard = 0
    while fleet.busy():
        guard += 1
        assert guard < 500, "fleet failed to drain"
        sweep()                       # wedged workers come back only via
        on_finished(fleet.step())     # heartbeat eviction
        fleet.audit()
        log.append({"ev": "drain-step"})
    guard = 0
    while fleet.live_workers():       # idle cooldown down to zero workers
        guard += 1
        assert guard < 100, "fleet failed to scale to zero"
        sweep()
        fleet.step()
        fleet.audit()
    assert not inflight, f"requests lost: {inflight}"
    _quiesce_ledger(fleet)
    fleet.audit()
    return log


def _run_and_dump(arch: str, seed: int, weights: str = "port") -> list:
    log: list = []
    try:
        return _run_fleet_sequence(arch, seed, log, weights)
    except Exception as e:
        FAILURE_DIR.mkdir(parents=True, exist_ok=True)
        path = FAILURE_DIR / f"seq_fleet_torch_{arch}_{seed}_{weights}.json"
        path.write_text(json.dumps(
            {"arch": arch, "seed": seed, "weights": weights, "error": str(e)[:2000],
             "repro": f"_run_fleet_sequence({arch!r}, {seed}, weights={weights!r})",
             "events": log}, indent=2))
        raise


@pytest.mark.parametrize("arch,seed", TIER1_SEEDS, ids=[f"{a}-{s}" for a, s in TIER1_SEEDS])
def test_fleet_differential(arch, seed):
    log = _run_and_dump(arch, seed)
    fleet = _arch(arch)[1]
    kinds = {ev.get("ev") for ev in log}
    assert "complete" in kinds and fleet.spawns > 0 and fleet.retires + fleet.crashes \
        + fleet.evictions == fleet.spawns


def _completions(log):
    return [(ev["rid"], ev["tokens"]) for ev in log if ev.get("ev") == "complete"]


@pytest.mark.parametrize("arch", ["minicpm-2b", "moonshot-v1-16b-a3b", "recurrentgemma-2b"])
def test_fleet_decisions_match_the_jax_fleet(arch):
    """On the JAX model's weights, every soup whose completed streams are
    equal across the frameworks also has an equal ``WorkerEvent`` feed,
    equal ``fleet_stats()`` gauges and the same blob keys at quiescence:
    the port's controller and workers made the reference's decisions
    (routing, autoscale, drains, crashes, evictions, journal and meta
    traffic).  Every dense soup must be covered; an MoE or hybrid soup can
    split at a bf16 near-tie (a flipped route, a recurrent row's rounding),
    after which the two soups draw different prompts and are not compared."""
    import tests.test_fleet_differential as jfd

    covered = []
    seeds = [s for a, s in TIER1_SEEDS if a == arch]
    for seed in seeds:
        jlog = jfd._run_fleet_sequence(arch, seed)
        jfleet = jfd._arch(arch)[3]
        plog = _run_and_dump(arch, seed, weights="jax")
        pfleet = _arch(arch, "jax")[1]
        if _completions(plog) != _completions(jlog):
            continue
        assert [dataclasses.astuple(e) for e in pfleet.events] == \
            [dataclasses.astuple(e) for e in jfleet.events], seed
        assert pfleet.fleet_stats() == jfleet.fleet_stats(), seed
        assert sorted(pfleet.blob_store.blobs) == sorted(jfleet.blob_store.blobs), seed
        covered.append(seed)
    print(f"{arch}: fleet decisions compared on {len(covered)}/{len(seeds)} soups "
          f"(seeds {covered})")
    if arch == "minicpm-2b":
        assert covered == seeds


# ---------------------------------------------------------------------------
# Scale-to-zero round trip (and its crash-during-drain fallback)
# ---------------------------------------------------------------------------


def _drive(fleet: FleetController, max_steps: int = 500) -> dict:
    fins = {}
    for _ in range(max_steps):
        for fin in fleet.step():
            fins[fin.request_id] = fin
        fleet.audit()
        if not fleet.busy():
            return fins
    raise AssertionError("fleet failed to drain")


def _to_zero(fleet: FleetController, max_steps: int = 60) -> None:
    for _ in range(max_steps):
        if not fleet.live_workers():
            return
        fleet.step()
        fleet.audit()
    raise AssertionError("fleet failed to scale to zero")


def test_scale_to_zero_round_trip():
    """Multi-turn session across a scale-to-zero gap: turn 1 completes, the
    fleet drains to zero (journal and prefix index externalized to blob),
    and turn 2 cold-starts a fresh worker that restores the parked journal,
    re-adopts the index, prefills only the new tokens, and produces the
    never-scaled solo reference's output."""
    cfg, fleet, ref = _arch("minicpm-2b")
    fleet.reset()
    fleet.membership = None
    rng = np.random.default_rng(7)
    p1 = rng.integers(0, cfg.vocab, 10).astype(np.int32)
    fleet.submit("sessA", "t1", p1, 3)
    t1 = np.asarray(_drive(fleet)["t1"].tokens)
    np.testing.assert_array_equal(t1, ref.run(p1, 3))

    _to_zero(fleet)
    assert fleet.live_workers() == 0
    assert PARK_META_PREFIX + "sessA" in fleet.blob_store.blobs, \
        "drain did not commit the parked journal to the directory"
    assert any(k.startswith("index/") for k in fleet.blob_store.blobs), \
        "prefix index was not journaled to blob"
    meta = fleet.blob_store.blobs[PARK_META_PREFIX + "sessA"]
    # a meta is host data: it outlives its worker's device rows
    assert isinstance(meta["history"], np.ndarray) and isinstance(meta["page_row"], np.ndarray)
    assert all(t.device.type == "cpu" for t in meta["state"].values())
    _quiesce_ledger(fleet)

    p2 = np.concatenate([p1, t1.astype(np.int32),
                         rng.integers(0, cfg.vocab, 2).astype(np.int32)])
    fleet.submit("sessA", "t2", p2, 3)
    fin2 = _drive(fleet)["t2"]
    assert fleet.cold_starts_from_zero == 2
    assert fleet.meta_adoptions == 1, "cold start did not adopt the journal"
    assert fleet.fleet_stats()["index_adopted"] > 0, \
        "cold start did not rebuild the prefix index from blob"
    assert fin2.reused_tokens >= len(p1), \
        "cold start re-prefilled tokens the journal already covered"
    np.testing.assert_array_equal(np.asarray(fin2.tokens), ref.run(p2, 3))
    assert PARK_META_PREFIX + "sessA" not in fleet.blob_store.blobs


def test_scale_to_zero_crash_during_drain():
    """A crash between the journal's KV blob PUT and the park-meta PUT
    leaves no directory entry, the orphaned KV blob is garbage-collected,
    and the session's next turn falls back to a full re-prefill: the same
    output, zero reused tokens."""
    cfg, fleet_, ref = _arch("minicpm-2b")
    model = ref.model
    store = PageBlobStore()
    # no prefix sharing: the fallback must not be rescued by the index
    w = DecodeScheduler(model, n_slots=N_SLOTS, max_seq=MAX_SEQ, page_size=PAGE_SIZE,
                        prefill_chunk=PREFILL_CHUNK, park_sessions=True, blob_store=store,
                        device="cpu")
    fleet = FleetController([w], min_workers=0, scale_to_zero=True, drain_idle_steps=2,
                            faults=FaultPlan(crashes={("fleet:w0", "mid-park"): 0}))
    rng = np.random.default_rng(11)
    p1 = rng.integers(0, cfg.vocab, 9).astype(np.int32)
    fleet.submit("sessA", "t1", p1, 3)
    t1 = np.asarray(_drive(fleet)["t1"].tokens)
    np.testing.assert_array_equal(t1, ref.run(p1, 3))

    _to_zero(fleet)
    assert fleet.crashes == 1
    assert PARK_META_PREFIX + "sessA" not in store.blobs, \
        "interrupted drain must not leave a committed directory entry"
    assert not any(k.startswith("park/") for k in store.blobs), \
        "orphaned journal KV blob survived the kill-path GC"

    p2 = np.concatenate([p1, t1.astype(np.int32),
                         rng.integers(0, cfg.vocab, 2).astype(np.int32)])
    fleet.submit("sessA", "t2", p2, 3)
    fin2 = _drive(fleet)["t2"]
    assert fin2.reused_tokens == 0
    assert fleet.meta_adoptions == 0 and fleet.meta_dropped == 0
    np.testing.assert_array_equal(np.asarray(fin2.tokens), ref.run(p2, 3))


def test_hybrid_meta_carries_host_rows_across_workers():
    """A hybrid session parked on one worker, drained to the directory,
    and adopted by the other: the meta's recurrent rows are host copies
    (the first worker's rows are zeroed by its reset before the second
    turn runs), and the second turn equals the solo reference."""
    cfg, _fleet, ref = _arch("recurrentgemma-2b")
    fleet = _fleet_of(ref.model, n_workers=2, drain_idle_steps=1)
    rng = np.random.default_rng(5)
    p1 = rng.integers(0, cfg.vocab, 9).astype(np.int32)
    fleet.submit("sessH", "t1", p1, 3)
    t1 = np.asarray(_drive(fleet)["t1"].tokens)
    np.testing.assert_array_equal(t1, ref.run(p1, 3))
    _to_zero(fleet)
    meta = fleet.blob_store.blobs[PARK_META_PREFIX + "sessH"]
    assert {"h", "conv"} <= set(meta["state"])
    held = {k: v.clone() for k, v in meta["state"].items()}
    # every worker's rows are cleared on recycle; the meta must not change
    for s in fleet._pool:
        assert float(s.cache["h"].abs().sum()) == 0.0
    for k, v in meta["state"].items():
        assert torch.equal(v, held[k])
    p2 = np.concatenate([p1, t1.astype(np.int32), rng.integers(0, cfg.vocab, 2).astype(np.int32)])
    fleet.submit("sessH", "t2", p2, 3)
    fin2 = _drive(fleet)["t2"]
    assert fleet.meta_adoptions == 1 and fin2.reused_tokens > 0
    np.testing.assert_array_equal(np.asarray(fin2.tokens), ref.run(p2, 3))
