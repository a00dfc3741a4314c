"""The port's FaaSKeeper core against the JAX package's, op for op.

Both packages hold their own copy of the coordination service (host code:
the simulated cloud, the DynamoDB/S3 stores, the writer, distributor,
watch and heartbeat functions, sessions and the kazoo-like client).  A
seeded op soup — create (plain, ephemeral, sequential), set, delete, get,
get_children and exists with watches, concurrent write bursts, session
close, heartbeat eviction of a failed client, the timed ``Lock``
primitive, and ``FaultPlan`` crashes in the writer and distributor — runs
on each package's ``FaaSKeeperService`` over a ``SimCloud`` of the same
seed.  The two sides must return the same values, ``Stat``s and errors,
deliver the same watch events in the same order, end at the same virtual
time (every latency is drawn from the cloud's generator, so one draw out
of order moves the clock), and leave the same store contents and function
statistics.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import repro.core as ref_core
import repro_torch.core as port_core

SEEDS = list(range(12))
PATHS = ("/a", "/b", "/a/x", "/a/y", "/b/z", "/a/x/q")
WRITER_POINTS = ("after_lock", "after_validate", "after_push", "after_commit")
DIST_POINTS = ("after_getnode", "after_dataupdate", "after_epoch_add", "after_notify")
N_OPS = 40


def _value(x):
    """A comparable form of one op's outcome."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, dataclasses.astuple(x))
    if isinstance(x, tuple):
        return tuple(_value(v) for v in x)
    if isinstance(x, list):
        return [_value(v) for v in x]
    return x


def _soup(core, seed: int) -> dict:
    """Run one seeded soup on ``core`` (a package's ``core`` module) and
    return everything it observed."""
    rng = np.random.default_rng(1000 + seed)
    crashes = {}
    for point in WRITER_POINTS:
        if rng.random() < 0.3:
            crashes[("writer", point)] = int(rng.integers(0, 4))
    for point in DIST_POINTS:
        if rng.random() < 0.3:
            crashes[("distributor", point)] = int(rng.integers(0, 4))
    cloud = core.SimCloud(seed=seed, faults=core.FaultPlan(crashes=crashes))
    svc = core.FaaSKeeperService(cloud, heartbeat_timeout=1.0)
    clients = {f"s{i}": svc.connect_sync(f"s{i}") for i in range(3)}
    live = sorted(clients)
    trace = []

    def call(sess, name, *args, **kw):
        try:
            out = getattr(clients[sess], name)(*args, **kw)
            trace.append((sess, name, args, _value(out)))
        except core.FKError as e:
            trace.append((sess, name, args, "error", type(e).__name__))

    def guarded(gen):
        try:
            out = yield from gen
            return "ok", _value(out)
        except core.FKError as e:
            return "error", type(e).__name__

    for i in range(N_OPS):
        if not live:
            break
        sess = live[int(rng.integers(len(live)))]
        path = PATHS[int(rng.integers(len(PATHS)))]
        roll = rng.random()
        if roll < 0.22:
            call(sess, "create", path, f"d{i}".encode(),
                 ephemeral=bool(rng.random() < 0.3), sequence=bool(rng.random() < 0.15))
        elif roll < 0.38:
            version = -1 if rng.random() < 0.6 else int(rng.integers(0, 3))
            call(sess, "set_data", path, f"v{i}".encode(), version=version)
        elif roll < 0.46:
            call(sess, "delete", path)
        elif roll < 0.58:
            call(sess, "get_data", path, watch=bool(rng.random() < 0.5))
        elif roll < 0.68:
            call(sess, "get_children", path, watch=bool(rng.random() < 0.5))
        elif roll < 0.74:
            call(sess, "exists", path, watch=bool(rng.random() < 0.5))
        elif roll < 0.82:
            # a concurrent burst: every live client writes at once
            tasks = [(s, cloud.spawn(guarded(clients[s].client.set_data(
                path, f"b{i}{s}".encode())), name=f"burst:{s}")) for s in live]
            cloud.run()
            for s, t in tasks:
                trace.append((s, "burst", path, t.result))
        elif roll < 0.88:
            # the timed lock primitive on the system store
            key = f"lock:{path}"
            lock, _ = cloud.run_task(svc.prim.lock_acquire(key, cloud.now))
            again, _ = cloud.run_task(svc.prim.lock_acquire(key, cloud.now))
            released = (cloud.run_task(svc.prim.lock_release(key, lock))
                        if lock is not None else None)
            trace.append((sess, "lock", key, _value(lock), _value(again), released))
        elif roll < 0.93 and len(live) > 1:
            # heartbeat eviction: the client stops answering, a sweep evicts
            # its session and its ephemerals
            clients[sess].client.failed = True
            svc.start_heartbeat(period=1.0, max_runs=1)
            cloud.run()
            live.remove(sess)
            trace.append((sess, "evicted", cloud.now))
        elif roll < 0.97 and len(live) > 1:
            clients[sess].close()
            cloud.run()
            live.remove(sess)
            trace.append((sess, "closed", cloud.now))
        else:
            cloud.run()
            trace.append(("tick", cloud.now))
    cloud.run()
    watches = {s: [ev for ev in c.client.inbox.events if ev.get("kind") == "watch"]
               for s, c in clients.items()}
    stats = {name: dataclasses.astuple(st) for name, st in svc.runtime.stats.items()}
    return {
        "trace": trace,
        "watches": watches,
        "now": cloud.now,
        "kv": svc.kv.tables,
        "kv_units": (svc.kv.read_units, svc.kv.write_units),
        "objects": {r: s.objects for r, s in svc.data_stores.items()},
        "stats": stats,
        "crashes": crashes,
        "cost": svc.cost_summary(),
    }


@pytest.mark.parametrize("seed", SEEDS)
def test_op_soup_matches_the_reference(seed):
    ref = _soup(ref_core, seed)
    port = _soup(port_core, seed)
    assert port["trace"] == ref["trace"]
    assert port["watches"] == ref["watches"]
    assert port["now"] == ref["now"]
    assert port["kv"] == ref["kv"]
    assert port["kv_units"] == ref["kv_units"]
    assert port["objects"] == ref["objects"]
    assert port["stats"] == ref["stats"]
    # the soup did real work on the service
    assert len(ref["trace"]) >= 10 and ref["stats"]["writer"][0] > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_cost_summary_matches_the_reference(seed):
    """``cost_summary()`` after the same soup: the reference's five totals,
    key by key, exactly (both read the SimCloud's virtual meters)."""
    ref = _soup(ref_core, seed)["cost"]
    port = _soup(port_core, seed)["cost"]
    assert list(port) == ["queue_usd", "s3_usd", "dynamodb_usd", "functions_usd", "total_usd"]
    assert port == ref
    assert port["total_usd"] > 0


def test_soups_cover_the_paths():
    """Across the seeds, the soups reach every kind of op, raise errors,
    deliver watches, evict a session and crash both functions."""
    kinds, errors, delivered, crashed = set(), 0, 0, set()
    for seed in SEEDS:
        out = _soup(port_core, seed)
        for ev in out["trace"]:
            kinds.add(ev[1])
            errors += "error" in ev
        delivered += sum(len(v) for v in out["watches"].values())
        crashed |= {name for name, st in out["stats"].items() if st[2]}
    assert {"create", "set_data", "delete", "get_data", "get_children", "exists",
            "burst", "lock", "evicted", "closed"} <= kinds
    assert errors > 0 and delivered > 0
    assert {"writer", "distributor"} <= crashed


def test_simcloud_additions_draw_nothing():
    """The pieces the core added to the port's SimCloud (quantiles,
    ``record``, cancellable timers, futures) draw nothing from its
    generator: a cancelled timer does not advance the clock, and the
    latency samples after them are the reference's."""
    out = []
    for core in (ref_core, port_core):
        cloud = core.SimCloud(seed=3)
        tok = cloud.schedule_cancellable(50.0, lambda: None)
        tok["cancelled"] = True
        cloud.record("m", 1.0)
        assert cloud.lat["kv_read"].p(0.5) > 0
        cloud.run()
        out.append((cloud.now, [cloud.sample("obj_read", 2.0) for _ in range(5)],
                    core.percentiles([1.0, 2.0, 3.0])))
    assert out[0] == out[1] and out[0][0] == 0.0
