"""The port's offload, sharing and parking slice against the JAX package.

Host bookkeeping is exact across the frameworks: ``page_hashes`` gives the
same bytes, and the allocator and ``PrefixIndex`` give the same page ids
and refcounts over one op sequence.  The kvcache page and row helpers are
pure copies, so they match bitwise on the same numpy inputs.

The whole slice: the JAX ``DecodeScheduler`` and the port's, on the same
weights (``params_from_jax``) and the same trace — fresh admissions,
multi-turn extensions, a shared system prompt, a pool small enough that
parked journals offload and admissions preempt, and forced preemptions —
end with equal ``stats()`` counters and blob-store meters, and hold equal
page-table rows after every step.  The port is teacher-forced on the JAX
token stream (each multi-turn extension is built from that stream), and
its logits agree with the JAX model's on that stream within the
tolerances of the existing scheduler tests (2.5% of the logit scale dense,
5% hybrid).  Through the serving frontend both bill the same storage ops
and the same USD on one workload.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SimCloud as JaxSimCloud
from repro.launch.serve import build_frontend as jax_build_frontend
from repro.launch.serve import spawn_workload as jax_spawn_workload
from repro.models import kvcache as jkv
from repro.serve.lifecycle import SlotState as JaxSlotState
from repro.serve.scheduler import DecodeScheduler as JaxDecodeScheduler
from repro_torch.core import SimCloud
from repro_torch.launch.serve import build_frontend, spawn_workload
from repro_torch.models import kvcache
from repro_torch.serve.lifecycle import SlotState
from test_torch_model import REL_TOL, jax_and_port
from test_torch_scheduler import ForcedScheduler

torch.set_num_threads(2)

MAX_SEQ, PAGE, CHUNK = 32, 4, 3
TOL = {"minicpm-2b": REL_TOL, "recurrentgemma-2b": 5e-2}


# ---------------------------------------------------------------------------
# Host bookkeeping: hashes, allocator, prefix index
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,ps", [(0, 4), (3, 4), (12, 4), (37, 16), (513, 16)])
def test_page_hashes_bytes_equal_reference(n, ps):
    toks = np.random.default_rng(n).integers(0, 151_000, size=n).astype(np.int64)
    assert kvcache.page_hashes(toks, ps) == jkv.page_hashes(toks, ps)


def test_allocator_and_index_match_reference_over_one_op_sequence():
    rng = np.random.default_rng(3)
    ours, theirs = kvcache.PageAllocator(12), jkv.PageAllocator(12)
    idx_o, idx_t = kvcache.PrefixIndex(), jkv.PrefixIndex()
    held = []
    chains = [kvcache.page_hashes(rng.integers(0, 50, size=16), 4) for _ in range(4)]
    for _ in range(200):
        op = rng.choice(["alloc", "share", "release", "publish", "lookup", "evict"])
        if op == "alloc" and ours.free_count:
            k = int(rng.integers(1, ours.free_count + 1))
            got, want = ours.alloc(k), theirs.alloc(k)
            assert got == want
            held += got
        elif op == "share" and held:
            p = held[int(rng.integers(len(held)))]
            ours.share([p])
            theirs.share([p])
            held.append(p)
        elif op == "release" and held:
            p = held.pop(int(rng.integers(len(held))))
            ours.release([p])
            theirs.release([p])
        elif op == "publish" and len(held) >= 4:
            chain = chains[int(rng.integers(len(chains)))]
            pids = [held[int(i)] for i in rng.integers(len(held), size=4)]
            assert idx_o.publish(chain, pids, ours) == idx_t.publish(chain, pids, theirs)
        elif op == "lookup":
            chain = chains[int(rng.integers(len(chains)))]
            assert idx_o.lookup(chain) == idx_t.lookup(chain)
        elif op == "evict":
            need = int(rng.integers(0, 13))
            assert idx_o.evict(ours, need) == idx_t.evict(theirs, need)
        assert ours._free == theirs._free and ours._rc == theirs._rc
        assert idx_o.pages == idx_t.pages and len(idx_o) == len(idx_t)
        assert ours.high_water == theirs.high_water


# ---------------------------------------------------------------------------
# kvcache helpers: pure copies, bitwise on the same inputs
# ---------------------------------------------------------------------------


def _pool(seed):
    rng = np.random.default_rng(seed)
    arrs = {k: rng.standard_normal((3, 9, 4, 2, 5)).astype(np.float32) for k in ("kp", "vp")}
    arrs["page_table"] = rng.integers(-1, 9, size=(2, 4)).astype(np.int32)
    arrs["length"] = np.array([5, 9], np.int32)
    arrs["h"] = rng.standard_normal((2, 2, 6)).astype(np.float32)
    arrs["conv"] = rng.standard_normal((2, 2, 3, 6)).astype(np.float32)
    return (arrs, {k: torch.from_numpy(v.copy()) for k, v in arrs.items()},
            {k: jnp.asarray(v) for k, v in arrs.items()})


def _same(port: dict, ref: dict):
    assert set(port) == set(ref)
    for k in port:
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_page_helpers_bitwise_equal_reference():
    _, ours, theirs = _pool(0)
    ids, dst = [6, 1, 3], [0, 8, 2]
    blob_o, blob_t = kvcache.gather_pages(ours, ids), jkv.gather_pages(theirs, ids)
    _same(blob_o, blob_t)
    kvcache.scatter_pages(ours, dst, blob_o)
    _same({k: ours[k] for k in ("kp", "vp")},
          {k: v for k, v in jkv.scatter_pages(theirs, dst, blob_t).items() if k in ("kp", "vp")})
    _, ours, theirs = _pool(1)
    kvcache.copy_pages(ours, [1, 3], [7, 0])
    out = jkv.copy_pages(theirs, [1, 3], [7, 0])
    _same({k: ours[k] for k in ours}, {k: out[k] for k in ours})
    piece_o, piece_t = kvcache.slice_page_blob(blob_o, 1, 3), jkv.slice_page_blob(blob_t, 1, 3)
    _same(piece_o, piece_t)
    assert kvcache.blob_nbytes(blob_o) == jkv.blob_nbytes(blob_t)


def test_slot_state_helpers_bitwise_equal_reference():
    _, ours, theirs = _pool(2)
    del ours["kp"], ours["vp"], theirs["kp"], theirs["vp"]
    snap_o, snap_t = kvcache.gather_slot_state(ours, 1), jkv.gather_slot_state(theirs, 1)
    _same(snap_o, snap_t)
    kvcache.scatter_slot_state(ours, 0, snap_o)
    out = jkv.scatter_slot_state(theirs, 0, snap_t)
    _same({k: ours[k] for k in ours}, {k: out[k] for k in ours})


# ---------------------------------------------------------------------------
# The whole slice: same trace, same weights
# ---------------------------------------------------------------------------


SCHED_KW = dict(n_slots=3, max_seq=MAX_SEQ, page_size=PAGE, prefill_chunk=CHUNK,
                kv_pages=14, offload=True, prefix_sharing=True, park_sessions=True)


def _jax_trace(jm, jp, vocab, seed=7, n_events=30):
    """Drive the JAX scheduler through a seeded event soup; returns the
    events (iteration -> submits and preempts), the page-table rows after
    every step, its completions, its stats and its blob meters."""
    sched = JaxDecodeScheduler(jm, jp, **SCHED_KW)
    rng = np.random.default_rng(seed)
    sessions = ["a", "b", "c", "d"]
    history = dict.fromkeys(sessions)
    inflight, events, rows, done = {}, {}, [], {}
    shared_sys = rng.integers(0, vocab, size=2 * PAGE).astype(np.int32)
    rid = 0
    it = 0
    while it < n_events or sched.busy():
        ev = events.setdefault(it, [])
        if it < n_events:
            for sess in sessions:
                if sess in inflight or rng.random() >= 0.4:
                    continue
                h = history[sess]
                if h is not None and rng.random() < 0.6 and len(h) + 6 <= MAX_SEQ:
                    prompt = np.concatenate([h, rng.integers(0, vocab, 2).astype(np.int32)])
                elif rng.random() < 0.6:
                    prompt = np.concatenate(
                        [shared_sys, rng.integers(0, vocab, int(rng.integers(2, 7)))
                         .astype(np.int32)])
                else:
                    prompt = rng.integers(0, vocab, int(rng.integers(5, 12))).astype(np.int32)
                max_new = min(int(rng.integers(3, 7)), MAX_SEQ - len(prompt))
                args = (sess, f"r{rid}", prompt, max_new)
                rid += 1
                ev.append(("submit", args))
                inflight[sess] = args
                sched.submit(*args)
            victims = [s.index for s in sched.slots
                       if s.state is JaxSlotState.ACTIVE and s.pages]
            if victims and rng.random() < 0.25:
                v = victims[int(rng.integers(len(victims)))]
                ev.append(("preempt", v))
                sched.preempt(v)
        for fin in sched.step():
            done[fin.request_id] = np.asarray(fin.tokens)
            _, _, prompt, _ = inflight.pop(fin.session)
            history[fin.session] = np.concatenate([prompt, done[fin.request_id]])
        sched.audit()
        rows.append(sched._page_rows.copy())
        it += 1
        assert it < 400
    bs = sched.blob_store
    meters = (bs.puts, bs.gets, bs.deletes, bs.bytes_out, bs.bytes_in, bs.bytes_stored,
              bs.high_water_bytes)
    return events, rows, done, sched.stats(), meters


def _jax_logits(jm, jp, prompt, tokens):
    """The JAX model's logits on its own stream: S=1 steps from an empty
    cache over the prompt, then over each sampled token."""
    step = _jit_step(jm)
    cache = jm.init_cache(1, MAX_SEQ)
    for t in prompt:
        logits, cache = step(jp, cache, jnp.asarray([[t]], jnp.int32))
    out = []
    for t in tokens:
        out.append(np.asarray(logits[0, -1], np.float32))
        logits, cache = step(jp, cache, jnp.asarray([[t]], jnp.int32))
    return out


_STEPS = {}


def _jit_step(jm):
    if id(jm) not in _STEPS:
        _STEPS[id(jm)] = jax.jit(jm.decode_step)
    return _STEPS[id(jm)]


@pytest.mark.parametrize("arch", ["minicpm-2b", "recurrentgemma-2b"])
def test_slice_matches_jax_scheduler_on_one_trace(arch):
    if arch == "recurrentgemma-2b":
        from test_torch_hybrid_serving import jax_and_port as hybrid_pair
        jm, jp, tm = hybrid_pair()
    else:
        jm, jp, tm = jax_and_port(arch)
    events, rows, done, jstats, jmeters = _jax_trace(jm, jp, tm.cfg.vocab)
    jstats_reached = {k: v for k, v in jstats.items() if isinstance(v, int)}
    for key in ("preemptions", "park_hits", "park_offloads", "cow_splits", "restores"):
        assert jstats_reached[key] > 0, f"the trace never reached {key}: {jstats}"
    if arch == "minicpm-2b":
        assert jstats_reached["index_hits"] > 0, jstats

    sched = ForcedScheduler(tm, {rid: toks for rid, toks in done.items()}, device="cpu",
                            **SCHED_KW)
    prompts = {}
    for it, row in enumerate(rows):
        for kind, arg in events.get(it, ()):
            if kind == "submit":
                prompts[arg[1]] = (arg[2], arg[3])
                sched.submit(*arg)
            else:
                assert sched.slots[arg].state is SlotState.ACTIVE
                sched.preempt(arg)
        for fin in sched.step():
            np.testing.assert_array_equal(fin.tokens, done[fin.request_id])
        sched.audit()
        np.testing.assert_array_equal(sched._page_rows, row, err_msg=f"page rows, step {it}")
    assert not sched.busy()
    got = sched.stats()
    assert {k: got[k] for k in got} == {k: jstats[k] for k in got}
    bs = sched.blob_store
    assert (bs.puts, bs.gets, bs.deletes, bs.bytes_out, bs.bytes_in, bs.bytes_stored,
            bs.high_water_bytes) == jmeters

    # teacher-forced logits against the JAX model's on the JAX stream
    rel = TOL[arch]
    assert sched.logits.keys() == {(rid, i) for rid, t in done.items() for i in range(len(t))}
    for rid, toks in done.items():
        want = _jax_logits(jm, jp, prompts[rid][0], toks)
        for i, w in enumerate(want):
            g, w = sched.logits[(rid, i)][:tm.cfg.vocab], w[:tm.cfg.vocab]
            tol = rel * float(np.abs(w).max())
            np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=f"{rid} token {i}")


def test_frontend_billing_equals_jax_frontend():
    """One workload through both serving frontends, offload and parking on:
    the same storage ops, the same op and retention USD, the same object
    reads and writes seen by the simulated cloud."""
    jm, jp, tm = jax_and_port("minicpm-2b")
    kw = dict(mode="continuous", batch_size=2, max_new=6, prompt_len=8, page_size=4,
              kv_pages=6, offload=True, park_sessions=True, prefix_sharing=True)
    work = dict(n_requests=6, sessions=3, prompt_len=8, max_new=6)
    jcloud = JaxSimCloud(seed=0)
    jfe = jax_build_frontend(jcloud, jm.cfg, jm, jp, **kw)
    jax_spawn_workload(jcloud, jfe, vocab=jm.cfg.vocab, **work)
    jcloud.run()
    cloud = SimCloud(seed=0)
    fe = build_frontend(cloud, tm.cfg, tm, device="cpu", **kw)
    spawn_workload(cloud, fe, vocab=tm.cfg.vocab, **work)
    cloud.run()
    js, ps = jfe.serving_stats(), fe.serving_stats()
    assert ps["offload_storage_ops"] > 0 and ps["preemptions"] + ps["park_offloads"] > 0
    for key in ("offload_storage_ops", "offload_puts", "offload_gets", "offload_bytes",
                "restore_bytes", "preemptions", "restores", "park_offloads", "park_hits"):
        assert ps[key] == js[key], key
    assert ps["offload_storage_usd"] == pytest.approx(js["offload_storage_usd"], rel=1e-12)
    assert ps["park_storage_usd"] == pytest.approx(js["park_storage_usd"], rel=1e-9)
    for kind in ("obj_read", "obj_write"):
        assert cloud.op_counts.get(kind, 0) == jcloud.op_counts.get(kind, 0), kind
