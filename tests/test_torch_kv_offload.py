"""Storage-backed KV page offload and the slot lifecycle, in the port.

The cases of the JAX package's ``test_kv_offload.py`` that apply to the
port (its mesh staging-spec case waits for the port's ``mesh=``), on the
port's own models at reduced size: a preempted-then-restored slot decodes
token for token as a never-preempted solo run — dense, moe and hybrid —
because ``gather_pages``/``scatter_pages`` are exact inverses through the
page table and a PREEMPTED slot's rows are frozen under the decode mask;
the pressure/idleness preemption policy; restore funding; lifecycle
legality; crash-reset blob hygiene; billing through the serving frontend;
the startup pool-sizing check.  Blobs live on the host.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import PageBlobStore, SimCloud
from repro_torch.core.cost import page_blob_cost
from repro_torch.launch.serve import (build_frontend, run_serving, spawn_workload,
                                      validate_pool_sizing)
from repro_torch.models import build_model, kvcache
from repro_torch.serve.engine import generate
from repro_torch.serve.lifecycle import IllegalTransition, Slot, SlotState
from repro_torch.serve.scheduler import DecodeScheduler

torch.set_num_threads(2)

PARITY_ARCHS = ["minicpm-2b", "moonshot-v1-16b-a3b", "recurrentgemma-2b"]


def tiny(arch="minicpm-2b"):
    cfg = configs.get(arch).reduced()
    return cfg, build_model(cfg, device="cpu", seed=0)


def solo(model, prompt, n, seq_len):
    return generate(model, torch.from_numpy(prompt)[None], n, seq_len=seq_len)[0].numpy()


def drain(sched, got=None, hooks=None, limit=500):
    """Run a scheduler dry; ``hooks`` maps an iteration index to a callback
    (a forced preemption, a late submit)."""
    got = got if got is not None else {}
    hooks = hooks or {}
    it = 0
    while sched.busy():
        if it in hooks:
            hooks[it](sched)
        for fin in sched.step():
            got[int(fin.request_id[1:])] = fin
        sched.audit()
        it += 1
        assert it < limit, "scheduler failed to drain"
    return got


def sched_for(model, **kw):
    return DecodeScheduler(model, device="cpu", **kw)


# ---------------------------------------------------------------------------
# Lifecycle state machine
# ---------------------------------------------------------------------------


def test_lifecycle_transitions_validated():
    s = Slot(index=0)
    s.to(SlotState.ADMITTING).to(SlotState.ACTIVE).to(SlotState.PREEMPTED)
    with pytest.raises(IllegalTransition):
        s.to(SlotState.ACTIVE)          # preempted must go through RESTORING
    s.to(SlotState.RESTORING)
    with pytest.raises(IllegalTransition):
        s.to(SlotState.PREEMPTED)       # a funded restore runs to completion
    s.to(SlotState.ACTIVE).to(SlotState.DRAINED).to(SlotState.EMPTY)
    with pytest.raises(IllegalTransition):
        Slot(index=1).to(SlotState.ACTIVE)   # EMPTY cannot skip ADMITTING
    s2 = Slot(index=2)
    s2.to(SlotState.ADMITTING)
    s2.force_empty()
    assert s2.state is SlotState.EMPTY and s2.req is None


def test_scheduler_slots_expose_states():
    cfg, model = tiny()
    sched = sched_for(model, n_slots=2, max_seq=16, page_size=4, prefill_chunk=3)
    assert all(s.empty for s in sched.slots)
    sched.submit("s", "r0", np.zeros(7, np.int32), 3)
    assert sched.slots[0].state is SlotState.ADMITTING
    sched.step()                         # chunk 1/3
    assert sched.admitting_slots() == 1 and sched.active_slots() == 0
    drain(sched)
    assert all(s.empty for s in sched.slots)


# ---------------------------------------------------------------------------
# gather/scatter exact-inverse property (scrambled page tables)
# ---------------------------------------------------------------------------


def _round_trip(n_pages, ps, H, D, table_rows, seed):
    """Pages gathered through one (scrambled) page table, scattered into a
    cold pool at other physical pages and gathered again are bit-identical,
    layer-stacked pool included; the blob is on the host."""
    gen = torch.Generator().manual_seed(seed)
    L = 2
    pool = {key: torch.randn((L, n_pages + 1, ps, H, D), generator=gen)
            for key in ("kp", "vp")}
    pool["page_table"] = torch.as_tensor(np.asarray(table_rows, np.int32))
    pool["length"] = torch.zeros((len(table_rows),), dtype=torch.int32)
    for row in table_rows:
        ids = [p for p in row if p >= 0]      # logical order through the table
        if not ids:
            continue
        blob = kvcache.to_host(kvcache.gather_pages(pool, ids))
        assert set(blob) == {"kp", "vp"}
        assert blob["kp"].shape == (L, len(ids), ps, H, D)
        assert all(leaf.device.type == "cpu" for leaf in blob.values())
        new_ids = [(p + 1) % n_pages for p in ids]
        cold = {k: torch.zeros_like(v) for k, v in pool.items()}
        kvcache.scatter_pages(cold, new_ids, blob)
        back = kvcache.gather_pages(cold, new_ids)
        for k in ("kp", "vp"):
            assert torch.equal(back[k], blob[k])
        assert kvcache.blob_nbytes(blob) == sum(
            blob[k].numel() * blob[k].element_size() for k in ("kp", "vp"))


def test_gather_scatter_round_trip_scrambled():
    _round_trip(9, 4, 2, 3, [[5, 2, 7, -1], [1, 6, -1, -1], [-1, -1, -1, -1]], seed=0)


def test_scatter_leaves_other_pages_untouched():
    gen = torch.Generator().manual_seed(1)
    pool = {"kp": torch.randn((1, 4, 2, 2, 2), generator=gen),
            "vp": torch.randn((1, 4, 2, 2, 2), generator=gen),
            "page_table": torch.zeros((1, 2), dtype=torch.int32)}
    before = pool["kp"].clone()
    blob = kvcache.gather_pages(pool, [3])
    kvcache.scatter_pages(pool, [0], blob)          # in place
    assert torch.equal(pool["kp"][:, 1:], before[:, 1:])
    assert torch.equal(pool["kp"][:, 0], before[:, 3])
    piece = kvcache.slice_page_blob(blob, 0, 1)
    assert piece["kp"].shape == (1, 1, 2, 2, 2)


try:  # optional dep, guarded like the JAX package's property tests
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=30, deadline=None)
    @given(st.integers(0, 10_000), st.integers(1, 3), st.integers(1, 4))
    def test_gather_scatter_round_trip_property(seed, rows, max_pages):
        rng = np.random.default_rng(seed)
        n_pages = rows * max_pages + 3
        table = np.full((rows, max_pages), -1, np.int64)
        perm = rng.permutation(n_pages)
        k = 0
        for r in range(rows):               # scrambled, partially-filled rows
            fill = int(rng.integers(0, max_pages + 1))
            table[r, :fill] = perm[k:k + fill]
            k += fill
        _round_trip(n_pages, int(rng.integers(1, 5)), 2, 3, table.tolist(), seed=seed + 1)

except ImportError:

    @pytest.mark.skip(reason="optional dep: property sweeps need hypothesis")
    def test_gather_scatter_round_trip_property():
        pass


# ---------------------------------------------------------------------------
# Preempt-mid-decode -> restore -> finish: token-for-token parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_preempt_restore_parity(arch):
    """A preemption forced mid-decode while a second slot keeps the batch
    and the pool moving, the restore interleaved chunk by chunk: the
    preempted request's tokens equal the eviction-free solo run's."""
    cfg, model = tiny(arch)
    P, N = 12, 8
    rng = np.random.default_rng(7)
    pa = rng.integers(0, cfg.vocab, size=P).astype(np.int32)
    pb = rng.integers(0, cfg.vocab, size=P).astype(np.int32)
    refs = [solo(model, p, N, P + N) for p in (pa, pb)]

    sched = sched_for(model, n_slots=2, max_seq=P + N, page_size=4, prefill_chunk=5,
                      offload=True)
    sched.submit("a", "r0", pa, N)
    sched.submit("b", "r1", pb, N)

    def force(s):
        s.preempt(0)
        assert s.slots[0].state is SlotState.PREEMPTED
        assert not s.slots[0].pages and s.blob_store.puts == 1
        blob = next(iter(s.blob_store.blobs.values()))
        assert all(leaf.device.type == "cpu" for leaf in blob.values())

    got = drain(sched, hooks={6: force})
    for i in range(2):
        np.testing.assert_array_equal(got[i].tokens, refs[i],
                                      err_msg=f"{arch} r{i}: preempt/restore diverged")
    assert got[0].preempts == 1 and got[1].preempts == 0
    assert sched.restores == 1 and sched.restored_pages == sched.offload_pages
    a = sched.allocator
    assert a.in_use == 0 and a.free_count == a.n_pages
    assert sched.blob_store.bytes_stored == 0     # restored blob deleted


def test_pressure_preemption_admits_starved_request():
    """A pool-gated arrival triggers the policy: the longest-resident ACTIVE
    slot goes to storage, the newcomer admits at once, and the victim
    restores when pressure clears — both exact."""
    cfg, model = tiny()
    P, N = 8, 12
    need = -(-(P + N - 1) // 4)                   # 5 pages each
    rng = np.random.default_rng(9)
    pa = rng.integers(0, cfg.vocab, size=P).astype(np.int32)
    pb = rng.integers(0, cfg.vocab, size=P).astype(np.int32)
    refs = [solo(model, p, N, P + N) for p in (pa, pb)]

    sched = sched_for(model, n_slots=2, max_seq=P + N, page_size=4, kv_pages=need + 1,
                      offload=True)
    sched.submit("a", "r0", pa, N)

    def arrive(s):
        assert s.slots[0].state is SlotState.ACTIVE
        s.submit("b", "r1", pb, N)                # pool-gated: 1 page free
        assert s.preemptions == 1, "pressure did not preempt"
        assert s.slots[0].state is SlotState.PREEMPTED
        assert s.slots[1].state is SlotState.ADMITTING

    got = drain(sched, hooks={3: arrive})
    for i in range(2):
        np.testing.assert_array_equal(got[i].tokens, refs[i],
                                      err_msg=f"r{i} corrupted by preemption")
    assert got[0].admitted_step < got[1].admitted_step
    assert got[0].finished_step > got[1].finished_step  # victim finished last
    assert sched.restores == 1


def test_idle_floor_blocks_preemption():
    """A slot younger than ``idle_preempt_steps`` is not preemptible: the
    arrival holds in pending instead."""
    cfg, model = tiny()
    P, N = 8, 12
    need = -(-(P + N - 1) // 4)
    sched = sched_for(model, n_slots=2, max_seq=P + N, page_size=4, kv_pages=need + 1,
                      offload=True, idle_preempt_steps=1000)
    sched.submit("a", "r0", np.zeros(P, np.int32), N)
    for _ in range(3):
        sched.step()
    sched.submit("b", "r1", np.zeros(P, np.int32), N)
    assert sched.preemptions == 0
    assert [r.request_id for r in sched.pending] == ["r1"]
    got = drain(sched)
    assert sorted(got) == [0, 1] and sched.preemptions == 0


def test_restore_waits_for_pressure_to_clear():
    """A preempted slot does not take its pages back while the request it
    was evicted for still decodes (preempt<->restore thrash)."""
    cfg, model = tiny()
    P, N = 8, 12
    need = -(-(P + N - 1) // 4)
    sched = sched_for(model, n_slots=2, max_seq=P + N, page_size=4, kv_pages=need + 1,
                      offload=True)
    sched.submit("a", "r0", np.zeros(P, np.int32), N)
    sched.step()
    sched.step()
    sched.submit("b", "r1", np.zeros(P, np.int32), N)   # evicts r0
    assert sched.slots[0].state is SlotState.PREEMPTED
    for _ in range(4):
        sched.step()
        assert sched.slots[0].state is SlotState.PREEMPTED, \
            "restore funded while the pool is still under pressure"
    drain(sched)
    assert sched.restores == 1 and sched.completed == 2


def test_reset_with_preempted_slot_replays_cleanly():
    """Crash recovery with a blob in flight: reset() clears the store and
    the preempted slot; redelivery replays from the prompt and still
    matches the solo run."""
    cfg, model = tiny("recurrentgemma-2b")
    P, N = 12, 6
    prompt = np.random.default_rng(13).integers(0, cfg.vocab, size=P).astype(np.int32)
    ref = solo(model, prompt, N, P + N)
    sched = sched_for(model, n_slots=2, max_seq=P + N, page_size=4, offload=True)
    sched.submit("s", "r0", prompt, N)
    sched.step()
    sched.step()
    sched.preempt(0)
    assert sched.blob_store.bytes_stored > 0
    sched.reset()
    assert sched.blob_store.bytes_stored == 0 and not sched.blob_store.blobs
    a = sched.allocator
    assert a.in_use == 0 and a.free_count == a.n_pages
    assert all(s.empty for s in sched.slots)
    sched.submit("s", "r0", prompt, N)            # queue redelivery
    got = drain(sched)
    np.testing.assert_array_equal(got[0].tokens, ref)


def test_offload_requires_paged_pool():
    cfg, model = tiny()
    with pytest.raises(ValueError, match="paged"):
        sched_for(model, n_slots=2, max_seq=16, kv_mode="ring", offload=True)
    with pytest.raises(ValueError, match="preempt_policy"):
        sched_for(model, n_slots=2, max_seq=16, preempt_policy="lru")


# ---------------------------------------------------------------------------
# Frontend: billing + gauges through the serving stack
# ---------------------------------------------------------------------------


def test_frontend_bills_offload_storage_ops():
    cfg, model = tiny()
    P, N = 8, 8
    need = -(-(P + N - 1) // 4)
    cloud = SimCloud(seed=0)
    fe = build_frontend(cloud, cfg, model, mode="continuous", batch_size=2, max_new=N,
                        prompt_len=P, page_size=4, kv_pages=need + 1, offload=True,
                        device="cpu")
    spawn_workload(cloud, fe, vocab=cfg.vocab, n_requests=4, sessions=4, prompt_len=P,
                   max_new=N)
    cloud.run()
    assert sum(len(v) for v in fe.completions.values()) == 4
    stats = fe.serving_stats()
    assert stats["preemptions"] >= 1 and stats["restores"] >= 1
    assert stats["offload_bytes"] > 0 and stats["restore_bytes"] > 0
    # every put/get journaled by the store was billed by the frontend
    assert stats["offload_storage_ops"] == (stats["offload_puts"] + stats["offload_gets"]
                                            + fe.scheduler.blob_store.deletes)
    assert stats["offload_storage_usd"] == pytest.approx(
        page_blob_cost(stats["offload_puts"], stats["offload_gets"]))
    assert cloud.op_counts.get("obj_write", 0) >= stats["offload_puts"]
    assert cloud.op_counts.get("obj_read", 0) >= stats["offload_gets"]


def test_blob_store_metering():
    bs = PageBlobStore()
    bs.put("a", {"x": 1}, 2048)
    bs.put("b", {"x": 2}, 1024)
    assert bs.bytes_stored == 3072 and bs.high_water_bytes == 3072
    assert bs.get("a") == {"x": 1} and bs.bytes_in == 2048
    bs.delete("a")
    assert bs.bytes_stored == 1024 and bs.high_water_bytes == 3072
    ops = bs.drain_ops()
    assert [o[0] for o in ops] == ["put", "put", "get", "delete"]
    assert bs.drain_ops() == []
    with pytest.raises(KeyError):
        bs.get("a")
    bs.clear()
    assert bs.bytes_stored == 0 and not bs.blobs


# ---------------------------------------------------------------------------
# Startup sizing validation
# ---------------------------------------------------------------------------


def test_pool_sizing_validated_at_startup():
    # one 16+8-token admission = 6 pages of 4, plus 3 more decoding slots
    assert validate_pool_sizing(batch_size=4, prompt_len=16, max_new=8, page_size=4,
                                kv_pages=9) == 9
    with pytest.raises(ValueError, match="max-size admission"):
        validate_pool_sizing(batch_size=4, prompt_len=16, max_new=8, page_size=4,
                             kv_pages=8)
    # offload relaxes the floor to one admission (preemption absorbs the
    # rest) but the largest single request must still fit the pool
    assert validate_pool_sizing(batch_size=4, prompt_len=16, max_new=8, page_size=4,
                                kv_pages=6, offload=True) == 6
    with pytest.raises(ValueError, match="even one max-size admission"):
        validate_pool_sizing(batch_size=4, prompt_len=16, max_new=8, page_size=4,
                             kv_pages=5, offload=True)
    with pytest.raises(ValueError, match="--page-size"):
        validate_pool_sizing(batch_size=2, prompt_len=8, max_new=4, page_size=0)
    with pytest.raises(ValueError, match="--prefill-chunk"):
        validate_pool_sizing(batch_size=2, prompt_len=8, max_new=4, page_size=4,
                             prefill_chunk=0)
    with pytest.raises(ValueError, match="max-size admission"):
        run_serving("minicpm-2b", n_requests=1, max_new=8, prompt_len=16, batch_size=4,
                    page_size=4, kv_pages=8, quiet=True, device="cpu")
    # the same pool serves under --offload
    fe = run_serving("minicpm-2b", n_requests=4, max_new=8, prompt_len=16, sessions=4,
                     batch_size=4, page_size=4, kv_pages=8, offload=True, quiet=True,
                     device="cpu")
    assert sum(len(v) for v in fe.completions.values()) == 4
    assert fe.serving_stats()["preemptions"] >= 1
