"""Refcounted copy-on-write prefix sharing and cross-request session parking,
in the port.

The cases of the JAX package's ``test_prefix_sharing.py`` that apply to the
port (its mesh placement case waits for the port's ``mesh=``), on the
port's own models at reduced size: (1) a request admitted over shared pages
— a parked session's journal or the content-addressed prefix index —
decodes token for token as a from-scratch solo run, while prefilling only
its tail; (2) shared pages are immutable: a completion never frees a page
another holder maps, and a writer never mutates a shared page in place
(copy-on-write splits, checked on the pool bytes); (3) ``reset()`` forgets
the prefix index and the parked table.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.coord.serving_front import InferenceRequest, ServingFrontend
from repro_torch.core import SimCloud
from repro_torch.models import build_model, kvcache
from repro_torch.serve.engine import generate
from repro_torch.serve.lifecycle import SlotState
from repro_torch.serve.scheduler import DecodeScheduler

torch.set_num_threads(2)

MAX_SEQ = 32


def tiny(arch="minicpm-2b"):
    cfg = configs.get(arch).reduced()
    return cfg, build_model(cfg, device="cpu", seed=0)


def sched_for(model, **kw):
    kw.setdefault("max_seq", MAX_SEQ)
    return DecodeScheduler(model, device="cpu", **kw)


def drain(sched, got=None, limit=300):
    got = got if got is not None else {}
    it = 0
    while sched.busy():
        for fin in sched.step():
            got[fin.request_id] = fin
        sched.audit()
        it += 1
        assert it < limit, "scheduler failed to drain"
    return got


def solo(model, prompt, max_new, seq_len=MAX_SEQ):
    return generate(model, torch.from_numpy(np.asarray(prompt, np.int32))[None], max_new,
                    seq_len=seq_len)[0].numpy()


# ---------------------------------------------------------------------------
# PageAllocator refcounts
# ---------------------------------------------------------------------------


def test_allocator_refcounts():
    a = kvcache.PageAllocator(4)
    p = a.alloc(2)
    assert a.refcount(p[0]) == 1 and a.in_use == 2 and a.total_refs == 2
    a.share([p[0]])
    assert a.refcount(p[0]) == 2 and a.total_refs == 3
    a.release([p[0]])                       # one ref down: still mapped
    assert a.refcount(p[0]) == 1 and a.in_use == 2
    a.release([p[0]])                       # last ref: back to the free list
    assert a.refcount(p[0]) == 0 and a.in_use == 1
    assert a.free_count + a.in_use == a.n_pages
    with pytest.raises(ValueError):
        a.release([p[0]])                   # double release
    with pytest.raises(ValueError):
        a.share([p[0]])                     # sharing a freed page
    a.check()
    a.release([p[1]])
    assert a.free_count == 4 and a.total_refs == 0


def test_allocator_free_alias_keeps_refcount_semantics():
    """``free`` (the pre-refcount name) is one release, not a force-free."""
    a = kvcache.PageAllocator(2)
    (p,) = a.alloc(1)
    a.share([p])
    a.free([p])
    assert a.refcount(p) == 1 and a.in_use == 1
    a.free([p])
    assert a.free_count == 2


# ---------------------------------------------------------------------------
# Prefix index: content addressing + LRU eviction
# ---------------------------------------------------------------------------


def test_page_hashes_chain_on_prefix():
    ps = 4
    t1 = np.arange(12, dtype=np.int32)
    t2 = t1.copy()
    t2[1] = 99                               # first page differs
    h1, h2 = kvcache.page_hashes(t1, ps), kvcache.page_hashes(t2, ps)
    assert len(h1) == 3                      # full pages only
    assert h1[0] != h2[0]
    # chaining: identical page-2 content still hashes apart because the
    # prefix differs — sharing keys on the whole token history
    assert h1[1] != h2[1] and h1[2] != h2[2]
    assert kvcache.page_hashes(t1[:11], ps) == h1[:2]   # partial page dropped


def test_prefix_index_publish_lookup_evict():
    a = kvcache.PageAllocator(6)
    idx = kvcache.PrefixIndex()
    pages = a.alloc(3)
    hashes = kvcache.page_hashes(np.arange(12, dtype=np.int32), 4)
    assert idx.publish(hashes, pages, a) == 3
    assert all(a.refcount(p) == 2 for p in pages)
    assert idx.publish(hashes, pages, a) == 0          # dedupe: no new refs
    assert idx.lookup(hashes) == pages
    assert idx.has(hashes[0]) and sorted(idx.pages) == sorted(pages)
    other = kvcache.page_hashes(np.arange(100, 112, dtype=np.int32), 4)
    assert idx.lookup(other) == []
    assert idx.lookup([hashes[0], other[0], hashes[2]]) == [pages[0]]
    # the holder releases: pages survive on the index's reference alone
    a.release(pages)
    assert a.in_use == 3
    # eviction reclaims index references until enough pages are free
    dropped = idx.evict(a, need_free=5)
    assert dropped == 2 and a.free_count == 5 and len(idx) == 1
    idx.clear(a)
    assert a.free_count == 6 and a.total_refs == 0


# ---------------------------------------------------------------------------
# Copy-on-write at the kvcache level: lane-exact, original untouched
# ---------------------------------------------------------------------------


def test_copy_pages_lane_exact():
    gen = torch.Generator().manual_seed(3)
    pool = {"kp": torch.randn((2, 5, 4, 2, 3), generator=gen),
            "vp": torch.randn((2, 5, 4, 2, 3), generator=gen),
            "page_table": torch.zeros((1, 2), dtype=torch.int32)}
    before = {k: v.clone() for k, v in pool.items()}
    kp_storage = pool["kp"].data_ptr()
    kvcache.copy_pages(pool, [1, 3], [0, 4])
    assert pool["kp"].data_ptr() == kp_storage           # in place
    for k in ("kp", "vp"):
        assert torch.equal(pool[k][:, 0], before[k][:, 1])
        assert torch.equal(pool[k][:, 4], before[k][:, 3])
        assert torch.equal(pool[k][:, [1, 2, 3]], before[k][:, [1, 2, 3]])
    assert torch.equal(pool["page_table"], before["page_table"])


def test_gather_scatter_slot_state_round_trip():
    cfg, model = tiny("recurrentgemma-2b")
    sched = sched_for(model, n_slots=3, max_seq=16, page_size=4)
    rng = np.random.default_rng(5)
    sched.submit("s", "r0", rng.integers(0, cfg.vocab, 8).astype(np.int32), 3)
    sched.step()
    sched.step()
    snap = kvcache.to_host(kvcache.gather_slot_state(sched.cache, 0))
    # the snapshot holds no pool and no page table
    assert set(snap) == {"length", "h", "conv"}
    # scatter into another slot and gather back: bit-identical, in place
    h_storage = sched.cache["h"].data_ptr()
    kvcache.scatter_slot_state(sched.cache, 2, snap)
    assert sched.cache["h"].data_ptr() == h_storage
    snap2 = kvcache.gather_slot_state(sched.cache, 2)
    for key in snap:
        assert torch.equal(snap[key], snap2[key]), key


# ---------------------------------------------------------------------------
# The sharp edge: shared page freed under a live reader / CoW mid-decode
# ---------------------------------------------------------------------------


def test_release_keeps_shared_page_and_cow_splits_mid_decode():
    """Two slots share an indexed prefix page; the one that completes first
    must not free it (the other still maps it), and a decode write through
    a shared page must CoW-split — checked on the pool bytes: the shared
    page is bit-identical before and after."""
    cfg, model = tiny()
    ps, N = 4, 6
    rng = np.random.default_rng(11)
    sys_p = rng.integers(0, cfg.vocab, size=2 * ps).astype(np.int32)
    pa = np.concatenate([sys_p, rng.integers(0, cfg.vocab, 3).astype(np.int32)])
    pb = np.concatenate([sys_p, rng.integers(0, cfg.vocab, 4).astype(np.int32)])
    pc = np.concatenate([sys_p, rng.integers(0, cfg.vocab, 5).astype(np.int32)])
    sched = sched_for(model, n_slots=2, page_size=ps, prefill_chunk=5, prefix_sharing=True)
    got = {}
    sched.submit("a", "r0", pa, N)
    drain(sched, got)                       # publishes a's full pages
    sys_pages = sched.prefix_index.lookup(kvcache.page_hashes(sys_p, ps))
    assert len(sys_pages) == 2
    indexed = sorted(sched.prefix_index.pages)
    before = {k: sched.cache[k][:, indexed].clone() for k in ("kp", "vp")}

    # b (short) and c (long) admit concurrently over the shared sys pages
    sched.submit("b", "r1", pb, 3)
    sched.submit("c", "r2", pc, 8)
    assert sched.slots[0].shared == sys_pages
    assert sched.slots[1].shared == sys_pages
    assert sched.allocator.refcount(sys_pages[0]) == 3   # index + b + c

    def step_into(got):
        for fin in sched.step():
            got[fin.request_id] = fin

    it = 0
    while "r1" not in got:        # b (3 tokens) finishes well before c (8)
        step_into(got)
        sched.audit()
        it += 1
        assert it < 20
    # b completed and released its references: the page survives for c
    assert sched.allocator.refcount(sys_pages[0]) == 2   # index + c
    assert all(sched.allocator.refcount(p) >= 1 for p in indexed)
    c_slot = sched.slots[1]
    assert c_slot.state is SlotState.ACTIVE

    # force a *decode* write through a shared page: give c's current append
    # page an external reference (as a parked journal would hold) and step
    while int(sched._page_rows[1, c_slot.len // ps]) < 0:
        step_into(got)
        assert c_slot.state is SlotState.ACTIVE
    append_page = int(sched._page_rows[1, c_slot.len // ps])
    sched.allocator.share([append_page])
    page_before = {k: sched.cache[k][:, append_page].clone() for k in ("kp", "vp")}
    cow0 = sched.cow_splits
    step_into(got)
    assert sched.cow_splits == cow0 + 1, "decode write did not CoW-split"
    for k in ("kp", "vp"):                   # original bytes untouched
        assert torch.equal(sched.cache[k][:, append_page], page_before[k])
    assert append_page not in sched.slots[1].pages
    sched.allocator.release([append_page])   # drop the synthetic holder
    sched.audit()
    drain(sched, got)

    # the published pages never moved a bit through all of it
    for k in ("kp", "vp"):
        assert torch.equal(sched.cache[k][:, indexed], before[k])
    for rid, p, n in [("r0", pa, N), ("r1", pb, 3), ("r2", pc, 8)]:
        np.testing.assert_array_equal(got[rid].tokens, solo(model, p, n),
                                      err_msg=f"{rid} diverged from solo")
    assert got["r2"].reused_tokens == 2 * ps


@pytest.mark.parametrize("arch", ["minicpm-2b", "recurrentgemma-2b"])
def test_multiturn_park_parity(arch):
    """Turns 2 and 3 extend the session history: the parked journal serves
    the resident prefix — prompt and generated tokens alike, decode-written
    KV being bitwise what a re-prefill writes — only the tail prefills, and
    the output is exactly the from-scratch solo run."""
    cfg, model = tiny(arch)
    N = 3
    rng = np.random.default_rng(7)
    sched = sched_for(model, n_slots=2, page_size=4, prefill_chunk=5,
                      park_sessions=True, prefix_sharing=True)
    hist = rng.integers(0, cfg.vocab, size=8).astype(np.int32)
    prefill_per_turn = []
    expect_reused = 0
    for turn in range(3):
        before = sched.prefill_tokens
        got = {}
        sched.submit("s", f"r{turn}", hist, N)
        drain(sched, got)
        np.testing.assert_array_equal(got[f"r{turn}"].tokens, solo(model, hist, N),
                                      err_msg=f"{arch} turn {turn} diverged")
        prefill_per_turn.append(sched.prefill_tokens - before)
        assert got[f"r{turn}"].reused_tokens == expect_reused
        assert prefill_per_turn[-1] == len(hist) - expect_reused
        # the journal serves next turn everything consumed: the prompt and
        # all but the last generated token (its KV was never written)
        expect_reused = len(hist) + N - 1
        hist = np.concatenate([hist, got[f"r{turn}"].tokens.astype(np.int32),
                               rng.integers(0, cfg.vocab, 2).astype(np.int32)])
    assert prefill_per_turn[1] < prefill_per_turn[0]
    assert prefill_per_turn[2] <= prefill_per_turn[1]
    assert sched.park_hits == 2 and sched.parks == 3


def test_park_offload_restores_from_blob():
    """Pool pressure offloads a parked journal through the blob store; the
    session's next request restores the blob (one GET) instead of
    re-prefilling, still token-exact."""
    cfg, model = tiny()
    N = 4
    rng = np.random.default_rng(9)
    p1 = rng.integers(0, cfg.vocab, size=10).astype(np.int32)
    sched = sched_for(model, n_slots=2, page_size=4, park_sessions=True)
    got = {}
    sched.submit("s", "r0", p1, N)
    drain(sched, got)
    rec = sched._parked["s"]
    sched._offload_parked(rec)
    sched.audit()
    assert rec.blob_key and not rec.pages and rec.slot is None
    assert sched.blob_store.bytes_stored > 0
    blob = sched.blob_store.blobs[rec.blob_key]
    assert all(leaf.device.type == "cpu" for leaf in blob.values())
    p2 = np.concatenate([p1, got["r0"].tokens.astype(np.int32),
                         rng.integers(0, cfg.vocab, 3).astype(np.int32)])
    sched.submit("s", "r1", p2, N)
    drain(sched, got)
    np.testing.assert_array_equal(got["r1"].tokens, solo(model, p2, N))
    assert sched.blob_store.gets == 1
    assert got["r1"].reused_tokens == len(p1) + N - 1   # full consumed span


def test_park_blob_restore_slices_to_reused_span():
    """A blob journal can hold more pages than the next request reuses: the
    restore allocates and writes only the reused span, inside the
    admission's reservation."""
    cfg, model = tiny()
    rng = np.random.default_rng(31)
    p1 = rng.integers(0, cfg.vocab, size=8).astype(np.int32)
    sched = sched_for(model, n_slots=2, page_size=4, park_sessions=True)
    got = {}
    sched.submit("s", "r0", p1, 12)          # long generated tail: 5-page blob
    drain(sched, got)
    rec = sched._parked["s"]
    sched._offload_parked(rec)
    sched.audit()
    assert len(rec.blob_pidx) == 5           # ceil((8+12-1)/4)
    # an 11-token prompt: reuse caps at P-1 = 10 tokens, 3 of the 5 pages
    p2 = np.concatenate([p1, got["r0"].tokens[:3].astype(np.int32)])
    sched.submit("s", "r1", p2, 4)
    assert SlotState.ADMITTING in (sched.slots[0].state, sched.slots[1].state)
    assert sched.blob_store.gets == 1
    drain(sched, got)
    np.testing.assert_array_equal(got["r1"].tokens, solo(model, p2, 4))
    assert got["r1"].reused_tokens == len(p2) - 1


def test_short_matching_resubmission_keeps_journal():
    """A prompt that matches the journal but leaves no prefill tail (hybrid:
    a resubmission of exactly the consumed span) is no divergence — the
    journal survives and serves the next real extension."""
    cfg, model = tiny("recurrentgemma-2b")
    rng = np.random.default_rng(37)
    p1 = rng.integers(0, cfg.vocab, size=8).astype(np.int32)
    sched = sched_for(model, n_slots=2, page_size=4, park_sessions=True)
    got = {}
    sched.submit("s", "r0", p1, 3)
    drain(sched, got)
    hist = np.concatenate([p1, got["r0"].tokens.astype(np.int32)])
    # journal: history 11, consumed 10.  P = 10 leaves no tail token
    sched.submit("s", "r1", hist[:10], 3)
    drain(sched, got)
    np.testing.assert_array_equal(got["r1"].tokens, solo(model, hist[:10], 3))
    assert sched.park_misses == 0            # NOT a divergence
    assert got["r1"].reused_tokens == 0
    hist2 = np.concatenate([hist[:10], got["r1"].tokens.astype(np.int32),
                            rng.integers(0, cfg.vocab, 2).astype(np.int32)])
    sched.submit("s", "r2", hist2, 3)
    drain(sched, got)
    np.testing.assert_array_equal(got["r2"].tokens, solo(model, hist2, 3))
    assert sched.park_hits == 1
    assert got["r2"].reused_tokens == 12     # the full consumed span


def test_exact_resubmission_reuses_consumed_span():
    """Resubmitting the full recorded history (P = consumed + 1) reuses every
    consumed token and prefills only the last sampled one, hybrid rows
    included."""
    cfg, model = tiny("recurrentgemma-2b")
    rng = np.random.default_rng(41)
    p1 = rng.integers(0, cfg.vocab, size=8).astype(np.int32)
    sched = sched_for(model, n_slots=2, page_size=4, park_sessions=True)
    got = {}
    sched.submit("s", "r0", p1, 3)
    drain(sched, got)
    hist = np.concatenate([p1, got["r0"].tokens.astype(np.int32)])
    before = sched.prefill_tokens
    sched.submit("s", "r1", hist, 3)         # P = 11 = consumed + 1
    drain(sched, got)
    np.testing.assert_array_equal(got["r1"].tokens, solo(model, hist, 3))
    assert sched.park_hits == 1
    assert got["r1"].reused_tokens == len(hist) - 1
    assert sched.prefill_tokens - before == 1    # only the sampled token


def test_slot_pressure_evicts_parked_then_restores():
    """All slots parked; a third session's admission reclaims the oldest
    residency (rows snapshot to the record, on the host); when the evicted
    session returns, its journal restores into another slot — still exact."""
    cfg, model = tiny("recurrentgemma-2b")
    N = 3
    rng = np.random.default_rng(13)
    pa = rng.integers(0, cfg.vocab, size=8).astype(np.int32)
    pb = rng.integers(0, cfg.vocab, size=9).astype(np.int32)
    sched = sched_for(model, n_slots=2, page_size=4, park_sessions=True)
    got = {}
    sched.submit("a", "r0", pa, N)
    drain(sched, got)
    sched.submit("b", "r1", pb, N)
    drain(sched, got)
    assert sched.parked_slots() == 2
    rows_a = kvcache.gather_slot_state(sched.cache, sched._parked["a"].slot)
    pc = rng.integers(0, cfg.vocab, size=6).astype(np.int32)
    sched.submit("c", "r2", pc, N)           # no empty slot: evicts a's
    drain(sched, got)
    rec = sched._parked["a"]
    assert sched.park_evictions == 1 and rec.slot is None
    assert all(leaf.device.type == "cpu" for leaf in rec.state.values())
    for key in rows_a:                       # the snapshot is the parked rows
        assert torch.equal(rec.state[key], rows_a[key]), key
    pa2 = np.concatenate([pa, got["r0"].tokens.astype(np.int32),
                          rng.integers(0, cfg.vocab, 2).astype(np.int32)])
    sched.submit("a", "r3", pa2, N)
    drain(sched, got)
    for rid, p in [("r0", pa), ("r1", pb), ("r2", pc), ("r3", pa2)]:
        np.testing.assert_array_equal(got[rid].tokens, solo(model, p, N),
                                      err_msg=f"{rid} diverged")
    assert got["r3"].reused_tokens == len(pa) + N - 1


def test_park_ttl_expires_idle_sessions():
    cfg, model = tiny()
    rng = np.random.default_rng(17)
    sched = sched_for(model, n_slots=2, page_size=4, park_sessions=True, park_ttl_steps=4)
    got = {}
    sched.submit("s", "r0", rng.integers(0, cfg.vocab, 8).astype(np.int32), 3)
    drain(sched, got)
    assert "s" in sched._parked
    # another session keeps the step clock moving past the TTL
    sched.submit("t", "r1", rng.integers(0, cfg.vocab, 8).astype(np.int32), 8)
    drain(sched, got)
    assert sched.park_expirations == 1 and "s" not in sched._parked
    sched.audit()
    assert sched.allocator.total_refs == sum(
        len(r.pages) for r in sched._parked.values()) + len(sched.prefix_index)


def test_reset_clears_prefix_index_and_parked_table():
    """Crash replay must not observe stale cross-request sharing: reset()
    forgets the index and the parked table, and the redelivered session
    replays from its prompt — full prefill, same tokens."""
    cfg, model = tiny()
    N = 4
    rng = np.random.default_rng(19)
    p1 = rng.integers(0, cfg.vocab, size=10).astype(np.int32)
    sched = sched_for(model, n_slots=2, page_size=4, park_sessions=True,
                      prefix_sharing=True)
    got = {}
    sched.submit("s", "r0", p1, N)
    drain(sched, got)
    assert sched._parked and len(sched.prefix_index) > 0
    sched.reset()
    assert not sched._parked and len(sched.prefix_index) == 0
    a = sched.allocator
    assert a.in_use == 0 and a.free_count == a.n_pages and a.total_refs == 0
    p2 = np.concatenate([p1, got["r0"].tokens.astype(np.int32),
                         rng.integers(0, cfg.vocab, 3).astype(np.int32)])
    before = sched.prefill_tokens
    sched.submit("s", "r1", p2, N)
    drain(sched, got)
    assert sched.park_hits == 0 and sched.index_hits == 0
    assert sched.prefill_tokens - before == len(p2)
    np.testing.assert_array_equal(got["r1"].tokens, solo(model, p2, N))


def test_sharing_requires_paged_pool():
    cfg, model = tiny()
    for kw in ({"prefix_sharing": True}, {"park_sessions": True}):
        with pytest.raises(ValueError, match="paged"):
            sched_for(model, n_slots=2, max_seq=16, kv_mode="ring", **kw)


def test_index_sharing_gated_to_attention_families():
    """Hybrid recurrent rows cannot be rebuilt from KV pages alone: the
    index is never consulted (or published) for them, while parking — which
    keeps the rows — stays on."""
    cfg, model = tiny("recurrentgemma-2b")
    sched = sched_for(model, n_slots=2, page_size=4, prefix_sharing=True,
                      park_sessions=True)
    assert sched.prefix_sharing and not sched._index_sharing
    got = {}
    sched.submit("s", "r0",
                 np.random.default_rng(23).integers(0, cfg.vocab, 8).astype(np.int32), 3)
    drain(sched, got)
    assert len(sched.prefix_index) == 0 and sched.parks == 1


def test_preempt_restore_of_unparked_slot_stays_exact():
    """A slot decoding over shared parked pages gets preempted: the blob
    captures the shared prefix too, the restore owns everything, and the
    journal keeps its own references — token-exact for both lives."""
    cfg, model = tiny()
    N = 6
    rng = np.random.default_rng(29)
    p1 = rng.integers(0, cfg.vocab, size=9).astype(np.int32)
    sched = sched_for(model, n_slots=2, page_size=4, park_sessions=True, offload=True)
    got = {}
    sched.submit("s", "r0", p1, N)
    drain(sched, got)
    p2 = np.concatenate([p1, got["r0"].tokens.astype(np.int32),
                         rng.integers(0, cfg.vocab, 2).astype(np.int32)])
    sched.submit("s", "r1", p2, N)
    sched.submit("t", "r2", rng.integers(0, cfg.vocab, 8).astype(np.int32), N)
    steps = 0
    while sched.busy():
        if steps == 3:
            victim = next(s for s in sched.slots if s.state is SlotState.ACTIVE and s.pages)
            sched.preempt(victim.index)
        for fin in sched.step():
            got[fin.request_id] = fin
        sched.audit()
        steps += 1
        assert steps < 300
    np.testing.assert_array_equal(got["r1"].tokens, solo(model, p2, N))
    assert sched.preemptions == 1 and sched.restores == 1


def test_frontend_bills_park_retention():
    """A pressure-offloaded journal's blob accrues Table-4 S3 retention over
    simulated time, the restore GET is billed as an object read, and the
    prompt tokens it saved are itemized next to the bill."""
    cfg, model = tiny()
    cloud = SimCloud(seed=0)
    # pool sized so session t's fresh admission must offload s's journal
    sched = sched_for(model, n_slots=2, max_seq=20, page_size=4, kv_pages=5,
                      park_sessions=True, prefix_sharing=True)
    fe = ServingFrontend(cloud, scheduler=sched, batch_size=2)
    rng = np.random.default_rng(0)
    p1 = rng.integers(0, cfg.vocab, size=10).astype(np.int32)
    cloud.run_task(fe.submit(InferenceRequest("s", "q0", p1, 4)), name="c0")
    cloud.run()
    assert sched.parked_slots() == 1
    cloud.run_task(fe.submit(
        InferenceRequest("t", "q1", rng.integers(0, cfg.vocab, 10).astype(np.int32), 4)),
        name="c1")
    cloud.run()
    assert sched.park_offloads == 1          # pool pressure pushed s's blob
    p2 = np.concatenate([p1, np.asarray(fe.results["s"][0], np.int32),
                         rng.integers(0, cfg.vocab, 2).astype(np.int32)])
    cloud.run_task(fe.submit(InferenceRequest("s", "q2", p2, 4)), name="c2")
    cloud.run()
    np.testing.assert_array_equal(fe.results["s"][1], solo(model, p2, 4, seq_len=20))
    stats = fe.serving_stats()
    assert stats["park_hits"] == 1
    assert stats["shared_prefix_tokens"] == len(p1) + 4 - 1   # consumed span
    assert stats["park_storage_usd"] > 0.0   # blob bytes x sim-time retention
    assert cloud.op_counts.get("obj_read", 0) >= 1   # the restore GET billed
    assert cloud.op_counts.get("obj_write", 0) >= 1  # the offload PUT billed
