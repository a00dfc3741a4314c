"""Randomized scheduler differential harness, in the port.

The JAX package's seeded event soup — admit (fresh / multi-turn extension /
cross-session shared system prompt), forced preemption, park, unpark,
restore, TTL expiry — drives the port's whole ``DecodeScheduler`` (paged
pool, chunked prefill, offload, refcounted prefix sharing, session parking)
across 3-5 sessions.  Every completed request must equal the port's own
eviction-free solo ``generate`` token for token, and the allocator,
refcount and reservation invariants are audited after every step.  A
failing sequence's event log is written to ``artifacts/diff_failures/``
(the sequence is a pure function of the arch, the seed and the
speculation setting).  ``_run_sequence(..., spec=)`` runs the same soup
with draft-and-verify speculative decoding on
(``test_torch_spec_differential``).

A hypothesis property pins the alloc/share/CoW/release round trip on the
allocator alone.
"""

from __future__ import annotations

import json
import zlib
from pathlib import Path
from typing import Optional

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch.sharded_smoke import SOUP_SYSTEM_PAGES, Soup, soup_events
from repro_torch.models import build_model, kvcache
from repro_torch.serve.engine import generate
from repro_torch.serve.scheduler import DecodeScheduler

torch.set_num_threads(2)

MAX_SEQ = 32
PAGE_SIZE = 4
N_SLOTS = 3
PREFILL_CHUNK = 3
MAX_NEW = (2, 4)                  # per-request decode budget range
FRESH_LEN = (5, 12)               # fresh prompt length range
EXTEND_LEN = (1, 4)               # extra user tokens per multi-turn turn
N_EVENTS = 28
SOUP = Soup(events=N_EVENTS, fresh_len=FRESH_LEN, extend_len=EXTEND_LEN, max_new=MAX_NEW)

# dense gets the widest sweep; moe and hybrid pin the family-specific paths
SEEDS = ([("minicpm-2b", s) for s in range(10)]
         + [("moonshot-v1-16b-a3b", s) for s in range(3)]
         + [("recurrentgemma-2b", s) for s in range(3)])

FAILURE_DIR = Path("artifacts/diff_failures")

_ARCH_CACHE = {}
_MODELS = {}


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


def _model(name):
    """(config, model, solo reference) of ``name``'s reduced config, seed 0."""
    if name not in _MODELS:
        cfg = configs.get(name).reduced()
        model = build_model(cfg, device="cpu", seed=0)
        _MODELS[name] = (cfg, model, SoloRef(model))
    return _MODELS[name]


def _arch(name, spec=None):
    """The scheduler for ``name``, with its config and solo reference.
    ``spec=(draft_arch, draft_seed, k)`` turns on speculative decoding;
    ``draft_seed == 0`` with ``draft_arch == name`` is a self-draft (the
    target's own module).  The reference is never speculative: that is
    the parity claim."""
    if (name, spec) not in _ARCH_CACHE:
        cfg, model, ref = _model(name)
        kw = {}
        if spec is not None:
            draft_arch, draft_seed, k = spec
            draft = (model if (draft_arch, draft_seed) == (name, 0) else
                     build_model(configs.get(draft_arch).reduced(), device="cpu",
                                 seed=draft_seed))
            kw = dict(draft_model=draft, spec_k=k)
        sched = DecodeScheduler(model, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                page_size=PAGE_SIZE, prefill_chunk=PREFILL_CHUNK,
                                offload=True, prefix_sharing=True, park_sessions=True,
                                device="cpu", **kw)
        _ARCH_CACHE[(name, spec)] = (cfg, sched, ref)
    return _ARCH_CACHE[(name, spec)]


def _run_sequence(arch: str, seed: int, log: Optional[list] = None, spec=None) -> list:
    """One seeded event sequence (``sharded_smoke.soup_events``, the soup
    the mesh runs drive too); appends every event to ``log`` (so a
    caller-owned list survives an assertion failure) and raises on any
    parity or invariant violation."""
    cfg, sched, ref = _arch(arch, spec)
    sched.reset()
    # zlib.crc32, not hash(): str hashing is salted per process, and a
    # failing (arch, seed) must replay bit-identically from the artifact
    tag = arch if spec is None else f"{arch}+{spec[0]}:{spec[1]}:{spec[2]}"
    rng = np.random.default_rng(zlib.crc32(tag.encode()) * 100003 + seed)
    sched.park_ttl_steps = int(rng.choice([0, 0, 18]))
    sessions = [f"s{i}" for i in range(int(rng.integers(3, 6)))]
    shared_sys = rng.integers(0, cfg.vocab, size=SOUP_SYSTEM_PAGES * PAGE_SIZE).astype(np.int32)
    log = log if log is not None else []
    log.append({"arch": arch, "seed": seed, "ttl": sched.park_ttl_steps,
                "sessions": len(sessions), "spec": spec})

    def against_solo(session, name, prompt, max_new, got):
        np.testing.assert_array_equal(
            got, ref.run(prompt, max_new),
            err_msg=f"{tag} seed {seed} {name}: scheduler diverged from the "
                    "eviction-free solo reference")

    soup_events(sched, rng, sessions, shared_sys, SOUP, MAX_SEQ, cfg.vocab, log=log,
                on_complete=against_solo)
    return log


def run_and_dump(arch: str, seed: int, spec=None) -> list:
    """``_run_sequence``, writing the event log to ``FAILURE_DIR`` when it
    raises."""
    log: list = []
    try:
        return _run_sequence(arch, seed, log, spec=spec)
    except Exception as e:
        FAILURE_DIR.mkdir(parents=True, exist_ok=True)
        tag = "" if spec is None else f"_spec_{spec[0]}_{spec[1]}_{spec[2]}"
        path = FAILURE_DIR / f"seq_torch_{arch}{tag}_{seed}.json"
        path.write_text(json.dumps(
            {"arch": arch, "seed": seed, "spec": spec, "error": str(e)[:2000],
             "repro": f"_run_sequence({arch!r}, {seed}, spec={spec!r})", "events": log},
            indent=2))
        raise


@pytest.mark.parametrize("arch,seed", SEEDS, ids=[f"{a}-{s}" for a, s in SEEDS])
def test_sched_differential(arch, seed):
    run_and_dump(arch, seed)


def test_event_soup_exercises_every_mechanism():
    """Across the seed matrix the soup reaches the mechanisms it exists to
    stress: forced preemption and restore, parked unparks, parked-slot
    evictions, parked-journal offloads, index hits and CoW splits.  (Its
    18-step TTL outlives its 28 events, as in the JAX package's soup; TTL
    expiry has its own test in ``test_torch_prefix_sharing``.)"""
    keys = ("preemptions", "restores", "park_hits", "index_hits", "cow_splits",
            "park_evictions", "park_offloads")
    totals = dict.fromkeys(keys, 0)
    for arch, seed in SEEDS:
        sched = _arch(arch)[1]
        before = sched.stats()
        _run_sequence(arch, seed)
        after = sched.stats()
        for key in keys:
            totals[key] += after[key] - before[key]
    assert all(n > 0 for n in totals.values()), totals
    assert totals["restores"] == totals["preemptions"]


# ---------------------------------------------------------------------------
# Hypothesis property: alloc/share/CoW/release round trips on the allocator
# ---------------------------------------------------------------------------

try:  # optional dep, guarded like the JAX package's property tests
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=40, deadline=None)
    @given(st.integers(0, 10_000_000))
    def test_alloc_share_cow_release_property(seed):
        """Random op soup against a shadow refcount model: ``free + in_use
        == n_pages``, per-page refcounts and the total-refs meter stay
        exact through alloc / share / release / CoW swaps, and releasing
        every holder returns the pool to fully free."""
        rng = np.random.default_rng(seed)
        n = int(rng.integers(1, 12))
        a = kvcache.PageAllocator(n)
        shadow = {}                 # page -> refcount
        holders = []                # one entry per outstanding reference
        for _ in range(60):
            op = rng.choice(["alloc", "share", "release", "cow"])
            if op == "alloc" and a.free_count:
                k = int(rng.integers(1, a.free_count + 1))
                pages = a.alloc(k)
                assert len(set(pages)) == k
                assert not any(p in shadow for p in pages), "page reissued"
                for p in pages:
                    shadow[p] = 1
                    holders.append(p)
            elif op == "share" and shadow:
                p = int(rng.choice(list(shadow)))
                a.share([p])
                shadow[p] += 1
                holders.append(p)
            elif op == "release" and holders:
                p = holders.pop(int(rng.integers(len(holders))))
                a.release([p])
                shadow[p] -= 1
                if not shadow[p]:
                    del shadow[p]
            elif op == "cow" and holders and a.free_count:
                # a writer splits: fresh private page in, old reference out
                old = holders.pop(int(rng.integers(len(holders))))
                new = a.alloc(1)[0]
                shadow[new] = 1
                holders.append(new)
                a.release([old])
                shadow[old] -= 1
                if not shadow[old]:
                    del shadow[old]
            a.check()
            assert a.in_use == len(shadow)
            assert a.total_refs == sum(shadow.values()) == len(holders)
            for p, rc in shadow.items():
                assert a.refcount(p) == rc
        for p in holders:
            a.release([p])
        assert a.free_count == n and a.in_use == 0 and a.total_refs == 0

except ImportError:

    @pytest.mark.skip(reason="optional dep: property sweeps need hypothesis")
    def test_alloc_share_cow_release_property():
        pass
