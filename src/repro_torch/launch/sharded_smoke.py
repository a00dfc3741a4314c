"""Sharded-decode smoke: one serving workload on ``mesh=None`` and on a
``(dp, mp)`` mesh of spawned ranks, asserted token-identical.

Every rank is a process (``torch.multiprocessing``, spawn) in one gloo
group (``file://`` rendezvous in a temporary directory), on the chosen
device: gloo takes CUDA tensors for ``all_reduce`` and ``broadcast``, and
several ranks may share one card, which NCCL refuses.  Each rank builds the
same model from the same seed, runs :class:`DecodeScheduler` with ``mesh=``
over the same submits, and reports its tokens; the parent runs the
workload on ``mesh=None`` itself.  A rank that raises fails the run (the
others are terminated), and so does one that outlives the join timeout.

For the mesh the smoke also measures

  * each rank's pool bytes, which must be ``1/|model|`` of the unsharded
    pool's, and
  * the collective bytes of one decode step (``last_step_wire_bytes``:
    every ``all_reduce`` payload the rank sent), at the default pool and
    at a pool 4x larger: the per-shard kernel's merge ships softmax
    statistics, whose size does not depend on the pool, so the bytes must
    not grow.

With ``--kv-mode ring`` the slots own rings (split on kv heads, else on
their T axis), every admission is one monolithic prefill, and the
collective bytes of a decode step must be the same at twice ``max_seq``.

The default arch is dense (``minicpm-2b``), which holds the strict
token-for-token claim; ``--mesh-matched`` instead holds the mesh run
against the same sharded scheduler serving one request at a time (the
reference's ``sched`` claim, for the hybrid, whose recurrence feeds
cross-shard summation order back on itself).

For the MoE family each rank builds only its experts
(``build_model(..., mesh=)``) and the verdicts add: each rank holds
``1/|model|`` of the model's expert bytes, and every rank of a ``model``
group routes the same inputs to the same experts (:class:`RouteDigests`
over the first MoE calls: the first chunks and decode steps).  A free
mesh run is held to its mesh-matched run (``--mesh-matched``): near-tied
routes flip at one bf16 ulp, and on a split over ``model`` the routed
sum may differ from ``mesh=None``'s by one.

A :class:`Workload` with a :class:`Soup` runs the seeded event soup of the
scheduler differential harness instead (fresh, multi-turn and
shared-system-prompt admissions across sessions, forced preemptions with
offload, parking with a TTL, prefix sharing), with ``audit()`` after every
step on every rank.  Its verdicts add: each rank's page blobs are its
shard of the ``mesh=None`` run's blobs, the billed
storage journals are equal, and the page moves send no collective bytes
(a slot's rows, snapshot when a parked slot is reclaimed, move over
``data``).

A :class:`Workload` with ``spec`` speculates (gather, greedy; a draft of
the target's arch and seed is the target's own module): a plain drive is
held to ``mesh=None`` without speculation, a soup to ``mesh=None``'s
speculative soup (its requests depend on when its streams end), and a
round's collective bytes must be the same at a 4x pool.  One with a
:class:`Fleet` serves through an elastic fleet of workers on the mesh
(:func:`fleet_turns` or the fleet differential's :func:`fleet_soup`),
each rank's workers sharing that rank's blob store; the verdicts add
that every rank's fleet record (:func:`fleet_record`) agrees.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.sharded_smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.sharded_smoke --device cpu --kv-mode ring
  PYTHONPATH=src python -m repro_torch.launch.sharded_smoke --mesh 2x2   # on the card
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import json
import os
import pickle
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..core.storage import PageBlobStore

PAGE_SIZE = 4            # divides the mesh's model axis -> lane decomposition
N_SLOTS = 4              # divides the mesh's data axis
JOIN_TIMEOUT_S = 600.0
SOUP_SYSTEM_PAGES = 2    # the event soup's shared system prompt
SOUP_PREEMPT_P = 0.12    # its chance of a forced preemption each round
SOUP_DRAIN_STEPS = 4000  # the most steps its drain may take


# ---------------------------------------------------------------------------
# Spawned ranks
# ---------------------------------------------------------------------------


def _rank_main(rank: int, world: int, dp: int, mp: int, device: str, tmp: str,
               timeout_s: float, fn: Callable, args: tuple) -> None:
    import torch.distributed as dist

    from .mesh import make_smoke_mesh

    if device == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(make_smoke_mesh(dp, mp, device=device), *args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def host_probe(device: str, launches: int = 500) -> Dict[str, Any]:
    """What one process sees of its host and card, in a few seconds: a pure
    Python loop's ms (the CPU share it gets), the host µs a tiny kernel
    launch costs, a 4096^3 bf16 matmul's device ms (the card's clocks), the
    µs of a 16 KiB ``all_reduce`` over every rank of a tensor on ``device``
    and of one in host memory (when a process group is up), its torch and
    OS thread counts, the cores it may run on, and the allocator's OOM
    retries."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    acc = 0
    for i in range(200_000):
        acc += i
    out: Dict[str, Any] = {"python_ms": (time.perf_counter() - t0) * 1e3,
                           "torch_threads": torch.get_num_threads(),
                           "cpu_count": os.cpu_count(),
                           "affinity": len(os.sched_getaffinity(0))}
    with open("/proc/self/status") as f:
        out["os_threads"] = next(int(line.split()[1]) for line in f
                                 if line.startswith("Threads:"))
    x = torch.zeros(16, device=device)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(launches):
        x.add_(1)
    _sync(device)
    out["launch_us"] = (time.perf_counter() - t0) / launches * 1e6
    if torch.device(device).type == "cuda":
        a = torch.randn(4096, 4096, device=device, dtype=torch.bfloat16)
        a @ a
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            a @ a
        end.record()
        end.synchronize()
        out["matmul_ms"] = start.elapsed_time(end) / 10
        out["alloc_retries"] = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    if dist.is_initialized():
        for key, where in (("all_reduce_us", device), ("host_all_reduce_us", "cpu")):
            t = torch.zeros(4096, device=where)
            dist.all_reduce(t)
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(100):
                dist.all_reduce(t)
            _sync(device)
            out[key] = (time.perf_counter() - t0) / 100 * 1e6
    return out


class Ranks:
    """``dp * mp`` ranks of a ``(dp, mp)`` ``("data", "model")`` mesh,
    spawned at construction, each running ``fn(mesh, *args)``; the caller
    may work while they run and :meth:`join` them later.  ``fn`` must be
    importable (module level) and its result picklable.  The process
    group's collectives time out after ``timeout_s``, and the join gives up
    (terminating every rank) at the same bound from the spawn; a rank that
    raises re-raises at the join."""

    def __init__(self, fn: Callable, args: tuple = (), *, dp: int, mp: int,
                 device: str = "cuda", timeout_s: float = JOIN_TIMEOUT_S):
        import torch.multiprocessing as tmp_mp

        self.world, self.timeout_s = dp * mp, timeout_s
        self.tmp = tempfile.mkdtemp(prefix="sharded_smoke_")
        self.deadline = time.monotonic() + timeout_s
        try:
            self.ctx = tmp_mp.spawn(_rank_main, args=(self.world, dp, mp, device, self.tmp,
                                                      timeout_s, fn, args),
                                    nprocs=self.world, join=False)
        except BaseException:
            shutil.rmtree(self.tmp, ignore_errors=True)
            raise

    def kill(self) -> None:
        """End every rank now (the caller failed while they ran)."""
        for p in self.ctx.processes:
            if p.is_alive():
                p.kill()
        for p in self.ctx.processes:
            p.join(10)
        shutil.rmtree(self.tmp, ignore_errors=True)

    def join(self) -> list:
        """Each rank's result, by rank."""
        try:
            while not self.ctx.join(timeout=max(0.0, min(5.0, self.deadline - time.monotonic()))):
                if time.monotonic() >= self.deadline:
                    for p in self.ctx.processes:
                        p.terminate()
                    for p in self.ctx.processes:
                        p.join(10)
                        if p.is_alive():
                            p.kill()
                    raise TimeoutError(f"{self.world} ranks did not finish in "
                                       f"{self.timeout_s:.0f} s")
            out = []
            for r in range(self.world):
                with open(os.path.join(self.tmp, f"rank{r}.pkl"), "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            shutil.rmtree(self.tmp, ignore_errors=True)


def spawn_ranks(fn: Callable, args: tuple = (), *, dp: int, mp: int, device: str = "cuda",
                timeout_s: float = JOIN_TIMEOUT_S) -> list:
    """Run ``fn(mesh, *args)`` on :class:`Ranks` and return each rank's
    result, by rank."""
    return Ranks(fn, args, dp=dp, mp=mp, device=device, timeout_s=timeout_s).join()


# ---------------------------------------------------------------------------
# The workload
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Soup:
    """The seeded event soup's shape (the scheduler differential harness's
    defaults): ``events`` rounds, each submitting to idle sessions with
    probability 0.35 (a multi-turn extension of the session's history,
    a prompt opening with the shared system prompt of SOUP_SYSTEM_PAGES
    pages, or a fresh one), forcing a preemption with probability
    SOUP_PREEMPT_P, and stepping once; then a drain."""

    events: int = 28
    sessions: int = 4
    fresh_len: tuple = (5, 12)
    extend_len: tuple = (1, 4)
    max_new: tuple = (2, 4)


@dataclasses.dataclass(frozen=True)
class Fleet:
    """An elastic fleet (:class:`~repro_torch.serve.fleet.FleetController`)
    of ``workers`` schedulers of the workload's slots, parking sessions,
    sharing prefixes and journaling the index over one blob store (a rank's
    own on a mesh), with ``crashes`` (``(worker, point, occurrence)``, the
    :class:`~repro_torch.core.FaultPlan`'s) and scale to zero.  ``soup``:
    the fleet differential harness's seeded soup of the workload's seed
    (scale-ups, forced scale-downs, wedged workers reaped by heartbeat
    eviction, crashes drawn at mid-decode, mid-restore and mid-park);
    otherwise the turns of :func:`fleet_turns`: the workload's requests in
    one burst, a scale to zero, then a second turn on ``second`` of its
    sessions, the cold start that adopts their parked records and the
    journaled index pages, and a scale to zero again."""

    workers: int = 2
    crashes: tuple = ()
    second: int = 2
    soup: bool = False


@dataclasses.dataclass(frozen=True)
class Workload:
    arch: str = "minicpm-2b"
    reduced: bool = True          # the config's reduced widths (CPU tests)
    n_layers: Optional[int] = None  # cut the depth (None: the config's)
    attn_backend: str = "paged_kernel"
    n_requests: int = 6
    sessions: int = 3
    prompt_len: int = 12
    max_new: int = 6
    n_slots: int = N_SLOTS
    page_size: int = PAGE_SIZE
    prefill_chunk: int = PAGE_SIZE
    seed: int = 0
    kv_mode: str = "paged"
    max_seq: Optional[int] = None   # None: prompt_len + max_new
    kv_pages: Optional[int] = None  # None: the scheduler's default pool
    offload: bool = False
    prefix_sharing: bool = False
    park_sessions: bool = False
    park_ttl_steps: int = 0
    soup: Optional[Soup] = None     # the event soup instead of a plain drive
    spec: Optional[tuple] = None    # (draft arch, draft seed, k): speculation (gather, greedy)
    fleet: Optional[Fleet] = None   # an elastic fleet of workers instead of one scheduler

    def config(self):
        from .. import configs

        cfg = configs.get(self.arch)
        if self.reduced:
            cfg = cfg.reduced()
        if self.n_layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=self.n_layers)
        return cfg

    def prompts(self, vocab: int) -> list:
        rng = np.random.default_rng(self.seed)
        return [rng.integers(0, vocab, size=self.prompt_len).astype(np.int32)
                for _ in range(self.n_requests)]

    @property
    def seq(self) -> int:
        return self.max_seq or self.prompt_len + self.max_new


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def build(w: Workload, device, mesh=None):
    """The workload's model; on a rank of ``mesh``, that rank's (an MoE
    model holds only its experts)."""
    from ..models import build_model

    return build_model(w.config(), device=device, seed=w.seed, mesh=mesh)


def build_draft(w: Workload, model, device, mesh=None):
    """The draft of ``w.spec``: the target's own module where the draft is
    its arch and seed (a self-draft), else a model of the draft's arch (the
    target's widths and depth where the arch is the target's, else the
    draft arch's config, reduced as the target is) from the draft's seed;
    None without speculation."""
    from .. import configs
    from ..models import build_model

    if w.spec is None:
        return None
    arch, seed, _ = w.spec
    if (arch, seed) == (w.arch, w.seed):
        return model
    cfg = w.config() if arch == w.arch else configs.get(arch)
    if arch != w.arch and w.reduced:
        cfg = cfg.reduced()
    return build_model(cfg, device=device, seed=seed, mesh=mesh)


def expert_bytes(model) -> int:
    """Bytes of the MoE expert leaves this process holds (0 outside MoE)."""
    return sum(p.numel() * p.element_size() for n, p in model.named_parameters()
               if ".moe.experts." in n)


class RouteDigests:
    """Within its scope, a digest of every MoE layer's input and of the
    experts its route picks (an observer of ``moe_experts.ops.route``, each
    call: one host copy of x and of the route's experts), for the first
    ``limit`` calls: every rank of a ``model`` group must route the same
    tokens to the same experts, or a pair is computed by no rank or by
    two."""

    def __init__(self, limit: int):
        self.limit = limit
        self.digests: list = []

    def _observe(self, x: torch.Tensor, r) -> None:
        import hashlib

        if len(self.digests) < self.limit:
            h = hashlib.sha1(x.detach().contiguous().view(torch.uint8).cpu().numpy())
            h.update(r.idx.detach().cpu().numpy().tobytes())
            self.digests.append(h.hexdigest())

    def __enter__(self):
        from ..kernels.moe_experts.ops import ROUTE_OBSERVERS

        ROUTE_OBSERVERS.append(self._observe)
        return self

    def __exit__(self, *exc):
        from ..kernels.moe_experts.ops import ROUTE_OBSERVERS

        ROUTE_OBSERVERS.remove(self._observe)
        return False


def scheduler(w: Workload, model, mesh=None, kv_pages: Optional[int] = None,
              max_seq: Optional[int] = None, blob_store=None, draft=None,
              index_journal: bool = False):
    """The workload's scheduler (speculating with ``draft`` where ``w.spec``
    sets it)."""
    from ..serve.scheduler import DecodeScheduler

    return DecodeScheduler(model, n_slots=w.n_slots, max_seq=max_seq or w.seq,
                           page_size=w.page_size, prefill_chunk=w.prefill_chunk,
                           attn_backend=w.attn_backend if w.kv_mode == "paged" else "gather",
                           device=model.device, mesh=mesh, kv_mode=w.kv_mode,
                           kv_pages=kv_pages if kv_pages is not None else w.kv_pages,
                           blob_store=blob_store, offload=w.offload,
                           prefix_sharing=w.prefix_sharing, park_sessions=w.park_sessions,
                           park_ttl_steps=w.park_ttl_steps, index_journal=index_journal,
                           draft_model=draft if w.spec is not None else None,
                           spec_k=w.spec[2] if w.spec is not None else 0)


def step_wire(sched) -> tuple:
    """The collective bytes and ms of ``sched``'s last decode step, or of
    its last round where it speculates."""
    if sched._spec:
        return sched.last_round_wire_bytes, sched.last_round_wire_ms
    return sched.last_step_wire_bytes, sched.last_step_wire_ms


class RecordingStore(PageBlobStore):
    """A page-blob store that also keeps every blob it is given, in order
    (``history``), so a mesh run's blobs can be held against ``mesh=None``'s
    after their restores have deleted them."""

    def __init__(self):
        super().__init__()
        self.history: list = []

    def put(self, key: str, blob, nbytes: int) -> None:
        super().put(key, blob, nbytes)
        self.history.append((key, blob))


def blob_shard(blob, pool: Dict[str, Any]):
    """The shard of a whole page blob ``{"kp", "vp": (L, n, ps, Hkv, D)}``
    that the rank of ``pool`` (a :class:`PoolShard` as a dict) holds: its
    lanes (axis 2) or kv heads (axis 3)."""
    if pool is None or pool["mode"] == "replicated":
        return blob
    dim = 2 if pool["mode"] == "lane" else 3
    return {key: leaf.narrow(dim, leaf.shape[dim] // pool["count"] * pool["index"],
                             leaf.shape[dim] // pool["count"]) for key, leaf in blob.items()}


def blob_agreement(ranks, single) -> Dict[str, Any]:
    """Each rank's blobs against its shard of ``mesh=None``'s, in put order:
    whether every one is bitwise, whether layer 0 of every one is (its K/V
    come from the embeddings alone, so a stale or misrouted page shows
    there), per blob the layers (leading axis) that are bitwise, the
    largest |difference| over the largest |value| of its leaf
    (``blob_rel_err_whole``), and over the largest |value| of its own layer
    and kv head, in all and per layer (a fleet's park-meta records are
    host data, not pages, and are left out)."""
    from ..serve.fleet import PARK_META_PREFIX

    none = {"blobs_bitwise": False, "blob_layer0_bitwise": False, "blob_rel_err": None,
            "blob_rel_err_whole": None, "blob_rel_err_by_layer": None,
            "blob_layers_bitwise": None}
    bitwise, layer0, layers, by_layer, whole_err = True, True, [], None, 0.0
    for r in ranks:
        if [k for k, _ in r["blobs"]] != [k for k, _ in single["blobs"]]:
            return none
        for (key, got), (_, whole) in zip(r["blobs"], single["blobs"]):
            if key.startswith(PARK_META_PREFIX):    # a fleet's directory record, not pages
                continue
            want = blob_shard(whole, r["pool"])
            same = [all(torch.equal(got[k][i], want[k][i]) for k in got)
                    for i in range(got["kp"].shape[0])]
            layers.append(sum(same))
            bitwise &= all(same)
            layer0 &= same[0]
            for k in got:
                err = (got[k].float() - want[k].float()).abs()
                whole_err = max(whole_err, err.max().item()
                                / (want[k].float().abs().max().item() or 1.0))
                # (L, n, ps, Hkv, D): reduce to one value a layer and kv head
                diff = err.amax(dim=(1, 2, 4))
                scale = want[k].float().abs().amax(dim=(1, 2, 4))
                rel = torch.where(diff == 0, torch.zeros_like(diff), diff / scale)
                rel = rel.amax(dim=1)
                by_layer = rel if by_layer is None else torch.maximum(by_layer, rel)
    return {"blobs_bitwise": bitwise, "blob_layer0_bitwise": layer0,
            "blob_rel_err": None if by_layer is None else by_layer.max().item(),
            "blob_rel_err_whole": whole_err,
            "blob_rel_err_by_layer": None if by_layer is None else by_layer.tolist(),
            "blob_layers_bitwise": layers}


def drive(sched, w: Workload, prompts: Sequence[np.ndarray], *, one_at_a_time: bool = False
          ) -> Dict[str, Any]:
    """Serve ``prompts`` (request ``r<i>`` in session ``s<i mod sessions>``)
    to completion: all submitted at once, or one request at a time.
    Returns the tokens by request, the step count, the wall ms of each step
    that ran a decode step and no chunk and of each that ran a chunk (its
    decode step included), and the collective bytes of each decode step
    and each chunk this rank ran (mesh mode)."""
    outputs: Dict[str, list] = {}
    step_ms, wire, chunk_ms, chunk_wire, wire_ms, chunk_wire_ms = [], [], [], [], [], []
    steps = 0
    batches = [[i] for i in range(len(prompts))] if one_at_a_time else [range(len(prompts))]
    for batch in batches:
        for i in batch:
            sched.submit(f"s{i % w.sessions}", f"r{i}", prompts[i], w.max_new)
        while sched.busy():
            decoded, chunks, ran = sched.decode_tokens, sched.prefill_chunks, sched.chunks_run
            _sync(sched.device)
            t0 = time.perf_counter()
            for fin in sched.step():
                outputs[fin.request_id] = np.asarray(fin.tokens).tolist()
            _sync(sched.device)
            ms = (time.perf_counter() - t0) * 1e3
            if sched.decode_tokens > decoded:
                sent, secs = step_wire(sched)
                wire.append(sent)
                wire_ms.append(secs)
                if sched.prefill_chunks == chunks:      # a step of decode alone
                    step_ms.append(ms)
            if sched.chunks_run > ran:
                chunk_ms.append(ms)
                chunk_wire.append(sched.last_chunk_wire_bytes)
                chunk_wire_ms.append(sched.last_chunk_wire_ms)
            steps += 1
            if steps > 100_000:
                raise RuntimeError("the scheduler failed to drain")
    return {"tokens": outputs, "steps": steps, "step_ms": step_ms, "wire": wire,
            "wire_ms": wire_ms, "chunk_ms": chunk_ms, "chunk_wire": chunk_wire,
            "chunk_wire_ms": chunk_wire_ms, "decode_tokens": sched.decode_tokens}


def event_soup(sched, w: Workload, vocab: int) -> Dict[str, Any]:
    """The workload's seeded event soup (``w.soup``, drawn from ``w.seed``)
    on ``sched``: :func:`soup_events` over ``w.soup.sessions`` sessions.
    Every rank of a mesh draws the same events, since the host state is the
    same on every rank."""
    rng = np.random.default_rng(w.seed)
    sessions = [f"s{i}" for i in range(w.soup.sessions)]
    system = rng.integers(0, vocab, size=SOUP_SYSTEM_PAGES * w.page_size).astype(np.int32)
    return soup_events(sched, rng, sessions, system, w.soup, w.seq, vocab)


def soup_events(sched, rng, sessions: Sequence[str], system: np.ndarray, soup: Soup, seq: int,
                vocab: int, *, log: Optional[list] = None, on_complete=None
                ) -> Dict[str, Any]:
    """The event soup's rounds and drain on ``sched`` (:class:`Soup`), drawn
    from ``rng``, prompts of ``vocab`` tokens at most ``seq`` long with
    their budgets, ``system`` the shared system prompt, ``audit()`` after
    every step; raises on a violation of per-session FIFO order, on a
    drain that does not end and on a leaked page reference.  ``log`` gets
    every event (submits with their kind, forced preemptions, completions,
    drain steps); ``on_complete(session, request, prompt, tokens)`` sees
    each completion (a reference check may raise there).  Returns the
    completions in order (session, request, prompt, budget, tokens), the
    counters, the collective bytes of each decode step and of each forced
    preemption, and the wall ms of each forced preemption, of each step
    that ran a restore chunk and of each that ran a decode step alone."""
    from ..serve.lifecycle import SlotState

    history: Dict[str, Any] = dict.fromkeys(sessions)
    inflight: Dict[str, tuple] = {}
    done, preempt_ms, preempt_wire, restore_ms = [], [], [], []
    wire, wire_ms, step_ms = [], [], []
    rid = 0
    policy = getattr(sched, "_policy", None)
    log = log if log is not None else []

    def submit(sess):
        nonlocal rid
        h = history[sess]
        roll = rng.random()
        if h is not None and roll < 0.6 and len(h) + 8 <= seq:
            # multi-turn: extend this session's conversation
            prompt = np.concatenate([h, rng.integers(
                0, vocab, int(rng.integers(*soup.extend_len))).astype(np.int32)])
            kind = "extend"
        elif roll < 0.8:
            # the shared system prompt across sessions (prefix-index food)
            prompt = np.concatenate([system, rng.integers(
                0, vocab, int(rng.integers(*soup.fresh_len))).astype(np.int32)])
            kind = "shared"
        else:
            prompt = rng.integers(0, vocab, int(rng.integers(*soup.fresh_len))).astype(np.int32)
            kind = "fresh"
        max_new = min(int(rng.integers(soup.max_new[0], soup.max_new[1] + 1)),
                      seq - len(prompt))
        if max_new < 1:
            history[sess] = None            # conversation too long: restart
            return
        name = f"r{rid}"
        rid += 1
        sched.submit(sess, name, prompt, max_new)
        inflight[sess] = (name, prompt, max_new)
        log.append({"ev": "submit", "session": sess, "rid": name, "kind": kind,
                    "prompt": prompt.tolist(), "max_new": max_new})

    def step():
        restores, decoded, chunks = sched.restore_chunks, sched.decode_tokens, sched.prefill_chunks
        _sync(sched.device)
        t0 = time.perf_counter()
        fins = sched.step()
        _sync(sched.device)
        ms = (time.perf_counter() - t0) * 1e3
        if sched.decode_tokens > decoded:
            sent, secs = step_wire(sched)
            wire.append(sent)
            wire_ms.append(secs)
            if sched.prefill_chunks == chunks and sched.restore_chunks == restores:
                step_ms.append(ms)
        if sched.restore_chunks > restores:
            restore_ms.append(ms)
        sched.audit()
        for fin in fins:
            name, prompt, max_new = inflight.pop(fin.session)
            if fin.request_id != name:
                raise AssertionError("per-session FIFO violated")
            tokens = np.asarray(fin.tokens).astype(np.int32)
            log.append({"ev": "complete", "rid": name, "tokens": tokens.tolist()})
            if on_complete is not None:
                on_complete(fin.session, name, prompt, max_new, tokens)
            done.append((fin.session, name, prompt.tolist(), max_new, tokens.tolist()))
            history[fin.session] = np.concatenate([prompt, tokens])

    for _ in range(soup.events):
        for sess in sessions:
            if sess not in inflight and rng.random() < 0.35:
                submit(sess)
        if rng.random() < SOUP_PREEMPT_P:
            victims = [s for s in sched.slots if s.state is SlotState.ACTIVE and s.pages]
            if victims:
                v = victims[int(rng.integers(len(victims)))]
                log.append({"ev": "preempt", "slot": v.index})
                sent = policy.wire.bytes if policy is not None else 0
                _sync(sched.device)
                t0 = time.perf_counter()
                sched.preempt(v.index)
                _sync(sched.device)
                preempt_ms.append((time.perf_counter() - t0) * 1e3)
                preempt_wire.append((policy.wire.bytes if policy is not None else 0) - sent)
        step()
    drained = 0
    while sched.busy():
        step()
        log.append({"ev": "drain-step"})
        drained += 1
        if drained > SOUP_DRAIN_STEPS:
            raise RuntimeError("the scheduler failed to drain")
    a = sched.allocator
    held = sum(len(r.pages) for r in sched._parked.values()) + len(sched.prefix_index)
    if a.total_refs != held:
        raise AssertionError(f"leaked references: {a.total_refs} != {held}")
    return {"completions": done, "stats": sched.stats(), "preempt_ms": preempt_ms,
            "preempt_wire": preempt_wire, "restore_ms": restore_ms, "wire": wire,
            "wire_ms": wire_ms, "step_ms": step_ms}


def sched_ref(w: Workload, model, mesh, completions) -> Dict[str, list]:
    """The reference's ``SchedRef`` on this mesh: a second scheduler with
    the same steps, eviction-free (no offload, no forced preemption, no
    prefix sharing, an ample pool), parking sessions when the workload's
    pool has pages so a multi-turn extension takes the same parked path,
    serving each completed request alone, in completion order, under its
    own session.  Returns its tokens by request."""
    paged = w.kv_mode == "paged"
    ref = scheduler(dataclasses.replace(w, offload=False, prefix_sharing=False,
                                        park_sessions=paged, park_ttl_steps=0,
                                        kv_pages=None), model, mesh)
    out = {}
    for session, name, prompt, max_new, _ in completions:
        ref.submit(session, name, np.asarray(prompt, np.int32), max_new)
        while True:
            fins = ref.step()
            if fins:
                out[name] = np.asarray(fins[0].tokens).tolist()
                break
    return out


# ---------------------------------------------------------------------------
# The elastic fleet
# ---------------------------------------------------------------------------

FLEET_EXTEND = 8          # user tokens a second turn adds to its session's history
FLEET_DRAIN_TICKS = 20000  # the most ticks a drain or a scale to zero may take
FLEET_SOUP = dict(events=22, sessions=(3, 6), fresh_len=(5, 12), extend_len=(1, 4),
                  max_new=(2, 4), crash_p=0.25, crash_at=6)
FLEET_CRASH_POINTS = ("mid-decode", "mid-restore", "mid-park")


def fleet_of(w: Workload, model, mesh=None, store=None, draft=None):
    """The workload's fleet: ``w.fleet.workers`` schedulers of ``w.n_slots``
    slots over one blob store (``store``), each parking sessions and
    journaling the prefix index, scaling to zero, with the
    :class:`~repro_torch.core.FaultPlan` of ``w.fleet.crashes``."""
    from ..core import FaultPlan
    from ..serve.fleet import FleetController

    store = store if store is not None else RecordingStore()
    wp = dataclasses.replace(w, park_sessions=True, prefix_sharing=True)
    workers = [scheduler(wp, model, mesh, blob_store=store, draft=draft, index_journal=True)
               for _ in range(w.fleet.workers)]
    crashes = {(f"fleet:{wid}", point): n for wid, point, n in w.fleet.crashes}
    return FleetController(workers, min_workers=0, scale_to_zero=True, drain_idle_steps=3,
                           faults=FaultPlan(crashes=crashes))


def fleet_tick(fleet, done: list, wire: list, inflight: dict, on_complete=None) -> None:
    """One tick of ``fleet``, its ledger audited after it: completions go to
    ``done`` in order (per-session FIFO checked against ``inflight``, which
    maps a session to the request it completes next), and each worker
    decode step's collective bytes to ``wire``."""
    before = {wid: w.sched.decode_tokens for wid, w in fleet.workers.items()}
    for fin in fleet.step():
        name, prompt, max_new = inflight.pop(fin.session)
        if fin.request_id != name:
            raise AssertionError("per-session FIFO violated across the fleet")
        tokens = np.asarray(fin.tokens).astype(np.int32)
        if on_complete is not None:
            on_complete(fin.session, name, prompt, max_new, tokens)
        done.append((fin.session, name, np.asarray(prompt).tolist(), max_new, tokens.tolist()))
    for wid, w in fleet.workers.items():
        if w.sched.decode_tokens > before.get(wid, w.sched.decode_tokens):
            wire.append(step_wire(w.sched)[0])
    fleet.audit()


def fleet_turns(fleet, w: Workload, vocab: int) -> Dict[str, Any]:
    """The scripted fleet scenario (:class:`Fleet`), drawn from ``w.seed``:
    ``w.n_requests`` prompts of ``w.prompt_len`` tokens (a shared system
    prompt of SOUP_SYSTEM_PAGES pages, then their own), request ``r<i>`` in
    session ``s<i mod sessions>``, in one burst; a scale to zero (every
    worker drains and externalizes its parked sessions); then the cold
    start: the first ``w.fleet.second`` sessions each extend their history
    by FLEET_EXTEND tokens; a scale to zero again.  Returns the
    completions in order and each worker decode step's collective bytes."""
    rng = np.random.default_rng(w.seed)
    system = rng.integers(0, vocab, SOUP_SYSTEM_PAGES * w.page_size).astype(np.int32)
    done, wire, inflight, history, queued = [], [], {}, {}, []

    def track(session, name, prompt, max_new, tokens):
        history[session] = np.concatenate([np.asarray(prompt, np.int32), tokens])

    def submit(session, name, prompt):
        fleet.submit(session, name, prompt, w.max_new)
        queued.append((session, name, prompt))

    def drain(what: str) -> None:
        for _ in range(FLEET_DRAIN_TICKS):
            for q in list(queued):      # a session's next request completes next
                if q[0] not in inflight:
                    inflight[q[0]] = (q[1], q[2], w.max_new)
                    queued.remove(q)
            if not (fleet.busy() or inflight):
                break
            fleet_tick(fleet, done, wire, inflight, track)
        else:
            raise RuntimeError(f"the fleet did not drain {what}")
        for _ in range(FLEET_DRAIN_TICKS):
            if not fleet.live_workers():
                return
            fleet_tick(fleet, done, wire, inflight)
        raise RuntimeError(f"the fleet did not scale to zero after {what}")

    for i in range(w.n_requests):
        submit(f"s{i % w.sessions}", f"r{i}", np.concatenate(
            [system, rng.integers(0, vocab, w.prompt_len - len(system)).astype(np.int32)]))
    drain("the burst")
    for j in range(w.fleet.second):
        session = f"s{j}"
        submit(session, f"r{w.n_requests + j}", np.concatenate(
            [history[session], rng.integers(0, vocab, FLEET_EXTEND).astype(np.int32)]))
    drain("the second turn")
    return {"completions": done, "wire": wire}


def fleet_soup(fleet, w: Workload, vocab: int) -> Dict[str, Any]:
    """The fleet differential harness's seeded soup on ``fleet`` (its draws
    in its order, from ``w.seed`` and the tag ``fleet-<arch>``): crashes at
    mid-decode, mid-restore and mid-park drawn for each worker, 3-5
    sessions submitting fresh, shared-system-prompt and multi-turn prompts,
    scale-up bursts, forced scale-downs and wedged workers reaped by
    heartbeat eviction (each rank's own membership service on its own
    simulated cloud), then a drain and a scale to zero; the ledger audited
    every tick.  Returns the completions in order and each worker decode
    step's collective bytes."""
    import zlib

    from ..coord import MembershipService
    from ..core import FaaSKeeperService, FaultPlan, SimCloud

    soup = FLEET_SOUP
    rng = np.random.default_rng(zlib.crc32(f"fleet-{w.arch}".encode()) * 100003 + w.seed)
    crashes = {}
    for k in range(fleet.max_workers):
        for point in FLEET_CRASH_POINTS:
            if rng.random() < soup["crash_p"]:
                crashes[(f"fleet:w{k}", point)] = int(rng.integers(0, soup["crash_at"]))
    fleet.reset(faults=FaultPlan(crashes=crashes))
    cloud = SimCloud(seed=w.seed)
    svc = FaaSKeeperService(cloud, regions=("region-0",))
    fleet.membership = MembershipService(svc)

    def sweep():
        svc.start_heartbeat(period=1.0, max_runs=1)
        cloud.run()

    sessions = [f"s{i}" for i in range(int(rng.integers(*soup["sessions"])))]
    history = dict.fromkeys(sessions)
    inflight: dict = {}
    system = rng.integers(0, vocab, size=SOUP_SYSTEM_PAGES * w.page_size).astype(np.int32)
    done, wire = [], []
    rid = 0

    def submit(sess):
        nonlocal rid
        h = history[sess]
        roll = rng.random()
        if h is not None and roll < 0.6 and len(h) + 8 <= w.seq:
            prompt = np.concatenate([h, rng.integers(
                0, vocab, int(rng.integers(*soup["extend_len"]))).astype(np.int32)])
        elif roll < 0.8:
            prompt = np.concatenate([system, rng.integers(
                0, vocab, int(rng.integers(*soup["fresh_len"]))).astype(np.int32)])
        else:
            prompt = rng.integers(0, vocab, int(rng.integers(*soup["fresh_len"]))).astype(
                np.int32)
        max_new = min(int(rng.integers(soup["max_new"][0], soup["max_new"][1] + 1)),
                      w.seq - len(prompt))
        if max_new < 1:
            history[sess] = None
            return
        fleet.submit(sess, f"r{rid}", prompt, max_new)
        inflight[sess] = (f"r{rid}", prompt, max_new)
        rid += 1

    def track(session, name, prompt, max_new, tokens):
        history[session] = np.concatenate([np.asarray(prompt, np.int32), tokens])

    for _ in range(soup["events"]):
        for sess in sessions:
            if sess not in inflight and rng.random() < 0.35:
                submit(sess)
        if rng.random() < 0.08:
            fleet.scale_up()
        if rng.random() < 0.08:
            fleet.scale_down()
        if rng.random() < 0.06:
            live = [x.worker_id for x in fleet.workers.values() if x.state != "wedged"]
            if live:
                fleet.fail_worker(live[int(rng.integers(len(live)))])
        if rng.random() < 0.25:
            sweep()
        fleet_tick(fleet, done, wire, inflight, track)
    for _ in range(FLEET_DRAIN_TICKS):
        if not fleet.busy():
            break
        sweep()
        fleet_tick(fleet, done, wire, inflight, track)
    else:
        raise RuntimeError("the fleet did not drain")
    for _ in range(FLEET_DRAIN_TICKS):
        if not fleet.live_workers():
            break
        sweep()
        fleet_tick(fleet, done, wire, inflight)
    else:
        raise RuntimeError("the fleet did not scale to zero")
    if inflight:
        raise AssertionError(f"requests lost: {sorted(inflight)}")
    return {"completions": done, "wire": wire}


def fleet_record(fleet) -> Dict[str, Any]:
    """What every rank of a mesh fleet must agree on: the fleet's stats,
    its log of worker events and adoptions in order, and every worker's
    scheduler stats."""
    return {"fleet": fleet.fleet_stats(), "log": list(fleet.log),
            "workers": [s.stats() for s in fleet._all_scheds()]}


def _one_decode_wire(sched, w: Workload, prompt: np.ndarray) -> int:
    """The collective bytes of one decode step of ``sched`` (every decode
    step computes every row, so any step's bytes are every step's, whatever
    the prompt: a few of its tokens are admitted, which keeps a long ring
    prefill's transients out of this check), or of the first speculation
    round after that admission (its catch-up spans the prompt)."""
    sched.submit("wire", "wire", prompt[:4], 2)
    while sched.decode_tokens == 0:
        sched.step()
    return step_wire(sched)[0]


def _launch_wrappers() -> dict:
    from ..kernels.flash_attention import flash_attention_kernel
    from ..kernels.moe_experts import moe_combine_kernel, moe_experts_kernel, moe_route_kernel
    from ..kernels.paged_attention import paged_attention_kernel
    from ..kernels.rglru_scan import rglru_scan_kernel
    from ..kernels.ssd_scan import ssd_scan_kernel

    return {"paged_attention": paged_attention_kernel, "rglru_scan": rglru_scan_kernel,
            "ssd_scan": ssd_scan_kernel, "flash_attention": flash_attention_kernel,
            "moe_route": moe_route_kernel, "moe_experts": moe_experts_kernel,
            "moe_combine": moe_combine_kernel}


def serve_workload(w: Workload, model, mesh=None, store=None, draft=None) -> tuple:
    """``w`` on ``mesh`` (None: in this process): its fleet (the soup or the
    turns), its event soup or a plain drive.  Returns the run (tokens by
    request, the collective bytes of each decode step or round, ...), the
    scheduler whose placement it reports (a fleet's first worker: every
    worker is placed alike) and the fleet (or None)."""
    vocab = model.cfg.vocab
    if w.fleet is not None:
        fleet = fleet_of(w, model, mesh, store, draft)
        workers = list(fleet._pool)
        run = fleet_soup(fleet, w, vocab) if w.fleet.soup else fleet_turns(fleet, w, vocab)
        run.update(tokens={c[1]: c[4] for c in run["completions"]}, steps=fleet.steps,
                   step_ms=[], wire_ms=[], chunk_ms=[], chunk_wire=[], chunk_wire_ms=[],
                   decode_tokens=sum(x.decode_tokens for x in workers),
                   chunks_run=sum(x.chunks_run for x in workers),
                   worker_steps=sum(x.steps for x in workers), stats=fleet.fleet_stats())
        return run, workers[0], fleet
    sched = scheduler(w, model, mesh, blob_store=store, draft=draft)
    if w.soup is not None:
        run = event_soup(sched, w, vocab)
        run.update(tokens={c[1]: c[4] for c in run["completions"]}, steps=sched.steps,
                   chunk_ms=[], chunk_wire=[], chunk_wire_ms=[],
                   decode_tokens=sched.decode_tokens)
    else:
        run = drive(sched, w, w.prompts(vocab))
    run["chunks_run"] = sched.chunks_run
    return run, sched, None


def serve_rank(mesh, w: Workload, *, mesh_matched: bool = False,
               probe: bool = True) -> Dict[str, Any]:
    """One rank of the mesh run: the workload (its fleet, its event soup or
    a plain drive) on ``mesh``, then the decode step's (or a speculation
    round's) collective bytes at a pool 4x larger (paged) or at twice
    ``max_seq`` (rings), and (``mesh_matched``) the same sharded scheduler,
    without speculation or a fleet, serving each request alone; a fleet's
    record (:func:`fleet_record`) is checked equal on every rank.  ``probe``:
    first :func:`host_probe` the rank (returned under "probe")."""
    import torch.distributed as dist

    from ..serve.scheduler import ranks_agree

    device = "cuda" if mesh.device_type == "cuda" else "cpu"
    t_job = time.perf_counter()
    probe = host_probe(device) if probe else None
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    wrappers = _launch_wrappers()
    model = build(w, device, mesh)
    draft = build_draft(w, model, device, mesh)
    prompts = w.prompts(model.cfg.vocab)
    store = RecordingStore()
    for wrapper in wrappers.values():
        wrapper.launches = 0
    by_kind = {name: wrappers[name].launches_by_kind
               for name in ("ssd_scan", "moe_route", "moe_experts", "moe_combine")}
    combine_modes = wrappers["moe_combine"].launches_by_mode
    for counts in (*by_kind.values(), combine_modes):
        counts.update(dict.fromkeys(counts, 0))
    digests = RouteDigests(4 * model.cfg.n_layers)
    t0 = time.perf_counter()
    with digests if model.cfg.family == "moe" else contextlib.nullcontext():
        run, sched, fleet = serve_workload(w, model, mesh, store, draft)
    _sync(device)
    wall = time.perf_counter() - t0
    policy = sched._policy
    out = {"rank": dist.get_rank(), "coord": tuple(mesh.get_coordinate()),
           "tokens": run["tokens"], "steps": run["steps"], "step_ms": run["step_ms"],
           "wall_s": wall, "decode_tokens": run["decode_tokens"],
           "decode_steps": len(run["wire"]), "chunks_run": run["chunks_run"],
           "launches": {name: fn.launches for name, fn in wrappers.items()},
           "ssd_launches_by_kind": dict(by_kind["ssd_scan"]),
           "moe_launches_by_kind": {name: dict(counts) for name, counts in by_kind.items()
                                    if name != "ssd_scan"},
           "combine_launches_by_mode": dict(combine_modes),
           "route_digests": digests.digests, "expert_bytes": expert_bytes(model),
           "experts": (dataclasses.asdict(policy.experts) if policy.experts else None),
           "wire_per_step": sorted(set(run["wire"])), "wire_ms": run["wire_ms"],
           "chunk_wire_ms": run["chunk_wire_ms"], "chunk_ms": run["chunk_ms"],
           "chunk_wire": sorted(set(run["chunk_wire"])), "pool_bytes": sched.pool_bytes(),
           "ring_bytes": sched.held_bytes(("k", "v")),
           "ring_scratch_bytes": sched.ring_scratch_bytes(),
           "state_bytes": sched.held_bytes(("ssm",)),
           "pool": dataclasses.asdict(policy.pool) if policy.pool else None,
           "ring": dataclasses.asdict(policy.ring) if policy.ring else None,
           "ssm": dataclasses.asdict(policy.ssm) if policy.ssm else None,
           "n_pages": sched.n_pages, "slot_split": sched._slot_split,
           "row_wire_bytes": sched.row_wire_bytes,
           "page_wire_bytes": sched.page_wire_bytes, "kv_share_bytes": sched.kv_share_bytes,
           "blobs": store.history, "journal": store.ops}
    if w.soup is not None:
        for key in ("completions", "stats", "preempt_ms", "preempt_wire", "restore_ms"):
            out[key] = run[key]
    if w.spec is not None:
        out["spec_stats"] = sched.spec_stats()
    if fleet is not None:
        out.update(completions=run["completions"], stats=run["stats"],
                   worker_steps=run["worker_steps"], fleet=fleet_record(fleet))
        out["fleet_agree"] = ranks_agree(out["fleet"])
    if device == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    del sched, fleet
    _free(device)           # each scheduler's cache before the next is placed
    # the one-scheduler form of the workload: its decode step's (or round's)
    # bytes at the default pool and at a bigger one, and its matched run
    wb = dataclasses.replace(w, fleet=None, park_sessions=w.park_sessions or bool(w.fleet),
                             prefix_sharing=w.prefix_sharing or bool(w.fleet))
    if w.spec is not None:
        out["wire_one"] = _one_decode_wire(scheduler(wb, model, mesh, draft=draft), w, prompts[0])
        _free(device)
    if w.kv_mode == "ring":
        big = scheduler(wb, model, mesh, max_seq=2 * w.seq, draft=draft)
    else:
        big = scheduler(wb, model, mesh, kv_pages=4 * (w.n_slots * -(-w.seq // w.page_size)),
                        draft=draft)
    out["wire_per_step_big"] = _one_decode_wire(big, w, prompts[0])
    out["pool_bytes_4x"] = big.pool_bytes()
    del big
    _free(device)
    if mesh_matched:
        wr = dataclasses.replace(wb, spec=None)
        out["matched_tokens"] = (
            sched_ref(wr, model, mesh, run["completions"])
            if w.soup is not None or w.fleet is not None else
            drive(scheduler(wr, model, mesh), w, prompts, one_at_a_time=True)["tokens"])
    if probe is not None and device == "cuda":
        probe["alloc_retries_after"] = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    out["probe"] = probe
    out["job_s"] = time.perf_counter() - t_job
    return out


def _free(device) -> None:
    """Collect what a finished scheduler leaves (it holds reference
    cycles) and return the cached blocks, so several ranks' models fit one
    card."""
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def serve_rank_jobs(mesh, jobs: Sequence[tuple], gate: Optional[tuple] = None) -> list:
    """One rank of several mesh runs in one spawn: ``jobs`` holds
    ``(workload, mesh_matched)`` pairs, each served by :func:`serve_rank`
    on a model of its own; the last job's model (its schedulers hold
    reference cycles) is collected before the next is built; the first
    job probes the rank (:func:`host_probe`).  ``gate``
    ``(index, path)``: job ``index`` starts once ``path`` exists (the
    spawning process's sign that it has freed the card for the jobs
    from there on)."""
    out = []
    for i, (w, matched) in enumerate(jobs):
        if gate is not None and i == gate[0]:
            _wait_for(gate[1])
        out.append(serve_rank(mesh, w, mesh_matched=matched, probe=i == 0))
        _free(mesh.device_type)
    return out


def _wait_for(path: str, timeout_s: float = JOIN_TIMEOUT_S) -> None:
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() >= deadline:
            raise TimeoutError(f"{path} did not appear in {timeout_s:.0f} s")
        time.sleep(0.2)


def run_single(w: Workload, device, model=None) -> Dict[str, Any]:
    """The workload on ``mesh=None`` in this process (:func:`serve_workload`'s
    run, the pool's and rings' bytes, and the storage journal and blobs),
    on ``model`` or a fresh one."""
    model = build(w, device) if model is None else model
    store = RecordingStore()
    # a plain drive's speculation is held to the run without it; a soup's
    # or a fleet's requests depend on when its streams end, so there it is
    # held to mesh=None's speculative run
    plain = w.soup is None and w.fleet is None
    single, sched, fleet = serve_workload(dataclasses.replace(w, spec=None) if plain else w,
                                          model, None, store,
                                          None if plain else build_draft(w, model, device))
    if fleet is not None:
        single["fleet"] = fleet_record(fleet)
    single["expert_bytes"] = expert_bytes(model)
    single["pool_bytes"] = sched.pool_bytes()
    single["ring_bytes"] = sched.held_bytes(("k", "v"))
    single["state_bytes"] = sched.held_bytes(("ssm",))
    single["blobs"] = store.history
    single["journal"] = store.ops
    return single


def verdicts(w: Workload, single: Dict[str, Any], ranks: Sequence[Dict[str, Any]], *,
             dp: int, mp: int, device: str, mesh_matched: bool = False) -> Dict[str, Any]:
    """The checks of one mesh run against its ``mesh=None`` run: their
    inputs and verdicts in one dict (``ok`` is their conjunction)."""
    r0 = ranks[0]
    res: Dict[str, Any] = {
        "arch": w.arch, "backend": w.attn_backend if w.kv_mode == "paged" else "gather",
        "kv_mode": w.kv_mode, "mesh": f"{dp}x{mp}",
        "device": device, "requests": len(r0["tokens"]), "prompt_len": w.prompt_len,
        "max_new": w.max_new, "single_steps": single["steps"], "sharded_steps": r0["steps"],
        "single_step_ms": _median(single["step_ms"]),
        "sharded_step_ms": [_median(r["step_ms"]) for r in ranks],
        "sharded_tok_s": [r["decode_tokens"] / r["wall_s"] for r in ranks],
        "ranks_agree": all(r["tokens"] == r0["tokens"] for r in ranks),
        "job_s": [r["job_s"] for r in ranks], "probe": [r["probe"] for r in ranks],
        "pool": r0["pool"], "ring": r0["ring"], "ssm": r0["ssm"],
        "pool_bytes_single": single.get("pool_bytes"),
        "pool_bytes_rank": [r["pool_bytes"] for r in ranks],
        "ring_bytes_single": single.get("ring_bytes"),
        "ring_bytes_rank": [r["ring_bytes"] for r in ranks],
        "ring_scratch_bytes_rank": [r["ring_scratch_bytes"] for r in ranks],
        "state_bytes_single": single.get("state_bytes"),
        "state_bytes_rank": [r["state_bytes"] for r in ranks],
        "wire_per_step": [r["wire_per_step"] for r in ranks],
        "wire_per_step_big": [r["wire_per_step_big"] for r in ranks],
        "chunk_wire": [r["chunk_wire"] for r in ranks],
        "wire_ms_per_step": [_median(r["wire_ms"]) for r in ranks],
        "wire_ms_per_chunk": [_median(r["chunk_wire_ms"]) for r in ranks],
        "sharded_chunk_ms": [_median(r["chunk_ms"]) for r in ranks],
        "row_wire_bytes": [r["row_wire_bytes"] for r in ranks],
        "page_wire_bytes": [r["page_wire_bytes"] for r in ranks],
        "kv_share_bytes": [r["kv_share_bytes"] for r in ranks],
        "peak_bytes": [r.get("peak_bytes") for r in ranks],
        "launches_by_rank": [r["launches"] for r in ranks],
        "ssd_launches_by_kind": [r["ssd_launches_by_kind"] for r in ranks],
        "decode_steps": [r["decode_steps"] for r in ranks],
        "chunks_run": [r["chunks_run"] for r in ranks],
    }
    res["identical_outputs"] = r0["tokens"] == single["tokens"]
    if single.get("expert_bytes"):
        # an MoE model: each rank holds E/mp experts (every one where E does
        # not divide), and every rank of a model group routes alike
        res["experts"] = r0["experts"]
        res["expert_bytes_single"] = single["expert_bytes"]
        res["expert_bytes_rank"] = [r["expert_bytes"] for r in ranks]
        res["expert_split"] = all(r["expert_bytes"] * r["experts"]["count"]
                                  == single["expert_bytes"] for r in ranks)
        groups: Dict[int, list] = {}
        for r in ranks:
            groups.setdefault(r["coord"][0], []).append(r["route_digests"])
        res["routes_agree"] = all(d == g[0] and len(d) > 0 for g in groups.values() for d in g)
        res["combine_launches_by_mode"] = [r["combine_launches_by_mode"] for r in ranks]
        res["moe_launches_by_kind"] = [r["moe_launches_by_kind"] for r in ranks]
    if mesh_matched:
        res["matched_identical"] = all(r["matched_tokens"] == r["tokens"] for r in ranks)
        res["tokens_matched"] = r0["matched_tokens"]
    # each rank holds 1/mp of every leaf the model axis splits (a T-split
    # ring's scratch lane aside), and the rings and the SSD state of its
    # data group's slots alone where the slots split over data
    split = [("pool_bytes", "pool_split", None), ("ring_bytes", "ring_split", "ring_scratch_bytes"),
             ("state_bytes", "state_split", None)]
    checks = [res["ranks_agree"]]
    for key, verdict, extra in split:
        if single.get(key):
            res[verdict] = all(
                (r[key] - (r[extra] if extra else 0)) * mp
                * (dp if r["slot_split"] and key != "pool_bytes" else 1) == single[key]
                for r in ranks)
            checks.append(res[verdict])
    if w.spec is not None:
        # a round's bytes follow its catch-up's width: the same first round
        # at the default pool and at the bigger one
        res["wire_one"] = [r["wire_one"] for r in ranks]
        res["wire_flat"] = all(r["wire_one"] == r["wire_per_step_big"] > 0 for r in ranks)
        res["spec_stats"] = [r["spec_stats"] for r in ranks]
    else:
        res["wire_flat"] = all(len(r["wire_per_step"]) == 1
                               and r["wire_per_step"][0] == r["wire_per_step_big"]
                               for r in ranks)
    checks.append(res["wire_flat"])
    if "expert_split" in res:
        checks += [res["expert_split"], res["routes_agree"]]
    if w.soup is not None:
        # the page moves (preemption, restore, parked offload, CoW) send
        # nothing; every rank bills what mesh=None bills; and each rank's
        # blobs are its shard of mesh=None's, where the tokens agree
        res["preempt_wire"] = [sum(r["preempt_wire"]) for r in ranks]
        res["pages_move_no_bytes"] = all(r["page_wire_bytes"] == 0 == sum(r["preempt_wire"])
                                         for r in ranks)
        res["journals_equal"] = all(r["journal"] == single["journal"] for r in ranks)
        res["blobs"] = len(single["blobs"])
        if res["identical_outputs"]:
            res.update(blob_agreement(ranks, single))
        for key in ("preempt_ms", "restore_ms"):
            res[f"single_{key}"] = _median(single[key])
            res[f"sharded_{key}"] = [_median(r[key]) for r in ranks]
        res["stats"] = r0["stats"]
        res["single_stats"] = single["stats"]
        res["completions"] = r0["completions"]
        checks += [res["pages_move_no_bytes"], res["journals_equal"]]
    if w.fleet is not None:
        # every rank's fleet made the same decisions (an all-reduced digest
        # of its record); each rank bills what mesh=None bills and holds its
        # shard of mesh=None's blobs, where the tokens agree
        res["fleet_agrees"] = all(r["fleet_agree"] for r in ranks)
        res["fleet_record"], res["single_fleet"] = r0["fleet"], single["fleet"]
        res["stats"], res["completions"] = r0["stats"], r0["completions"]
        res["worker_steps"] = [r["worker_steps"] for r in ranks]
        res["pages_move_no_bytes"] = all(r["page_wire_bytes"] == 0 for r in ranks)
        res["journals_equal"] = all(r["journal"] == single["journal"] for r in ranks)
        res["blobs"] = len(single["blobs"])
        if res["identical_outputs"]:
            res.update(blob_agreement(ranks, single))
        checks += [res["fleet_agrees"], res["pages_move_no_bytes"]]
    res["tokens_single"] = single["tokens"]
    res["tokens_sharded"] = r0["tokens"]
    tokens_ok = res["matched_identical"] if mesh_matched else res["identical_outputs"]
    if w.spec is not None:
        res["spec_matches"] = tokens_ok
    checks.append(tokens_ok)
    res["ok"] = all(checks)
    return res


def run_smoke(ws, *, dp: int = 2, mp: int = 2, device: str = "cuda", mesh_matched=False,
              timeout_s: float = JOIN_TIMEOUT_S) -> list:
    """Each workload of ``ws`` (one or a list) on ``dp x mp`` spawned ranks,
    all in one spawn, and on ``mesh=None`` here while they run;
    :func:`verdicts` of each.  ``mesh_matched``: a bool for every
    workload, or one per workload."""
    ws = [ws] if isinstance(ws, Workload) else list(ws)
    matched = ([mesh_matched] * len(ws) if isinstance(mesh_matched, bool)
               else list(mesh_matched))
    ranks = Ranks(serve_rank_jobs, (list(zip(ws, matched)),), dp=dp, mp=mp, device=device,
                  timeout_s=timeout_s)
    try:
        singles = [run_single(w, device) for w in ws]
    except BaseException:
        ranks.kill()
        raise
    out = ranks.join()
    return [verdicts(w, single, [r[i] for r in out], dp=dp, mp=mp, device=device,
                     mesh_matched=m)
            for i, (w, single, m) in enumerate(zip(ws, singles, matched))]


def _median(xs) -> Optional[float]:
    return float(np.median(xs)) if len(xs) else None


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--attn-backend", default="paged_kernel", choices=["gather", "paged_kernel"])
    ap.add_argument("--mesh", default="2x2", help="DPxMP")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--full-width", action="store_true",
                    help="the config's published widths (default: its reduced widths)")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--sessions", type=int, default=3)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=6)
    ap.add_argument("--page-size", type=int, default=PAGE_SIZE,
                    help="lanes a page: the model axis dividing it splits lanes, else kv heads")
    ap.add_argument("--mesh-matched", action="store_true",
                    help="hold the mesh run against itself one request at a time")
    ap.add_argument("--kv-mode", default="paged", choices=["paged", "ring"],
                    help="the shared page pool (default) or per-slot rings")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    try:
        dp, mp = (int(p) for p in args.mesh.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh wants DPxMP (e.g. 2x2), got {args.mesh!r}")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (pass --device cpu)")
    w = Workload(arch=args.arch, reduced=not args.full_width, n_layers=args.layers,
                 attn_backend=args.attn_backend, n_requests=args.requests,
                 sessions=args.sessions, prompt_len=args.prompt_len, max_new=args.max_new,
                 page_size=args.page_size, kv_mode=args.kv_mode)
    res = run_smoke(w, dp=dp, mp=mp, device=args.device, mesh_matched=args.mesh_matched)[0]
    big = "2x max_seq" if args.kv_mode == "ring" else "4x pool"
    print(f"{res['arch']} [{res['backend']}] on {res['device']}: mesh=None "
          f"{res['single_step_ms']} ms/step vs {res['mesh']} {res['sharded_step_ms']} ms/step; "
          f"pool {res['pool']}, rank pool bytes {res['pool_bytes_rank']} of "
          f"{res['pool_bytes_single']}; ring {res['ring']}, rank ring bytes "
          f"{res['ring_bytes_rank']} of {res['ring_bytes_single']}; "
          + (f"experts {res['experts']}, rank expert bytes {res['expert_bytes_rank']} of "
             f"{res['expert_bytes_single']}, routes agree {res['routes_agree']}; "
             if "expert_split" in res else "")
          + f"collective bytes per "
          f"decode step {res['wire_per_step']} ({big} {res['wire_per_step_big']}); "
          f"identical_outputs={res['identical_outputs']}"
          + (f" matched_identical={res['matched_identical']}" if args.mesh_matched else ""))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
        print(f"wrote {args.out}")
    if not res["ok"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
