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

The default arch is dense (``minicpm-2b``), which holds the strict
token-for-token claim; ``--mesh-matched`` instead holds the mesh run
against the same sharded scheduler serving one request at a time (the
reference's ``sched`` claim, for the hybrid, whose recurrence feeds
cross-shard summation order back on itself).

Usage::

  PYTHONPATH=src python -m repro_torch.launch.sharded_smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.sharded_smoke --mesh 2x2   # on the card
"""

from __future__ import annotations

import argparse
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

PAGE_SIZE = 4            # divides the mesh's model axis -> lane decomposition
N_SLOTS = 4              # divides the mesh's data axis
JOIN_TIMEOUT_S = 600.0


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


def spawn_ranks(fn: Callable, args: tuple = (), *, dp: int, mp: int, device: str = "cuda",
                timeout_s: float = JOIN_TIMEOUT_S) -> list:
    """Run ``fn(mesh, *args)`` on ``dp * mp`` spawned ranks of a ``(dp, mp)``
    ``("data", "model")`` mesh and return each rank's result, by rank.
    ``fn`` must be importable (module level) and its result picklable.  The
    process group's collectives time out after ``timeout_s``, and the join
    gives up (terminating every rank) at the same bound; a rank that raises
    re-raises here."""
    import torch.multiprocessing as tmp_mp

    world = dp * mp
    tmp = tempfile.mkdtemp(prefix="sharded_smoke_")
    try:
        ctx = tmp_mp.spawn(_rank_main, args=(world, dp, mp, device, tmp, timeout_s, fn, args),
                           nprocs=world, join=False)
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=max(0.0, min(5.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    p.terminate()
                for p in ctx.processes:
                    p.join(10)
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(f"{world} ranks did not finish in {timeout_s:.0f} s")
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# The workload
# ---------------------------------------------------------------------------


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


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def build(w: Workload, device):
    from ..models import build_model

    return build_model(w.config(), device=device, seed=w.seed)


def scheduler(w: Workload, model, mesh=None, kv_pages: Optional[int] = None):
    from ..serve.scheduler import DecodeScheduler

    return DecodeScheduler(model, n_slots=w.n_slots, max_seq=w.prompt_len + w.max_new,
                           page_size=w.page_size, prefill_chunk=w.prefill_chunk,
                           attn_backend=w.attn_backend, device=model.device, mesh=mesh,
                           kv_pages=kv_pages)


def drive(sched, w: Workload, prompts: Sequence[np.ndarray], *, one_at_a_time: bool = False
          ) -> Dict[str, Any]:
    """Serve ``prompts`` (request ``r<i>`` in session ``s<i mod sessions>``)
    to completion: all submitted at once, or one request at a time.
    Returns the tokens by request, the step count, the wall ms of each step
    that ran a decode step and no chunk, and the collective bytes of each
    decode step (mesh mode)."""
    outputs: Dict[str, list] = {}
    step_ms, wire = [], []
    steps = 0
    batches = [[i] for i in range(len(prompts))] if one_at_a_time else [range(len(prompts))]
    for batch in batches:
        for i in batch:
            sched.submit(f"s{i % w.sessions}", f"r{i}", prompts[i], w.max_new)
        while sched.busy():
            decoded, chunks = sched.decode_tokens, sched.prefill_chunks
            _sync(sched.device)
            t0 = time.perf_counter()
            for fin in sched.step():
                outputs[fin.request_id] = np.asarray(fin.tokens).tolist()
            _sync(sched.device)
            if sched.decode_tokens > decoded:
                wire.append(sched.last_step_wire_bytes)
                if sched.prefill_chunks == chunks:      # a step of decode alone
                    step_ms.append((time.perf_counter() - t0) * 1e3)
            steps += 1
            if steps > 100_000:
                raise RuntimeError("the scheduler failed to drain")
    return {"tokens": outputs, "steps": steps, "step_ms": step_ms, "wire": wire,
            "decode_tokens": sched.decode_tokens}


def _one_decode_wire(sched, w: Workload, prompt: np.ndarray) -> int:
    """The collective bytes of one decode step of ``sched`` (every decode
    step computes every row, so any step's bytes are every step's)."""
    sched.submit("wire", "wire", prompt, 2)
    while sched.decode_tokens == 0:
        sched.step()
    return sched.last_step_wire_bytes


def serve_rank(mesh, w: Workload, *, mesh_matched: bool = False) -> Dict[str, Any]:
    """One rank of the mesh run: the workload on ``mesh``, then the decode
    step's collective bytes at a pool 4x larger, and (``mesh_matched``)
    the same sharded scheduler serving one request at a time."""
    import torch.distributed as dist

    device = "cuda" if mesh.device_type == "cuda" else "cpu"
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    from ..kernels.paged_attention import paged_attention_kernel
    from ..kernels.rglru_scan import rglru_scan_kernel

    model = build(w, device)
    prompts = w.prompts(model.cfg.vocab)
    sched = scheduler(w, model, mesh)
    for wrapper in (paged_attention_kernel, rglru_scan_kernel):
        wrapper.launches = 0
    t0 = time.perf_counter()
    run = drive(sched, w, prompts)
    _sync(device)
    wall = time.perf_counter() - t0
    out = {"rank": dist.get_rank(), "coord": tuple(mesh.get_coordinate()),
           "tokens": run["tokens"], "steps": run["steps"], "step_ms": run["step_ms"],
           "wall_s": wall, "decode_tokens": run["decode_tokens"],
           "decode_steps": len(run["wire"]), "chunks_run": sched.chunks_run,
           "launches": {"paged_attention": paged_attention_kernel.launches,
                        "rglru_scan": rglru_scan_kernel.launches},
           "wire_per_step": sorted(set(run["wire"])), "pool_bytes": sched.pool_bytes(),
           "pool": dataclasses.asdict(sched._policy.pool) if sched._policy.pool else None,
           "n_pages": sched.n_pages}
    del sched
    big = scheduler(w, model, mesh, kv_pages=4 * (w.n_slots * -(-(w.prompt_len + w.max_new)
                                                                 // w.page_size)))
    out["wire_per_step_4x"] = _one_decode_wire(big, w, prompts[0])
    out["pool_bytes_4x"] = big.pool_bytes()
    del big
    if mesh_matched:
        out["matched_tokens"] = drive(scheduler(w, model, mesh), w, prompts,
                                      one_at_a_time=True)["tokens"]
    if device == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def serve_rank_jobs(mesh, jobs: Sequence[tuple]) -> list:
    """One rank of several mesh runs in one spawn: ``jobs`` holds
    ``(workload, mesh_matched)`` pairs, each served by :func:`serve_rank`."""
    return [serve_rank(mesh, w, mesh_matched=matched) for w, matched in jobs]


def run_single(w: Workload, device, model=None) -> Dict[str, Any]:
    """The workload on ``mesh=None`` in this process (:func:`drive`'s result
    and the pool's bytes), on ``model`` or a fresh one."""
    model = build(w, device) if model is None else model
    sched = scheduler(w, model)
    single = drive(sched, w, w.prompts(model.cfg.vocab))
    single["pool_bytes"] = sched.pool_bytes()
    return single


def verdicts(w: Workload, single: Dict[str, Any], ranks: Sequence[Dict[str, Any]], *,
             dp: int, mp: int, device: str, mesh_matched: bool = False) -> Dict[str, Any]:
    """The checks of one mesh run against its ``mesh=None`` run: their
    inputs and verdicts in one dict (``ok`` is their conjunction)."""
    r0 = ranks[0]
    res: Dict[str, Any] = {
        "arch": w.arch, "backend": w.attn_backend, "mesh": f"{dp}x{mp}", "device": device,
        "requests": w.n_requests, "prompt_len": w.prompt_len, "max_new": w.max_new,
        "single_steps": single["steps"], "sharded_steps": r0["steps"],
        "single_step_ms": _median(single["step_ms"]),
        "sharded_step_ms": [_median(r["step_ms"]) for r in ranks],
        "sharded_tok_s": [r["decode_tokens"] / r["wall_s"] for r in ranks],
        "ranks_agree": all(r["tokens"] == r0["tokens"] for r in ranks),
        "pool": r0["pool"],
        "pool_bytes_single": single.get("pool_bytes"),
        "pool_bytes_rank": [r["pool_bytes"] for r in ranks],
        "wire_per_step": [r["wire_per_step"] for r in ranks],
        "wire_per_step_4x": [r["wire_per_step_4x"] for r in ranks],
        "peak_bytes": [r.get("peak_bytes") for r in ranks],
        "launches_by_rank": [r["launches"] for r in ranks],
        "decode_steps": [r["decode_steps"] for r in ranks],
        "chunks_run": [r["chunks_run"] for r in ranks],
    }
    res["identical_outputs"] = r0["tokens"] == single["tokens"]
    if mesh_matched:
        res["matched_identical"] = all(r["matched_tokens"] == r["tokens"] for r in ranks)
    res["pool_split"] = all(r["pool_bytes"] * mp == single["pool_bytes"] for r in ranks)
    res["wire_flat"] = all(len(r["wire_per_step"]) == 1
                           and r["wire_per_step"][0] == r["wire_per_step_4x"]
                           for r in ranks)
    res["tokens_single"] = single["tokens"]
    res["tokens_sharded"] = r0["tokens"]
    res["ok"] = all([res["ranks_agree"], res["wire_flat"], res["pool_split"],
                     res["matched_identical"] if mesh_matched else res["identical_outputs"]])
    return res


def run_smoke(ws, *, dp: int = 2, mp: int = 2, device: str = "cuda", mesh_matched=False,
              timeout_s: float = JOIN_TIMEOUT_S, singles=None) -> list:
    """Each workload of ``ws`` (one or a list) on ``mesh=None`` here (unless
    ``singles`` holds those runs already) and on ``dp x mp`` spawned ranks,
    all in one spawn; :func:`verdicts` of each.  ``mesh_matched``: a bool
    for every workload, or one per workload."""
    ws = [ws] if isinstance(ws, Workload) else list(ws)
    matched = ([mesh_matched] * len(ws) if isinstance(mesh_matched, bool)
               else list(mesh_matched))
    if singles is None:
        singles = [run_single(w, device) for w in ws]
    ranks = spawn_ranks(serve_rank_jobs, (list(zip(ws, matched)),), dp=dp, mp=mp,
                        device=device, timeout_s=timeout_s)
    return [verdicts(w, single, [r[i] for r in ranks], dp=dp, mp=mp, device=device,
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
                 page_size=args.page_size)
    res = run_smoke(w, dp=dp, mp=mp, device=args.device, mesh_matched=args.mesh_matched)[0]
    print(f"{res['arch']} [{res['backend']}] on {res['device']}: mesh=None "
          f"{res['single_step_ms']} ms/step vs {res['mesh']} {res['sharded_step_ms']} ms/step; "
          f"pool {res['pool']}, rank pool bytes {res['pool_bytes_rank']} of "
          f"{res['pool_bytes_single']}; collective bytes per decode step "
          f"{res['wire_per_step']} (4x pool {res['wire_per_step_4x']}); "
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
