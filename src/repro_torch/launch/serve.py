"""Serving driver: FaaSKeeper queue/batcher front + PyTorch decode back end.

Requests enter through the paper's per-session FIFO queues, route into one
shared dispatch queue, and are served by the continuous-batching decode
scheduler over the paged KV pool or per-slot rings (``--kv-mode ring``;
slots re-admitted across sessions between decode steps), or by whole-batch
generation (``--mode shared`` / ``per-session``, and whatever the mode for
the audio and VLM families, which have no per-slot decode path; as in the
JAX package, that path passes no frames and no patches).  Runs the
``.reduced()`` config of ``--arch`` on ``--device`` (default ``cuda``).

``--offload`` turns on storage-backed preemption, ``--prefix-sharing``
copy-on-write prefix sharing and ``--park-sessions`` cross-request session
parking (paged mode only).  ``--spec-draft ARCH`` turns on draft-and-verify
speculative decoding with a seeded draft of ``ARCH`` (the target's own
model when it is ``--arch``), ``--spec-k`` drafts a round (paged, gather,
greedy).  ``--fleet N`` serves through an elastic fleet of N disposable
scheduler workers (paged, parked sessions and the index journal implied;
``--min-workers``, ``--max-workers``, ``--scale-to-zero``).  ``--mesh
DPxMP`` serves through the sharded scheduler on ``DP * MP`` spawned ranks
of a ``(data, model)`` mesh on ``--device`` (gloo; several ranks may share
one card); every rank serves the same submits, and rank 0 reports.  Under
``--mesh`` the paged pool and ``--kv-mode ring``, the SSM and MoE
families (each rank holding only its experts), ``--offload``,
``--prefix-sharing``, ``--park-sessions``, speculation and ``--fleet``
(every worker on the same mesh, each rank's workers sharing that rank's
blob store; the ranks' fleet and serving stats and worker events must
agree) are served.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \\
      --requests 12 --sessions 3 --batch-size 4 --prompt-len 16 [--device cpu] \\
      [--offload] [--prefix-sharing] [--park-sessions] [--spec-draft ARCH --spec-k K]
      [--fleet N [--min-workers M] [--max-workers N] [--scale-to-zero]] [--mesh DPxMP]
"""

from __future__ import annotations

import argparse
import functools
import time
from typing import List, Optional

import numpy as np
import torch

from .. import configs
from ..coord.serving_front import InferenceRequest, ServingFrontend
from ..core import PageBlobStore, SimCloud
from ..models import build_model
from ..serve.engine import make_decode_step, make_prefill
from ..serve.fleet import FleetController
from ..serve.scheduler import DecodeScheduler, supports_continuous


def _whole_batch_model_fn(model, max_new: int):
    decode = make_decode_step(model)

    def model_fn(prompts: List[np.ndarray]) -> List[np.ndarray]:
        toks = torch.as_tensor(np.stack(prompts), dtype=torch.int32).to(model.device)
        # cache sized prompt + decode budget: the ring never wraps
        tok, cache = make_prefill(model, seq_len=toks.shape[1] + max_new)(toks)
        outs = [tok]
        for _ in range(max_new - 1):
            tok, _, cache = decode(cache, tok[:, None])
            outs.append(tok)
        gen = torch.stack(outs, dim=1).cpu().numpy()
        return [gen[i] for i in range(gen.shape[0])]

    return model_fn


def validate_pool_sizing(*, batch_size: int, prompt_len: int, max_new: int,
                         page_size: int, kv_pages: Optional[int] = None,
                         prefill_chunk: Optional[int] = None,
                         offload: bool = False) -> int:
    """Fail fast, with the arithmetic spelled out, instead of letting an
    undersized pool stall the first admission mid-run.

    Without offload the pool must fit one max-size admission
    (``ceil((prompt_len + max_new - 1) / page_size)`` pages, reserved up
    front) plus one decode page for each other slot.  With ``offload`` the
    preemption policy turns pool pressure into bounded preempt/restore
    cycles, so the floor relaxes to the one hard requirement: the largest
    single admission must fit on its own.  Returns the minimum page count."""
    if page_size < 1:
        raise ValueError(f"--page-size must be >= 1, got {page_size}")
    if prefill_chunk is not None and prefill_chunk < 1:
        raise ValueError(f"--prefill-chunk must be >= 1, got {prefill_chunk}")
    admission_pages = -(-(prompt_len + max_new - 1) // page_size)
    min_pages = admission_pages if offload else admission_pages + (batch_size - 1)
    if kv_pages is not None and kv_pages < min_pages:
        if offload:
            raise ValueError(
                f"--kv-pages {kv_pages} cannot fit even one max-size "
                f"admission: a {prompt_len}-token prompt with {max_new} "
                f"decode tokens reserves "
                f"ceil(({prompt_len}+{max_new}-1)/{page_size}) = "
                f"{admission_pages} pages, and preempting every other slot "
                f"cannot make the pool larger than it is.")
        raise ValueError(
            f"--kv-pages {kv_pages} cannot fit one max-size admission plus "
            f"one active decode batch: a {prompt_len}-token prompt with "
            f"{max_new} decode tokens reserves "
            f"ceil(({prompt_len}+{max_new}-1)/{page_size}) = "
            f"{admission_pages} pages, and the other {batch_size - 1} slots "
            f"need one decode page each -> minimum {min_pages} pages "
            f"(or enable --offload, which turns pool pressure into bounded "
            f"preempt/restore cycles).")
    return min_pages


def build_frontend(cloud: SimCloud, cfg, model, *, mode: str, batch_size: int,
                   max_new: int, prompt_len: int, temperature: float = 0.0,
                   top_k: int = 0, seed: int = 0, kv_mode: str = "paged",
                   page_size: int = 16, prefill_chunk: Optional[int] = None,
                   kv_pages: Optional[int] = None, attn_backend: str = "gather",
                   offload: bool = False, preempt_policy: Optional[str] = None,
                   idle_preempt_steps: int = 0, prefix_sharing: bool = False,
                   park_sessions: bool = False, park_ttl_steps: int = 0,
                   draft_model=None, spec_k: int = 0,
                   fleet_size: int = 0, min_workers: int = 0,
                   scale_to_zero: bool = False, device="cuda", mesh=None) -> ServingFrontend:
    """Frontend for ``mode`` in {'continuous', 'shared', 'per-session'}.

    ``continuous`` serves through :class:`DecodeScheduler`: from the shared
    paged KV pool with chunked prefill (``kv_mode='paged'``; ``attn_backend``
    picks the gather path or the CUDA paged-attention kernel for S=1
    decode), or from per-slot rings with one prefill per admission
    (``kv_mode='ring'``; the pool sizing check does not apply).
    ``offload`` enables storage-backed preemption; ``prefix_sharing`` maps
    indexed prompt prefixes read-only with copy-on-write splits;
    ``park_sessions`` retains a completed session's KV across requests
    (``park_ttl_steps`` bounds the retention; paged mode only).
    ``draft_model`` with ``spec_k >= 1`` turns on speculative decoding.
    ``fleet_size`` > 0 serves through a :class:`FleetController` of that
    many worker schedulers over one shared blob store (paged, parked
    sessions and the index journal on; ``min_workers`` and
    ``scale_to_zero`` set its autoscaler).  ``mesh`` (a live DeviceMesh)
    serves through the sharded continuous scheduler (every fleet worker on
    that mesh).
    """
    if mode not in ("continuous", "shared", "per-session"):
        raise ValueError(f"unknown serving mode {mode!r}")
    if mesh is not None and (mode != "continuous" or not supports_continuous(cfg)):
        raise ValueError("--mesh needs the continuous scheduler")
    if fleet_size:
        if mode != "continuous" or not supports_continuous(cfg):
            raise ValueError("--fleet needs the continuous scheduler "
                             "(decoder-only families)")
        if kv_mode != "paged" or cfg.family == "ssm":
            raise ValueError("--fleet needs the paged KV pool "
                             "(parked journals are page blobs)")
        validate_pool_sizing(batch_size=batch_size, prompt_len=prompt_len,
                             max_new=max_new, page_size=page_size,
                             kv_pages=kv_pages, prefill_chunk=prefill_chunk,
                             offload=offload)
        store = PageBlobStore()     # the fleet's shared durable substrate
        workers = [DecodeScheduler(model, n_slots=batch_size,
                                   max_seq=prompt_len + max_new,
                                   temperature=temperature, top_k=top_k, seed=seed,
                                   kv_mode="paged", page_size=page_size,
                                   prefill_chunk=prefill_chunk, kv_pages=kv_pages,
                                   offload=offload, preempt_policy=preempt_policy,
                                   idle_preempt_steps=idle_preempt_steps,
                                   prefix_sharing=prefix_sharing,
                                   park_sessions=True,
                                   park_ttl_steps=park_ttl_steps,
                                   blob_store=store, index_journal=True,
                                   attn_backend=attn_backend, draft_model=draft_model,
                                   spec_k=spec_k, device=device, mesh=mesh)
                   for _ in range(fleet_size)]
        ctrl = FleetController(workers, min_workers=min_workers,
                               scale_to_zero=scale_to_zero)
        return ServingFrontend(cloud, fleet=ctrl, batch_size=batch_size)
    if mode == "continuous" and supports_continuous(cfg):
        if kv_mode == "paged":
            validate_pool_sizing(batch_size=batch_size, prompt_len=prompt_len,
                                 max_new=max_new, page_size=page_size,
                                 kv_pages=kv_pages, prefill_chunk=prefill_chunk,
                                 offload=offload)
        sched = DecodeScheduler(model, n_slots=batch_size,
                                max_seq=prompt_len + max_new,
                                temperature=temperature, top_k=top_k, seed=seed,
                                kv_mode=kv_mode, page_size=page_size,
                                prefill_chunk=prefill_chunk, kv_pages=kv_pages,
                                offload=offload, preempt_policy=preempt_policy,
                                idle_preempt_steps=idle_preempt_steps,
                                prefix_sharing=prefix_sharing,
                                park_sessions=park_sessions,
                                park_ttl_steps=park_ttl_steps,
                                attn_backend=attn_backend, draft_model=draft_model,
                                spec_k=spec_k, device=device, mesh=mesh)
        return ServingFrontend(cloud, scheduler=sched, batch_size=batch_size)
    if temperature or top_k:
        raise ValueError(
            "temperature/top-k sampling needs the continuous scheduler; the "
            f"{cfg.family!r}/{mode!r} whole-batch path decodes greedily")
    front_mode = "per-session" if mode == "per-session" else "shared"
    return ServingFrontend(cloud, _whole_batch_model_fn(model, max_new),
                           batch_size=batch_size, mode=front_mode)


def spawn_workload(cloud: SimCloud, frontend: ServingFrontend, *, vocab: int,
                   n_requests: int, sessions: int, prompt_len: int,
                   max_new: int, seed: int = 0) -> None:
    """Spawn the standard serving workload: requests round-robin across
    ``sessions`` concurrent clients, each session pipelining its requests
    over its own FIFO channel; the shared dispatch queue batches across
    their arrivals.  The caller runs the cloud."""
    rng = np.random.default_rng(seed)
    per_session = {}
    for i in range(n_requests):
        sess = f"s{i % sessions}"
        per_session.setdefault(sess, []).append(InferenceRequest(
            session=sess, request_id=f"r{i}",
            prompt=rng.integers(0, vocab, size=prompt_len).astype(np.int32),
            max_tokens=max_new))

    def session_driver(reqs):
        for req in reqs:
            yield from frontend.submit(req)
        return None

    for sess, reqs in per_session.items():
        cloud.spawn(session_driver(reqs), name=f"client:{sess}")


def run_serving(arch: str, n_requests: int = 12, *, max_new: int = 8,
                prompt_len: int = 16, sessions: int = 3, batch_size: int = 4,
                mode: str = "continuous", temperature: float = 0.0,
                top_k: int = 0, seed: int = 0, quiet: bool = False,
                kv_mode: str = "paged", page_size: int = 16,
                prefill_chunk: Optional[int] = None,
                kv_pages: Optional[int] = None, attn_backend: str = "gather",
                offload: bool = False, preempt_policy: Optional[str] = None,
                idle_preempt_steps: int = 0, prefix_sharing: bool = False,
                park_sessions: bool = False, park_ttl_steps: int = 0,
                spec_draft: Optional[str] = None, spec_k: int = 0,
                fleet: int = 0, min_workers: int = 0,
                max_workers: Optional[int] = None, scale_to_zero: bool = False,
                device="cuda", mesh=None) -> ServingFrontend:
    cfg = configs.get(arch).reduced()
    # on a mesh an MoE model holds only this rank's experts
    model = build_model(cfg, device=device, seed=0, mesh=mesh)
    draft_model = None
    if spec_draft is not None:
        # a self-draft reuses the target's module and weights; any other
        # arch is a reduced draft drawn from the same seed
        draft_model = (model if spec_draft == arch else
                       build_model(configs.get(spec_draft).reduced(), device=device, seed=0,
                                   mesh=mesh))
        spec_k = spec_k or 3
    cloud = SimCloud(seed=seed)
    frontend = build_frontend(cloud, cfg, model, mode=mode, batch_size=batch_size,
                              max_new=max_new, prompt_len=prompt_len,
                              temperature=temperature, top_k=top_k, seed=seed,
                              kv_mode=kv_mode, page_size=page_size,
                              prefill_chunk=prefill_chunk, kv_pages=kv_pages,
                              attn_backend=attn_backend, offload=offload,
                              preempt_policy=preempt_policy,
                              idle_preempt_steps=idle_preempt_steps,
                              prefix_sharing=prefix_sharing,
                              park_sessions=park_sessions,
                              park_ttl_steps=park_ttl_steps, draft_model=draft_model,
                              spec_k=spec_k,
                              fleet_size=(max_workers or fleet) if fleet else 0,
                              min_workers=min_workers, scale_to_zero=scale_to_zero,
                              device=device, mesh=mesh)
    t0 = time.time()
    spawn_workload(cloud, frontend, vocab=cfg.vocab, n_requests=n_requests,
                   sessions=sessions, prompt_len=prompt_len, max_new=max_new)
    cloud.run()
    served = sum(len(v) for v in frontend.completions.values())
    if not quiet:
        where = "" if mesh is None else \
            f" (mesh {'x'.join(str(n) for n in mesh.shape)} of {mesh.size()} ranks)"
        print(f"served {served}/{n_requests} requests in {time.time()-t0:.1f}s wall "
              f"({cloud.now:.3f}s simulated) on {device}{where}")
        for sess, ids in sorted(frontend.completions.items()):
            print(f"  session {sess}: completions in order {ids}")
        s = frontend.serving_stats()
        inv = s["invocations"]
        print(f"function invocations: {inv} "
              f"(batching {served}/{inv} = {served/inv if inv else 0.0:.1f} "
              f"req/invoke); cost ${s['cost_usd']:.6f}; dropped {s['dropped']} "
              f"(dead-letter {frontend.dead_letter_ids()})")
        if frontend.fleet is not None:
            print(f"fleet: {s['spawns']} spawns / {s['retires']} retires "
                  f"({s['cold_starts_from_zero']} from zero), "
                  f"{s['workers_live']}/{s['workers_max']} live at exit, "
                  f"{s['meta_puts']} park-metas committed / "
                  f"{s['meta_adoptions']} adopted, "
                  f"{s['index_journal_puts']} index blobs journaled / "
                  f"{s['index_adopted']} re-adopted")
            print(f"fleet billing: {s['worker_invocations']} worker "
                  f"invocations (${s['worker_cost_usd']:.6f}), storage "
                  f"${s['offload_storage_usd']:.6f} ops + "
                  f"${s['park_storage_usd']:.9f} retention")
        if frontend.scheduler is not None:
            print(f"decode scheduler: occupancy {s['occupancy']:.2f} "
                  f"slots/step over {s['steps']} steps, "
                  f"{s['decode_tokens']} decode + {s['prefill_tokens']} "
                  f"prefill tokens, attn_backend {s['attn_backend']}")
            if s["kv_mode"] == "paged":
                print(f"kv pool: {s['kv_pages_high_water']}/{s['kv_pages']} "
                      f"pages high-water ({s['kv_high_water_bytes']/1024:.1f} "
                      f"of {s['kv_pool_bytes']/1024:.1f} KiB), "
                      f"{s['prefill_chunks']} prefill chunks")
            else:
                print(f"kv rings: {s['kv_pool_bytes']/1024:.1f} KiB "
                      f"({s['kv_bytes_per_token']} B/token), one prefill per admission")
            if "offload_bytes" in s:
                print(f"kv offload: {s['preemptions']} preemptions / "
                      f"{s['restores']} restores, "
                      f"{s['offload_bytes']/1024:.1f} KiB offloaded + "
                      f"{s['restore_bytes']/1024:.1f} KiB restored "
                      f"({s['offload_puts']} puts / {s['offload_gets']} gets, "
                      f"storage ${s['offload_storage_usd']:.6f})")
            if "spec_rounds" in s:
                print(f"speculation: k={s['spec_k']}, {s['spec_rounds']} "
                      f"rounds, acceptance {s['spec_acceptance_rate']:.2f}, "
                      f"{s['spec_steps_per_token']:.2f} steps/token "
                      f"({s['spec_emitted']} tokens emitted)")
            if "shared_prefix_tokens" in s:
                print(f"prefix sharing: {s['shared_prefix_tokens']} prompt "
                      f"tokens served from resident pages "
                      f"({s['park_hits']} park hits / {s['index_hits']} index "
                      f"hits, {s['cow_splits']} CoW splits, "
                      f"{s['parked_sessions']} sessions parked, retention "
                      f"${s['park_storage_usd']:.9f})")
    return frontend


def parse_mesh(spec: Optional[str]):
    """``"2x4"`` -> ``(dp, mp)``; None passes through."""
    if spec is None:
        return None
    try:
        dp, mp = (int(p) for p in spec.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh wants DPxMP (e.g. 2x4), got {spec!r}")
    if dp < 1 or mp < 1:
        raise SystemExit(f"--mesh {spec}: both sizes must be >= 1")
    return dp, mp


def _serve_rank(mesh, arch: str, n_requests: int, kw: dict) -> dict:
    """One rank of ``--mesh``: the same run on every rank, rank 0 reports;
    a fleet's serving and fleet stats, worker events and adoptions must
    agree on every rank (an all-reduced digest)."""
    import torch.distributed as dist

    from ..serve.scheduler import ranks_agree
    from .sharded_smoke import fleet_record

    front = run_serving(arch, n_requests, quiet=dist.get_rank() != 0, mesh=mesh, **kw)
    if front.fleet is not None and not ranks_agree(
            {"serving": front.serving_stats(), **fleet_record(front.fleet)}):
        raise RuntimeError("the ranks' fleets disagree (stats, worker events or adoptions)")
    return {sess: list(ids) for sess, ids in front.completions.items()}


def run_serving_mesh(arch: str, n_requests: int, *, dp: int, mp: int, device="cuda",
                     **kw) -> list:
    """:func:`run_serving` on ``dp * mp`` spawned ranks of a ``(dp, mp)``
    mesh; every rank must complete the same requests in the same order.
    Returns each rank's completions by session."""
    from .sharded_smoke import spawn_ranks

    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--mesh on --device cuda: no CUDA device")
    out = spawn_ranks(_serve_rank, (arch, n_requests, dict(kw, device=device)),
                      dp=dp, mp=mp, device=device)
    if any(o != out[0] for o in out):
        raise RuntimeError(f"the ranks' completions differ: {out}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.list_archs())
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--sessions", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=4,
                    help="dispatch batch width == decode slots")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--mode", default="continuous",
                    choices=["continuous", "shared", "per-session"])
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--kv-mode", default="paged", choices=["paged", "ring"],
                    help="paged-block KV pool (default) or per-slot rings")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV pool page")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="admission chunk size in tokens (default: whole prompt)")
    ap.add_argument("--kv-pages", type=int, default=None,
                    help="pool size in pages (default: slots x max_pages)")
    ap.add_argument("--offload", action="store_true",
                    help="storage-backed preemption: evict a victim slot's "
                         "KV pages to the object store under pool pressure "
                         "and restore them chunked (paged mode only)")
    ap.add_argument("--preempt-policy", default=None, choices=["none", "pressure"],
                    help="victim policy (default: pressure when --offload)")
    ap.add_argument("--idle-preempt-steps", type=int, default=0,
                    help="minimum steps a slot must be resident before it "
                         "is preemptible (anti-thrash floor)")
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="map indexed prompt prefixes read-only from the "
                         "refcounted page pool and prefill only the tail "
                         "(copy-on-write on shared-page writes; paged only)")
    ap.add_argument("--park-sessions", action="store_true",
                    help="retain a completed session's KV pages across "
                         "requests so its next request restores instead of "
                         "re-prefilling (paged only)")
    ap.add_argument("--park-ttl-steps", type=int, default=0,
                    help="drop a parked session after this many scheduler "
                         "steps (0 = retain until evicted or reset)")
    ap.add_argument("--attn-backend", default="gather",
                    choices=["gather", "paged_kernel"],
                    help="decode attention over the paged pool: gather the "
                         "slot's pages (reference) or stream them through "
                         "the CUDA paged-attention kernel")
    ap.add_argument("--spec-draft", default=None, choices=configs.list_archs(),
                    help="draft arch for draft-and-verify speculative decoding "
                         "(same arch = self-draft; greedy + paged + gather "
                         "backend only; the output stays the non-speculative "
                         "stream)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="draft tokens proposed per verify round (default 3 "
                         "when --spec-draft is set)")
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="serve with an elastic fleet of N disposable "
                         "scheduler workers behind the shared dispatch "
                         "queue (paged + parked sessions implied); 0 = one "
                         "resident scheduler (default)")
    ap.add_argument("--min-workers", type=int, default=0,
                    help="always-warm worker floor the autoscaler holds")
    ap.add_argument("--max-workers", type=int, default=None,
                    help="worker ceiling (default: the --fleet count)")
    ap.add_argument("--scale-to-zero", action="store_true",
                    help="let the fleet drain-and-park every worker when "
                         "idle; the next burst cold-starts from the blob "
                         "store (parked journals + index blobs)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; nothing "
                         "falls back to the CPU)")
    ap.add_argument("--mesh", default=None, metavar="DPxMP",
                    help="serve sharded on DP*MP spawned ranks of a (data, model) "
                         "mesh (gloo; ranks may share one card)")
    args = ap.parse_args()
    mesh = parse_mesh(args.mesh)
    serve = run_serving
    if mesh is not None:
        serve = functools.partial(run_serving_mesh, dp=mesh[0], mp=mesh[1])
    serve(args.arch, args.requests, max_new=args.max_new,
                sessions=args.sessions, batch_size=args.batch_size,
                prompt_len=args.prompt_len, mode=args.mode,
                temperature=args.temperature, top_k=args.top_k,
                kv_mode=args.kv_mode, page_size=args.page_size,
                prefill_chunk=args.prefill_chunk, kv_pages=args.kv_pages,
                offload=args.offload, preempt_policy=args.preempt_policy,
                idle_preempt_steps=args.idle_preempt_steps,
                prefix_sharing=args.prefix_sharing, park_sessions=args.park_sessions,
                park_ttl_steps=args.park_ttl_steps,
                attn_backend=args.attn_backend, spec_draft=args.spec_draft,
                spec_k=args.spec_k, fleet=args.fleet, min_workers=args.min_workers,
                max_workers=args.max_workers, scale_to_zero=args.scale_to_zero,
                device=args.device)


if __name__ == "__main__":
    main()
