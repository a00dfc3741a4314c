"""Serving driver: FaaSKeeper queue/batcher front + PyTorch decode back end.

Requests enter through the paper's per-session FIFO queues, route into one
shared dispatch queue, and are served by the continuous-batching decode
scheduler over the paged KV pool or per-slot rings (``--kv-mode ring``;
slots re-admitted across sessions between decode steps), or by whole-batch
generation (``--mode shared`` / ``per-session``).  Runs the ``.reduced()``
config of ``--arch`` on ``--device`` (default ``cuda``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \\
      --requests 12 --sessions 3 --batch-size 4 --prompt-len 16 [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from .. import configs
from ..coord.serving_front import InferenceRequest, ServingFrontend
from ..core import SimCloud
from ..models import build_model
from ..serve.engine import make_decode_step, make_prefill
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
                         prefill_chunk: Optional[int] = None) -> int:
    """Fail fast, with the arithmetic spelled out, instead of letting an
    undersized pool stall the first admission mid-run: the pool must fit
    one max-size admission (``ceil((prompt_len + max_new - 1) /
    page_size)`` pages, reserved up front) plus one decode page for each
    other slot.  Returns the minimum page count."""
    if page_size < 1:
        raise ValueError(f"--page-size must be >= 1, got {page_size}")
    if prefill_chunk is not None and prefill_chunk < 1:
        raise ValueError(f"--prefill-chunk must be >= 1, got {prefill_chunk}")
    admission_pages = -(-(prompt_len + max_new - 1) // page_size)
    min_pages = admission_pages + (batch_size - 1)
    if kv_pages is not None and kv_pages < min_pages:
        raise ValueError(
            f"--kv-pages {kv_pages} cannot fit one max-size admission plus "
            f"one active decode batch: a {prompt_len}-token prompt with "
            f"{max_new} decode tokens reserves "
            f"ceil(({prompt_len}+{max_new}-1)/{page_size}) = "
            f"{admission_pages} pages, and the other {batch_size - 1} slots "
            f"need one decode page each -> minimum {min_pages} pages.")
    return min_pages


def build_frontend(cloud: SimCloud, cfg, model, *, mode: str, batch_size: int,
                   max_new: int, prompt_len: int, temperature: float = 0.0,
                   top_k: int = 0, seed: int = 0, kv_mode: str = "paged",
                   page_size: int = 16, prefill_chunk: Optional[int] = None,
                   kv_pages: Optional[int] = None, attn_backend: str = "gather",
                   device="cuda") -> ServingFrontend:
    """Frontend for ``mode`` in {'continuous', 'shared', 'per-session'}.

    ``continuous`` serves through :class:`DecodeScheduler`: from the shared
    paged KV pool with chunked prefill (``kv_mode='paged'``; ``attn_backend``
    picks the gather path or the CUDA paged-attention kernel for S=1
    decode), or from per-slot rings with one prefill per admission
    (``kv_mode='ring'``; the pool sizing check does not apply).
    """
    if mode not in ("continuous", "shared", "per-session"):
        raise ValueError(f"unknown serving mode {mode!r}")
    if mode == "continuous" and supports_continuous(cfg):
        if kv_mode == "paged":
            validate_pool_sizing(batch_size=batch_size, prompt_len=prompt_len,
                                 max_new=max_new, page_size=page_size,
                                 kv_pages=kv_pages, prefill_chunk=prefill_chunk)
        sched = DecodeScheduler(model, n_slots=batch_size,
                                max_seq=prompt_len + max_new,
                                temperature=temperature, top_k=top_k, seed=seed,
                                kv_mode=kv_mode, page_size=page_size,
                                prefill_chunk=prefill_chunk, kv_pages=kv_pages,
                                attn_backend=attn_backend, device=device)
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
                device="cuda") -> ServingFrontend:
    cfg = configs.get(arch).reduced()
    model = build_model(cfg, device=device, seed=0)
    cloud = SimCloud(seed=seed)
    frontend = build_frontend(cloud, cfg, model, mode=mode, batch_size=batch_size,
                              max_new=max_new, prompt_len=prompt_len,
                              temperature=temperature, top_k=top_k, seed=seed,
                              kv_mode=kv_mode, page_size=page_size,
                              prefill_chunk=prefill_chunk, kv_pages=kv_pages,
                              attn_backend=attn_backend, device=device)
    t0 = time.time()
    spawn_workload(cloud, frontend, vocab=cfg.vocab, n_requests=n_requests,
                   sessions=sessions, prompt_len=prompt_len, max_new=max_new)
    cloud.run()
    served = sum(len(v) for v in frontend.completions.values())
    if not quiet:
        print(f"served {served}/{n_requests} requests in {time.time()-t0:.1f}s wall "
              f"({cloud.now:.3f}s simulated) on {device}")
        for sess, ids in sorted(frontend.completions.items()):
            print(f"  session {sess}: completions in order {ids}")
        s = frontend.serving_stats()
        inv = s["invocations"]
        print(f"function invocations: {inv} "
              f"(batching {served}/{inv} = {served/inv if inv else 0.0:.1f} "
              f"req/invoke); cost ${s['cost_usd']:.6f}; dropped {s['dropped']} "
              f"(dead-letter {frontend.dead_letter_ids()})")
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
    return frontend


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
    ap.add_argument("--attn-backend", default="gather",
                    choices=["gather", "paged_kernel"],
                    help="decode attention over the paged pool: gather the "
                         "slot's pages (reference) or stream them through "
                         "the CUDA paged-attention kernel")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; nothing "
                         "falls back to the CPU)")
    args = ap.parse_args()
    run_serving(args.arch, args.requests, max_new=args.max_new,
                sessions=args.sessions, batch_size=args.batch_size,
                prompt_len=args.prompt_len, mode=args.mode,
                temperature=args.temperature, top_k=args.top_k,
                kv_mode=args.kv_mode, page_size=args.page_size,
                prefill_chunk=args.prefill_chunk, kv_pages=args.kv_pages,
                attn_backend=args.attn_backend, device=args.device)


if __name__ == "__main__":
    main()
