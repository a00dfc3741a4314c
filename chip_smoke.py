#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU (written for an H100).

Phases, each of which must pass (any failed check exits non-zero before the
last line is printed):

1. Card name and power limit (``nvidia-smi``); build every CUDA source of
   ``src/repro_torch/kernels/csrc`` with ``nvcc`` for sm_90a, one process
   per source, all started together.
2. Kernel vs its plain PyTorch version on the card, both in the working
   type (fp32 tolerance 2e-4, bf16 3e-2 — the JAX kernel tests' tolerances):
   GQA groups 1/5/8, head dims 8/64/128, holes and scrambled tables, a fully
   unmapped slot, a window, append and post-update modes, lane_base and
   pos_stride off their defaults, a page wider than the kernel's tile, and
   minicpm-2b's decode shape (B 8, 36 kv heads, 34 pages, one split).  At
   the serving shape the kernel, the plain version and a library yardstick
   (page gather + ``scaled_dot_product_attention``) are timed with CUDA
   events, each launch on another layer's pages so every launch reads cold
   K/V, as decode does; there the kernel is held to its plain version
   within 1e-5 of max |o| (both fp32 math on the same bf16 values).
3. Full-width, full-depth ``minicpm-2b`` (random weights from ``--seed``)
   served through ``ServingFrontend`` -> ``DecodeScheduler(attn_backend=
   'paged_kernel')`` on the simulated cloud: 16 requests over 4 sessions,
   prompt 512, 32 new tokens, 8 slots, page size 16, prefill chunk 256.
   Checks: every request served, per-session FIFO order, tokens below the
   vocab, ``audit()``, and 40 kernel launches per decode step.
4. Backend agreement at full width: on one shared cache state (8 slots
   prefilled through a gather scheduler), one decode step with
   ``paged_kernel`` and one with ``gather``; logits must agree within 5% of
   the logits' largest magnitude (bf16 activations through 40 layers; the
   two paths differ only in whether attention probabilities are rounded to
   bf16 before the PV product).
5. RG-LRU scan kernel vs its plain left fold on the card: fp32 and bf16;
   B 1/2/8; L 1/16/17/29/33/100/256/2048; W 8/10/24/2560 (L < 32 and W =
   10 take the direct kernel, the rest the staged one, as
   ``launches_by_kernel`` counts; L = 100 ends inside a stage); a
   near-one decay (a = 0.999, L = 2048) and a = 0 resets.  fp32 must be
   bitwise the plain fold, bf16 within 3e-2.  The paged kernel at recurrentgemma's shape
   (D = 256, G = 10, Hkv = 1), with and without a window, in append and
   post-update modes, and over page splits merged in the launch: contexts
   past the 2048-token window at B = 1 and B = 8, scrambled tables with
   holes, splits with no live lane (a 3-token slot, an unmapped slot) and
   ``lane_base``/``pos_stride`` off their defaults (fp32 2e-4, bf16 3e-2).
6. Full-width, full-depth ``recurrentgemma-2b`` (26 layers ``rra``: 18
   RG-LRU, 8 local attention; random weights from ``--seed``) served through
   ``ServingFrontend`` -> ``DecodeScheduler(attn_backend='paged_kernel')``:
   8 requests over 8 sessions, prompt 2300, 16 new tokens, 8 slots, page
   16, prefill chunk 256 (the last chunk is 252 tokens; decode runs past the
   2048-token window).  Checks as in phase 3, and exact launch counts:
   paged kernel = 8 x decode steps, RG-LRU = 18 x (decode steps + chunks),
   18 x chunks of them on the staged kernel.
7. Both kernels timed with CUDA events at recurrentgemma-2b's serving
   shapes, each against its bound: the scan at (1, 256, 2560) (one prefill
   chunk), (8, 1, 2560) (one decode step) and (1, 2048, 2560); paged
   attention at B = 8, D = 256, G = 10, 145 pages per slot, window 2048
   (33 page splits, as the wrapper reports them), beside page gather +
   ``scaled_dot_product_attention``; kernel vs plain within 1e-5 of max |o|
   as in phase 2.
8. Backend agreement at full width for the hybrid, as in phase 4; its
   traced 256-token chunk (device busy time, peak memory above what the
   model and cache hold) must show no ``aten::clone`` of the RG-LRU gate
   weights broadcast over tokens.
9. Decode vs chunk prefill on the card, one slot at full width: the RG-LRU
   recurrence (the scan kernel with ``h0`` folded in, and the conv tail)
   run as N S=1 steps leaves, bitwise, the rows one N-token chunk leaves,
   on every RG-LRU layer's gates for a real token stream.  The same
   comparison through the whole model (every projection included) is
   printed: its matmuls run through cuBLAS, whose kernel for M = 1 rows may
   differ from the one for M = N.

10. SSD scan kernel vs its plain chunked form on the card: fp32 and bf16;
    B 1/2/3/8; L 1/8/37/130/200/252/256/300/2048; H 3-64; P 4/32/48/64; N
    8/64/128/256; zero and nonzero ``h0``; rows with dt = 0; |A dt| up to
    ~100.  Every case launches once, on the route ``route()`` names (the
    library's ``ssd_scan_route``: bf16 at P % 16 == 0 and N 64/128/256 on
    the tensor cores, the rest on the CUDA cores).  fp32 ``y`` and final
    state per element within 1e-4 of the plain version (the JAX
    kernel-vs-model tolerance); at |A dt| ~ 100 ``y`` per element within
    ``ssd_scan/ref.py::fp32_rounding_bound`` of the plain version in
    float64 instead, with the kernel's and the fp32 plain version's
    distance from 1e-4 of float64 printed.  bf16 ``y`` and state per
    element within ``ssd_scan/ref.py::bf16_rounding_bound`` of the fp32
    plain version (with the hi + lo split terms on the tensor-core chunk
    kernel only).  Each bound, on the row of the token whose input moves
    that row the most, must lie below the move.
11. Full-width, full-depth ``mamba2-1.3b`` (48 layers, d_model 2048, 64 SSD
    heads of 64, d_state 128; random weights from ``--seed``) served
    through ``ServingFrontend`` -> ``DecodeScheduler(kv_mode='paged')``
    (gather backend: there is no attention): 8 requests over 8 sessions,
    prompt 2300 (9 chunks of 256, the last 252), 32 new tokens, 8 slots.
    Checks as in phase 3, no pool pages, and SSD launches exactly 48 x
    (decode steps + chunks), every one on the tensor-core route.
12. The SSD kernel timed with CUDA events at (1, 256, 64, 64, 128) (one
    prefill chunk), (8, 1, 64, 64, 128) (one decode step) and
    (1, 2048, 64, 64, 128), each against its plain version and its bound
    (operations at the route's rate: 989 TFLOP/s bf16 on the tensor cores),
    each held to the bf16 bound as in phase 10.  The timed launches rotate
    over input sets moving 400 MB (12 sets of the decode step's 16.8 MB
    state) and keep every launch's outputs until the timing ends, so no
    launch reads a state or writes into lines an earlier one left in the
    50 MB L2.
13. The SSM decode step's costs outside the kernel (``mask_slot_rows``
    over the 768 MiB of SSD state of 8 slots, the per-layer
    ``torch.stack``), and one decode step and one prefill chunk traced.
14. Decode vs chunk prefill of one SSM slot at full width: the kernel on
    every layer's inputs, one N-token launch vs N one-token launches
    carrying the state (bf16: each within the bound of phase 10, the chunk
    with the split terms, the steps on the decode kernel without, and each
    bound below the one-token effect as there; fp32: within 1e-4 of each
    other), and the whole model (logits and rows within 5% of their
    scale); the max |delta| printed.
15. Flash-attention kernel vs its plain version on the card (fp32 2e-4,
    bf16 3e-2): head dims 8/16/64/128/256, GQA groups 1/2/5/10, S = T,
    S < T and S > T under a window (rows that see no key take the mean of
    v), T not a multiple of the tile, windows 8 and 2048, B 1 and 2, kv rows
    past ``t_real``, one non-causal case; an unsupported call raises.  bf16
    cases at D 64/128/256 (and 48/80/192, known only at run time) that
    cross several q tiles and kv stages, with ``t_real < T`` and windows,
    must take the tensor-core route.
16. The flash kernel timed with CUDA events against its plain version,
    ``scaled_dot_product_attention`` as the library yardstick, and its
    bound, at the prefills of qwen3-14b (1, 4096, 40, 8, 128; causal),
    minicpm-2b (1, 4096, 36, 36, 64) and recurrentgemma-2b's local
    attention (1, 4200, 10, 1, 256; window 2048), bf16.  The bf16 kernel is
    also held against the fp32 plain version on the same bf16 values, per
    element within 1e-5 + 2^-8 (|o| + sum p|v| / l) (its two bf16
    roundings: P before P.V and o at the store), and that bound on the
    last row must lie below the change that leaving out one 64-key tile
    makes there.
17. Full-width, full-depth ``qwen3-14b`` (40 layers, d_model 5120, 40 query
    heads of 128 over 8 kv heads, qk-norm; random weights from ``--seed``)
    served through ``ServingFrontend`` -> ``DecodeScheduler(kv_mode=
    'ring')``: 8 requests over 8 sessions, prompt 4096, 32 new tokens,
    greedy, 8 slots, ``max_seq`` 4128 (5.41 GB of rings).  Checks as in
    phase 3, flash launches exactly 40 x admissions (every admission is a
    4096-token from-scratch prefill), all on the tensor-core route, no
    paged, RG-LRU or SSD launch; one
    prefill and one decode step traced.  The earlier models are freed first.
18. In-situ agreement at full width: on one 4096-token prompt, qwen3-14b's
    last-position logits from the ring prefill (flash) and from paged
    chunked prefill (chunks of 256 through ``sdpa``) agree within 5% of the
    logits' largest magnitude.
19. ``recurrentgemma-2b`` in ring mode on phase 6's model (so it runs right
    after phase 9): 4 requests over 4 sessions, prompt 4200 (past the
    2048-token window, so every local-attention layer's prefill runs the
    windowed flash kernel at D = 256), 16 new tokens.  Exact launch counts:
    flash = 8 x admissions (all on the tensor cores), RG-LRU = 18 x
    (admissions + decode steps), 18 x admissions of them staged; the peak
    device memory is printed (the 4200-token prefills' gates run as one
    batched product per block).

20. CUDA graphs vs the eager step at full width, on minicpm-2b
    (``paged_kernel`` and ``gather``), recurrentgemma-2b (``paged_kernel``),
    mamba2-1.3b and qwen3-14b rings, each greedy and with temperature 0.8 /
    top-k 50: 8 slots decoding after a 300-token prompt (one graphed chunk
    of 256, an eager tail of 44), slots 1, 4 and 7 masked out, then from
    one copied state 8 replays of the decode graph and 8 eager
    ``_step_impl`` steps with the generator restored between; every cache
    leaf (lengths, recurrent rows, the whole pool or every ring), the token
    buffers and the output rings must agree bitwise, and the masked slots'
    lengths and output rings must not move.  In paged mode the 256-token
    chunk graph at slot 3 (its length set back to 0, so the chunk writes
    into the pages its table maps) against the eager chunk, the logits and
    the token drawn from them bitwise, as every leaf.  Runs after phase 4
    (minicpm), 9 (hybrid), 14 (mamba2) and 18 (qwen3-14b).

21. The grouped expert kernel (``kernels/csrc/moe_experts.cu``, two
    launches per layer through ``expert_ffn``: gate/up with the SwiGLU
    epilogue, then down; the shared expert rides in both as a second group)
    against its plain version (a ``torch.matmul`` per expert), within 3e-2
    of the output's largest magnitude: P from 1 to 24576 pairs, E 4/64/128,
    k 1/2/6/8, (D, F) (64, 32), (2048, 1408) and (4096, 1536), empty experts,
    every pair on one expert, segments that are not a multiple of the
    tile, segments long enough for the 128-row tile; each case's two
    launches counted on the route of the library's own plan
    (``moe_experts_plan``: ``wgmma`` on 64- or 128-row tiles), and that
    plan (tile rows, ring stages, shared memory, grid) equal to the model in
    ``kernels/moe_experts/plan.py``.  Row
    invariance at both tile shapes: rows of the 1536-row call (64-row
    tiles) and of the 24576-row call (128-row tiles) alone (1-row calls on
    64-row tiles), with their shared rows, bitwise the same rows inside
    them.  One launch captured in a CUDA graph: its replay bitwise the
    eager launch.  The ``ptxas`` report of the kernel's six instances is
    printed, and fails on a wgmma that ``ptxas`` serialised (C7515, C7517,
    C7518); the work items per SM at each timed shape (``plan.py``'s item
    map over the offsets) are printed.  The
    router kernel against the fp64 product within 1e-5 of the largest
    logit, a row alone bitwise the same row in the call.  Timed at
    moonshot's P = 48 (decode, 8 slots), 1536 (a 256-token chunk) and 24576
    (a 4096-token ring prefill), uniform routing (the experts hit counted),
    beside the plain version, ``torch._grouped_mm`` where this torch has
    it, and its bound; the router beside the fp32 matmul.  The paged kernel
    at moonshot's decode shape (B 8, 16 kv heads of 128, 2300..2331 live
    tokens, 8 layers' pools rotated) and flash at its ring prefill (1, 4096,
    16, 16, 128), causal, as in phases 2 and 16.
22. Full-width, full-depth ``moonshot-v1-16b-a3b`` (48 layers, d_model
    2048, 16 x 128 heads, 64 experts top-6 of width 1408 and a shared
    expert of 2816, vocab 163840; 28.9 B weights, 57.8 GB in bf16, random
    from ``--seed``), loaded after every earlier model is freed (free memory
    printed), served through ``ServingFrontend`` -> ``DecodeScheduler(
    attn_backend='paged_kernel')``: 8 requests over 8 sessions, prompt 2300
    in chunks of 256 (the last 252), 32 new, 8 slots, page 16.  Checks as
    in phase 3 and exact launch counts: paged = 48 x decode steps,
    moe_experts = 2 x 48 x (decode steps + chunks) (half of them gate/up),
    every one on the ``wgmma`` route with 64-row tiles, router = 48 x
    (decode steps + chunks), no flash.  Backend agreement as
    in phase 4 (traced steps), phase 20's replay checks, and one slot's
    29-token chunk vs 29 S=1 steps: every layer's MoE output on the same
    inputs bitwise (router, routing, both launches, shared expert,
    combine); the whole model printed, as phase 9 does.
23. The same model from per-slot rings: 4 requests over 4 sessions, prompt
    4096, 16 new, 4 slots.  flash = 48 x admissions, all on the tensor-core
    route; moe_experts = 2 x 48 x (admissions + decode steps), every
    launch on the ``wgmma`` route, each admission's on 128-row tiles and
    each decode step's on 64-row tiles; no paged,
    RG-LRU or SSD launch; peak memory printed.  Ring prefill vs paged
    chunked prefill logits within 5%, as in phase 18.

On the card the scheduler replays a CUDA graph for every decode step and
every 256-token chunk (``serve/graphs.py``), so phases 3, 6, 11, 17, 19, 22
and 23 serve on graphs; their exact launch counts are counted through replays
(each replay adds the launches its capture recorded).  Phases 4, 8, 13, 17
and 22 trace steps with ``torch.profiler`` (wall time with the profiler on,
device busy time, idle share, kernels the device ran, launch calls the
host made, and the heaviest kernels): each traces its scheduler's eager
decode step (and 256-token chunk) beside the replayed graph, times both
without the profiler, and prints the captures made, the seconds each took
and the graph pool's memory; phase 20 does the same for the
``paged_kernel`` schedulers.  No phase is cut in depth: every path runs at
its full depth and the whole script stays well inside its time limit.

Each serving phase sets the launch counts to 0 just before it drives the
path and reads them just after.  The line before the last is the kernels'
JSON record (one entry per timed shape), then the card's ``name,
power.limit``; the last line is the device JSON.

Usage:  python3 chip_smoke.py [--seed N]
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import copy
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 on the tensor cores
TOL = {"float32": 2e-4, "bfloat16": 3e-2}
# The paged kernel and its plain version at a serving shape: both compute in
# fp32 on the same bf16 values and return fp32, so they differ only in
# summation order; held to this share of the largest |o| (leaving out one
# 32-lane tile of ~500 keys moves o by ~0.02 of a max |o| below 1)
PAGED_SUM_REL = 1e-5
AGREE_REL_TOL = 0.05
DEVICE = "cuda"                  # the phases' device (a CPU rehearsal may set "cpu")

ARCH = "minicpm-2b"
N_REQUESTS, SESSIONS, PROMPT, MAX_NEW = 16, 4, 512, 32
SLOTS, PAGE, CHUNK = 8, 16, 256

HYBRID = "recurrentgemma-2b"
H_REQUESTS, H_SESSIONS, H_PROMPT, H_MAX_NEW = 8, 8, 2300, 16
PARITY_PREFIX, PARITY_TOKENS = 40, 29     # phases 9, 14: prefix chunk, then N tokens

SSM = "mamba2-1.3b"
S_REQUESTS, S_SESSIONS, S_PROMPT, S_MAX_NEW = 8, 8, 2300, 32

DENSE_RING = "qwen3-14b"
Q_REQUESTS, Q_SESSIONS, Q_PROMPT, Q_MAX_NEW = 8, 8, 4096, 32
R_REQUESTS, R_SESSIONS, R_PROMPT, R_MAX_NEW = 4, 4, 4200, 16     # phase 19

MOE = "moonshot-v1-16b-a3b"
M_REQUESTS, M_SESSIONS, M_PROMPT, M_MAX_NEW = 8, 8, 2300, 32      # phase 22, paged
MR_REQUESTS, MR_SESSIONS, MR_PROMPT, MR_MAX_NEW = 4, 4, 4096, 16  # phase 23, rings
M_PAGED_LAYERS = 8               # pools rotated when timing the paged kernel at moonshot


class Failures(list):
    def check(self, ok: bool, what: str) -> bool:
        print(f"  [{'ok' if ok else 'FAIL'}] {what}")
        if not ok:
            self.append(what)
        return ok


def sync() -> None:
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


def release() -> None:
    """Free what the last phase left: its schedulers, frontends and graphs
    hold reference cycles (a model among them), which only the cyclic
    collector frees, and then the allocator's cache."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 5) -> float:
    """Mean ms per call over ``iters`` calls, timed with CUDA events after
    ``warmup`` calls; ``fn(i)`` gets the iteration index."""
    import torch

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms_per_launch(fn, iters: int, kernel: str):
    """Device time per launch of the kernels whose name contains ``kernel``
    over ``iters`` calls of ``fn(i)``, from ``torch.profiler`` (None when
    the profiler records no device time).  Unlike the CUDA-event time of
    back-to-back calls, it leaves out the host's launch path."""
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        sync()
    averages = prof.key_averages()
    evs = [e for e in averages if kernel in e.key]
    count = sum(e.count for e in evs)
    if not count:
        seen = sorted({e.key[:60] for e in averages if e.self_device_time_total > 0})
        print(f"  profiler: no event named {kernel!r} over {iters} calls; "
              f"device events seen: {seen[:6]}")
    return sum(e.self_device_time_total for e in evs) / count / 1e3 if count else None


# -- phase 2: kernel vs plain version ------------------------------------------------


def paged_case(gen, *, B, Hkv, G, D, ps, mp, n_pages, dtype, holes=0, fill=0.8, min_len=1):
    """Random pool and scrambled per-slot tables with ragged lengths (from
    ``min_len``) and optional unmapped holes below the live length."""
    import numpy as np
    import torch

    rng = np.random.default_rng(int(torch.randint(0, 2**31, (1,), generator=gen)))

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
            device=DEVICE, dtype=dtype)

    q = rnd(B, 1, Hkv * G, D)
    kp, vp = rnd(n_pages, ps, Hkv, D), rnd(n_pages, ps, Hkv, D)
    k_new, v_new = rnd(B, 1, Hkv, D), rnd(B, 1, Hkv, D)
    lengths = rng.integers(min_len, max(min_len + 1, int(mp * ps * fill)), size=B)
    pt = np.full((B, mp), -1, np.int32)
    for b in range(B):
        need = -(-int(lengths[b]) // ps)
        pt[b, :need] = rng.choice(n_pages, size=need, replace=False)
        for _ in range(holes):
            pt[b, rng.integers(0, mp)] = -1
        # keep the newest live token's page mapped: post-update mode attends
        # that token, and a row with no live lane has no defined oracle
        last = (int(lengths[b]) - 1) // ps
        if pt[b, last] < 0:
            pt[b, last] = rng.choice(np.setdiff1d(np.arange(n_pages), pt[b]))
    as_dev = lambda a: torch.as_tensor(a, dtype=torch.int32).to(DEVICE)  # noqa: E731
    return q, kp, vp, as_dev(pt), as_dev(lengths), k_new, v_new


PAGED_CASES = [
    dict(B=3, Hkv=4, G=1, D=64, ps=16, mp=6, n_pages=32, holes=1),
    dict(B=2, Hkv=2, G=5, D=128, ps=8, mp=5, n_pages=24, window=12),
    dict(B=2, Hkv=3, G=8, D=64, ps=16, mp=4, n_pages=16, holes=2, post=True),
    dict(B=2, Hkv=2, G=8, D=128, ps=48, mp=3, n_pages=10, window=40),
    dict(B=3, Hkv=2, G=3, D=8, ps=4, mp=6, n_pages=20, holes=1),
    dict(B=2, Hkv=1, G=5, D=64, ps=8, mp=6, n_pages=16, unmapped=True),
    dict(B=3, Hkv=2, G=1, D=128, ps=8, mp=6, n_pages=24, lane_base=8, stride=16),
    # minicpm-2b's decode shape: 8 slots of 512..543 tokens over 34 pages, one split
    dict(B=8, Hkv=36, G=1, D=64, ps=16, mp=34, n_pages=300, fill=1.0, min_len=512),
]

# recurrentgemma-2b's local attention: MQA, 10 query heads of 256
PAGED_CASES_D256 = [
    dict(B=3, Hkv=1, G=10, D=256, ps=16, mp=12, n_pages=40),
    dict(B=3, Hkv=1, G=10, D=256, ps=16, mp=12, n_pages=40, post=True),
    dict(B=3, Hkv=1, G=10, D=256, ps=16, mp=12, n_pages=40, window=48, holes=1),
    dict(B=3, Hkv=1, G=10, D=256, ps=16, mp=12, n_pages=40, window=48, post=True),
    dict(B=2, Hkv=1, G=10, D=256, ps=8, mp=20, n_pages=48, window=100, post=True, holes=2),
    # contexts past the 2048-token window, split over pages (B=1 and B=8)
    dict(B=1, Hkv=1, G=10, D=256, ps=16, mp=145, n_pages=150, window=2048, post=True,
         fill=1.0, min_len=2100),
    dict(B=8, Hkv=1, G=10, D=256, ps=16, mp=145, n_pages=1200, window=2048, post=True,
         holes=3, fill=1.0, min_len=2100),
    dict(B=8, Hkv=1, G=10, D=256, ps=16, mp=145, n_pages=1200, window=2048, fill=1.0,
         min_len=2100),
    # a slot of 3 tokens (most of its splits hold no live lane) and an
    # unmapped slot (no split does)
    dict(B=3, Hkv=1, G=10, D=256, ps=16, mp=40, n_pages=130, window=100, unmapped=True,
         short=True),
    # lane_base / pos_stride off their defaults, with a window, over splits
    dict(B=2, Hkv=1, G=10, D=256, ps=8, mp=60, n_pages=130, window=200, lane_base=8,
         stride=16, post=True, holes=2),
]


def phase_kernel_cases(fails: Failures, seed: int, cases=PAGED_CASES) -> None:
    import torch

    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_kernel,
                                                     paged_attention_plain,
                                                     reference_paged_attention)

    gen = torch.Generator().manual_seed(seed)
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[str(dtype).split(".")[-1]]
        for c in cases:
            q, kp, vp, pt, lengths, k_new, v_new = paged_case(
                gen, B=c["B"], Hkv=c["Hkv"], G=c["G"], D=c["D"], ps=c["ps"],
                mp=c["mp"], n_pages=c["n_pages"], dtype=dtype, holes=c.get("holes", 0),
                fill=c.get("fill", 0.8), min_len=c.get("min_len", 1))
            if c.get("unmapped"):
                pt[1] = -1
                lengths[1] = 0
            if c.get("short"):
                lengths[0] = 3
            B, Hkv, G, D = c["B"], c["Hkv"], c["G"], c["D"]
            window = c.get("window")
            q_pos = lengths - 1 if c.get("post") else lengths
            qg = q.reshape(B, Hkv, G, D).contiguous()
            kw = dict(lane_base=c.get("lane_base", 0), pos_stride=c.get("stride"),
                      window=window)
            acc, m, l = paged_attention_kernel(qg, kp, vp, pt, lengths, q_pos, **kw)
            racc, rm, rl = paged_attention_plain(qg, kp, vp, pt, lengths, q_pos, **kw)
            sync()
            o = acc / l.clamp(min=1e-30)[..., None]
            ro = racc / rl.clamp(min=1e-30)[..., None]
            err = max((o - ro).abs().max().item(), (m - rm).abs().max().item(),
                      ((l - rl).abs() / rl.clamp(min=1.0)).max().item())
            name = ", ".join(f"{k}={v}" for k, v in c.items())
            name += f"; {paged_attention_kernel.last_splits} splits"
            fails.check(err <= tol and torch.isfinite(o).all().item(),
                        f"kernel vs plain {str(dtype)[6:]} [{name}]: max err {err:.3g} <= {tol}")
            if "lane_base" in c:
                continue
            # end to end through ops.py against the gather oracle
            post = c.get("post", False)
            out = paged_attention(q, kp, vp, pt, lengths, q_pos=q_pos, window=window,
                                  k_new=None if post else k_new,
                                  v_new=None if post else v_new)
            ref = reference_paged_attention(q, kp, vp, pt, lengths, q_pos=q_pos,
                                            window=window, k_new=None if post else k_new,
                                            v_new=None if post else v_new)
            err = (out.float() - ref.float()).abs().max().item()
            fails.check(err <= tol, f"ops.paged_attention vs gather oracle "
                        f"{str(dtype)[6:]} [{name}]: max err {err:.3g} <= {tol}")


def phase_kernel_timing(fails: Failures, cfg, seed: int, *, prompt: int = PROMPT,
                        max_new: int = MAX_NEW, layers=None) -> dict:
    """The kernel at the serving shape: B=8 slots of prompt..prompt+max_new-1
    live tokens, every slot's pages scrambled over the pool, one pool per
    layer for ``layers`` layers (default all; minicpm-2b's 40 hold 1.6 GB,
    moonshot's 8 rotated 1.2 GB, far past the 50 MB L2)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import (paged_attention_kernel,
                                                     paged_attention_plain)

    L, Hkv, D = layers or cfg.n_layers, cfg.n_kv_heads, cfg.the_head_dim()
    G = cfg.n_heads // Hkv
    mp = -(-(prompt + max_new) // PAGE)
    n_pages = SLOTS * mp
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kp = torch.randn(L, n_pages, PAGE, Hkv, D, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    vp = torch.randn_like(kp)
    qs = torch.randn(L, SLOTS, Hkv, G, D, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    pt_np = rng.permutation(n_pages).reshape(SLOTS, mp).astype(np.int32)
    len_np = rng.integers(prompt, prompt + max_new, size=SLOTS).astype(np.int32)
    pt = torch.as_tensor(pt_np).cuda()
    lengths = torch.as_tensor(len_np).cuda()

    def kernel(i):
        return paged_attention_kernel(qs[i % L], kp[i % L], vp[i % L], pt, lengths, lengths)

    def plain(i):
        return paged_attention_plain(qs[i % L], kp[i % L], vp[i % L], pt, lengths, lengths)

    T = mp * PAGE
    live = (torch.arange(T, device="cuda")[None] < lengths[:, None])[:, None, None, :]

    def library(i):
        k = kp[i % L][pt.long()].reshape(SLOTS, T, Hkv, D).transpose(1, 2)
        v = vp[i % L][pt.long()].reshape(SLOTS, T, Hkv, D).transpose(1, 2)
        return F.scaled_dot_product_attention(qs[i % L], k, v, attn_mask=live)

    acc, m, l = kernel(0)
    racc, rm, rl = plain(0)
    o = acc / l.clamp(min=1e-30)[..., None]
    ro = racc / rl.clamp(min=1e-30)[..., None]
    max_err = (o - ro).abs().max().item()
    scale = ro.abs().max().item()
    lib_err = (o - library(0).float()).abs().max().item()
    fails.check(max_err <= PAGED_SUM_REL * scale,
                f"kernel vs plain at the serving shape: max err {max_err:.3g} <= "
                f"{PAGED_SUM_REL} x max |o| {scale:.4g}")
    fails.check(lib_err <= TOL["bfloat16"],
                f"kernel vs gather+SDPA at the serving shape: max err {lib_err:.3g}")

    ms = cuda_time_ms(kernel, 400, warmup=40)
    plain_ms = cuda_time_ms(plain, 40)
    library_ms = cuda_time_ms(library, 40)
    ms_again = cuda_time_ms(kernel, 400, warmup=0)
    dev_ms = device_ms_per_launch(kernel, 40, "paged_attn_kernel")

    live_tokens = int(len_np.sum())
    elt = 2
    bytes_moved = (qs[0].numel() * elt                           # q
                   + 2 * live_tokens * Hkv * D * elt             # live K and V lanes
                   + sum(-(-int(n) // PAGE) for n in len_np) * 4  # page-table entries
                   + 2 * SLOTS * 4                               # lengths, q_pos
                   + SLOTS * Hkv * G * (D + 2) * 4)              # acc, m, l (fp32)
    flops = 4 * live_tokens * Hkv * G * D                        # QK and PV, 2 each
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    print(f"  serving shape: B={SLOTS} Hkv={Hkv} G={G} D={D} page={PAGE} "
          f"max_pages={mp} live tokens={live_tokens} layers rotated={L}")
    print(f"  kernel {ms:.4f} ms (again {ms_again:.4f}; device time per launch "
          f"{dev_ms} ms), plain {plain_ms:.4f} ms, gather+SDPA {library_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bytes_moved/1e6:.2f} MB, {flops/1e6:.2f} MFLOP)")
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention/kernel.py:99",
            "launches": None, "max_abs_err": max_err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


# -- phase 3: full-width serving ------------------------------------------------------


class TimedScheduler:
    """Times each ``step()`` of a scheduler, and each ``submit()`` (where a
    ring admission prefills), on the host clock, synchronized with the card;
    every other attribute passes through."""

    def __init__(self, sched):
        self.sched = sched
        self.chunk_s = self.decode_s = 0.0
        self.chunk_tokens = self.decode_only_tokens = 0
        self.decode_only_steps = 0

    def __getattr__(self, name):
        return getattr(self.sched, name)

    def submit(self, *args, **kw):
        s = self.sched
        pf0 = s.prefill_tokens
        sync()
        t0 = time.perf_counter()
        s.submit(*args, **kw)
        sync()
        if s.prefill_tokens > pf0:
            self.chunk_s += time.perf_counter() - t0
            self.chunk_tokens += s.prefill_tokens - pf0

    def step(self):
        s = self.sched
        pf0, dec0 = s.prefill_tokens, s.decode_tokens
        sync()
        t0 = time.perf_counter()
        out = s.step()
        sync()
        dt = time.perf_counter() - t0
        if s.prefill_tokens > pf0:
            self.chunk_s += dt
            self.chunk_tokens += s.prefill_tokens - pf0
        elif s.decode_tokens > dec0:
            self.decode_s += dt
            self.decode_only_tokens += s.decode_tokens - dec0
            self.decode_only_steps += 1
        return out


def phase_serving(fails: Failures, model, cfg, seed: int, *, n_requests=N_REQUESTS,
                  sessions=SESSIONS, prompt=PROMPT, max_new=MAX_NEW,
                  attn_backend="paged_kernel", kv_mode="paged", then=None,
                  slots=SLOTS) -> dict:
    """Serve the workload through ``ServingFrontend`` -> ``DecodeScheduler(
    attn_backend=..., kv_mode=...)`` and check what came out.  Every
    kernel's launch count is set to 0 just before the run and read just
    after; returns those counts with the scheduler's decode steps, chunks,
    admissions and pool pages.  ``then(scheduler)`` runs last (phase 17's
    traced steps)."""
    import numpy as np
    import torch

    from repro_torch.coord.serving_front import ServingFrontend
    from repro_torch.core import SimCloud
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.moe_experts import moe_experts_kernel, moe_router_kernel
    from repro_torch.kernels.paged_attention import paged_attention_kernel
    from repro_torch.kernels.rglru_scan import rglru_scan_kernel
    from repro_torch.kernels.ssd_scan import ssd_scan_kernel
    from repro_torch.launch.serve import spawn_workload
    from repro_torch.serve.scheduler import DecodeScheduler

    sched = DecodeScheduler(model, n_slots=slots, max_seq=prompt + max_new,
                            page_size=PAGE, prefill_chunk=CHUNK, kv_mode=kv_mode,
                            attn_backend=attn_backend, seed=seed, device=DEVICE)
    timed = TimedScheduler(sched)
    cloud = SimCloud(seed=seed)
    front = ServingFrontend(cloud, scheduler=timed, batch_size=slots)
    spawn_workload(cloud, front, vocab=cfg.vocab, n_requests=n_requests,
                   sessions=sessions, prompt_len=prompt, max_new=max_new, seed=seed)
    sync()
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    paged_attention_kernel.launches = 0
    rglru_scan_kernel.launches = 0
    rglru_scan_kernel.launches_by_kernel = dict.fromkeys(rglru_scan_kernel.launches_by_kernel, 0)
    ssd_scan_kernel.launches = 0
    ssd_scan_kernel.launches_by_route = dict.fromkeys(ssd_scan_kernel.launches_by_route, 0)
    flash_attention_kernel.launches = 0
    flash_attention_kernel.launches_by_route = dict.fromkeys(
        flash_attention_kernel.launches_by_route, 0)
    moe_experts_kernel.launches = 0
    moe_experts_kernel.launches_by_mode = dict.fromkeys(moe_experts_kernel.launches_by_mode, 0)
    moe_experts_kernel.launches_by_route = dict.fromkeys(moe_experts_kernel.launches_by_route, 0)
    moe_router_kernel.launches = 0
    t0 = time.perf_counter()
    cloud.run()
    sync()
    wall = time.perf_counter() - t0
    counts = {"paged_attention": paged_attention_kernel.launches,
              "rglru_scan": rglru_scan_kernel.launches,
              "rglru_staged": rglru_scan_kernel.launches_by_kernel["staged"],
              "ssd_scan": ssd_scan_kernel.launches,
              "ssd_tensor_core": ssd_scan_kernel.launches_by_route["tensor_core"],
              "flash_attention": flash_attention_kernel.launches,
              "flash_tensor_core": flash_attention_kernel.launches_by_route["tensor_core"],
              "moe_experts": moe_experts_kernel.launches,
              "moe_experts_swiglu": moe_experts_kernel.launches_by_mode["swiglu"],
              **{f"moe_experts_{r}": n for r, n in moe_experts_kernel.launches_by_route.items()},
              "moe_router": moe_router_kernel.launches,
              "steps": sched.steps, "chunks": sched.prefill_chunks,
              "admitted": sched.admitted, "pages": sched.allocator.n_pages}

    served = sum(len(v) for v in front.completions.values())
    fails.check(served == n_requests, f"served {served}/{n_requests} requests")
    fifo = all(ids == sorted(ids, key=lambda r: int(r[1:]))
               for ids in front.completions.values())
    fails.check(fifo and len(front.completions) == sessions,
                f"per-session FIFO over {len(front.completions)} sessions: "
                f"{dict(sorted(front.completions.items()))}")
    toks = [np.asarray(t) for outs in front.results.values() for t in outs]
    fails.check(all(t.shape == (max_new,) and (t >= 0).all() and (t < cfg.vocab).all()
                    for t in toks), f"every token in [0, {cfg.vocab}), {max_new} per request")
    try:
        sched.audit()
        fails.check(True, "scheduler audit")
    except AssertionError as e:
        fails.check(False, f"scheduler audit: {e}")
    st = front.serving_stats()
    print(f"  served in {wall:.3f} s wall: {sched.steps} decode steps, occupancy "
          f"{st['occupancy']} slots/step, {st['decode_tokens']} decode + "
          f"{st['prefill_tokens']} prefill tokens, {st['prefill_chunks']} chunks")
    print(f"  decode tok/s (steps without a chunk): "
          f"{timed.decode_only_tokens / max(timed.decode_s, 1e-9):.1f} "
          f"({timed.decode_only_tokens} tokens in {timed.decode_only_steps} steps, "
          f"{timed.decode_s:.3f} s, {1e3 * timed.decode_s / max(timed.decode_only_steps, 1):.2f} ms/step)")
    print(f"  prefill tok/s (calls that prefilled, their decode included): "
          f"{timed.chunk_tokens / max(timed.chunk_s, 1e-9):.1f} "
          f"({timed.chunk_tokens} tokens, {timed.chunk_s:.3f} s)")
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
    pool = (f"{st['kv_pages']} pages, high water {st['kv_pages_high_water']}"
            if kv_mode == "paged" else f"{slots} rings of {model.cache_len(prompt + max_new)}")
    print(f"  peak device memory {peak / 2**30:.3f} GiB; "
          f"KV {kv_mode} {st['kv_pool_bytes'] / 2**30:.3f} GiB "
          f"({st['kv_bytes_per_token']} B/token, {pool})")
    print(f"  kernel launches: {counts}")
    if then is not None:
        then(sched)
    return counts


# -- phase 4: backend agreement ---------------------------------------------------------


class RouteLog:
    """The experts every MoE layer picks, by layer and token, across the
    ``moe_ffn`` calls of a forward (one per layer, or one per layer and
    chunk).  ``record()`` keeps a run's picks; ``compare()`` counts the
    (token, layer) routes of another run that differ from them; ``force()``
    makes another run pick them (each call takes its gates at the recorded
    experts), so that two runs which differ only in attention can be
    compared where a route would flip: routing is discrete, and a one-ulp
    difference in a hidden state moves a near-tied gate past another."""

    def __init__(self, cfg):
        self.n_layers = cfg.n_layers
        self.picks = {}
        self.flipped = self.routes = 0

    @contextlib.contextmanager
    def _patched(self, pick):
        from repro_torch.models import moe as moe_mod

        orig, calls = moe_mod.top_k_lower_first, [0]
        self.pos = dict.fromkeys(range(self.n_layers), 0)

        def top_k(gates, k):
            layer = calls[0] % self.n_layers
            calls[0] += 1
            return pick(orig, gates, k, layer)

        moe_mod.top_k_lower_first = top_k
        try:
            yield self
        finally:
            moe_mod.top_k_lower_first = orig

    def record(self):
        import torch

        self.picks = {}

        def pick(orig, gates, k, layer):
            vals, idx = orig(gates, k)
            prev = self.picks.get(layer)
            self.picks[layer] = idx.clone() if prev is None else torch.cat([prev, idx])
            return vals, idx
        return self._patched(pick)

    def _recorded(self, gates, layer):
        lo = self.pos[layer]
        self.pos[layer] += gates.shape[0]
        return self.picks[layer][lo:lo + gates.shape[0]]

    def compare(self):
        self.flipped = self.routes = 0

        def pick(orig, gates, k, layer):
            vals, idx = orig(gates, k)
            want = self._recorded(gates, layer)
            self.flipped += int((idx.sort(-1)[0] != want.sort(-1)[0]).any(-1).sum())
            self.routes += idx.shape[0]
            return vals, idx
        return self._patched(pick)

    def force(self):
        def pick(orig, gates, k, layer):
            idx = self._recorded(gates, layer)
            return gates.gather(-1, idx), idx
        return self._patched(pick)

    def report(self) -> str:
        return (f"{self.flipped} of {self.routes} (token, layer) routes picked another "
                "expert set than the reference run")


def phase_agreement(fails: Failures, model, cfg, seed: int, *, prompt=PROMPT,
                    max_new=MAX_NEW) -> None:
    import numpy as np
    import torch

    from repro_torch.serve.engine import make_chunk_step
    from repro_torch.serve.scheduler import DecodeScheduler

    sched = DecodeScheduler(model, n_slots=SLOTS, max_seq=prompt + max_new,
                            page_size=PAGE, prefill_chunk=CHUNK, seed=seed,
                            device=DEVICE)
    rng = np.random.default_rng(seed + 1)
    for i in range(SLOTS):
        sched.submit(f"a{i}", f"a{i}", rng.integers(0, cfg.vocab, size=prompt), max_new)
    while sched.active_slots() < SLOTS and sched.busy():
        sched.step()
    if not fails.check(sched.active_slots() == SLOTS,
                       f"{sched.active_slots()}/{SLOTS} slots decoding at once"):
        return
    for st in sched.slots:
        # map the page each slot's next write lands in, as a scheduler step
        # does before its decode: through an unmapped row the write goes to
        # the scratch page, where the gather drops the token and the append
        # kernel still attends it
        sched._prepare_write_span(st, st.len, 1)
    fused = copy.copy(model)
    fused.cfg = dataclasses.replace(cfg, attn_backend="paged_kernel")
    tokens = sched.last_tokens[:, None]
    # each step writes its own KV at lane `length` before any read of it
    # (gather, post-update kernel) or masks that lane (append kernel), and
    # returns new recurrent rows, so both can run on one cache
    def last(logits):
        return logits[:, -1, :cfg.vocab].float()

    routes = RouteLog(cfg) if cfg.family == "moe" else None
    with routes.record() if routes else contextlib.nullcontext():
        lg = last(model.decode_step(sched.cache, tokens)[0])
    with routes.compare() if routes else contextlib.nullcontext():
        lk = last(fused.decode_step(sched.cache, tokens)[0])
    diff = (lg - lk).abs().max().item()
    scale = lg.abs().max().item()
    agree = (lg.argmax(-1) == lk.argmax(-1)).float().mean().item()
    print(f"  logits max |gather| {scale:.4f}, max |delta| {diff:.4g}, "
          f"argmax agreement {agree:.3f}")
    what = "paged_kernel vs gather logits"
    if routes:
        print(f"  free-running, {routes.report()}")
        with routes.force():
            lk = last(fused.decode_step(sched.cache, tokens)[0])
        diff = (lg - lk).abs().max().item()
        what += ", paged_kernel's experts forced to gather's routes"
    fails.check(math.isfinite(diff) and diff <= AGREE_REL_TOL * scale,
                f"{what}: max |delta| {diff:.4g} <= {AGREE_REL_TOL} x {scale:.4f}")
    if DEVICE == "cuda":
        for label, m in (("gather", model), ("paged_kernel", fused)):
            profile_step(f"{label} decode step",
                         lambda m=m: m.decode_step(sched.cache, tokens))
        # one prefill chunk for slot 0 past its live length (the slot's
        # unmapped pages take the writes; the cache is not used afterwards)
        chunk = torch.as_tensor(rng.integers(0, cfg.vocab, size=(1, CHUNK)),
                                dtype=torch.int32).to(DEVICE)
        step = make_chunk_step(model)
        hybrid = cfg.family == "hybrid"
        sync()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        prof = profile_step(f"prefill chunk of {CHUNK}", lambda: step(sched.cache, chunk, 0),
                            record_shapes=hybrid)
        print(f"  prefill chunk of {CHUNK}: peak {(torch.cuda.max_memory_allocated() - base) / 2**20:.1f} "
              f"MiB above the {base / 2**30:.3f} GiB held before it")
        if hybrid:
            clones = weight_clones(prof, cfg) if prof is not None else None
            fails.check(clones == [], f"no per-token copy of the RG-LRU gate weights in the "
                        f"traced chunk (aten::clone of (..., nb, Wb, Wb): {clones})")
        trace_graphs("gather scheduler", sched, chunk, slot=0)


def profile_step(label: str, fn, record_shapes: bool = False):
    """One step under ``torch.profiler``: wall time (profiler on),
    the device's busy time summed over kernels, the idle share, the kernels
    the device ran, the launch calls the host made (``cudaLaunchKernel``
    and the like, one ``cudaGraphLaunch`` for a replayed graph), and the
    kernels that take the most device time.  Returns the profile (None
    when no device time was recorded)."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=record_shapes) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    averages = prof.key_averages()
    kernels = [e for e in averages
               if getattr(e, "device_type", None) is not None
               and str(e.device_type).endswith("CUDA")]
    busy = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    calls = {e.key: e.count for e in averages if e.key.startswith(("cuda", "cu"))
             and ("Launch" in e.key)}
    if not busy:
        print(f"  profile {label}: no device time recorded (not measured)")
        return None
    print(f"  profile {label}: wall {wall_us / 1e3:.2f} ms (profiler on), "
          f"device busy {busy / 1e3:.2f} ms, idle share {1 - busy / wall_us:.3f}, "
          f"{launches} kernel launches, host launch calls {sum(calls.values())} {calls}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")
    return prof


def weight_clones(prof, cfg) -> list:
    """The ``aten::clone`` calls of a traced step whose input is the RG-LRU
    gate weight broadcast over tokens: shape (..., nb, Wb, Wb) with more
    than three dims: the copy ``models/rglru.py::block_diag_rows`` makes,
    which the card must not run."""
    nb = cfg.n_heads
    Wb = (cfg.hybrid.lru_width or cfg.d_model) // nb
    return [tuple(e.input_shapes[0]) for e in prof.events()
            if e.name == "aten::clone" and e.input_shapes and len(e.input_shapes[0]) > 3
            and list(e.input_shapes[0][-3:]) == [nb, Wb, Wb]]


# -- phase 20 and the traced phases: the scheduler's CUDA graphs ----------------------------


GRAPH_STEPS = 8                    # decode steps replayed and run eagerly, phase 20
GRAPH_INACTIVE = (1, 4, 7)         # slots masked out of those steps
GRAPH_PROMPT = CHUNK + 44          # one full chunk (the graph) and a tail (eager)
SAMPLINGS = (("greedy", 0.0, 0), ("temperature 0.8 / top-k 50", 0.8, 50))


def step_state(sched) -> tuple:
    """Copies of everything a decode step or a chunk writes: every cache
    leaf (lengths, recurrent rows, the whole pool or every ring), and the
    token buffers."""
    return ({k: v.clone() for k, v in sched.cache.items()}, sched.last_tokens.clone(),
            sched.out_buf.clone(), sched.out_pos.clone())


def state_diff(a, b) -> list:
    """Names of the leaves where two ``step_state``s differ in any bit."""
    import torch

    names = [f"cache.{k}" for k in a[0]] + ["last_tokens", "out_buf", "out_pos"]
    leaves_a = list(a[0].values()) + list(a[1:])
    leaves_b = [b[0][k] for k in a[0]] + list(b[1:])
    return [n for n, x, y in zip(names, leaves_a, leaves_b, strict=True)
            if not torch.equal(x, y)]


def graph_report(label: str, sched) -> None:
    """The captures a scheduler made, the seconds each took, and the memory
    its graphs' pool holds."""
    caps = ", ".join(f"{key} {1e3 * sec:.1f} ms" for key, sec in sched.graphs.captures)
    print(f"  {label}: {len(sched.graphs.captures)} captures ({caps}), graph pool "
          f"{sched.graphs.pool_bytes() / 2**20:.1f} MiB")


def host_ms(fn, iters: int) -> float:
    """Mean ms per call on the host clock, synchronized, no profiler."""
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return 1e3 * (time.perf_counter() - t0) / iters


def trace_graphs(label: str, sched, tokens=None, slot: int = 0, iters: int = 5) -> None:
    """A scheduler's eager decode step (``_step_impl`` on its own state)
    beside its replayed decode graph, and with ``tokens`` its eager
    ``prefill_chunk``-token chunk beside the replayed chunk graph at
    ``slot``: each traced once, then timed ``iters`` times without the
    profiler.  Both write the scheduler's state: run it last."""
    import torch

    def eager_step():
        sched._step_impl(sched.cache, sched.last_tokens, sched.out_buf, sched.out_pos,
                         sched._active)

    steps = [("decode step", eager_step, lambda: sched.graphs.replay("decode"))]
    if tokens is not None and "chunk" in sched.graphs:
        at = torch.tensor(slot, device=DEVICE)
        sched._chunk_tokens.copy_(tokens)
        sched._chunk_at.fill_(slot)
        steps.append((f"chunk of {tokens.shape[1]}", lambda: sched._chunk(sched.cache, tokens, at),
                      lambda: sched.graphs.replay("chunk")))
    for what, eager, replay in steps:
        profile_step(f"{label} {what}, eager", eager)
        profile_step(f"{label} {what}, replayed graph", replay)
        e_ms, r_ms = host_ms(eager, iters), host_ms(replay, iters)
        print(f"  {label} {what}, no profiler: eager {e_ms:.3f} ms, replayed {r_ms:.3f} ms "
              f"({iters} each)")
    graph_report(label, sched)


def phase_graph_replay(fails: Failures, model, cfg, seed: int, label: str, *,
                       kv_mode: str = "paged", attn_backend: str = "gather",
                       trace: bool = False) -> None:
    """Replay vs eager at full width, greedy and with temperature / top-k:
    from one copied state, ``GRAPH_STEPS`` replays of the decode graph and
    as many eager ``_step_impl`` steps, slots ``GRAPH_INACTIVE`` masked out,
    the generator restored between; then (paged mode) one replay of the
    ``CHUNK``-token chunk graph at slot 3 (from length 0, into mapped pages)
    and the eager chunk, each with the token drawn from its last logits.  Every cache leaf, the token buffers,
    the logits and the drawn token must agree bitwise.  ``trace``: the
    greedy scheduler's steps are traced last, as in ``trace_graphs``."""
    import numpy as np
    import torch

    from repro_torch.serve.scheduler import DecodeScheduler

    if DEVICE != "cuda":
        print("  no CUDA graph off the card (a CPU rehearsal runs every step eagerly)")
        return
    rng = np.random.default_rng(seed + 20)
    # room for every slot to decode while the last one is admitted, then more
    max_new = SLOTS * -(-GRAPH_PROMPT // CHUNK) + 2 * GRAPH_STEPS
    for sampling, temperature, top_k in SAMPLINGS:
        sched = DecodeScheduler(model, n_slots=SLOTS, max_seq=GRAPH_PROMPT + max_new,
                                page_size=PAGE, prefill_chunk=CHUNK, kv_mode=kv_mode,
                                attn_backend=attn_backend, temperature=temperature,
                                top_k=top_k, seed=seed, device=DEVICE)
        for i in range(SLOTS):
            sched.submit(f"g{i}", f"g{i}", rng.integers(0, cfg.vocab, size=GRAPH_PROMPT),
                         max_new)
        while (sched.active_slots() < SLOTS or "decode" not in sched.graphs) and sched.busy():
            sched.step()
        what = f"{label}, {sampling}"
        if not fails.check(sched.active_slots() == SLOTS and "decode" in sched.graphs,
                           f"{what}: {sched.active_slots()}/{SLOTS} slots decoding, decode "
                           "graph captured"):
            continue
        if kv_mode == "paged":
            for st in sched.slots:       # map the pages the steps' writes land in
                sched._prepare_write_span(st, st.len, GRAPH_STEPS)
        active = torch.tensor([i not in GRAPH_INACTIVE for i in range(SLOTS)], device=DEVICE)
        sched._active.copy_(active)
        start, gen0 = step_state(sched), sched._gen.get_state()
        want = torch.stack([start[0]["length"], start[3]]) + GRAPH_STEPS * active.int()
        for _ in range(GRAPH_STEPS):
            sched.graphs.replay("decode")
        replayed = step_state(sched)
        sched._gen.set_state(gen0)
        for _ in range(GRAPH_STEPS):
            sched._step_impl(*start, active)
        sync()
        bad = state_diff(replayed, start)
        moved = torch.equal(torch.stack([replayed[0]["length"], replayed[3]]), want)
        fails.check(not bad and moved,
                    f"{what}: {GRAPH_STEPS} decode replays bitwise {GRAPH_STEPS} eager steps "
                    f"(slots {GRAPH_INACTIVE} inactive, their lengths and output rings "
                    f"unmoved: {moved}): "
                    f"{'every leaf equal' if not bad else f'differ in {bad}'}")
        del start, replayed
        if kv_mode == "paged":
            # the chunk prefills slot 3's first CHUNK positions again, into
            # pages its table maps, as a first chunk does (past the table
            # every write would go to the scratch page, where the colliding
            # writes of one launch land in no fixed order)
            slot = 3
            sched.cache["length"][slot] = 0
            tokens = torch.as_tensor(rng.integers(0, cfg.vocab, size=(1, CHUNK)),
                                     dtype=torch.int32).to(DEVICE)
            start, gen0 = step_state(sched), sched._gen.get_state()
            sched._chunk_tokens.copy_(tokens)
            sched._chunk_at.fill_(slot)
            lr = sched.graphs.replay("chunk").clone()
            tr = sched._sample(lr[:, -1])
            replayed = step_state(sched)
            sched._gen.set_state(gen0)
            le, _ = sched._chunk(start[0], tokens, torch.tensor(slot, device=DEVICE))
            te = sched._sample(le[:, -1])
            sync()
            bad = state_diff(replayed, start)
            same = torch.equal(lr, le) and torch.equal(tr, te)
            fails.check(not bad and same,
                        f"{what}: {CHUNK}-token chunk graph at slot {slot} bitwise the eager "
                        f"chunk (logits {'equal' if torch.equal(lr, le) else 'DIFFER'}, token "
                        f"{tr.tolist()} / {te.tolist()}, "
                        f"{'every leaf equal' if not bad else f'differ in {bad}'})")
            del start, replayed
        if temperature == 0.0:
            if trace:
                trace_graphs(what, sched, torch.as_tensor(
                    rng.integers(0, cfg.vocab, size=(1, CHUNK)), dtype=torch.int32).to(DEVICE),
                    slot=0)
            else:
                graph_report(what, sched)
        del sched
        torch.cuda.empty_cache()


# -- phase 5: RG-LRU scan kernel vs its plain fold ---------------------------------------


RGLRU_CASES = [  # (B, L, W, kind)
    (1, 1, 8, "random"), (2, 16, 24, "random"), (2, 17, 2560, "random"),
    (8, 1, 2560, "random"), (1, 29, 24, "random"), (8, 29, 8, "resets"),
    (1, 256, 2560, "random"), (8, 256, 24, "resets"), (2, 2048, 8, "near_one"),
    (1, 2048, 2560, "random"), (2, 33, 10, "random"), (1, 100, 2560, "resets"),
]


def rglru_inputs(gen, B, L, W, kind, dtype):
    """a in (0.01, 0.99) and standard-normal b; ``near_one``: a = 0.999 and
    b = 0.01 (a trained RG-LRU's slow channels); ``resets``: a tenth of
    the a's exactly 0."""
    import torch

    if kind == "near_one":
        a = torch.full((B, L, W), 0.999, device=DEVICE)
        b = torch.full((B, L, W), 0.01, device=DEVICE)
    else:
        a = torch.sigmoid(torch.randn(B, L, W, generator=gen).to(DEVICE)) * 0.98 + 0.01
        b = torch.randn(B, L, W, generator=gen).to(DEVICE)
        if kind == "resets":
            a = torch.where(torch.rand(B, L, W, generator=gen).to(DEVICE) < 0.1, 0.0, a)
    return a.to(dtype).contiguous(), b.to(dtype).contiguous()


def phase_rglru_cases(fails: Failures, seed: int) -> None:
    import torch

    from repro_torch.kernels.rglru_scan import rglru_scan_kernel, rglru_scan_plain

    gen = torch.Generator().manual_seed(seed)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for B, L, W, kind in RGLRU_CASES:
            a, b = rglru_inputs(gen, B, L, W, kind, dtype)
            before = dict(rglru_scan_kernel.launches_by_kernel)
            got = rglru_scan_kernel(a, b)
            kernel = [k for k, v in rglru_scan_kernel.launches_by_kernel.items()
                      if v != before[k]]
            want = rglru_scan_plain(a, b)
            sync()
            err = (got.float() - want.float()).abs().max().item()
            same = torch.equal(got, want)
            label = f"rglru kernel {kernel} vs plain {name} [B={B} L={L} W={W} {kind}]"
            if dtype == torch.float32:
                fails.check(same, f"{label}: bitwise (max err {err:.3g})")
            else:
                fails.check(err <= TOL[name] and torch.isfinite(got).all().item(),
                            f"{label}: max err {err:.3g} <= {TOL[name]} (bitwise: {same})")


# -- phase 7: both kernels at recurrentgemma-2b's serving shapes ---------------------------


def input_sets(make, nbytes: int, cold_bytes: float = 120e6, cap: int = 256):
    """Enough copies of one kernel call's inputs that a loop over them
    streams more than the 50 MB L2: every timed launch reads cold inputs,
    as the serving path does."""
    n = max(2, min(cap, math.ceil(cold_bytes / max(nbytes, 1))))
    return [make(i) for i in range(n)]


def phase_rglru_timing(fails: Failures, seed: int, shape, launches: int) -> dict:
    import torch

    from repro_torch.kernels.rglru_scan import rglru_scan_kernel, rglru_scan_plain

    B, L, W = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def make(i):
        a = torch.sigmoid(torch.randn(B, L, W, generator=gen, device="cuda")) * 0.98 + 0.01
        return a, torch.randn(B, L, W, generator=gen, device="cuda")

    sets = input_sets(make, 8 * B * L * W)
    n = len(sets)
    before = dict(rglru_scan_kernel.launches_by_kernel)
    got = rglru_scan_kernel(*sets[0])
    kernel = [k for k, v in rglru_scan_kernel.launches_by_kernel.items() if v != before[k]]
    want = rglru_scan_plain(*sets[0])
    max_err = (got - want).abs().max().item()
    fails.check(torch.equal(got, want),
                f"rglru kernel vs plain at {shape} fp32 ({kernel} kernel): bitwise (max err "
                f"{max_err:.3g})")
    iters = max(n, 40)
    ms = cuda_time_ms(lambda i: rglru_scan_kernel(*sets[i % n]), iters, warmup=n)
    plain_iters = 3 if L >= 1024 else 10
    plain_ms = cuda_time_ms(lambda i: rglru_scan_plain(*sets[i % n]), plain_iters, warmup=1)
    ms_again = cuda_time_ms(lambda i: rglru_scan_kernel(*sets[i % n]), iters, warmup=0)
    dev_ms = device_ms_per_launch(lambda i: rglru_scan_kernel(*sets[i % n]),
                                  max(n, 20), "rglru_scan_")
    elems = B * L * W
    t_bytes = 12 * elems / HBM_BYTES_PER_S          # read a and b, write h (fp32)
    t_ops = 2 * elems / FP32_FLOPS_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    print(f"  rglru_scan {shape} fp32 ({n} input sets): kernel {ms:.4f} ms "
          f"(again {ms_again:.4f}; device time per launch {dev_ms} ms), plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({12 * elems / 1e6:.2f} MB)")
    return {"name": "rglru_scan", "route": "cuda", "kernel_route": kernel[0],
            "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
            "replaces": "src/repro/kernels/rglru_scan/kernel.py:54",
            "shape": f"a,b {B}x{L}x{W} fp32", "launches": launches,
            "max_abs_err": max_err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def phase_paged_timing_d256(fails: Failures, cfg, seed: int, launches: int) -> dict:
    """The paged kernel at the hybrid's decode shape: 8 slots of 2301..2316
    live tokens (post-update: the new token is in the pool), 145 scrambled
    pages per slot, window 2048, one pool per attention layer (8 pools,
    152 MB) rotated so every launch reads cold K/V."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import (paged_attention_kernel,
                                                     paged_attention_plain)
    from repro_torch.kernels.paged_attention.plan import live_pages
    from repro_torch.models.config import layer_pattern

    L = layer_pattern(cfg).count("a")
    Hkv, D, window = cfg.n_kv_heads, cfg.the_head_dim(), cfg.hybrid.local_window
    G = cfg.n_heads // Hkv
    mp = -(-(H_PROMPT + H_MAX_NEW) // PAGE)
    n_pages = SLOTS * mp
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kp = torch.randn(L, n_pages, PAGE, Hkv, D, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    vp = torch.randn_like(kp)
    qs = torch.randn(L, SLOTS, Hkv, G, D, generator=gen, device="cuda", dtype=torch.bfloat16)
    pt = torch.as_tensor(rng.permutation(n_pages).reshape(SLOTS, mp).astype(np.int32)).cuda()
    pos_np = rng.integers(H_PROMPT, H_PROMPT + H_MAX_NEW, size=SLOTS).astype(np.int32)
    q_pos = torch.as_tensor(pos_np).cuda()
    lengths = q_pos + 1                           # post-update: lane pos is attended

    def kernel(i):
        return paged_attention_kernel(qs[i % L], kp[i % L], vp[i % L], pt, lengths, q_pos,
                                      window=window)

    def plain(i):
        return paged_attention_plain(qs[i % L], kp[i % L], vp[i % L], pt, lengths, q_pos,
                                     window=window)

    T = mp * PAGE
    lane = torch.arange(T, device="cuda")[None]
    live = ((lane < lengths[:, None]) & (lane > q_pos[:, None] - window))[:, None, None, :]

    def library(i):
        # G query rows against the one kv head: (B, Hkv, G, D) as (B, heads, L, D)
        k = kp[i % L][pt.long()].reshape(SLOTS, T, Hkv, D).transpose(1, 2)
        v = vp[i % L][pt.long()].reshape(SLOTS, T, Hkv, D).transpose(1, 2)
        return F.scaled_dot_product_attention(qs[i % L], k, v, attn_mask=live)

    acc, m, l = kernel(0)
    racc, rm, rl = plain(0)
    o = acc / l.clamp(min=1e-30)[..., None]
    ro = racc / rl.clamp(min=1e-30)[..., None]
    max_err = (o - ro).abs().max().item()
    scale = ro.abs().max().item()
    lib_err = (o - library(0).float()).abs().max().item()
    fails.check(max_err <= PAGED_SUM_REL * scale,
                f"kernel vs plain at the hybrid decode shape: max err {max_err:.3g} <= "
                f"{PAGED_SUM_REL} x max |o| {scale:.4g}")
    fails.check(lib_err <= TOL["bfloat16"],
                f"kernel vs gather+SDPA at the hybrid decode shape: max err {lib_err:.3g}")
    ms = cuda_time_ms(kernel, 400, warmup=40)
    plain_ms = cuda_time_ms(plain, 40)
    library_ms = cuda_time_ms(library, 40)
    ms_again = cuda_time_ms(kernel, 400, warmup=0)
    dev_ms = device_ms_per_launch(kernel, 40, "paged_attn_kernel")
    n_split = paged_attention_kernel.last_splits    # what the wrapper launched

    lanes = int(np.minimum(pos_np + 1, window).sum())    # the lanes the function needs
    pages = sum(-(-int(p + 1) // PAGE) - (int(p + 1) - min(int(p + 1), window)) // PAGE
                for p in pos_np)
    # what the kernel streams: the pages from the window's first to the last live one
    read_lanes = PAGE * sum(hi - lo for lo, hi in (
        live_pages(int(p + 1), int(p), window, 0, PAGE, PAGE, mp) for p in pos_np))
    elt = 2
    bytes_moved = (qs[0].numel() * elt + 2 * lanes * Hkv * D * elt + pages * 4
                   + 2 * SLOTS * 4 + SLOTS * Hkv * G * (D + 2) * 4)
    flops = 4 * lanes * Hkv * G * D
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    print(f"  hybrid decode shape: B={SLOTS} Hkv={Hkv} G={G} D={D} page={PAGE} "
          f"max_pages={mp} window={window} in-window lanes={lanes} (kernel streams "
          f"{read_lanes} lanes over {n_split} page splits) layers rotated={L}")
    print(f"  kernel {ms:.4f} ms (again {ms_again:.4f}; device time per launch "
          f"{dev_ms} ms), plain {plain_ms:.4f} ms, gather+SDPA {library_ms:.4f} ms "
          f"(kernel / gather+SDPA {min(ms, ms_again) / library_ms:.3f}), "
          f"bound {bound_ms:.4f} ms ({bytes_moved/1e6:.2f} MB, {flops/1e6:.2f} MFLOP)")
    return {"name": "paged_attention", "route": "cuda", "splits": n_split,
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention/kernel.py:99",
            "shape": f"recurrentgemma-2b decode: B={SLOTS} Hkv={Hkv} G={G} D={D} "
                     f"window={window} bf16",
            "launches": launches, "max_abs_err": max_err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


# -- phase 9: decode vs chunk prefill of the recurrent rows --------------------------------


def phase_recurrent_parity(fails: Failures, model, cfg, seed: int) -> None:
    """One slot: a prefix as one chunk, then N tokens as one chunk or as N
    S=1 steps from copies of the same state.

    Gated, bitwise: on every RG-LRU layer's gates for the N tokens (taken
    from the chunk run), the scan with ``h0`` folded in and the conv-tail
    update, as one N-token chunk and as N S=1 steps, leave the same ``h``
    and ``conv`` rows, and the per-token states agree.  Printed: the same
    comparison through the whole model."""
    import numpy as np
    import torch

    from repro_torch.models import kvcache, layers
    from repro_torch.models import rglru as rg

    n0, n = PARITY_PREFIX, PARITY_TOKENS
    n_pages = -(-(n0 + n) // PAGE)
    toks = torch.as_tensor(np.random.default_rng(seed + 2).integers(
        0, cfg.vocab, size=(1, n0 + n)), dtype=torch.int32).to(DEVICE)
    base = kvcache.paged_cache(model, 1, page_size=PAGE, n_pages=n_pages, max_pages=n_pages)
    base["page_table"][0] = torch.arange(n_pages, dtype=torch.int32)
    _, base = model.decode_step(base, toks[:, :n0])

    def clone(c):
        return {k: v.clone() for k, v in c.items()}

    # capture every RG-LRU layer's conv input, conv carry and gates during
    # the chunk run
    convs, gates = [], []
    orig_conv, orig_gates = rg.causal_conv, rg.rglru_gates

    def conv_spy(p, xw, prev):
        convs.append((p, xw, prev))
        return orig_conv(p, xw, prev)

    def gates_spy(p, x, nb):
        a, g = orig_gates(p, x, nb)
        gates.append((a, g))
        return a, g

    rg.causal_conv, rg.rglru_gates = conv_spy, gates_spy
    try:
        _, whole = model.decode_step(clone(base), toks[:, n0:])
    finally:
        rg.causal_conv, rg.rglru_gates = orig_conv, orig_gates
    stepped = clone(base)
    for t in range(n):
        _, stepped = model.decode_step(stepped, toks[:, n0 + t:n0 + t + 1])
    sync()

    # the recurrence alone: chunk vs S=1 steps on the same inputs
    ok, worst = len(gates) == len(convs) == base["h"].shape[0], 0.0
    for j, ((p, xw, prev), (a, g)) in enumerate(zip(convs, gates)):
        h0 = base["h"][j]
        chunk = rg.rglru_scan(g, a, h0)
        xc_chunk, tail_chunk = rg.causal_conv(p, xw, prev)
        h, tail, hs, xcs = h0, prev, [], []
        for t in range(n):
            h = rg.rglru_scan(g[:, t:t + 1], a[:, t:t + 1], h)[:, 0]
            xc, tail = rg.causal_conv(p, xw[:, t:t + 1], tail)
            hs.append(h)
            xcs.append(xc)
        hs = torch.stack(hs, 1)
        ok &= (torch.equal(chunk, hs) and torch.equal(chunk[:, -1], whole["h"][j])
               and torch.equal(xc_chunk, torch.cat(xcs, 1))
               and torch.equal(tail_chunk, tail) and torch.equal(tail, whole["conv"][j]))
        worst = max(worst, (chunk - hs).abs().max().item())
    fails.check(ok, f"RG-LRU h and conv rows, {n}-token chunk vs {n} S=1 steps on the "
                f"same inputs, {len(gates)} layers: bitwise (max |delta h| {worst:.3g})")

    # the whole model: every projection too (cuBLAS picks kernels by shape)
    diffs = {key: (whole[key].float() - stepped[key].float()).abs().max().item()
             for key in ("h", "conv")}
    lanes = slice(n0, n0 + n)
    for key in ("kp", "vp"):
        a_ = whole[key][:, :n_pages].flatten(1, 2)[:, lanes].float()
        b_ = stepped[key][:, :n_pages].flatten(1, 2)[:, lanes].float()
        diffs[key] = (a_ - b_).abs().max().item()
    bitwise = all(v == 0.0 for v in diffs.values())
    scale = whole["h"].abs().max().item()
    print(f"  whole model, {n}-token chunk vs {n} S=1 steps: bitwise {bitwise}, "
          f"max |delta| {diffs} (|h| up to {scale:.4g}, hidden dtype "
          f"{layers.COMPUTE_DTYPE})")


# -- phase 10: SSD scan kernel vs its plain chunked form ---------------------------------


SSD_CASES = [  # (B, L, H, P, N, h0, kind)
    (1, 1, 6, 4, 8, True, "random"), (2, 8, 6, 4, 8, False, "random"),
    (2, 37, 6, 4, 8, True, "dt_zero"), (2, 37, 6, 4, 8, True, "big_decay"),
    (8, 8, 6, 64, 128, True, "dt_zero"),
    (8, 1, 64, 64, 128, True, "random"), (2, 37, 64, 64, 128, True, "big_decay"),
    (1, 252, 64, 64, 128, True, "random"), (1, 256, 64, 64, 128, False, "random"),
    (1, 256, 64, 64, 128, True, "big_decay"), (1, 2048, 64, 64, 128, True, "dt_zero"),
    (2, 200, 3, 48, 256, True, "random"), (1, 130, 4, 32, 64, False, "dt_zero"),
    (3, 300, 8, 64, 128, True, "big_decay"), (2, 1, 8, 16, 64, False, "random"),
]


def ssd_inputs(gen, B, L, H, P, N, h0, kind, dtype, device=None):
    """x normal; dt = softplus(normal); A = -exp(0.3 normal); B and C 0.5
    normal; h0 normal or None.  ``dt_zero``: every third token has dt = 0
    (the padding the plain version uses); ``big_decay``: A from -1 to -16
    (mamba2's init range) and dt x 4, so |A dt| reaches ~100 in a step."""
    import torch
    import torch.nn.functional as F

    device = device or DEVICE

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=gen.device).to(device)

    x = rnd(B, L, H, P)
    dt = F.softplus(rnd(B, L, H))
    A = -torch.exp(rnd(H) * 0.3)
    Bm, Cm = rnd(B, L, N) * 0.5, rnd(B, L, N) * 0.5
    h = rnd(B, H, P, N) if h0 else None
    if kind == "dt_zero":
        dt[:, ::3] = 0.0
    if kind == "big_decay":
        dt = dt * 4
        A = -torch.linspace(1.0, 16.0, H, device=device)
    return (x.to(dtype).contiguous(), dt.contiguous(), A.contiguous(),
            Bm.to(dtype).contiguous(), Cm.to(dtype).contiguous(), h)


def ssd_close(got, want, tol: float, normwise: bool = False) -> bool:
    """``|got - want| <= atol + tol |want|`` elementwise (``allclose``), with
    ``atol = tol``, or ``tol`` times the largest ``|want|`` when
    ``normwise``."""
    got, want = got.double(), want.double()
    atol = tol * (want.abs().max().item() if normwise else 1.0)
    return bool(((got - want).abs() <= atol + tol * want.abs()).all().item())


def ssd_bf16_margins(y, h, args, split: bool) -> dict:
    """The kernel's bf16 ``y`` and fp32 state against the fp32 plain version
    on the same values and ``bf16_rounding_bound`` (the kernel's roundings:
    y to bf16 once, fp32 sums and exponents, and where ``split`` (the
    tensor-core route's chunk kernel) its hi + lo operand splits): the
    largest errors, whether each element lies within its bound and the
    largest error / bound, and on the row ``t`` of the token whose input
    moves its own row the most the bound's largest value beside the change
    that leaving out that token's input makes there (``drop``)."""
    import torch

    from repro_torch.kernels.ssd_scan.ref import (KERNEL_CHUNK, bf16_rounding_bound,
                                                  dropped_token_effect)

    want_y, bound_y, want_h, bound_h = bf16_rounding_bound(
        *args, kernel_chunk=KERNEL_CHUNK if split else None)
    dy, dh = (y.float() - want_y).abs(), (h - want_h).abs()
    t, drop = dropped_token_effect(*args)

    def ratio(d, b):
        return (d / b.clamp(min=1e-30)).max().item()

    return {"err_y": dy.max().item(), "within_y": bool((dy <= bound_y).all().item()),
            "ratio_y": ratio(dy, bound_y), "err_h": dh.max().item(),
            "within_h": bool((dh <= bound_h).all().item()), "ratio_h": ratio(dh, bound_h),
            "t": t, "row_bound": bound_y[:, t].max().item(), "drop": drop,
            "finite": bool(torch.isfinite(y.float()).all().item())}


def ssd_bf16_check(fails: Failures, label: str, y, h, args, split: bool) -> float:
    """:func:`ssd_bf16_margins` checked and printed: every element within
    its bound, and the bound on row t below the one-token effect there.
    Returns the largest |y - plain|."""
    m = ssd_bf16_margins(y, h, args, split)
    fails.check(m["within_y"] and m["within_h"] and m["finite"] and m["row_bound"] < m["drop"],
                f"{label}: bf16 y within bf16_rounding_bound{'' if split else ' (no split)'} of "
                f"the fp32 plain version (max err {m['err_y']:.3g}, largest err / bound "
                f"{m['ratio_y']:.3g}), state within its bound (max err {m['err_h']:.3g}, "
                f"largest err / bound {m['ratio_h']:.3g}); on row {m['t']} the bound is at most "
                f"{m['row_bound']:.3g}, and leaving out token {m['t']}'s input moves y there by "
                f"up to {m['drop']:.3g}")
    return m["err_y"]


def ssd_fp32_readings(y, yr, args) -> dict:
    """The kernel's fp32 ``y`` and the plain version's (``yr``, chunks of
    256) against the plain version in float64, per element: the largest
    error, the largest error / ``fp32_rounding_bound`` (the kernel's own
    roundings on its chunks of 64), and the largest error / (1e-4 + 1e-4
    |y64|) with the share of elements where that passes 1 (where
    ``allclose`` at 1e-4 fails); and the bound on the row of the token whose
    input moves its own row the most, beside that move."""
    from repro_torch.kernels.ssd_scan.ref import dropped_token_effect, fp32_rounding_bound

    y64, bound = fp32_rounding_bound(*args)
    tol = 1e-4 + 1e-4 * y64.abs()
    out = {}
    for name, got in (("kernel", y), ("plain", yr)):
        d = (got.double() - y64).abs()
        out[name] = {"err": d.max().item(), "err/bound": (d / bound).max().item(),
                     "within": bool((d <= bound).all().item()),
                     "err/1e-4": (d / tol).max().item(),
                     "share over 1e-4": (d > tol).double().mean().item()}
    t, drop = dropped_token_effect(*args)
    out.update(t=t, row_bound=bound[:, t].max().item(), drop=drop)
    return out


def phase_ssd_cases(fails: Failures, seed: int) -> None:
    """fp32 ``y`` and final state per element within 1e-4 of the plain
    version (``allclose``, the JAX kernel-vs-model tolerance); bf16 ``y`` and
    state within ``bf16_rounding_bound`` (:func:`ssd_bf16_check`).  Each
    case launches once, on the route ``route()`` (the library's rule)
    names.

    At |A dt| up to ~100 (``big_decay``, fp32) the cumsums of dt * A fall to
    -thousands within a chunk, and exp(cums_i - cums_j) carries their
    rounding: there ``y`` is held per element against the plain version
    run in float64, within ``fp32_rounding_bound``, the limit the kernel's
    own roundings give, and that limit must lie below the effect of leaving
    out one token.  The state stays within 1e-4 of the fp32 plain version.
    How far the kernel and the fp32 plain version (chunks of 256, whose
    cumsums grow four times as long) each are from 1e-4 of float64 is
    printed (:func:`ssd_fp32_readings`)."""
    import torch

    from repro_torch.kernels.ssd_scan import ssd_scan_kernel, ssd_scan_plain
    from repro_torch.kernels.ssd_scan.kernel import route

    gen = torch.Generator().manual_seed(seed)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for B, L, H, P, N, h0, kind in SSD_CASES:
            args = ssd_inputs(gen, B, L, H, P, N, h0, kind, dtype)
            label = f"[B={B} L={L} H={H} P={P} N={N} h0={h0} {kind}]"
            path = route(dtype, P, N)
            before = dict(ssd_scan_kernel.launches_by_route)
            y, h = ssd_scan_kernel(*args)
            sync()
            launched = {r: ssd_scan_kernel.launches_by_route[r] - before[r] for r in before}
            fails.check(launched[path] == 1 and sum(launched.values()) == 1,
                        f"ssd kernel {name} {label} launched once, on the {path} route")
            if dtype == torch.bfloat16:
                ssd_bf16_check(fails, f"ssd kernel vs plain {name} {label} ({path})", y, h, args,
                               split=path == "tensor_core" and L > 1)
                continue
            yr, hr = ssd_scan_plain(*args)
            err = (y.float() - yr.float()).abs().max().item()
            herr = (h - hr).abs().max().item()
            finite = bool(torch.isfinite(y.float()).all().item())
            if kind != "big_decay":
                fails.check(ssd_close(y, yr, 1e-4) and ssd_close(h, hr, 1e-4) and finite,
                            f"ssd kernel vs plain {name} {label}: max err y {err:.3g}, h "
                            f"{herr:.3g} (allclose 1e-4)")
                continue
            r = ssd_fp32_readings(y, yr, args)
            fails.check(r["kernel"]["within"] and r["row_bound"] < r["drop"]
                        and ssd_close(h, hr, 1e-4) and finite,
                        f"ssd kernel {name} {label}: y within fp32_rounding_bound of the plain "
                        f"version in float64 ({r['kernel']}), vs the plain version in fp32 "
                        f"max err y {err:.3g}, h {herr:.3g} (h allclose 1e-4); on row {r['t']} "
                        f"the bound is at most {r['row_bound']:.3g}, leaving out token "
                        f"{r['t']}'s input moves y there by {r['drop']:.3g}")
            print(f"    the plain version in fp32 against float64: {r['plain']}")
    print(f"  launches by route: {ssd_scan_kernel.launches_by_route}")


# -- phase 12: the SSD kernel at mamba2-1.3b's serving shapes -----------------------------


def ssd_bound(B, L, H, P, N, elt: int, chunk: int):
    """(bytes, operations) the function needs: each input read once, each
    output written once; operations the fewer of the token-by-token
    recurrence (5 P N + P per token and head: decay, outer-product update,
    C . h) and the chunked form at the model's chunk (C . B^T once per chunk,
    and per head the (q, q) product, C . h_prev, the state product and the
    carry)."""
    nbytes = (B * L * H * P * elt * 2          # x in, y out
              + B * L * H * 4 + H * 4          # dt, A
              + 2 * B * L * N * elt            # B, C
              + 2 * B * H * P * N * 4)         # h0 in, h_final out
    seq = B * L * H * (5 * P * N + P)
    chunked = 0
    for lo in range(0, L, chunk):
        q = min(chunk, L - lo)
        chunked += B * (2 * q * q * N + H * (2 * q * q * P + 4 * q * P * N + 2 * P * N))
    return nbytes, min(seq, chunked)


SSD_COLD_BYTES = 400e6      # input sets per SSD timing: 8x the 50 MB L2


def phase_ssd_timing(fails: Failures, seed: int, shape, launches: int) -> dict:
    """The kernel, its plain version and their bound at one shape, bf16 x,
    B and C as the model gives them, fp32 dt and h0.  Every timed launch
    reads cold inputs and writes fresh memory: the launches rotate over
    enough input sets to move SSD_COLD_BYTES (at the decode shape 12 sets,
    each h0 16.8 MB), and each launch's outputs are kept until the timing
    ends, so no launch writes into lines the last one left in L2.  The
    bound takes the operations at the route's rate: 989 TFLOP/s dense bf16
    on the tensor cores, 67 TFLOP/s fp32 on the CUDA cores."""
    import torch

    from repro_torch.kernels.ssd_scan import ssd_scan_kernel, ssd_scan_plain
    from repro_torch.kernels.ssd_scan.kernel import route

    B, L, H, P, N = shape
    path = route(torch.bfloat16, P, N)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    nbytes, ops = ssd_bound(B, L, H, P, N, 2, CHUNK)
    sets = input_sets(lambda i: ssd_inputs(gen, B, L, H, P, N, True, "random",
                                           torch.bfloat16, "cuda"), nbytes,
                      cold_bytes=SSD_COLD_BYTES)
    n = len(sets)
    kept = []

    def kernel(i):
        kept.append(ssd_scan_kernel(*sets[i % n]))

    before = ssd_scan_kernel.launches_by_route[path]
    y, h = ssd_scan_kernel(*sets[0])
    fails.check(ssd_scan_kernel.launches_by_route[path] == before + 1,
                f"ssd kernel at {shape} bf16 launched on the {path} route")
    max_err = ssd_bf16_check(fails, f"ssd kernel vs plain at {shape}", y, h, sets[0],
                             split=path == "tensor_core" and L > 1)
    iters = max(n, 20)
    ms = cuda_time_ms(kernel, iters, warmup=n)
    kept.clear()
    plain_ms = cuda_time_ms(lambda i: ssd_scan_plain(*sets[i % n]), 3 if L >= 1024 else 10,
                            warmup=1)
    ms_again = cuda_time_ms(kernel, iters, warmup=0)
    kept.clear()
    dev_ms = device_ms_per_launch(kernel, max(n, 10), "ssd_")
    kept.clear()
    rate = BF16_FLOPS_PER_S if path == "tensor_core" else FP32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    bound_ms = max(t_bytes, t_ops) * 1e3
    bound_fp32_ms = max(t_bytes, ops / FP32_FLOPS_PER_S) * 1e3
    print(f"  ssd_scan {shape} bf16, {path} route ({n} input sets, outputs kept): kernel "
          f"{ms:.4f} ms (again "
          f"{ms_again:.4f}; device time per launch {dev_ms} ms), plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.5f} ms ({nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP at "
          f"{rate / 1e12:.0f} TFLOP/s; {bound_fp32_ms:.5f} ms at 67 TFLOP/s fp32)")
    return {"name": "ssd_scan", "route": "cuda", "kernel_route": path,
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan/kernel.py:68",
            "shape": f"x {B}x{L}x{H}x{P} bf16, N={N}, h0 fp32", "launches": launches,
            "max_abs_err": max_err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_fp32_ms": bound_fp32_ms, "library_ms": None}


# -- phase 13: the SSM step's costs outside the kernel, and one traced step of each ---------


def phase_ssm_steps(fails: Failures, model, cfg, seed: int) -> None:
    """All 8 slots decoding at once: one scheduler step (a replayed decode
    graph) traced, and the eager decode step and 256-token prefill chunk
    beside their replayed graphs (``trace_graphs``); the full-size
    ``mask_slot_rows`` over the 768 MiB of SSD state (merged in place) and
    the per-layer ``torch.stack`` of new states timed with CUDA events."""
    import numpy as np
    import torch

    from repro_torch.models import kvcache
    from repro_torch.serve.scheduler import DecodeScheduler

    sched = DecodeScheduler(model, n_slots=SLOTS, max_seq=CHUNK + 64, page_size=PAGE,
                            prefill_chunk=CHUNK, seed=seed, device=DEVICE)
    rng = np.random.default_rng(seed + 3)
    for i in range(SLOTS):
        sched.submit(f"p{i}", f"p{i}", rng.integers(0, cfg.vocab, size=16), 64)
    while sched.active_slots() < SLOTS and sched.busy():
        sched.step()
    if not fails.check(sched.active_slots() == SLOTS,
                       f"{sched.active_slots()}/{SLOTS} slots decoding at once"):
        return
    if DEVICE != "cuda":
        return
    cache = sched.cache
    state_bytes = cache["ssm"].numel() * 4
    new = dict(cache, ssm=cache["ssm"].clone(), conv=cache["conv"].clone())
    keep = torch.ones(SLOTS, dtype=torch.bool, device=DEVICE)
    mask_ms = cuda_time_ms(lambda i: kvcache.mask_slot_rows(new, cache, keep), 10, warmup=2)
    rows = list(new["ssm"].unbind(0))
    stack_ms = cuda_time_ms(lambda i: torch.stack(rows), 10, warmup=2)
    print(f"  SSD state {state_bytes / 2**20:.0f} MiB for {SLOTS} slots: mask_slot_rows "
          f"{mask_ms:.3f} ms ({3 * state_bytes / mask_ms / 1e6:.0f} GB/s over 3x the state), "
          f"per-layer torch.stack {stack_ms:.3f} ms ({2 * state_bytes / stack_ms / 1e6:.0f} "
          f"GB/s over 2x)")
    del new, rows
    profile_step("ssm decode step (scheduler.step(), replayed graph, 8 slots)", sched.step)
    chunk = rng.integers(0, cfg.vocab, size=CHUNK).astype(np.int32)
    sched._chunk_logits(chunk, 0)          # the prompts were one short chunk: capture one
    trace_graphs("ssm scheduler", sched, torch.as_tensor(chunk[None]).to(DEVICE), slot=0)


# -- phase 14: decode vs chunk prefill of one SSM slot ------------------------------------


def phase_ssm_parity(fails: Failures, model, cfg, seed: int) -> None:
    """One slot: a prefix as one chunk, then N tokens as one chunk or as N
    S=1 steps from copies of the same state.

    The kernel alone, on every layer's SSD inputs for the N tokens (taken
    from the chunk run): one N-token launch vs N one-token launches that
    carry the state, in the model's bf16 (each side's ``y`` and state
    within ``bf16_rounding_bound`` of the fp32 plain version, and that
    bound below the one-token effect) and in fp32
    (both within 1e-4 of each other).  The whole model:
    logits within 5% of their largest magnitude, the SSD and conv rows
    within 5% of theirs.  No bitwise claim: the chunked form reassociates."""
    import numpy as np
    import torch

    import repro_torch.kernels.ssd_scan as ssd_pkg
    from repro_torch.models import kvcache

    n0, n = PARITY_PREFIX, PARITY_TOKENS
    toks = torch.as_tensor(np.random.default_rng(seed + 4).integers(
        0, cfg.vocab, size=(1, n0 + n)), dtype=torch.int32).to(DEVICE)
    base = kvcache.paged_cache(model, 1, page_size=PAGE, n_pages=0, max_pages=1)
    _, base = model.decode_step(base, toks[:, :n0])

    def clone(c):
        return {k: v.clone() for k, v in c.items()}

    calls, orig = [], ssd_pkg.ssd_scan

    def spy(*args, **kw):
        calls.append(args)
        return orig(*args, **kw)

    ssd_pkg.ssd_scan = spy
    try:
        lw, whole = model.decode_step(clone(base), toks[:, n0:])
    finally:
        ssd_pkg.ssd_scan = orig
    stepped, ls = clone(base), []
    for t in range(n):
        lt, stepped = model.decode_step(stepped, toks[:, n0 + t:n0 + t + 1])
        ls.append(lt)
    sync()

    ok, worst, bf16 = len(calls) == cfg.n_layers, {}, []
    for x, dt, A, Bm, Cm, h0 in calls:
        for label, cast in (("bf16", lambda t: t), ("fp32", lambda t: t.float())):
            xx, bb, cc = cast(x), cast(Bm), cast(Cm)
            y_chunk, h_chunk = orig(xx, dt, A, bb, cc, h0)
            h, ys = h0, []
            for t in range(n):
                y_t, h = orig(xx[:, t:t + 1], dt[:, t:t + 1], A, bb[:, t:t + 1],
                              cc[:, t:t + 1], h)
                ys.append(y_t)
            y_steps = torch.cat(ys, 1)
            if label == "bf16":
                # each side against the fp32 plain version within the bound:
                # the chunk on the tensor-core chunk kernel (hi + lo splits),
                # the steps on the decode kernel (fp32, no split)
                args = (xx, dt, A, bb, cc, h0)
                for m in (ssd_bf16_margins(y_chunk, h_chunk, args, split=True),
                          ssd_bf16_margins(y_steps, h, args, split=False)):
                    ok &= (m["within_y"] and m["within_h"] and m["finite"]
                           and m["row_bound"] < m["drop"])
                    bf16.append(m)
            else:
                ok &= ssd_close(y_steps, y_chunk, 1e-4) and ssd_close(h, h_chunk, 1e-4)
            dy = (y_steps.float() - y_chunk.float()).abs().max().item()
            dh = (h - h_chunk).abs().max().item()
            wy, wh = worst.get(label, (0.0, 0.0))
            worst[label] = (max(wy, dy), max(wh, dh))
    summary = {k: max(m[k] for m in bf16) for k in ("ratio_y", "ratio_h")} if bf16 else {}
    seen = sorted(m["row_bound"] / m["drop"] for m in bf16) or [0.0]
    fails.check(ok, f"SSD kernel, {n}-token chunk vs {n} one-token launches carrying the "
                f"state, {len(calls)} layers: max |delta| (y, h) {worst}; bf16 chunk and "
                f"steps each within bf16_rounding_bound of the plain version (largest "
                f"err / bound {summary}), and on the row of the token whose input moves it "
                f"most the bound below that move (bound / move over layers and sides: median "
                f"{seen[len(seen) // 2]:.3g}, largest {seen[-1]:.3g}); fp32 within 1e-4")

    lw = lw[0, :, :cfg.vocab].float()
    lsteps = torch.cat(ls, 1)[0, :, :cfg.vocab].float()
    dl, scale = (lw - lsteps).abs().max().item(), lw.abs().max().item()
    deltas = {key: (whole[key].float() - stepped[key].float()).abs().max().item()
              for key in ("ssm", "conv")}
    scales = {key: whole[key].float().abs().max().item() for key in ("ssm", "conv")}
    print(f"  whole model, {n}-token chunk vs {n} S=1 steps: max |delta| logits {dl:.4g} "
          f"(scale {scale:.4g}), states {deltas} (scales {scales})")
    fails.check(dl <= AGREE_REL_TOL * scale and all(
        deltas[k] <= AGREE_REL_TOL * scales[k] for k in deltas),
        f"whole model chunk vs S=1 steps within {AGREE_REL_TOL} of each scale")


# -- phase 15: flash-attention kernel vs its plain version ---------------------------------


FLASH_CASES = [  # (B, S, T, H, Hkv, D, window, extra)
    (1, 16, 16, 1, 1, 8, None, {}),                 # D 8, G 1
    (2, 77, 77, 4, 2, 16, 8, {}),                   # G 2, window 8, T off the tile, B 2
    (1, 12, 4, 2, 1, 8, 2, {}),                     # S > T: rows 5..11 see no key
    (1, 130, 70, 10, 1, 256, 8, {}),                # D 256, G 10, S > T under a window
    (1, 200, 130, 10, 1, 64, None, {}),             # S > T, causal only
    (2, 100, 300, 40, 8, 128, 2048, {}),            # S < T, G 5, window 2048
    (1, 2100, 2100, 10, 1, 256, 2048, {}),          # the hybrid's window in play
    (1, 1000, 1000, 40, 8, 128, None, {}),          # qwen3-14b's heads
    (2, 64, 64, 2, 2, 64, None, {"t_real": 41}),    # kv rows past t_real masked
    (1, 50, 90, 4, 2, 32, None, {"causal": False}),
]

# bf16 on the tensor-core route: several 128-row q tiles and kv stages, kv
# rows past t_real, windows
FLASH_TC_CASES = [  # (B, S, T, H, Hkv, D, window, extra)
    (2, 700, 700, 8, 2, 64, None, {"t_real": 650}),
    (1, 1000, 1000, 40, 8, 128, 300, {}),
    (1, 900, 900, 10, 1, 256, 256, {"t_real": 870}),
    (1, 520, 600, 4, 1, 128, None, {"causal": False, "t_real": 555}),
    (1, 400, 200, 2, 1, 64, 40, {}),          # S > T: rows 239..399 see no key
    (1, 300, 300, 4, 2, 80, 100, {}),         # head dims known only at run time
    (1, 260, 260, 2, 1, 48, None, {"t_real": 250}),
    (1, 200, 200, 2, 2, 192, None, {}),
]


def flash_inputs(gen, B, S, T, H, Hkv, D, dtype):
    import torch

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    return rnd(B, S, H, D), rnd(B, T, Hkv, D), rnd(B, T, Hkv, D)


def phase_flash_cases(fails: Failures, seed: int) -> None:
    import torch

    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_kernel,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_attention.kernel import route

    gen = torch.Generator(device="cuda").manual_seed(seed)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        tol = TOL[name]
        cases = FLASH_CASES + (FLASH_TC_CASES if dtype == torch.bfloat16 else [])
        for B, S, T, H, Hkv, D, window, extra in cases:
            q, k, v = flash_inputs(gen, B, S, T, H, Hkv, D, dtype)
            kw = dict(causal=extra.get("causal", True), window=window,
                      t_real=extra.get("t_real"))
            path = route(dtype, D)
            n0 = flash_attention_kernel.launches
            r0 = flash_attention_kernel.launches_by_route[path]
            got = flash_attention_kernel(q, k, v, **kw)
            want = flash_attention_plain(q, k, v, **kw)
            sync()
            err = (got.float() - want.float()).abs().max().item()
            label = (f"flash kernel ({path}) vs plain {name} [B={B} S={S} T={T} H={H} "
                     f"Hkv={Hkv} D={D} window={window}{' ' + str(extra) if extra else ''}]")
            fails.check(flash_attention_kernel.launches == n0 + 1
                        and flash_attention_kernel.launches_by_route[path] == r0 + 1
                        and err <= tol and torch.isfinite(got).all().item(),
                        f"{label}: max err {err:.3g} <= {tol}")
            if (B, S, T, H, Hkv, D, window, extra) in FLASH_TC_CASES:
                fails.check(path == "tensor_core", f"{label}: took the tensor-core route")
            if window is not None and S >= T + window:
                t_real = extra.get("t_real", T)
                mean = v[:, :t_real].float().mean(dim=1).repeat_interleave(H // Hkv, dim=1)
                e = (got[:, T + window - 1:].float() - mean[:, None]).abs().max().item()
                fails.check(e <= tol, f"{label}: rows with no key are the mean of v "
                            f"(max err {e:.3g})")
        # the model-layout entry point (k, v brought to q's dtype)
        q, k, v = flash_inputs(gen, 2, 300, 300, 40, 8, 128, dtype)
        got = flash_attention(q, k.float(), v.float(), window=64)
        err = (got.float() - flash_attention_plain(q, k, v, window=64).float()).abs().max()
        fails.check(err.item() <= tol, f"ops.flash_attention {name}: max err {err:.3g}")
    q, k, v = flash_inputs(gen, 1, 8, 8, 2, 1, 264, torch.bfloat16)
    for label, args in (("head dim 264", (q, k, v)),
                        ("float16", tuple(t[..., :64].half().contiguous() for t in (q, k, v)))):
        try:
            flash_attention_kernel(*args)
            fails.check(False, f"flash kernel refuses {label}")
        except (ValueError, TypeError) as e:
            fails.check(True, f"flash kernel refuses {label}: {e}")


# -- phase 16: the flash kernel at the prefill shapes ---------------------------------------


def flash_bound(S, T, H, Hkv, D, window, elt: int):
    """(bytes, operations) the function needs at one batch row: q, k, v read
    once and o written once; 4 D operations (Q.K^T and P.V, 2 each) per
    query head and attended (row, key) pair, causal from position 0."""
    nbytes = (2 * S * H * D + 2 * T * Hkv * D) * elt
    pairs = sum(min(i + 1, T, window or T) for i in range(S))
    return nbytes, 4 * D * H * pairs


DROP_TILE = 64


def dropped_tile_effect(q, k, v, window, tile: int = DROP_TILE) -> float:
    """Max |change| of the last row's output (fp32, every head) when the
    one ``tile``-key tile in the middle of its attended keys is left out:
    the size of the error a kernel that lost a tile would make there."""
    import torch

    B, S, H, D = q.shape
    Hkv = k.shape[2]
    i = S - 1
    lo = 0 if window is None else max(0, i - window + 1)
    keys = torch.arange(lo, i + 1, device=q.device)
    c0 = tile * ((lo + i + 1) // (2 * tile))
    keep = (keys < c0) | (keys >= c0 + tile)
    qi = q[:, i].float().reshape(B, Hkv, H // Hkv, D) / math.sqrt(D)
    kk, vv = k[:, keys].float(), v[:, keys].float()

    def attend(sel):
        p = torch.softmax(torch.einsum("bhgd,bthd->bhgt", qi, kk[:, sel]), dim=-1)
        return torch.einsum("bhgt,bthd->bhgd", p, vv[:, sel])

    return (attend(torch.ones_like(keep)) - attend(keep)).abs().max().item()


def phase_flash_timing(fails: Failures, seed: int, label: str, shape, window,
                       launches: int) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_kernel, flash_attention_plain
    from repro_torch.kernels.flash_attention.kernel import route
    from repro_torch.kernels.flash_attention.ref import bf16_rounding_bound

    B, S, H, Hkv, D = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    nbytes, ops = flash_bound(S, S, H, Hkv, D, window, 2)
    sets = input_sets(lambda i: flash_inputs(gen, B, S, S, H, Hkv, D, torch.bfloat16),
                      B * nbytes)
    n = len(sets)
    got = flash_attention_kernel(*sets[0], window=window)
    want = flash_attention_plain(*sets[0], window=window)
    max_err = (got.float() - want.float()).abs().max().item()
    fails.check(max_err <= TOL["bfloat16"],
                f"flash kernel vs plain at {label} {shape}: max err {max_err:.3g}")
    # bf16's 3e-2 is about the size of a typical |o| over thousands of keys;
    # fp32 on the same inputs holds every kv tile of the long rows to 2e-4
    q32, k32, v32 = (t.float() for t in sets[0])
    # the fp32 plain version on the same bf16 values, and the per-element
    # bound of the bf16 kernel's two roundings (P before P.V, o at the store)
    want32, bound = bf16_rounding_bound(*sets[0], window=window)
    err32 = (flash_attention_kernel(q32, k32, v32, window=window)
             - want32).abs().max().item()
    rms = want32.square().mean().sqrt().item()
    fails.check(err32 <= TOL["float32"],
                f"flash kernel vs plain fp32 at {label} {shape}: max err {err32:.3g} "
                f"<= {TOL['float32']} (output rms {rms:.3g})")
    # The bf16 kernel against the fp32 plain version within that bound, per
    # element; the effect of dropping one tile of the last row is printed
    # beside the bound's largest value on that row.
    excess = ((got.float() - want32).abs() - bound).max().item()
    err_vs32 = (got.float() - want32).abs().max().item()
    last_tol = bound[:, -1].max().item()
    drop = dropped_tile_effect(q32, k32, v32, window)
    fails.check(excess <= 0 and last_tol < drop,
                f"flash kernel ({route(torch.bfloat16, D)}) bf16 vs plain fp32 on the same "
                f"values at {label}: max err {err_vs32:.3g}, every element within 1e-5 + "
                f"2^-8 (|o| + sum p|v| / l) (worst margin {-excess:.3g}); on the last row "
                f"that bound is at most {last_tol:.3g}, and leaving out its middle "
                f"{DROP_TILE}-key tile moves it by up to {drop:.3g}")
    del q32, k32, v32, want32, bound
    mask = None
    if window is not None:
        i = torch.arange(S, device="cuda")
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)

    def library(j):
        q, k, v = (t.transpose(1, 2) for t in sets[j % n])
        if mask is None:
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=H != Hkv)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=H != Hkv)

    lib_err = (got.float() - library(0).transpose(1, 2).float()).abs().max().item()
    fails.check(lib_err <= TOL["bfloat16"],
                f"flash kernel vs scaled_dot_product_attention at {label}: max err "
                f"{lib_err:.3g}")
    ms = cuda_time_ms(lambda j: flash_attention_kernel(*sets[j % n], window=window),
                      max(n, 10), warmup=2)
    plain_ms = cuda_time_ms(lambda j: flash_attention_plain(*sets[j % n], window=window),
                            3, warmup=1)
    library_ms = cuda_time_ms(library, max(n, 10), warmup=2)
    ms_again = cuda_time_ms(lambda j: flash_attention_kernel(*sets[j % n], window=window),
                            max(n, 10), warmup=0)
    dev_ms = device_ms_per_launch(lambda j: flash_attention_kernel(*sets[j % n], window=window),
                                  n, "flash_attn_kernel")
    t_bytes = B * nbytes / HBM_BYTES_PER_S
    t_bf16, t_fp32 = B * ops / BF16_FLOPS_PER_S, B * ops / FP32_FLOPS_PER_S
    bound_ms = max(t_bytes, t_bf16) * 1e3
    print(f"  flash {label} {shape} window={window} bf16 ({n} input sets): kernel {ms:.4f} ms "
          f"(again {ms_again:.4f}; device time per launch {dev_ms} ms, "
          f"{B * ops / (ms * 1e-3) / 1e12:.2f} TFLOP/s), plain {plain_ms:.4f} ms, SDPA "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms at 989 TFLOP/s bf16 "
          f"({t_fp32 * 1e3:.4f} ms at 67 TFLOP/s fp32; {B * nbytes / 1e6:.2f} MB, "
          f"{B * ops / 1e9:.2f} GFLOP)")
    return {"name": "flash_attention", "route": "cuda", "kernel_route": route(torch.bfloat16, D),
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:73",
            "shape": f"{label} prefill: q {B}x{S}x{H}x{D}, kv heads {Hkv}, "
                     f"{'causal' if window is None else f'window {window}'}, bf16",
            "launches": launches, "max_abs_err": max_err, "max_abs_err_fp32": err32,
            "max_abs_err_vs_fp32_plain": err_vs32, "last_row_bound": last_tol,
            "dropped_tile_effect": drop,
            "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_bf16 else "operations",
            "bound_fp32_ms": max(t_bytes, t_fp32) * 1e3, "library_ms": library_ms}


# -- phases 17-18: qwen3-14b from per-slot rings ----------------------------------------------


def phase_ring_traces(model, cfg, sched, seed: int) -> None:
    """One 4096-token ring prefill and one decode step of all slots traced
    (the decode writes into the finished serving run's rings)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed + 2)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, size=(1, Q_PROMPT)),
                           dtype=torch.int32).to(DEVICE)
    profile_step(f"ring prefill of {Q_PROMPT}",
                 lambda: model.prefill(toks, seq_len=Q_PROMPT + Q_MAX_NEW))
    last = sched.last_tokens[:, None]
    profile_step(f"ring decode step, {SLOTS} slots",
                 lambda: model.decode_step(sched.cache, last))
    trace_graphs("ring scheduler", sched)


def phase_ring_agreement(fails: Failures, model, cfg, seed: int, *, prompt: int = Q_PROMPT,
                         max_new: int = Q_MAX_NEW) -> None:
    """Last-position logits of one ``prompt``-token prompt: the ring prefill
    (every layer through the flash kernel) against paged chunked prefill
    (chunks of 256 through ``sdpa`` over the gathered pool)."""
    import numpy as np
    import torch

    from repro_torch.models import kvcache
    from repro_torch.serve.engine import make_chunk_step

    rng = np.random.default_rng(seed + 3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, size=(1, prompt)),
                           dtype=torch.int32).to(DEVICE)
    max_seq = prompt + max_new
    mp = -(-max_seq // PAGE)
    step = make_chunk_step(model)

    def chunked():
        cache = kvcache.paged_cache(model, 1, page_size=PAGE, n_pages=mp, max_pages=mp)
        kvcache.set_page_row(cache, 0, np.arange(mp))
        for lo in range(0, prompt, CHUNK):
            logits, cache = step(cache, toks[:, lo:lo + CHUNK], 0)
        return logits[0, -1, :cfg.vocab].float()

    routes = RouteLog(cfg) if cfg.family == "moe" else None
    with routes.record() if routes else contextlib.nullcontext():
        ring = model.prefill(toks, seq_len=max_seq)[0][0, -1, :cfg.vocab].float()
    with routes.compare() if routes else contextlib.nullcontext():
        paged = chunked()
    diff = (ring - paged).abs().max().item()
    scale = paged.abs().max().item()
    print(f"  last-position logits: max |paged chunked| {scale:.4f}, max |delta| {diff:.4g}, "
          f"argmax ring {ring.argmax().item()} / paged {paged.argmax().item()}")
    what = "ring prefill (flash) vs paged chunked prefill logits"
    if routes:
        print(f"  free-running, {routes.report()}")
        with routes.force():
            paged = chunked()
        diff = (ring - paged).abs().max().item()
        what += ", the chunks' experts forced to the ring prefill's routes"
    fails.check(math.isfinite(diff) and diff <= AGREE_REL_TOL * scale,
                f"{what}: max |delta| {diff:.4g} <= {AGREE_REL_TOL} x {scale:.4f}")


# -- phase 21: the grouped expert kernel and the router kernel vs their plain versions -----


# (T tokens, E, k, D, F, routing, shared expert): P = T k pairs
MOE_CASES = [
    (1, 4, 1, 64, 32, "random", False),           # P = 1
    (1, 4, 2, 64, 32, "random", False),           # P = 2
    (3, 4, 2, 64, 32, "one", True),               # every pair on one expert
    (37, 64, 6, 64, 32, "random", True),          # empty experts, ragged segments
    (1, 64, 6, 2048, 1408, "random", False),      # P = 6
    (8, 64, 6, 2048, 1408, "random", True),       # moonshot decode, 8 slots: P = 48
    (200, 64, 6, 2048, 1408, "half", True),       # half the experts empty
    (256, 64, 6, 2048, 1408, "random", True),     # moonshot chunk: P = 1536
    (4096, 64, 6, 2048, 1408, "random", True),    # moonshot ring prefill: P = 24576
    (2048, 8, 2, 64, 32, "random", True),         # segments of ~512 rows: 128-row tiles
    (64, 128, 8, 4096, 1536, "random", False),    # qwen3-moe widths: P = 512
    (700, 128, 8, 4096, 1536, "one", False),      # P = 5600 on one expert (88 tiles)
]
MOE_TIMED = ((8, "decode, 8 slots"), (CHUNK, f"chunk of {CHUNK}"),
             (4096, "ring prefill of 4096"))      # moonshot's T per layer on the main path


def moe_routing(gen, T: int, E: int, k: int, kind: str):
    """(T k,) expert ids, token-major: ``random`` k distinct experts per
    token, uniform (the spread of a trained router at its best);
    ``half`` the same over the first E / 2; ``one`` every pair on E / 2."""
    import torch

    if kind == "one":
        return torch.full((T * k,), E // 2, dtype=torch.int32, device=DEVICE)
    pool = E // 2 if kind == "half" else E
    scores = torch.rand(T, pool, generator=gen, device=gen.device).to(DEVICE)
    return scores.argsort(dim=-1)[:, :k].reshape(-1).to(torch.int32)


def moe_inputs(gen, T, E, k, D, F, kind, shared):
    """The layer's rows x (T, D), its pairs in expert order, their offsets
    and expert weights (and a shared expert 2F wide), bf16, weights scaled
    as the model draws them."""
    import torch

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=gen.device) * scale).to(
            device=DEVICE, dtype=torch.bfloat16)

    e_flat = moe_routing(gen, T, E, k, kind)
    order = torch.argsort(e_flat, stable=True)
    offsets = torch.searchsorted(e_flat[order], torch.arange(E + 1, dtype=torch.int32,
                                                             device=DEVICE), out_int32=True)
    x = rnd(T, D)
    xs = x[torch.div(order, k, rounding_mode="floor")].contiguous()
    experts = {"w_gate": rnd(E, D, F, scale=D ** -0.5), "w_up": rnd(E, D, F, scale=D ** -0.5),
               "w_down": rnd(E, F, D, scale=F ** -0.5)}
    sh = None
    if shared:
        sh = {"w_gate": rnd(D, 2 * F, scale=D ** -0.5), "w_up": rnd(D, 2 * F, scale=D ** -0.5),
              "w_down": rnd(2 * F, D, scale=(2 * F) ** -0.5)}
    return x, xs, offsets, experts, sh


def moe_plain_layer(x, xs, offsets, experts, sh):
    """The plain version of the two launches ``expert_ffn`` makes."""
    from repro_torch.kernels.moe_experts import moe_experts_plain

    h, h_s = moe_experts_plain("swiglu", xs, offsets, experts["w_gate"], experts["w_up"],
                               None if sh is None else (x, sh["w_gate"], sh["w_up"]))
    return moe_experts_plain("plain", h, offsets, experts["w_down"],
                             shared=None if sh is None else (h_s, sh["w_down"], None))


def moe_rel_err(got, want) -> tuple:
    """(max |got - want|, max |want|) over both outputs."""
    err = scale = 0.0
    for g, w in zip(got, want):
        if w is not None:
            err = max(err, (g.float() - w.float()).abs().max().item())
            scale = max(scale, w.float().abs().max().item())
    return err, scale


def phase_moe_cases(fails: Failures, seed: int) -> None:
    """Every case through ``expert_ffn`` (the model's two launches) against
    the plain version, within 3e-2 of the output's largest magnitude; row
    invariance and a CUDA graph's replay bitwise; the router kernel against
    the fp32 product."""
    import torch

    from repro_torch.kernels.moe_experts import (expert_ffn, library_plan, moe_experts_kernel,
                                                 moe_router_kernel, moe_router_plain, plan)
    from repro_torch.kernels.moe_experts.kernel import ROUTES

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    tol = TOL["bfloat16"]
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    routes_seen = set()
    for T, E, k, D, F, kind, shared in MOE_CASES:
        x, xs, offsets, experts, sh = moe_inputs(gen, T, E, k, D, F, kind, shared)
        P, R = T * k, (T if shared else 0)
        plans = {(mode, n0, n1): library_plan(mode, P, E, n0, R, n1)
                 for mode, n0, n1 in (("swiglu", F, 2 * F), ("plain", D, D))}
        mirror = {key: plan.make_plan(key[0], P, E, key[1], R, key[2], n_sms) for key in plans}
        fails.check(plans == mirror, f"moe_experts plan [P={P} E={E}]: the library's "
                    f"{list(plans.values())} == plan.py's")
        route = f"wgmma_bm{plans[('swiglu', F, 2 * F)].bm}"
        before = moe_experts_kernel.launches
        by_route = dict(moe_experts_kernel.launches_by_route)
        got = expert_ffn("swiglu", xs, offsets, experts, None if sh is None else (x, sh))
        want = moe_plain_layer(x, xs, offsets, experts, sh)
        sync()
        err, scale = moe_rel_err(got, want)
        hit = int((offsets[1:] > offsets[:-1]).sum())
        took = {r: n - by_route[r] for r, n in moe_experts_kernel.launches_by_route.items()
                if n != by_route[r]}
        fails.check(moe_experts_kernel.launches == before + 2 and err <= tol * scale
                    and took == {route: 2}
                    and all(torch.isfinite(g.float()).all().item() for g in got if g is not None),
                    f"moe_experts vs plain [T={T} E={E} k={k} P={P} D={D} F={F} {kind}, "
                    f"{hit} experts hit, shared {shared}]: 2 launches on {route} ({took}), max "
                    f"err {err:.3g} <= {tol} x {scale:.4g}")
        routes_seen.update(took)
        if D == 2048 and T in (CHUNK, 4096):
            # row invariance: a row alone (and its token's shared row) bitwise
            # the same row inside the 1536-row call, and inside the
            # 24576-row call, whose segments take 128-row tiles
            same = True
            bounds = offsets.tolist()
            for r in (0, 777, T * k - 1):
                e = bisect.bisect_right(bounds, r) - 1
                one_off = torch.zeros(E + 1, dtype=torch.int32, device=DEVICE)
                one_off[e + 1:] = 1
                t = r % T
                ys, y_s = expert_ffn("swiglu", xs[r:r + 1], one_off, experts,
                                     (x[t:t + 1].contiguous(), sh))
                same &= torch.equal(ys[0], got[0][r]) and torch.equal(y_s[0], got[1][t])
            fails.check(same, f"moe_experts row invariance: rows 0, 777, {T * k - 1} alone "
                        "(1-row calls on 64-row tiles, with their shared rows) bitwise the same "
                        f"rows of the {T * k}-row call ({route})")
        if (T, D) == (CHUNK, 2048):
            # one launch captured in a CUDA graph, replayed: bitwise the eager launch
            eager, _ = moe_experts_kernel("swiglu", xs, offsets, experts["w_gate"],
                                          experts["w_up"])
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                moe_experts_kernel("swiglu", xs, offsets, experts["w_gate"], experts["w_up"])
            torch.cuda.current_stream().wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            gc.collect()    # no garbage CUDAGraph freed (and destroyed) mid-capture
            with torch.cuda.graph(graph):
                captured, _ = moe_experts_kernel("swiglu", xs, offsets, experts["w_gate"],
                                                 experts["w_up"])
            captured.zero_()
            graph.replay()
            sync()
            fails.check(torch.equal(captured, eager),
                        "moe_experts launch captured in a CUDA graph: replay bitwise the "
                        "eager launch")
        del x, xs, offsets, experts, sh, got, want
        torch.cuda.empty_cache()
    fails.check(routes_seen == set(ROUTES),
                f"moe_experts cases ran every route the kernel has: {sorted(routes_seen)}")
    print(f"  launches by route: {moe_experts_kernel.launches_by_route}")
    # the router: fp32 within 1e-5 of the largest logit, row-invariant
    for T, D, E in ((1, 64, 4), (8, 2048, 64), (CHUNK, 2048, 64), (4096, 2048, 64),
                    (37, 4096, 128)):
        xr = torch.randn(T, D, generator=gen, device=gen.device).to(torch.bfloat16)
        wr = torch.randn(D, E, generator=gen, device=gen.device) * D ** -0.5
        got = moe_router_kernel(xr, wr)
        want = moe_router_plain(xr, wr)
        ref = xr.double() @ wr.double()
        err = (got.double() - ref).abs().max().item()
        scale = ref.abs().max().item()
        one = moe_router_kernel(xr[T - 1:T].contiguous(), wr)
        fails.check(err <= 1e-5 * scale and torch.equal(one[0], got[T - 1]),
                    f"moe_router vs fp64 product [T={T} D={D} E={E}]: max err {err:.3g} <= "
                    f"1e-5 x {scale:.4g} (fp32 matmul's {(want.double() - ref).abs().max().item():.3g}); "
                    "last row alone bitwise")


def moe_bound(T: int, P: int, hit: int, D: int, F: int, shared: bool):
    """(bytes, operations) of one layer's expert FFN: the weights of the
    experts hit (3 D F bf16 each) and of the shared expert, the xs rows, h
    written and read, ys written (and the shared expert's rows); 6 P D F
    operations, 6 T D 2F for the shared expert."""
    nbytes = hit * 3 * D * F * 2 + 2 * P * D * 2 + 2 * P * F * 2
    ops = 6 * P * D * F
    if shared:
        nbytes += 3 * D * 2 * F * 2 + 2 * T * D * 2 + 2 * T * 2 * F * 2
        ops += 6 * T * D * 2 * F
    return nbytes, ops


def moe_schedule(offsets, P: int, E: int, D: int, F: int, T: int) -> None:
    """Prints the two launches' schedules: the library's plan (tile rows,
    ring, shared memory, grid) and the work items of gate/up (N = F, shared
    2F) and of down (N = D) per SM, as ``kernels/moe_experts/plan.py``'s
    item map counts them over these offsets (the kernel's own list stays on
    the device)."""
    from repro_torch.kernels.moe_experts import library_plan, plan

    offs = offsets.tolist()
    for label, mode, n0, n1 in (("gate/up", "swiglu", F, 2 * F), ("down", "plain", D, D)):
        pl = library_plan(mode, P, E, n0, T, n1)
        n = len(plan.items(offs, P, n0, T, n1, bm=pl.bm))
        per = plan.items_per_block(n, pl.grid)
        print(f"  moe_experts {label} schedule: wgmma_bm{pl.bm}, {pl.stages}-stage ring, "
              f"{pl.smem} B shared memory, {pl.grid} blocks (one an SM); plan.py's item map: "
              f"{n} work items, {n / pl.grid:.2f} per SM ({min(per)}-{max(per)})")


def ptxas_report(fails: Failures, src: str, kernel: str, instances: int) -> None:
    """Prints ``ptxas -v``'s registers, spills and warnings for each instance of
    ``kernel`` in the build of ``src``; fails unless all ``instances`` are in
    the build's log and none has a wgmma serialised by ``ptxas`` (C7515,
    C7517 or C7518: a wait after each wgmma)."""
    from repro_torch.kernels import build

    name, seen, serialised = None, set(), []
    for line in build.build_log(src).splitlines():
        serial = re.search(r"\(C75(15|17|18)\)", line)
        if "Compiling entry" in line:
            m = re.search(rf"{kernel}ILi(\d)ELi(\d)E", line)
            name = m and f"{kernel}<mode {m.group(1)}, {m.group(2)} consumer warpgroup(s)>"
            if name:
                seen.add(name)
        elif serial or (kernel in line and ("Performance Loss" in line or "injected" in line)):
            print(f"  ptxas warning: {line.strip()}")
            if serial:
                serialised.append(line.strip())
        elif name and ("Used" in line or "spill" in line):
            print(f"  ptxas {name}: {line.strip().replace('ptxas info    : ', '')}")
    fails.check(len(seen) == instances and not serialised,
                f"ptxas report of {src}.cu: {len(seen)} of {instances} instances of {kernel}, "
                f"{len(serialised)} with a wgmma serialised (C7515/C7517/C7518)")


def grouped_mm_layer(x, xs, offsets, experts, sh):
    """The layer's expert FFN through ``torch._grouped_mm`` (the yardstick,
    never on the port's path) and plain matmuls for the shared expert; None
    where this torch has no grouped product that takes these operands."""
    import torch
    import torch.nn.functional as F

    mm = getattr(torch, "_grouped_mm", None)
    if mm is None:
        return None
    ends = offsets[1:]

    def fn():
        g = mm(xs, experts["w_gate"], offs=ends)
        u = mm(xs, experts["w_up"], offs=ends)
        y = mm(F.silu(g) * u, experts["w_down"], offs=ends)
        hs = F.silu(x @ sh["w_gate"]) * (x @ sh["w_up"])
        return y, hs @ sh["w_down"]
    return fn


def phase_moe_timing(fails: Failures, seed: int, T: int, label: str) -> list:
    """moonshot's expert FFN of one layer (the two launches, with the
    shared expert) at T tokens x 6 = P pairs, uniform routing, against its
    plain version (a ``torch.matmul`` per expert), ``torch._grouped_mm``
    where this torch has it, and its bound; and the router kernel at the
    same T against the fp32 matmul.  The weights of one layer are 1.1 GB:
    every launch streams its experts from HBM."""
    import torch

    from repro_torch.kernels.moe_experts import expert_ffn, moe_experts_kernel, moe_router_kernel

    E, k, D, F = 64, 6, 2048, 1408
    gen = torch.Generator(device="cuda").manual_seed(seed + T)
    x, xs, offsets, experts, sh = moe_inputs(gen, T, E, k, D, F, "random", True)
    P = T * k
    hit = int((offsets[1:] > offsets[:-1]).sum())
    by_route = dict(moe_experts_kernel.launches_by_route)
    got = expert_ffn("swiglu", xs, offsets, experts, (x, sh))
    tile_route = "+".join(r for r, n in moe_experts_kernel.launches_by_route.items()
                          if n != by_route[r])
    want = moe_plain_layer(x, xs, offsets, experts, sh)
    err, scale = moe_rel_err(got, want)
    fails.check(err <= TOL["bfloat16"] * scale,
                f"moe_experts at {label} (P={P}) on {tile_route}: max err {err:.3g} <= 3e-2 x "
                f"{scale:.4g}")
    moe_schedule(offsets, P, E, D, F, T)
    iters = 20 if P <= 2048 else 10
    ms = cuda_time_ms(lambda i: expert_ffn("swiglu", xs, offsets, experts, (x, sh)), iters)
    plain_ms = cuda_time_ms(lambda i: moe_plain_layer(x, xs, offsets, experts, sh), 5,
                            warmup=1)
    ms_again = cuda_time_ms(lambda i: expert_ffn("swiglu", xs, offsets, experts, (x, sh)),
                            iters, warmup=0)
    dev_ms = device_ms_per_launch(lambda i: expert_ffn("swiglu", xs, offsets, experts,
                                                       (x, sh)), 10, "moe_experts_kernel")
    library_ms, lib_note = None, "torch._grouped_mm: absent"
    gmm = grouped_mm_layer(x, xs, offsets, experts, sh)
    if gmm is not None:
        try:
            lib = gmm()
            lib_err, _ = moe_rel_err(lib, want)
            library_ms = cuda_time_ms(lambda i: gmm(), iters)
            lib_note = f"torch._grouped_mm {library_ms:.4f} ms (max err {lib_err:.3g})"
        except (RuntimeError, TypeError, ValueError, NotImplementedError) as e:
            lib_note = f"torch._grouped_mm refused these operands: {str(e).splitlines()[0][:160]}"
    nbytes, ops = moe_bound(T, P, hit, D, F, True)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    print(f"  moe_experts {label}: P={P}, {hit} of {E} experts hit + the shared expert; "
          f"layer (2 launches) {ms:.4f} ms (again {ms_again:.4f}; device time per launch "
          f"{dev_ms} ms), {ops / (ms * 1e-3) / 1e12:.1f} TFLOP/s, "
          f"{nbytes / (ms * 1e-3) / 1e12:.2f} TB/s; plain (matmul per expert) {plain_ms:.4f} ms; "
          f"{lib_note}; bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP)")
    record = {"name": "moe_experts", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/moe_experts.cu",
              "replaces": "src/repro/models/moe.py:53 (_dispatch_ffn einsums; no Pallas kernel)",
              "shape": f"moonshot {label}: one layer's 2 launches, P={P} pairs ({T} tokens "
                       f"x top-{k}), {hit} experts hit, D={D} F={F}, shared 2F, bf16",
              "launches": None, "tile_route": tile_route, "experts_hit": hit,
              "max_abs_err": err, "ms": ms,
              "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": "bytes" if t_bytes >= t_ops else "operations",
              "library_ms": library_ms}
    # the router at the same T
    w = torch.randn(D, E, generator=gen, device="cuda") * D ** -0.5
    xf = x.contiguous()
    lr = moe_router_kernel(xf, w)
    ref = xf.float() @ w
    r_err = (lr - ref).abs().max().item()
    r_ms = cuda_time_ms(lambda i: moe_router_kernel(xf, w), 40)
    r_dev = device_ms_per_launch(lambda i: moe_router_kernel(xf, w), 20, "moe_router_kernel")
    r_lib = cuda_time_ms(lambda i: xf.float() @ w, 40)
    r_bytes, r_ops = T * D * 2 + D * E * 4 + T * E * 4, 2 * T * D * E
    rb, ro = r_bytes / HBM_BYTES_PER_S, r_ops / FP32_FLOPS_PER_S
    print(f"  moe_router {label}: ({T}, {D}) x ({D}, {E}) fp32: kernel {r_ms:.4f} ms "
          f"(device time per launch {r_dev} ms), "
          f"fp32 matmul {r_lib:.4f} ms, bound {max(rb, ro) * 1e3:.5f} ms, max err {r_err:.3g}")
    router = {"name": "moe_router", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/moe_experts.cu",
              "replaces": "src/repro/models/moe.py:170 (router einsum in fp32; no Pallas kernel)",
              "shape": f"moonshot {label}: x ({T}, {D}) bf16 . w ({D}, {E}) fp32",
              "launches": None, "max_abs_err": r_err, "ms": r_ms, "device_ms": r_dev,
              "plain_ms": r_lib,
              "bound_ms": max(rb, ro) * 1e3, "bound_by": "bytes" if rb >= ro else "operations",
              "library_ms": r_lib}
    return [record, router]


# -- phases 22-23: moonshot-v1-16b-a3b (MoE) paged and from rings ----------------------------


def phase_moe_parity(fails: Failures, model, cfg, seed: int) -> None:
    """One slot: a prefix as one chunk, then N tokens as one chunk or as N
    S=1 steps from copies of the same state.  Gated, bitwise: on every
    layer's MoE input taken from the chunk run, ``moe_ffn`` over the N
    tokens equals ``moe_ffn`` of each token alone (router, routing, both
    launches, the shared expert and the combine).  Printed: the same
    comparison through the whole model (cuBLAS picks its attention
    projections' kernels by row count)."""
    import numpy as np
    import torch

    from repro_torch.models import kvcache
    from repro_torch.models import moe as moe_mod

    n0, n = PARITY_PREFIX, PARITY_TOKENS
    n_pages = -(-(n0 + n) // PAGE)
    toks = torch.as_tensor(np.random.default_rng(seed + 4).integers(
        0, cfg.vocab, size=(1, n0 + n)), dtype=torch.int32).to(DEVICE)
    base = kvcache.paged_cache(model, 1, page_size=PAGE, n_pages=n_pages, max_pages=n_pages)
    base["page_table"][0] = torch.arange(n_pages, dtype=torch.int32)
    _, base = model.decode_step(base, toks[:, :n0])

    def clone(c):
        return {k_: v.clone() for k_, v in c.items()}

    inputs = []
    orig = moe_mod.moe_ffn

    def spy(p, cfg_, h, **kw):
        inputs.append((p, h))
        return orig(p, cfg_, h, **kw)

    moe_mod.moe_ffn = spy
    try:
        lw, whole = model.decode_step(clone(base), toks[:, n0:])
    finally:
        moe_mod.moe_ffn = orig
    stepped, ls = clone(base), []
    for t in range(n):
        lt, stepped = model.decode_step(stepped, toks[:, n0 + t:n0 + t + 1])
        ls.append(lt)
    ok = len(inputs) == cfg.n_layers
    worst = 0.0
    for p, h in inputs:
        chunk, _ = orig(p, cfg, h, no_drop=True)
        steps = torch.cat([orig(p, cfg, h[:, t:t + 1].contiguous(), no_drop=True)[0]
                           for t in range(n)], dim=1)
        ok &= torch.equal(chunk, steps)
        worst = max(worst, (chunk.float() - steps.float()).abs().max().item())
    sync()
    fails.check(ok, f"MoE layer output, {n}-token chunk vs {n} one-token calls on the same "
                f"inputs, {len(inputs)} layers: bitwise (max |delta| {worst:.3g})")
    lanes = slice(n0, n0 + n)
    diffs = {key: (whole[key][:, :n_pages].flatten(1, 2)[:, lanes].float()
                   - stepped[key][:, :n_pages].flatten(1, 2)[:, lanes].float()).abs().max().item()
             for key in ("kp", "vp")}
    lg = (lw[0].float() - torch.cat(ls, dim=1)[0].float()).abs().max().item()
    print(f"  whole model, {n}-token chunk vs {n} S=1 steps: K/V max |delta| {diffs}, logits "
          f"max |delta| {lg:.4g} (|logits| up to {lw.float().abs().max().item():.4g})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    from repro_torch.models.config import layer_pattern

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fails = Failures()
    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"[1] card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {name} x{torch.cuda.device_count()}")
    secs = build.build()
    print(f"  built {', '.join(build.sources())} in {secs:.2f} s")
    for src in build.sources():
        for line in build.build_log(src).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}")

    print("[2] kernel vs plain version")
    phase_kernel_cases(fails, args.seed)
    cfg = configs.get(ARCH)
    record = phase_kernel_timing(fails, cfg, args.seed)

    print(f"[3] full-width {ARCH} serving: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}x{cfg.the_head_dim()} heads, vocab "
          f"{cfg.vocab} (padded {cfg.padded_vocab}), {cfg.param_count() / 1e9:.3f} B params")
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=args.seed)
    torch.cuda.synchronize()
    wbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"  random init in {time.perf_counter() - t0:.2f} s, weights "
          f"{wbytes / 1e9:.3f} GB")
    counts = phase_serving(fails, model, cfg, args.seed)
    fails.check(counts["paged_attention"] == cfg.n_layers * counts["steps"],
                f"paged kernel launches {counts['paged_attention']} == {cfg.n_layers} "
                f"layers x {counts['steps']} decode steps")
    fails.check(counts["flash_attention"] == 0,
                f"no flash launch in chunked prefill ({counts['flash_attention']})")
    record["shape"] = f"{ARCH} decode: B={SLOTS} Hkv={cfg.n_kv_heads} G=1 " \
                      f"D={cfg.the_head_dim()} bf16"
    record["launches"] = counts["paged_attention"]

    print("[4] backend agreement at full width")
    phase_agreement(fails, model, cfg, args.seed)
    print(f"[20] graph replay vs eager: {ARCH}, paged_kernel and gather")
    phase_graph_replay(fails, model, cfg, args.seed, f"{ARCH} paged_kernel",
                       attn_backend="paged_kernel", trace=True)
    phase_graph_replay(fails, model, cfg, args.seed, f"{ARCH} gather")
    del model
    torch.cuda.empty_cache()

    print("[5] RG-LRU scan kernel and the paged kernel at D=256 vs plain versions")
    phase_rglru_cases(fails, args.seed)
    phase_kernel_cases(fails, args.seed, cases=PAGED_CASES_D256)

    hcfg = configs.get(HYBRID)
    pat = layer_pattern(hcfg)
    n_rec, n_attn = pat.count("r"), pat.count("a")
    print(f"[6] full-width {HYBRID} serving: {hcfg.n_layers} layers ({n_rec} RG-LRU, "
          f"{n_attn} local attention, window {hcfg.hybrid.local_window}), d_model "
          f"{hcfg.d_model}, {hcfg.n_heads}x{hcfg.the_head_dim()} heads (kv "
          f"{hcfg.n_kv_heads}), lru width {hcfg.hybrid.lru_width}, vocab {hcfg.vocab}, "
          f"{hcfg.param_count() / 1e9:.3f} B params")
    t0 = time.perf_counter()
    hmodel = build_model(hcfg, device="cuda", seed=args.seed)
    torch.cuda.synchronize()
    wbytes = sum(p.numel() * p.element_size() for p in hmodel.parameters())
    nparams = sum(p.numel() for p in hmodel.parameters())
    print(f"  random init in {time.perf_counter() - t0:.2f} s, {nparams / 1e9:.3f} B "
          f"weights, {wbytes / 1e9:.3f} GB")
    hcounts = phase_serving(fails, hmodel, hcfg, args.seed, n_requests=H_REQUESTS,
                            sessions=H_SESSIONS, prompt=H_PROMPT, max_new=H_MAX_NEW)
    steps, chunks = hcounts["steps"], hcounts["chunks"]
    fails.check(hcounts["paged_attention"] == n_attn * steps,
                f"paged kernel launches {hcounts['paged_attention']} == {n_attn} "
                f"attention layers x {steps} decode steps")
    fails.check(hcounts["rglru_scan"] == n_rec * (steps + chunks)
                and hcounts["rglru_staged"] == n_rec * chunks,
                f"rglru kernel launches {hcounts['rglru_scan']} == {n_rec} RG-LRU layers "
                f"x ({steps} decode steps + {chunks} prefill chunks), "
                f"{hcounts['rglru_staged']} of them (every chunk's) on the staged kernel")
    fails.check(chunks == H_REQUESTS * -(-H_PROMPT // CHUNK),
                f"{chunks} prefill chunks == {H_REQUESTS} x ceil({H_PROMPT}/{CHUNK})")
    fails.check(hcounts["flash_attention"] == 0,
                f"no flash launch in chunked prefill ({hcounts['flash_attention']})")

    print("[7] kernels at the hybrid's serving shapes (CUDA events)")
    records = [record]
    records.append(phase_paged_timing_d256(fails, hcfg, args.seed,
                                           hcounts["paged_attention"]))
    W = hcfg.hybrid.lru_width
    # launches on the serving path by shape: a chunk launch per RG-LRU layer
    # and chunk, a decode launch per layer and step; no 2048-token chunk runs
    for shape, launches in (((1, CHUNK, W), n_rec * chunks), ((SLOTS, 1, W), n_rec * steps),
                            ((1, 2048, W), 0)):
        records.append(phase_rglru_timing(fails, args.seed, shape, launches))

    print("[8] backend agreement at full width (hybrid)")
    phase_agreement(fails, hmodel, hcfg, args.seed, prompt=H_PROMPT, max_new=H_MAX_NEW)

    print("[9] decode vs chunk prefill of one slot's recurrent rows (full width)")
    phase_recurrent_parity(fails, hmodel, hcfg, args.seed)
    print(f"[20] graph replay vs eager: {HYBRID}, paged_kernel")
    phase_graph_replay(fails, hmodel, hcfg, args.seed, f"{HYBRID} paged_kernel",
                       attn_backend="paged_kernel", trace=True)

    print(f"[19] {HYBRID} in ring mode on phase 6's model: {R_REQUESTS} requests, prompt "
          f"{R_PROMPT} (window {hcfg.hybrid.local_window}), {R_MAX_NEW} new")
    rcounts = phase_serving(fails, hmodel, hcfg, args.seed, n_requests=R_REQUESTS,
                            sessions=R_SESSIONS, prompt=R_PROMPT, max_new=R_MAX_NEW,
                            attn_backend="gather", kv_mode="ring")
    adm, steps = rcounts["admitted"], rcounts["steps"]
    fails.check(adm == R_REQUESTS and rcounts["flash_attention"] == n_attn * adm
                and rcounts["flash_tensor_core"] == rcounts["flash_attention"],
                f"flash launches {rcounts['flash_attention']} == {n_attn} attention layers x "
                f"{adm} admissions, {rcounts['flash_tensor_core']} on the tensor cores")
    fails.check(rcounts["rglru_scan"] == n_rec * (adm + steps)
                and rcounts["rglru_staged"] == n_rec * adm,
                f"rglru kernel launches {rcounts['rglru_scan']} (staged "
                f"{rcounts['rglru_staged']}: every prefill's) == {n_rec} RG-LRU layers x "
                f"({adm} admissions + {steps} decode steps)")
    fails.check(rcounts["paged_attention"] == 0 and rcounts["ssd_scan"] == 0
                and rcounts["chunks"] == 0,
                "no paged or SSD launch and no prefill chunk in ring mode")
    r_flash = rcounts["flash_attention"]
    del hmodel
    torch.cuda.empty_cache()

    print("[10] SSD scan kernel vs its plain chunked form")
    phase_ssd_cases(fails, args.seed)

    scfg = configs.get(SSM)
    ss = scfg.ssm
    H, P, N = ss.n_heads(scfg.d_model), ss.head_dim, ss.d_state
    print(f"[11] full-width {SSM} serving: {scfg.n_layers} layers, d_model {scfg.d_model}, "
          f"d_inner {ss.d_inner(scfg.d_model)}, {H} SSD heads of {P}, d_state {N}, d_conv "
          f"{ss.d_conv}, vocab {scfg.vocab} (padded {scfg.padded_vocab}), "
          f"{scfg.param_count() / 1e9:.3f} B params")
    t0 = time.perf_counter()
    smodel = build_model(scfg, device="cuda", seed=args.seed)
    torch.cuda.synchronize()
    wbytes = sum(p.numel() * p.element_size() for p in smodel.parameters())
    nparams = sum(p.numel() for p in smodel.parameters())
    print(f"  random init in {time.perf_counter() - t0:.2f} s, {nparams / 1e9:.3f} B "
          f"weights, {wbytes / 1e9:.3f} GB")
    scounts = phase_serving(fails, smodel, scfg, args.seed, n_requests=S_REQUESTS,
                            sessions=S_SESSIONS, prompt=S_PROMPT, max_new=S_MAX_NEW,
                            attn_backend="gather")
    steps, chunks = scounts["steps"], scounts["chunks"]
    fails.check(scounts["ssd_scan"] == scfg.n_layers * (steps + chunks),
                f"ssd kernel launches {scounts['ssd_scan']} == {scfg.n_layers} layers x "
                f"({steps} decode steps + {chunks} prefill chunks)")
    fails.check(scounts["ssd_tensor_core"] == scounts["ssd_scan"],
                f"all {scounts['ssd_scan']} SSD launches, prefill and decode, took the "
                f"tensor-core route ({scounts['ssd_tensor_core']})")
    fails.check(chunks == S_REQUESTS * -(-S_PROMPT // CHUNK),
                f"{chunks} prefill chunks == {S_REQUESTS} x ceil({S_PROMPT}/{CHUNK})")
    fails.check(scounts["pages"] == 0 and scounts["paged_attention"] == 0
                and scounts["rglru_scan"] == 0 and scounts["flash_attention"] == 0,
                f"no pool pages ({scounts['pages']}) and no attention or RG-LRU launches")

    print(f"[12] SSD kernel at {SSM}'s serving shapes (CUDA events)")
    for shape, launches in (((1, CHUNK, H, P, N), scfg.n_layers * chunks),
                            ((SLOTS, 1, H, P, N), scfg.n_layers * steps),
                            ((1, 2048, H, P, N), 0)):
        records.append(phase_ssd_timing(fails, args.seed, shape, launches))

    print(f"[13] {SSM} decode step and prefill chunk: costs outside the kernel, traces")
    phase_ssm_steps(fails, smodel, scfg, args.seed)

    print("[14] decode vs chunk prefill of one SSM slot (full width)")
    phase_ssm_parity(fails, smodel, scfg, args.seed)
    print(f"[20] graph replay vs eager: {SSM}")
    phase_graph_replay(fails, smodel, scfg, args.seed, SSM)
    del smodel
    torch.cuda.empty_cache()

    print("[15] flash-attention kernel vs its plain version")
    phase_flash_cases(fails, args.seed)

    qcfg = configs.get(DENSE_RING)
    print("[16] flash kernel at the prefill shapes (CUDA events)")
    flash_shapes = (
        (DENSE_RING, (1, Q_PROMPT, qcfg.n_heads, qcfg.n_kv_heads, qcfg.the_head_dim()), None),
        (ARCH, (1, Q_PROMPT, cfg.n_heads, cfg.n_kv_heads, cfg.the_head_dim()), None),
        (HYBRID, (1, R_PROMPT, hcfg.n_heads, hcfg.n_kv_heads, hcfg.the_head_dim()),
         hcfg.hybrid.local_window))
    flash_records = [phase_flash_timing(fails, args.seed, label, shape, window, launches)
                     for (label, shape, window), launches
                     in zip(flash_shapes, (None, 0, r_flash), strict=True)]
    records.extend(flash_records)

    print(f"[17] full-width {DENSE_RING} served from per-slot rings: {qcfg.n_layers} layers, "
          f"d_model {qcfg.d_model}, {qcfg.n_heads}x{qcfg.the_head_dim()} heads over "
          f"{qcfg.n_kv_heads} kv heads, qk-norm {qcfg.qk_norm}, d_ff {qcfg.d_ff}, vocab "
          f"{qcfg.vocab}, {qcfg.param_count() / 1e9:.3f} B params")
    t0 = time.perf_counter()
    qmodel = build_model(qcfg, device="cuda", seed=args.seed)
    torch.cuda.synchronize()
    wbytes = sum(p.numel() * p.element_size() for p in qmodel.parameters())
    nparams = sum(p.numel() for p in qmodel.parameters())
    print(f"  random init in {time.perf_counter() - t0:.2f} s, {nparams / 1e9:.3f} B "
          f"weights, {wbytes / 1e9:.3f} GB")
    qcounts = phase_serving(fails, qmodel, qcfg, args.seed, n_requests=Q_REQUESTS,
                            sessions=Q_SESSIONS, prompt=Q_PROMPT, max_new=Q_MAX_NEW,
                            attn_backend="gather", kv_mode="ring",
                            then=lambda sched: phase_ring_traces(qmodel, qcfg, sched, args.seed))
    adm = qcounts["admitted"]
    fails.check(adm == Q_REQUESTS and qcounts["flash_attention"] == qcfg.n_layers * adm,
                f"flash launches {qcounts['flash_attention']} == {qcfg.n_layers} layers x "
                f"{adm} admissions")
    fails.check(qcounts["flash_tensor_core"] == qcounts["flash_attention"],
                f"all {qcounts['flash_attention']} flash launches took the tensor-core route "
                f"({qcounts['flash_tensor_core']})")
    fails.check(qcounts["paged_attention"] == 0 and qcounts["rglru_scan"] == 0
                and qcounts["ssd_scan"] == 0 and qcounts["chunks"] == 0,
                "no paged, RG-LRU or SSD launch and no prefill chunk in ring mode")
    flash_records[0]["launches"] = qcounts["flash_attention"]
    torch.cuda.empty_cache()

    print(f"[18] ring prefill (flash) vs paged chunked prefill at full width ({DENSE_RING})")
    phase_ring_agreement(fails, qmodel, qcfg, args.seed)
    print(f"[20] graph replay vs eager: {DENSE_RING} rings (decode)")
    phase_graph_replay(fails, qmodel, qcfg, args.seed, f"{DENSE_RING} ring", kv_mode="ring")
    del qmodel
    release()

    mcfg = configs.get(MOE)
    mm = mcfg.moe
    print("[21] grouped expert kernel and router kernel vs their plain versions")
    ptxas_report(fails, "moe_experts", "moe_experts_kernel", 6)
    phase_moe_cases(fails, args.seed)
    print(f"[21] kernels at {MOE}'s shapes (CUDA events)")
    moe_records = []
    for T, label in MOE_TIMED:
        moe_records.extend(phase_moe_timing(fails, args.seed, T, label))
    m_paged = phase_kernel_timing(fails, mcfg, args.seed, prompt=M_PROMPT, max_new=M_MAX_NEW,
                                  layers=M_PAGED_LAYERS)
    m_paged["shape"] = (f"{MOE} decode: B={SLOTS} Hkv={mcfg.n_kv_heads} G=1 "
                        f"D={mcfg.the_head_dim()}, {M_PROMPT}..{M_PROMPT + M_MAX_NEW - 1} live "
                        f"tokens, bf16")
    m_flash = phase_flash_timing(fails, args.seed, MOE, (1, MR_PROMPT, mcfg.n_heads,
                                                         mcfg.n_kv_heads, mcfg.the_head_dim()),
                                 None, None)
    release()

    free, total = torch.cuda.mem_get_info()
    print(f"[22] full-width {MOE} served paged: {mcfg.n_layers} layers, d_model "
          f"{mcfg.d_model}, {mcfg.n_heads}x{mcfg.the_head_dim()} heads (kv {mcfg.n_kv_heads}), "
          f"{mm.n_experts} experts top-{mm.top_k} of width {mm.d_expert} + a shared expert of "
          f"{2 * mm.d_expert}, vocab {mcfg.vocab}; param_count {mcfg.param_count() / 1e9:.3f} B "
          f"(the JAX package's count, no shared expert); free before the load "
          f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    mmodel = build_model(mcfg, device="cuda", seed=args.seed)
    torch.cuda.synchronize()
    wbytes = sum(p.numel() * p.element_size() for p in mmodel.parameters())
    nparams = sum(p.numel() for p in mmodel.parameters())
    print(f"  random init in {time.perf_counter() - t0:.2f} s, {nparams / 1e9:.3f} B weights, "
          f"{wbytes / 1e9:.3f} GB ({wbytes / 2**30:.2f} GiB); peak during init "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    mcounts = phase_serving(fails, mmodel, mcfg, args.seed, n_requests=M_REQUESTS,
                            sessions=M_SESSIONS, prompt=M_PROMPT, max_new=M_MAX_NEW)
    steps, chunks = mcounts["steps"], mcounts["chunks"]
    L = mcfg.n_layers
    fails.check(mcounts["paged_attention"] == L * steps,
                f"paged kernel launches {mcounts['paged_attention']} == {L} layers x {steps} "
                "decode steps")
    fails.check(mcounts["moe_experts"] == 2 * L * (steps + chunks)
                and mcounts["moe_experts_swiglu"] == L * (steps + chunks)
                and mcounts["moe_router"] == L * (steps + chunks),
                f"moe_experts launches {mcounts['moe_experts']} == 2 x {L} layers x ({steps} "
                f"decode steps + {chunks} chunks), half of them gate/up "
                f"({mcounts['moe_experts_swiglu']}); router launches {mcounts['moe_router']}")
    fails.check(mcounts["moe_experts_wgmma_bm64"] == mcounts["moe_experts"],
                f"every moe_experts launch of paged serving on the wgmma route with 64-row "
                f"tiles: {mcounts['moe_experts_wgmma_bm64']} of {mcounts['moe_experts']} "
                f"({mcounts['moe_experts_wgmma_bm128']} on 128-row tiles)")
    fails.check(chunks == M_REQUESTS * -(-M_PROMPT // CHUNK),
                f"{chunks} prefill chunks == {M_REQUESTS} x ceil({M_PROMPT}/{CHUNK})")
    fails.check(mcounts["flash_attention"] == 0 and mcounts["rglru_scan"] == 0
                and mcounts["ssd_scan"] == 0,
                "no flash, RG-LRU or SSD launch in chunked serving")
    m_paged["launches"] = mcounts["paged_attention"]
    for rec in moe_records:
        rec["launches"] = mcounts["moe_experts" if rec["name"] == "moe_experts"
                                  else "moe_router"]
    release()
    print(f"[22] backend agreement at full width ({MOE})")
    phase_agreement(fails, mmodel, mcfg, args.seed, prompt=M_PROMPT, max_new=M_MAX_NEW)
    release()
    print(f"[20] graph replay vs eager: {MOE}, paged_kernel")
    phase_graph_replay(fails, mmodel, mcfg, args.seed, f"{MOE} paged_kernel",
                       attn_backend="paged_kernel", trace=True)
    print(f"[22] decode vs chunk prefill of one slot's MoE layers (full width)")
    phase_moe_parity(fails, mmodel, mcfg, args.seed)
    release()

    print(f"[23] {MOE} from per-slot rings: {MR_REQUESTS} requests, prompt {MR_PROMPT}, "
          f"{MR_MAX_NEW} new, {MR_REQUESTS} slots")
    rcounts = phase_serving(fails, mmodel, mcfg, args.seed, n_requests=MR_REQUESTS,
                            sessions=MR_SESSIONS, prompt=MR_PROMPT, max_new=MR_MAX_NEW,
                            attn_backend="gather", kv_mode="ring", slots=MR_REQUESTS)
    adm, steps = rcounts["admitted"], rcounts["steps"]
    fails.check(adm == MR_REQUESTS and rcounts["flash_attention"] == L * adm
                and rcounts["flash_tensor_core"] == rcounts["flash_attention"],
                f"flash launches {rcounts['flash_attention']} == {L} layers x {adm} admissions, "
                f"{rcounts['flash_tensor_core']} on the tensor cores")
    fails.check(rcounts["moe_experts"] == 2 * L * (adm + steps)
                and rcounts["moe_router"] == L * (adm + steps),
                f"moe_experts launches {rcounts['moe_experts']} == 2 x {L} layers x ({adm} "
                f"admissions + {steps} decode steps); router {rcounts['moe_router']}")
    fails.check(rcounts["moe_experts_wgmma_bm128"] == 2 * L * adm
                and rcounts["moe_experts_wgmma_bm64"] == 2 * L * steps,
                f"every moe_experts launch of ring serving on the wgmma route: "
                f"{rcounts['moe_experts_wgmma_bm128']} on 128-row tiles == 2 x {L} x {adm} "
                f"admissions, {rcounts['moe_experts_wgmma_bm64']} on 64-row tiles == 2 x {L} x "
                f"{steps} decode steps")
    fails.check(rcounts["paged_attention"] == 0 and rcounts["rglru_scan"] == 0
                and rcounts["ssd_scan"] == 0 and rcounts["chunks"] == 0,
                "no paged, RG-LRU or SSD launch and no prefill chunk in ring mode")
    m_flash["launches"] = rcounts["flash_attention"]
    release()
    print(f"[23] ring prefill (flash) vs paged chunked prefill at full width ({MOE})")
    phase_ring_agreement(fails, mmodel, mcfg, args.seed, prompt=MR_PROMPT,
                         max_new=MR_MAX_NEW)
    records.extend(moe_records + [m_paged, m_flash])

    print(f"total {time.perf_counter() - t_start:.1f} s")
    if fails:
        print(f"chip_smoke: {len(fails)} check(s) failed:", file=sys.stderr)
        for f in fails:
            print(f"  {f}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": records}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
