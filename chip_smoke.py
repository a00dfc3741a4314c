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
    eager launch.  The ``ptxas`` report of the kernel's ten instances (six
    serving, four with a training forward's pre-activation stores) is
    printed, and fails on a wgmma that ``ptxas`` serialised (C7515, C7517,
    C7518); the work items per SM at each timed shape (``plan.py``'s item
    map over the offsets) are printed.  The
    route kernel (``moe_route``: the fp32 router product, softmax, top-k,
    renormalisation and the stable sort of the pairs, one launch) against
    ``moe_route_plain`` at T = 1, 8, 256, 4096, 8192 (D 2048, 64 experts
    top-6), 37 (D 4096, 128 top-8) and 300 tied tokens: logits within 1e-5 of the
    fp64 product, the experts equal outside near-ties of the plain gates
    (gap <= 1e-6; every mismatch counted), the weights within 1e-6
    relative of the plain routing of the kernel's own logits, the sort
    outputs exactly the plain argsort's of the kernel's own experts, the
    last row alone bitwise, ties to the lower expert; the combine kernel
    bitwise its plain version with and without the shared expert and the
    kept mask; route + combine in one CUDA graph, two replays bitwise the
    eager launches.  Timed at moonshot's P = 48 (decode, 8 slots), 1536 (a
    256-token chunk) and 24576 (a 4096-token ring prefill), uniform routing
    (the experts hit counted), beside the plain version,
    ``torch._grouped_mm`` where this torch has it, and its bound; route and
    combine at the same T beside their plain versions eager and as one
    replayed graph (its kernel nodes counted), route beside the fp32
    matmul.  The paged kernel
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
    every one on the ``wgmma`` route with 64-row tiles, route = combine =
    48 x (decode steps + chunks), no flash.  Backend agreement as
    in phase 4 (traced steps), phase 20's replay checks, and one slot's
    29-token chunk vs 29 S=1 steps: every layer's MoE output on the same
    inputs bitwise (route, the row gather, both expert launches, the
    shared expert, combine); the whole model printed, as phase 9 does.
    One layer's ``moe_ffn`` at 8, 256 and 4096 tokens: the wrappers count
    one route, two expert and one combine launch, and every aten op it
    dispatches is a view, an allocation or the one row gather (no torch
    sort, argsort, searchsorted or softmax).
23. The same model from per-slot rings: 4 requests over 4 sessions, prompt
    4096, 16 new, 4 slots.  flash = 48 x admissions, all on the tensor-core
    route; moe_experts = 2 x 48 x (admissions + decode steps), every
    launch on the ``wgmma`` route, each admission's on 128-row tiles and
    each decode step's on 64-row tiles; no paged,
    RG-LRU or SSD launch; peak memory printed.  Ring prefill vs paged
    chunked prefill logits within 5%, as in phase 18.

24. Storage-backed preemption, copy-on-write prefix sharing and session
    parking on phase 3's ``minicpm-2b`` (``paged_kernel``, 8 slots, page
    16, chunk 256), each sub-run served through ``ServingFrontend`` and a
    scheduler that audits after every step:
    (a) 16 requests over 8 sessions, prompt 512, 32 new, a pool of 136
    pages (4 slots' worst case), ``offload=True``,
    ``idle_preempt_steps=8``: at least one preemption, as many restores,
    every blob leaf on the host, every request's tokens bitwise the
    unpressured run's (default pool, offload off).  (b) 16 requests over
    8 sessions, each a shared 384-token system prompt and 128 unique
    tokens, ``prefix_sharing=True``: at least 8 index hits, 384 shared
    tokens per hit, every indexed page bitwise as published at the end.
    (c) 8 sessions x 3 turns (512 tokens, then 64 more user tokens a
    turn), ``park_sessions=True`` on a pool that holds every journal: 16
    park hits, at least 16 copy-on-write splits (each reused span ends
    inside a page), the parked pages and rows bitwise at every unpark;
    (c') the same on a pool of 8 first-turn journals + 16 pages: journals
    offload, and every park-blob restore writes back the pages parked,
    bitwise.  (b), (c) and (c') run teacher-forced on their feature-off
    run's token stream: logits within 5% of the logit scale (phase 4's
    check), the token streams they would have produced unforced counted.
    Every sub-run: paged launches exactly 40 x decode steps, one
    decode-graph capture, and the decode replay right after a restore, a
    copy-on-write split, an unpark, a park-blob restore and an index hit
    bitwise the eager step on a copy of the state (the scratch page aside:
    unmapped rows write there in no fixed order, and nothing reads it).
    Printed: ms and GB/s
    per gather to the host (preemptions and journal offloads) and per
    restore chunk, bytes offloaded, prefill tokens saved, TPOT and decode
    tok/s beside phase 3's, peak memory, and one blob's gather and host
    copy four ways (fresh, reused and given pinned memory, pageable).
25. Session parking and forced preemption on phase 6's
    ``recurrentgemma-2b`` (before phase 19): 8 sessions x 2 turns (prompt
    2300, then 64 more user tokens), 16 new, on 4 slots so that parked
    slots are evicted and their rows reinstalled elsewhere,
    ``park_sessions=True`` and ``offload=True``, and one preemption forced
    mid-decode with ``sched.preempt(i)`` in each turn.  The preempted
    requests' tokens bitwise the unpreempted run's; the ``h``, ``conv``
    and ``length`` rows of every evicted slot's host snapshot, and of every
    unpark (in place or reinstalled), bitwise the rows parked; paged
    launches exactly 8 x decode steps and RG-LRU exactly 18 x (decode
    steps + chunks); the replay checks as in phase 24.  Both phases print
    their wall time.

26. Draft-and-verify speculative decoding on the paged pool (``gather``,
    greedy), each target at full width and depth beside the same requests
    served without speculation: (a) phase 3's ``minicpm-2b`` and traffic
    (after phase 24), with a self-draft at k = 3 (the accept path; its
    acceptance must reach 0.5) and with the same config drawn from
    ``--seed`` + 7 at k = 2 (the reject path); (b) phase 6's
    ``recurrentgemma-2b`` (after phase 19), 8 requests of 512 tokens, 32
    new, 4 slots, k = 3, under a seeded 4-layer dense draft of
    minicpm-2b's widths and the target's vocab of 256000, which rejects
    nearly every proposal, so the rows' restore and the replay of the
    accepted span run almost every round (at least one); (c) phase 22's
    ``moonshot-v1-16b-a3b`` (after phase 23), a self-draft at k = 3, 4
    requests of 512 tokens on 4 slots.  Every run: every request served
    in per-session FIFO order, tokens in the vocab, ``audit()`` after every
    step, and exact launch counts: RG-LRU = 18 x (verify rounds + chunks +
    rollback replays), moe_experts = 2 x 48 x (chunks + rounds x (k + 1))
    and route = combine = 48 x the same for the MoE self-draft (a round is one
    catch-up, k - 1 draft steps and one verify), no paged or flash launch;
    without speculation the counts of phases 6 and 22 on ``gather``.  The
    identical token streams are counted; where a stream diverges, the
    target teacher-forced on the stream without speculation must have a
    top-2 logit margin within 5% of the logit scale at the first
    diverging token (a near-tie that the verify chunk's GEMM order may
    swap).  After the first speculative run, from one state with every
    slot decoding, the draft graph's and the verify graph's replays must
    be bitwise their eager steps (the scratch page aside).  Printed: ms
    per emitted token and decode tok/s with and without speculation,
    acceptance, verify steps per token, each graph's replay ms, the eager
    catch-up's ms, the hybrid rollbacks and their ms, captures, the graph
    pool, peak memory and the launch counts.
27. The elastic fleet, through ``launch/serve.build_frontend(fleet_size=N)``
    -> ``ServingFrontend(fleet=FleetController)``, membership on the port's
    ``FaaSKeeperService``, beside one unfleeted scheduler of a worker's
    shape on the same requests: (a) phase 3's ``minicpm-2b`` (after 26a),
    3 workers of 4 slots (``paged_kernel``, parking, prefix sharing, the
    index journal), 24 requests over 6 sessions in one burst (a 2-page
    system prompt; each session's 4th request extends its 3rd), a
    ``FaultPlan`` crash at ``mid-decode`` and one at ``mid-restore``,
    worker w2 wedged and reaped by a heartbeat sweep, scale to zero, then
    a cold start that re-adopts the index journal and a park-meta; (b)
    phase 6's ``recurrentgemma-2b`` (after 26b), 2 workers, 8 requests of
    2300 tokens, scale to zero and a cold start from a park-meta carrying
    recurrent rows.  Checks: every request served exactly once in
    per-session FIFO order, ``fleet.audit()`` after every tick and each
    worker's ``audit()`` after every step, zero live workers after each
    burst, only committed journals, metas and index blobs in the store at
    quiescence, the crashes and the eviction taken, streams equal to the
    unfleeted run's or split at a near-tie (as phase 26), a decode replay
    bitwise its eager step after every index adoption and meta restore
    (the scratch page aside), each adopted page bitwise its journal blob,
    each worker's graphs captured once over all its incarnations, and
    exact launch counts (paged = attention layers x worker steps, RG-LRU =
    18 x (steps + chunks)).  Printed beside the card's name and power
    limit: spawns, retires, crashes, evictions, cold starts, meta and
    journal traffic, captures, graph pools, peak memory, fleet decode
    tok/s against the unfleeted run's, ms per controller tick beyond the
    workers' steps, host gathers and the simulated invocations and cost.

28. The two families without a per-slot decode path, served as the JAX
    package serves them: ``launch/serve.build_frontend(mode='continuous')``
    falls back to the shared whole-batch flavour (one prefill and eager
    greedy decode steps a dispatched batch, rings sized prompt + budget,
    no frames and no patches), where sampling flags raise.  Full width and
    depth, random weights from ``--seed``, each model loaded alone (after
    the qwen3-14b phases, before moonshot).  (a) ``whisper-base`` (6
    encoder + 6 decoder layers, d_model 512, 8 x 64 heads, 1500 frames):
    16 requests over 4 sessions, batch 8, prompt 4, 224 new; no
    hand-written kernel launches; the encoder timed at 8 x 1500 frames;
    ``generate`` with seeded frames (8, 1500, 512), its prefill and 16
    teacher-forced decode steps within 5% of the logit scale of
    ``apply(tokens, frames)``.  (b) ``internvl2-2b`` (24 layers, 16 x 128
    heads over 8): 8 requests over 4 sessions, batch 4, text prompt 4096,
    32 new; flash launches exactly 24 x prefill batches, all on the
    tensor cores, and no other kernel; the flash prefill of 4096 tokens
    against the same prompt as two 2048-token decode chunks (last
    position within 5%); ``generate`` with seeded patches (1, 256, 1024)
    and 512 text tokens (no flash launch), teacher-forced as in (a); flash
    timed at (1, 4096, 16, 8, 128) as in phase 16.  Both: every request
    served exactly once in per-session FIFO order, each stream equal to
    the model's solo ``generate`` (B = 1) or split at a near-tie (as phase
    26).  Printed beside the card's name and power limit: weights, prefill
    ms a batch and tok/s, decode ms a step and tok/s, peak memory.

29–33. Training (``launch/train.run_training``), last, after moonshot is
    freed.  29: the flash backward (``flash_attention_backward_kernel``)
    against ``ref.py``'s plain fp32 backward, fp32 within 2e-4 and bf16
    within 3e-2 of the largest |gradient| per dq, dk and dv (D 8-256, G
    1-10, S off the tile, windows 8 and 2048, B 1 and 2; bf16 at D % 16 ==
    0 on the tensor cores, at D 64, 128 and 256 on the wgmma design, dQ
    with delta then dK/dV, its tiles the library's as ``plan.py`` models
    them; elsewhere mma.sync or the CUDA cores, delta, dK/dV, dQ), two
    launches bitwise equal, the forward with lse bitwise the forward
    without and its lse within 1e-5; the RG-LRU backward (one reverse-mode
    launch, no copies) bitwise the plain reverse fold at phase 5's shapes
    and (1, 4096, 2560).  30: both timed at the training shapes (CUDA
    events) beside the forward with lse, the plain version, SDPA's
    backward alone (its forward run before the timed region), SDPA
    forward + backward, and one library call that returns o and the
    log-sum-exp (``_scaled_dot_product_flash_attention`` causal,
    ``_scaled_dot_product_efficient_attention`` with the window's mask).  31: full-depth
    ``minicpm-2b``, 6 steps of 8 x 4096 tokens in 4 microbatches (WSD, lr
    3e-4): losses and grad norms finite, the last loss below the first,
    every parameter with a gradient, flash forward launches exactly 2 x
    40 x microsteps (forward and remat recompute) and backward 40 x
    microsteps, no paged, SSD or MoE launch; a microstep traced by kernel
    class and the optimiser update timed on a second full model.  32:
    ``recurrentgemma-2b``, 4 steps of 4 x 4096 in 4, the same checks with
    8 windowed attention and 18 RG-LRU layers.  33: at 2 layers of
    ``minicpm-2b`` (full width), (a) one step through the kernels and
    through the plain attention, loss within 1e-3 and every gradient
    within 3e-2 of its largest |value|; (b) a crash at step 7 resumed at
    step 6 through the FaaSKeeper manifest, every restored leaf checked
    against its digest, losses within 1e-3 of an uninterrupted run's, the
    checkpoint directory removed; (c) the paged decode kernel, which
    serves only, refuses a query that requires grad (every family trains
    on the card).  Printed beside the card's name and power limit: step
    ms, tokens/s, MFU, peak memory, optimiser ms.

34–36. The SSD scan's backward and mamba2 training, after phase 32.  34:
    the backward kernel (``ssd_scan_backward_kernel``: the state passes,
    the chunk kernel and a reduction; on the route ``backward_route``
    names: the tensor cores for bf16 at P a multiple of 16 and N
    64/128/256, the CUDA cores (fp32 arithmetic) for fp32 and P 4 / N 8)
    against ``ssd_scan/ref.py::ssd_scan_backward_plain`` in fp32 at
    mamba2-1.3b's dims (H 64, P 64, N 128; L 300 and 2048), a big decay, a
    ragged L, L = 1, h0 and dh_final given and not, fp32 and bf16, P 4-64,
    N 8-256: every gradient (dx, ddt, dA, dBm, dCm, dh0) per element within
    ``ref.py::bf16_backward_rounding_bound`` on the case's route and chunk
    (its fp32 analogue for fp32 inputs), the worst err / bound printed;
    leaving out one 64-token chunk's share of the state's adjoint
    (``dropped_chunk_effects``) must exceed the bound somewhere wherever
    that share reaches an earlier chunk or h0 (not at big decay, where it
    falls under bf16's resolution); two launches bitwise equal.  35: the
    backward timed at the training shape (2, 4096, 64, 64), N 128, on both
    routes (bf16 on the tensor cores, fp32 on the CUDA cores), beside the
    plain backward, its bound (bytes at 3.35 TB/s, the chunked adjoint's
    operations at 989 TFLOP/s; no library call computes it) and each
    kernel's device time; the library's tensor-core plan
    (``kernel.library_plan``) equal to ``kernels/ssd_scan/plan.py``'s at 12
    (P, N), and the route's kernels' ``ptxas`` registers and spills.  36:
    full-depth ``mamba2-1.3b`` (48 layers), 4 steps of 8 x 4096 tokens in
    4 microbatches (cosine, lr 3e-4), checked as 31 with SSD forward
    launches exactly 2 x 48 x microsteps (all on the tensor cores) and
    backward 48 x microsteps (all on the tensor cores), no flash, paged,
    RG-LRU or MoE launch.

37–39. The MoE layer's backward and moonshot training, after phase 36.
    37: the four backward kernels of ``moe_backward.cu`` through their five
    wrappers (``moe_combine_backward_kernel``, ``moe_down_grad_kernel``,
    ``moe_weight_grad_kernel``, ``moe_up_grad_kernel``,
    ``moe_route_backward_kernel``) and the gather's backward (the forward
    combine kernel with unit weights) against their plain versions of
    ``kernels/moe_experts/ref.py``, on one layer's forward state made by the
    forward kernels (the gate/up launch that saves the pre-activations
    gives h and ys bitwise as without): T 1-512, E 4-64, D 64-2048, the
    shared expert on and off, SwiGLU and GELU, capacity drops, expert 0
    with no row and expert 1 with one.  Combine and gather bitwise, the
    grouped products within 4 bf16 steps (2^-8 each) of their largest
    |element|, the route backward's dx within 2 and its dw within 1e-4;
    leaving out the largest expert's segment (one 64-token tile for the
    route) must exceed the bound; two launches bitwise; and the weight
    gradient with every odd expert's rows NaN / Inf, then 1e4-scaled: the
    even experts' dW finite and within the bound (a segment's last ring
    stage holds the next expert's rows, which the kernel clears).  The
    grouped products (``moe_data_grad_kernel``, two launches, and
    ``moe_weight_grad_kernel``) run on wgmma from TMA rings over
    persistent grids.  38: each at moonshot's training microstep (T 8192,
    P 49152, capacity 1.25): CUDA events, device time per launch
    (``queued_device_ms``: launches queued behind a device sleep, no
    profiler; a host that fell behind the sleep fails), TFLOP/s, the
    plain version, the bound, and ``torch._grouped_mm`` (or the plain
    sequence replayed as one graph) as the yardstick; for the grouped
    products their library plans held equal to ``backward_plan.py``'s
    model with its work items per SM, and ``ptxas``'s registers and
    spills of their 7 instances (a wgmma serialised fails).  39: moonshot
    at full width, cut to 4 of 48 layers, 4 steps of 8 x 4096 tokens in 4 microbatches:
    losses finite and falling, every parameter with a gradient, route,
    gate/up and down launches 2 x layers x microsteps each (forward and
    remat recompute), combine 3 x (the gather's backward too), each
    backward wrapper layers x microsteps, flash as in 31, no paged launch;
    MFU by active parameters (``active_params``: top-6 of 64 experts).
40. The paged kernel per shard of a split pool (``sharded_paged_attention``,
    the reference's shard_map decomposition): lane shards (``lane_base``,
    ``pos_stride``) at 2 and 4 shards at minicpm-2b's decode (B 8, 36 kv
    heads, D 64, page 16), moonshot's (G 1, D 128) and recurrentgemma-2b's
    (Hkv 1, G 10, D 256, a 2048 window past the context's start, and a
    3-token slot beside an unmapped one), head shards at page 9 for 36 and
    8 kv heads; each shard's launch against its plain version on its slice
    (fp32 2e-4, bf16 3e-2) and the merged shards against the unsharded
    kernel at the same tolerances.  Then shard 1 of 2 at minicpm-2b's and
    recurrentgemma-2b's serving shapes (every layer's pool rotated): CUDA
    events, device ms queued behind a sleep, the plain version, gather +
    SDPA over the shard's lanes, the in-process merge and splice, the
    unsharded launch's device ms and the shard's bound; the launches are
    the (1, 2) runs' below, summed over ranks.
41. Full-width, full-depth minicpm-2b served by ``DecodeScheduler(mesh=)``
    on (1, 2) and (2, 2) meshes of spawned ranks on the one card (gloo on
    CUDA tensors, ``launch/sharded_smoke.py``), ``paged_kernel``: 8
    requests over 4 sessions, prompt 256, 16 new, 8 slots, page 16 (a lane
    shard of 8 lanes a rank).  Tokens identical to the ``mesh=None`` run of
    the same workload (in this process) or split at a near-tie (as phase
    26); every rank's tokens agree; each rank's pool bytes 1/2 of the whole
    pool's; the collective bytes of a decode step equal at a 4x pool; the
    paged kernel launched 40 x decode steps on every rank; ms per decode
    step, tok/s and peak memory by rank printed.  Under a mesh every step
    runs eagerly (a collective cannot be captured in a graph).
42. Full-width recurrentgemma-2b on (1, 2): 8 requests, prompt 2100 (past
    the 2048-token window), 8 new, against its mesh-matched run (the same
    sharded scheduler, one request at a time), tokens identical; pool and
    bytes as in 41; paged launches 8 x decode steps and RG-LRU launches 18
    x (decode steps + chunks) on every rank.
43. The SSD scan per head shard (``ssd_scan_shard``) at mamba2-1.3b's
    serving shapes (a 256-token chunk from a live state, a decode step at
    B 8), 2 and 4 shards: each against its plain version (the scan's bf16
    bound) and bitwise against the same heads of the unsharded launch;
    device ms of a shard's launch and of the unsharded one.
44. Full-width, full-depth mamba2-1.3b on (1, 2), paged, its SSD state on
    heads: tokens against ``mesh=None``, each rank's state half the whole,
    SSD launches by kind on every rank (48 x chunks, 48 x decode steps,
    each counted by the wrapper).
45. Ring mode on (1, 2): minicpm-2b at full width and depth, prompts of
    4096 tokens (every admission launches the flash kernel), against
    ``mesh=None``; recurrentgemma-2b with its ring split on T, against its
    mesh-matched run; ring bytes by rank and the collective bytes of a
    decode step equal at twice ``max_seq``.
46. The event soup of full-width minicpm-2b (``paged_kernel``, forced
    preemptions with offload, parking with a TTL, prefix sharing) on
    (1, 2) and (2, 2): tokens against ``mesh=None``, journals equal, page
    moves 0 collective bytes, layer 0 of every rank's blobs bitwise its
    shard of ``mesh=None``'s and deeper layers within ``SOUP_BLOB_REL`` of
    the leaf's largest value and ``SOUP_BLOB_LAYER_REL`` of their layer's
    and kv head's; the same soup on (1, 1)
    (nothing split) with every blob bitwise ``mesh=None``'s.
47. The grouped expert kernel on one expert shard (``ops.layer_forward_shard``'s
    launches: the route's offsets viewed at the shard's experts, the
    shard's weights, the shared expert in both launches) at moonshot's
    decode, chunk and ring prefill shapes (T 8, 256, 4096), 2 and 4
    shards: each shard's rows bitwise the unsharded launch's rows, its
    shared rows bitwise; ``moe_combine``'s fp32 partial mode bitwise its
    plain version, and over every pair cast bitwise the bf16 mode; the
    partials summed and cast within one bf16 ulp of the unsharded combine
    (differing elements counted); device ms of a shard's two launches
    beside the unsharded pair's, plain, ``torch._grouped_mm`` on the
    segment and the bound; the partial combine's device ms and bound.
48. Full-width, full-depth moonshot-v1-16b-a3b on (1, 2) ranks of the one
    card, each rank holding only its 32 experts a layer: paged
    (``paged_kernel``, 8 requests, prompt 256, 4 new, 8 slots) and from
    a ring (2 x 4096-token prompts on one slot, flash every admission), each against
    its mesh-matched run; the paged workload on (1, 1) against
    ``mesh=None``.  Each rank's expert bytes half the model's, its peak
    memory; routes and MoE inputs bitwise across ``model`` (digests of
    the first MoE calls); on every rank route, combine (fp32 partial) and
    half the grouped kernel's launches 48 x (decode steps + chunks or
    prefills), each also by step kind (decode, chunk or ring prefill, as
    the wrappers count them), paged 48 x decode steps, flash 48 x ring
    prefills; a decode step's wall ms and collective bytes (flat at a 4x
    pool).
49. The event soup of moonshot-v1-16b-a3b at full width and M49_LAYERS of
    its 48 layers (four ranks' weights on one card) on (2, 2) against its
    mesh-matched run, with the checks of 48 and the soup's preemptions,
    page moves and (where the tokens are ``mesh=None``'s) journals.
50. Speculation on a mesh (gather, greedy): (a) phase 41's minicpm-2b
    workload at full width and depth on (1, 2) with the self-draft at k = 3
    and a draft reseeded +P26_RESEED at k = 2, and on (2, 2) with the
    self-draft, each held to the ``mesh=None`` run without speculation
    (tokens equal, or near-tied at each stream's first divergence), the
    self-draft's acceptance at least 0.5, one round's collective bytes
    (flat at a 4x pool) and ms by rank; (b) moonshot-v1-16b-a3b at full
    width and depth on (1, 2), self-draft k = 3, 4 requests, prompt 256,
    4 new, held to its mesh-matched run without speculation (tokens equal,
    or near-tied at each stream's first divergence, as 26c), routes
    bitwise across ``model``, every MoE wrapper's launches by step kind
    exactly layers x (rounds x k) draft, layers x rounds verify and layers
    x chunks, and none else; peak memory by rank.
51. The elastic fleet on (1, 2): P51_WORKERS workers of 4 slots of
    minicpm-2b at full width and depth (``paged_kernel``, parking, prefix
    sharing, the index journal) serve phase 41's requests in one burst
    over a 2-page system prompt, with a crash mid-decode and one
    mid-restore (P51_CRASHES), scale to zero, then cold start for a second
    turn on two sessions (adopting their parked records and the journaled
    index pages) and scale to zero again; held to the same fleet on
    ``mesh=None`` token for token, its stats and its log of events and
    adoptions equal; every rank's fleet agrees (an all-reduced digest);
    each rank's page blobs its lane shard of ``mesh=None``'s (layer 0
    bitwise, deeper layers within the bounds of 46); every rank bills what
    ``mesh=None`` bills; paged-kernel launches = layers x that rank's
    worker decode steps, by counter.

Phases 40-51 run after 33 in this order: the kernel checks of 40, 43 and
47; the ``mesh=None`` runs of moonshot's workloads (48-49, 50b); one
spawn of ranks for each mesh shape (``MeshJobs``: (1, 2) serves 41, 42,
44-46, 50a and 51, then 48 and 50b, (2, 2) 41, 46, 50a and 49, (1, 1) 46
and 48; a spawn's ranks pay their start, CUDA and gloo set-up once; each
job prints its wall by rank, the first of a spawn a probe of its ranks'
host and card), the ``mesh=None`` runs of the other workloads made in
this process while the first spawn serves; then each phase's checks, and
40's timing at the shapes 41-42 served.  Every phase prints its wall
(``wall: <phase> <s> s``).

On the card the scheduler replays a CUDA graph for every decode step and
every 256-token chunk (``serve/graphs.py``), so phases 3, 6, 11, 17, 19,
22, 23, 24, 25, 26 and 27 serve on graphs; their exact launch counts are counted
through replays (each replay adds the launches its capture recorded).  Phases 4, 8, 13, 17
and 22 trace steps with ``torch.profiler`` (wall time with the profiler on,
device busy time, idle share, kernels the device ran, launch calls the
host made, and the heaviest kernels): each traces its scheduler's eager
decode step (and 256-token chunk) beside the replayed graph, times both
without the profiler, and prints the captures made, the seconds each took
and the graph pool's memory; phase 20 does the same for the
``paged_kernel`` schedulers.  No phase but 33, 39 and 49 is cut in
depth (33: 2 layers, each save writes ~4.9 GB of fp32 state; 39: 4
layers, as much of moonshot's 28.9 B parameters as fits one card with
fp32 master, gradient and Adam state; 49: M49_LAYERS of 48 layers, four
ranks' moonshot weights on one card): every other path runs at its full
depth.  The whole script, the kernels' build included, must end within
1200 s on the card.

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


def parent_state() -> dict:
    """This process's share of the card and the host just before it spawns
    ranks: the allocator's reserved and allocated GiB, the card's used MiB
    (``nvidia-smi``), this process's resident GiB, the host's available
    GiB, its Python and OS threads, and the host's load average."""
    import threading

    import torch

    out = {"reserved_gib": torch.cuda.memory_reserved() / 2**30,
           "allocated_gib": torch.cuda.memory_allocated() / 2**30,
           "threads": [t.name for t in threading.enumerate()]}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    out["smi_used"] = smi.stdout.strip()
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(("VmRSS:", "Threads:")):
                key, val = line.split()[:2]
                out[key.rstrip(":")] = int(val)
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                out["mem_available_gib"] = int(line.split()[1]) / 2**20
    with open("/proc/loadavg") as f:
        out["loadavg"] = f.read().split()[:3]
    return out


class Walls:
    """Each phase's wall seconds, printed as it ends (``wall: <phase> <s> s``)."""

    def __init__(self):
        self.t0 = self.t = time.perf_counter()

    def mark(self, label: str) -> None:
        now = time.perf_counter()
        print(f"  wall: {label} {now - self.t:.1f} s (at {now - self.t0:.1f} s)")
        self.t = now


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
    over ``iters`` calls of ``fn(i)``: the mean duration of their intervals
    in a ``torch.profiler`` trace (``kernel_intervals``, as phases 31-32
    read it; None when the trace holds no such kernel).  Unlike the
    CUDA-event time of back-to-back calls, it leaves out the host's launch
    path."""
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        sync()
    intervals = kernel_intervals(prof)
    spans = [end - start for name, start, end in intervals if kernel in name]
    if not spans:
        seen = sorted({name[:60] for name, _, _ in intervals})
        print(f"  profiler: no kernel named {kernel!r} over {iters} calls; "
              f"device kernels seen: {seen[:6]}")
    return sum(spans) / len(spans) / 1e3 if spans else None


def queued_device_ms(fn, iters: int):
    """Device time per call of ``fn(i)`` over ``iters`` calls, without the
    profiler: the host queues the calls while the device runs
    ``torch.cuda._sleep``, so CUDA events bracket them back to back on the
    device and the host's launch path is left out.  Valid only when the
    host has queued every call before the sleep ends, which is checked
    (the sleep grows 4x up to three times); None when it never was.  For
    wrappers that launch one kernel and nothing else, it is that kernel's
    time."""
    import torch

    fn(0)
    sync()
    cycles = 1 << 25                # ~17 ms at the H100's 1.98 GHz boost clock
    for _ in range(4):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        t0 = time.perf_counter()
        marks[0].record()
        torch.cuda._sleep(cycles)
        marks[1].record()
        for i in range(iters):
            fn(i)
        marks[2].record()
        queued_ms = (time.perf_counter() - t0) * 1e3
        sync()
        if queued_ms < marks[0].elapsed_time(marks[1]):
            return marks[1].elapsed_time(marks[2]) / iters
        cycles *= 4
    return None


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
    from repro_torch.kernels.moe_experts import (moe_combine_kernel, moe_experts_kernel,
                                                 moe_route_kernel)
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
    reset_launch_counts()
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
              "moe_route": moe_route_kernel.launches,
              "moe_combine": moe_combine_kernel.launches,
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
    counts["tpot_ms"] = 1e3 * timed.decode_s / max(timed.decode_only_steps, 1)
    counts["decode_tok_s"] = timed.decode_only_tokens / max(timed.decode_s, 1e-9)
    if then is not None:
        then(sched)
    return counts


# -- phase 4: backend agreement ---------------------------------------------------------


class RouteLog:
    """The experts every MoE layer picks, by layer and token, across the
    ``moe_ffn`` calls of a forward (one per layer, or one per layer and
    chunk), read from each call's ``route`` output.  ``record()`` keeps a
    run's picks; ``compare()`` counts the (token, layer) routes of another
    run that differ from them; ``force()`` makes another run pick them (each
    call passes them to ``route`` as ``forced``: on the card the route
    kernel takes its gates at those experts and renormalises them), so
    that two runs which differ only in attention can be compared where a
    route would flip: routing is discrete, and a one-ulp difference in a
    hidden state moves a near-tied gate past another.  ``forced`` counts
    the forced calls, ``forced_launches`` the route kernel's launches among
    them."""

    def __init__(self, cfg):
        self.n_layers = cfg.n_layers
        self.picks = {}
        self.flipped = self.routes = self.forced = self.forced_launches = 0

    @contextlib.contextmanager
    def _patched(self, pick):
        from repro_torch.kernels.moe_experts import ops as moe_ops

        orig, calls = moe_ops.route, [0]
        self.pos = dict.fromkeys(range(self.n_layers), 0)

        def route(x, w, k, forced=None):
            layer = calls[0] % self.n_layers
            calls[0] += 1
            return pick(orig, x, w, k, layer)

        moe_ops.route = route       # layer_forward's route: every MoE layer's
        try:
            yield self
        finally:
            moe_ops.route = orig

    def record(self):
        import torch

        self.picks = {}

        def pick(orig, x, w, k, layer):
            r = orig(x, w, k)
            prev = self.picks.get(layer)
            self.picks[layer] = r.idx.clone() if prev is None else torch.cat([prev, r.idx])
            return r
        return self._patched(pick)

    def _recorded(self, n, layer):
        lo = self.pos[layer]
        self.pos[layer] += n
        return self.picks[layer][lo:lo + n]

    def compare(self):
        self.flipped = self.routes = 0

        def pick(orig, x, w, k, layer):
            r = orig(x, w, k)
            want = self._recorded(x.shape[0], layer)
            self.flipped += int((r.idx.sort(-1)[0] != want.sort(-1)[0]).any(-1).sum())
            self.routes += r.idx.shape[0]
            return r
        return self._patched(pick)

    def force(self):
        from repro_torch.kernels.moe_experts import moe_route_kernel

        self.forced = self.forced_launches = 0

        def pick(orig, x, w, k, layer):
            before = moe_route_kernel.launches
            r = orig(x, w, k, forced=self._recorded(x.shape[0], layer).contiguous())
            self.forced += 1
            self.forced_launches += moe_route_kernel.launches - before
            return r
        return self._patched(pick)

    def check_forced(self, fails: Failures, what: str) -> None:
        """On the card every forced call went through the route kernel."""
        if DEVICE == "cuda":
            fails.check(self.forced > 0 and self.forced_launches == self.forced,
                        f"{what}: {self.forced_launches} route kernel launches of "
                        f"{self.forced} forced calls")

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
        routes.check_forced(fails, "paged_kernel step, gather's routes forced")
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
    the device's busy time summed over kernels and as the union of their
    intervals (:func:`union_us`), the idle share, the kernels
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
    union = union_us(k[1:] for k in kernel_intervals(prof))
    print(f"  profile {label}: wall {wall_us / 1e3:.2f} ms (profiler on), "
          f"device busy {busy / 1e3:.2f} ms, idle share {1 - busy / wall_us:.3f}, "
          f"{launches} kernel launches, host launch calls {sum(calls.values())} {calls}; "
          f"union of kernel intervals {union / 1e3:.2f} ms, idle share by it "
          f"{1 - union / wall_us:.3f}")
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
        routes.check_forced(fails, "paged chunks, the ring prefill's routes forced")
        diff = (ring - paged).abs().max().item()
        what += ", the chunks' experts forced to the ring prefill's routes"
    fails.check(math.isfinite(diff) and diff <= AGREE_REL_TOL * scale,
                f"{what}: max |delta| {diff:.4g} <= {AGREE_REL_TOL} x {scale:.4f}")


# -- phase 21: the grouped expert, route and combine kernels vs their plain versions -----


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
    invariance and a CUDA graph's replay bitwise."""
    import torch

    from repro_torch.kernels.moe_experts import expert_ffn, library_plan, moe_experts_kernel, plan
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


# (T, D, E, k, kind): moonshot's decode, chunk and ring prefill and one
# token, 8192 tokens (moonshot's training microstep), qwen3-moe's widths at
# a ragged T, every token tied (a zero router), and a ragged tile of the
# register-tiled product (T one short of 4096, 48-wide slices, 40 experts
# padded to 64), and rows of x or w that are no 16-byte multiples (stages
# by cp.async, not TMA; at 2 and at 8 tokens a thread)
ROUTE_CASES = [
    (1, 2048, 64, 6, "random"), (8, 2048, 64, 6, "random"), (CHUNK, 2048, 64, 6, "random"),
    (4096, 2048, 64, 6, "random"), (8192, 2048, 64, 6, "random"), (37, 4096, 128, 8, "random"),
    (300, 2048, 64, 6, "tied"), (4095, 1536, 40, 5, "random"), (50, 1030, 6, 2, "random"),
    (2048, 1030, 40, 5, "random"),
]
ROUTE_ROW_TS = (8, CHUNK, 4096)  # one row's logits bitwise the same alone and among T rows
ROUTE_TIE_GAP = 1e-6       # gates closer than this may swap between the kernel and torch


def near_tie_rows(gates, k: int):
    """Rows whose k-th and (k+1)-th largest gates lie within ROUTE_TIE_GAP."""
    import torch

    top = torch.sort(gates, dim=-1, descending=True)[0]
    return (top[:, k - 1] - top[:, k]) <= ROUTE_TIE_GAP


def graphed(fn):
    """``fn`` captured in a CUDA graph (after a warm-up on a side stream):
    returns (replay, the captured outputs)."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    gc.collect()    # no garbage CUDAGraph freed (and destroyed) mid-capture
    with torch.cuda.graph(graph):
        out = fn()
    return graph.replay, out


def phase_route_cases(fails: Failures, seed: int) -> None:
    """``moe_route`` against ``moe_route_plain`` (logits within 1e-5 of the
    fp64 product; the experts equal outside near-ties of the plain gates,
    every mismatch counted; the weights within 1e-6 relative of the plain
    routing of the kernel's own logits; offsets, order, tok, pos and ranks
    exactly the plain argsort's of the kernel's own experts; the last row
    alone bitwise its row in the call), ``moe_combine`` bitwise
    ``moe_combine_plain`` with and without the shared expert and the kept
    mask, and both captured in one CUDA graph, replayed twice, bitwise the
    eager launches."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.moe_experts import (moe_combine_kernel, moe_combine_plain,
                                                 moe_route_kernel, moe_route_plain,
                                                 route_logits_plain, route_plan,
                                                 route_sort_plain)
    from repro_torch.kernels.moe_experts.route_plan import library_fields, route_shape

    name = None
    for line in build.build_log("moe_experts").splitlines():
        if "Compiling entry" in line:
            m = re.search(r"moe_route_kernelILi\d|moe_route_sort_kernel|moe_combine_kernel",
                          line)
            name = m and m.group(0)
        elif name and ("Used" in line or "spill" in line):
            print(f"  ptxas {name}: {line.strip().replace('ptxas info    : ', '')}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count if DEVICE == "cuda" else 132
    for T, D, E, k, _ in ROUTE_CASES:
        want_pl = library_fields(route_shape(T, D, E, k, sms))
        fails.check(tuple(route_plan(T, D, E, k)) == want_pl,
                    f"moe_route plan [T={T} D={D} E={E} k={k}]: the library's "
                    f"{tuple(route_plan(T, D, E, k))} == route_plan.py's {want_pl} ({sms} SMs)")
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 21)
    for T, D, E, k, kind in ROUTE_CASES:
        x = torch.randn(T, D, generator=gen, device=DEVICE).to(torch.bfloat16)
        w = (torch.zeros(D, E, device=DEVICE) if kind == "tied" else
             torch.randn(D, E, generator=gen, device=DEVICE) * D ** -0.5)
        before = moe_route_kernel.launches
        got = moe_route_kernel(x, w, k)
        one = moe_route_kernel(x[T - 1:T].contiguous(), w, k)
        want = moe_route_plain(x, w, k)
        own = route_logits_plain(got.logits, k)
        sync()
        ref = x.double() @ w.double()
        l_err = (got.logits.double() - ref).abs().max().item()
        l_scale = ref.abs().max().item()
        mism = ~(got.idx == want.idx).all(-1)
        outside = int((mism & ~near_tie_rows(want.gates, k)).sum())
        same = (got.idx == own.idx).all(-1)
        own_bad = int((~same & ~near_tie_rows(own.gates, k)).sum())
        w_rel = ((got.weights - own.weights).abs() / own.weights)[same].max().item()
        agree = ~mism
        w_rel_plain = (((got.weights - want.weights).abs() / want.weights)[agree].max().item()
                       if bool(agree.any()) else 0.0)
        sort_ok = all(torch.equal(a, b) for a, b in zip(got[4:], route_sort_plain(got.idx, E)))
        row_ok = all(torch.equal(a[0], b[T - 1]) for a, b in zip(one[:4], got[:4]))
        tie_ok = kind != "tied" or bool(
            (got.idx == torch.arange(k, device=DEVICE, dtype=torch.int32)).all())
        pl = route_plan(T, D, E, k)
        fails.check(moe_route_kernel.launches == before + 2 and l_err <= 1e-5 * l_scale
                    and outside == 0 and own_bad == 0 and w_rel <= 1e-6 and sort_ok and row_ok
                    and tie_ok,
                    f"moe_route vs plain [T={T} D={D} E={E} k={k} {kind}; grid {pl.tiles} tiles "
                    f"of {pl.tile_tokens} x {pl.groups} slice groups, {pl.thread_tokens} tokens "
                    f"a thread, {pl.sort_blocks} sort blocks]: logits max err "
                    f"{l_err:.3g} <= 1e-5 x {l_scale:.4g}; experts differ on {int(mism.sum())} "
                    f"of {T} tokens, {outside} outside near-ties (gap <= {ROUTE_TIE_GAP}); "
                    f"against its own logits' plain routing {own_bad} outside near-ties, "
                    f"weights rel err {w_rel:.3g} <= 1e-6 (vs plain {w_rel_plain:.3g}); sort "
                    f"outputs exact {sort_ok}; last row alone bitwise {row_ok}; ties to the "
                    f"lower expert {tie_ok}")
    # one unchanged row alone and among T rows (each T on its own plan): the
    # slice-order logits, and so the route, bitwise the same
    D, E, k = 2048, 64, 6
    w = torch.randn(D, E, generator=gen, device=DEVICE) * D ** -0.5
    x0 = torch.randn(1, D, generator=gen, device=DEVICE).to(torch.bfloat16)
    alone = moe_route_kernel(x0, w, k)
    for T in ROUTE_ROW_TS:
        x = torch.randn(T, D, generator=gen, device=DEVICE).to(torch.bfloat16)
        at = T // 2
        x[at] = x0[0]
        got = moe_route_kernel(x, w, k)
        sync()
        pl = route_plan(T, D, E, k)
        same = [torch.equal(a[at], b[0]) for a, b in zip(got[:4], alone[:4])]
        fails.check(all(same), f"moe_route row {at} of T={T} ({pl.thread_tokens} tokens a thread, "
                    f"{pl.groups} slice groups, {pl.tiles} tiles) vs the row alone (T=1): logits, "
                    f"gates, weights, experts bitwise {same}")
    # the combine, bitwise, at moonshot's chunk
    T, D, E, k = CHUNK, 2048, 64, 6
    x = torch.randn(T, D, generator=gen, device=DEVICE).to(torch.bfloat16)
    w = torch.randn(D, E, generator=gen, device=DEVICE) * D ** -0.5
    r = moe_route_kernel(x, w, k)
    ys = torch.randn(T * k, D, generator=gen, device=DEVICE).to(torch.bfloat16)
    ysh = torch.randn(T, D, generator=gen, device=DEVICE).to(torch.bfloat16)
    kept = r.rank < 20
    for label, kp, sh in (("no drop, no shared", None, None), ("shared", None, ysh),
                          ("kept mask + shared", kept, ysh), ("kept mask", kept, None)):
        before = moe_combine_kernel.launches
        got = moe_combine_kernel(ys, r.pos, r.weights, kp, sh)
        want = moe_combine_plain(ys, r.pos, r.weights, kp, sh)
        sync()
        fails.check(moe_combine_kernel.launches == before + 1 and torch.equal(got, want),
                    f"moe_combine vs plain [T={T} k={k} D={D}, {label}"
                    f"{f', {int((~kept).sum())} pairs dropped' if kp is not None else ''}]: "
                    f"bitwise (max |delta| {(got.float() - want.float()).abs().max().item():.3g})")

    def layer():
        rr = moe_route_kernel(x, w, k)
        return rr, moe_combine_kernel(ys, rr.pos, rr.weights, None, ysh)

    eager = layer()
    replay, captured = graphed(layer)
    ok = True
    for _ in range(2):
        for t in (*captured[0], captured[1]):
            t.zero_()
        replay()
        sync()
        ok &= all(torch.equal(a, b) for a, b in zip(captured[0], eager[0])) and \
            torch.equal(captured[1], eager[1])
    fails.check(ok, f"moe_route + moe_combine [T={T}] captured in one CUDA graph: two replays "
                "in a row bitwise the eager launches (the counters back at 0 after each)")


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
    ``kernel`` in the build of ``src`` (named by its template arguments as
    they are mangled, or by ``kernel`` alone); fails unless
    all ``instances`` are in the build's log and no kernel of ``src`` has a
    wgmma serialised by ``ptxas`` (C7515, C7517 or C7518: a wait after each
    wgmma)."""
    from repro_torch.kernels import build

    name, seen, serialised = None, set(), []
    for line in build.build_log(src).splitlines():
        serial = re.search(r"\(C75(15|17|18)\)", line)
        if "Compiling entry" in line:
            m = re.search(rf"\d{kernel}(?:ILi(\d)ELi(\d)E(?:Lb(\d)E)?)?E", line)
            name = m and (kernel if m.group(1) is None else
                          f"{kernel}<{', '.join(g for g in m.groups() if g is not None)}>")
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


def flash_bwd_ptxas_report(fails: Failures) -> None:
    """Prints ``ptxas -v``'s registers and spills for the wgmma backward's six
    kernels (dQ and dK/dV at D = 64, 128, 256) and fails unless all six are
    in the build's log and no ``ptxas`` warning says it serialised one's
    wgmmas (C7513, C7515, C7517, C7518, ...)."""
    from repro_torch.kernels import build

    name, seen, serialised = None, set(), []
    for line in build.build_log("flash_attention").splitlines():
        m = re.search(r"flash_bwd_(dq|dkdv)_wgmmaILi(\d+)E", line)
        if "Compiling entry" in line:
            name = m and f"flash_bwd_{m.group(1)}_wgmma<{m.group(2)}>"
            if name:
                seen.add(name)
        elif m and "serialized" in line:
            print(f"  ptxas warning: {line.strip()}")
            serialised.append(line.strip())
        elif name and ("Used" in line or "spill" in line):
            print(f"  ptxas {name}: {line.strip().replace('ptxas info    : ', '')}")
    fails.check(len(seen) == 6 and not serialised,
                f"ptxas report of flash_attention.cu: {len(seen)} of 6 wgmma backward kernels, "
                f"{len(serialised)} with its wgmmas serialised")


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
    where this torch has it, and its bound.  The weights of one layer are
    1.1 GB: every launch streams its experts from HBM."""
    import torch

    from repro_torch.kernels.moe_experts import expert_ffn, moe_experts_kernel

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
    return [record]


def kernel_events(fn) -> tuple:
    """(kernels the device ran, their device ms) over one call of ``fn``
    after one warm-up call, from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    ks = [e for e in prof.key_averages()
          if str(getattr(e, "device_type", "")).endswith("CUDA")]
    return sum(e.count for e in ks), sum(e.self_device_time_total for e in ks) / 1e3


def phase_route_timing(fails: Failures, seed: int, T: int, label: str,
                       combine: bool = True) -> list:
    """moonshot's routing and (with ``combine``) combine of one layer at T
    tokens (D 2048, 64 experts top-6, the shared expert's rows): each
    kernel's time (CUDA events, back to back) and device time per launch
    (``queued_device_ms``: no profiler) beside its bound, its plain version
    run eagerly, and the torch sequence it replaces captured in one CUDA
    graph and replayed (host-timed and ``queued_device_ms``); the fp32
    matmul alone as the router product's library call."""
    import torch

    from repro_torch.kernels.moe_experts import (moe_combine_kernel, moe_combine_plain,
                                                 moe_route_kernel, moe_route_plain, route_plan)

    D, E, k = 2048, 64, 6
    P = T * k
    gen = torch.Generator(device="cuda").manual_seed(seed + 7 * T)
    x = torch.randn(T, D, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn(D, E, generator=gen, device="cuda") * D ** -0.5
    ys = torch.randn(P, D, generator=gen, device="cuda").to(torch.bfloat16)
    ysh = torch.randn(T, D, generator=gen, device="cuda").to(torch.bfloat16)
    got = moe_route_kernel(x, w, k)
    want = moe_route_plain(x, w, k)
    r_err = (got.logits - want.logits).abs().max().item()
    c_got = moe_combine_kernel(ys, got.pos, got.weights, None, ysh)
    c_err = (c_got.float() - moe_combine_plain(ys, got.pos, got.weights, None,
                                               ysh).float()).abs().max().item()
    iters = 40 if T <= 256 else 20
    out = []
    timed = (
        ("moe_route", lambda: moe_route_kernel(x, w, k), lambda: moe_route_plain(x, w, k),
         T * D * 2 + D * E * 4 + 2 * T * E * 4 + 2 * P * 4 + (E + 1) * 4 + 4 * P * 4,
         2 * T * D * E, FP32_FLOPS_PER_S, lambda: x.float() @ w),
        ("moe_combine", lambda: moe_combine_kernel(ys, got.pos, got.weights, None, ysh),
         lambda: moe_combine_plain(ys, got.pos, got.weights, None, ysh),
         P * D * 2 + 2 * T * D * 2 + 2 * P * 4, 2 * P * D + T * D, FP32_FLOPS_PER_S, None))
    for name, kern, plain, nbytes, ops, rate, lib in timed[:2 if combine else 1]:
        ms = cuda_time_ms(lambda i: kern(), iters)
        dev = queued_device_ms(lambda i: kern(), iters)
        fails.check(dev is not None, f"{name} {label}: device time per launch {dev} ms "
                    f"({iters} launches queued behind a device sleep)")
        plain_ms = cuda_time_ms(lambda i: plain(), 10)
        graph_ms, graph_dev, nodes = None, None, (None, None)
        try:
            replay, _ = graphed(plain)
            graph_ms = cuda_time_ms(lambda i: replay(), iters)
            graph_dev = queued_device_ms(lambda i: replay(), iters)
            nodes = kernel_events(replay)
        except RuntimeError as e:
            print(f"  {name} {label}: the plain sequence did not capture: {str(e)[:160]}")
        lib_ms = cuda_time_ms(lambda i: lib(), iters) if lib is not None else None
        again = cuda_time_ms(lambda i: kern(), iters, warmup=0)
        tb, to = nbytes / HBM_BYTES_PER_S, ops / rate
        bound = max(tb, to) * 1e3
        extra = ""
        if name == "moe_route":
            pl = route_plan(T, D, E, k)
            extra = (f"grid {pl.tiles} tiles of {pl.tile_tokens} tokens x {pl.groups} slice "
                     f"groups ({pl.thread_tokens} tokens a thread, {pl.slice_warps} slice warps, "
                     f"{'TMA' if pl.tma else 'cp.async'} stages of {pl.stage_d} d), "
                     f"{pl.sort_blocks} sort blocks, {pl.smem} B shared memory, workspace "
                     f"{pl.workspace} B; ")
        print(f"  {name} {label}: T={T} P={P}: {extra}kernel {ms:.4f} ms (again {again:.4f}; "
              f"device time per launch {dev} ms); plain eager {plain_ms:.4f} ms; plain "
              f"sequence as one replayed graph {graph_ms} ms ({nodes[0]} kernel nodes, "
              f"device {graph_dev} ms queued, {nodes[1]} ms profiled); "
              f"{'fp32 matmul ' + format(lib_ms, '.4f') + ' ms; ' if lib_ms else ''}bound "
              f"{bound:.5f} ms ({nbytes / 1e6:.3f} MB, {ops / 1e9:.4f} GFLOP)")
        out.append({"name": name, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/moe_experts.cu",
                    "replaces": ("src/repro/models/moe.py:171-174 (router einsum, softmax, "
                                 "top_k, renormalisation) and the torch sort of the pairs; no "
                                 "Pallas kernel" if name == "moe_route" else
                                 "src/repro/models/moe.py:90-94 (the weighted combine of "
                                 "_dispatch_ffn); no Pallas kernel"),
                    "shape": (f"moonshot {label}: x ({T}, {D}) bf16 . w ({D}, {E}) fp32, top-{k}"
                              if name == "moe_route" else
                              f"moonshot {label}: ys ({P}, {D}) bf16, top-{k}, shared rows"),
                    "launches": None, "max_abs_err": r_err if name == "moe_route" else c_err,
                    "ms": ms, "device_ms": dev, "plain_ms": plain_ms,
                    "graphed_plain_ms": graph_ms, "graphed_plain_device_ms": graph_dev,
                    "graphed_plain_nodes": nodes[0], "bound_ms": bound,
                    "bound_by": "bytes" if tb >= to else "operations", "library_ms": lib_ms})
    fails.check(r_err <= 1e-5 * want.logits.abs().max().item() and c_err == 0.0,
                f"route and combine at {label}: logits max err {r_err:.3g}, combine bitwise "
                f"({c_err:.3g})")
    return out


# -- phases 22-23: moonshot-v1-16b-a3b (MoE) paged and from rings ----------------------------


def phase_moe_parity(fails: Failures, model, cfg, seed: int) -> None:
    """One slot: a prefix as one chunk, then N tokens as one chunk or as N
    S=1 steps from copies of the same state.  Gated, bitwise: on every
    layer's MoE input taken from the chunk run, ``moe_ffn`` over the N
    tokens equals ``moe_ffn`` of each token alone (route, gather, both
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


# aten ops that launch no kernel: views and allocations
NO_LAUNCH_OPS = frozenset({"aten.view", "aten._unsafe_view", "aten.slice", "aten.select",
                           "aten.unbind", "aten.alias", "aten.as_strided", "aten.t",
                           "aten.expand", "aten.detach", "aten.split", "aten.unsqueeze",
                           "aten.squeeze", "aten.permute", "aten.transpose", "aten.empty",
                           "aten.new_empty", "aten.empty_strided", "aten.empty_like"})


def phase_moe_launches(fails: Failures, model, cfg, seed: int) -> None:
    """One layer's ``moe_ffn`` as the serving paths call it (drop-free, no
    aux) at a decode step's, a chunk's and a ring prefill's token counts:
    every aten op it dispatches is logged (a ``TorchDispatchMode``), and
    apart from views and allocations it must be the one row gather, with
    one route, two expert and one combine launch counted by the wrappers:
    five launches, none of them a torch sort, argsort, searchsorted or
    softmax.  The kernels a ``torch.profiler`` trace sees are printed (it
    may record no device event for so short a region)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.kernels.moe_experts import (moe_combine_kernel, moe_experts_kernel,
                                                 moe_route_kernel)
    from repro_torch.models import moe as moe_mod

    class OpLog(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func.overloadpacket))
            return func(*args, **(kwargs or {}))

    gen = torch.Generator(device=DEVICE).manual_seed(seed + 22)
    p = model.layers[0].moe
    wrappers = (moe_route_kernel, moe_experts_kernel, moe_combine_kernel)
    for T in (SLOTS, CHUNK, MR_PROMPT):
        h = torch.randn(1, T, cfg.d_model, generator=gen, device=DEVICE).to(torch.bfloat16)
        moe_mod.moe_ffn(p, cfg, h, no_drop=True, with_aux=False)
        sync()
        before = [w.launches for w in wrappers]
        with OpLog() as log:
            moe_mod.moe_ffn(p, cfg, h, no_drop=True, with_aux=False)
        sync()
        counted = [w.launches - b for w, b in zip(wrappers, before)]
        launching = [op for op in log.ops if op not in NO_LAUNCH_OPS]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            moe_mod.moe_ffn(p, cfg, h, no_drop=True, with_aux=False)
            sync()
        kernels = [(e.key[:48], e.count) for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")]
        fails.check(counted == [1, 2, 1] and launching == ["aten.index_select"],
                    f"one MoE layer at T={T} (moe_ffn, drop-free, no aux): route, experts, "
                    f"combine launches {counted} == [1, 2, 1]; aten ops other than views and "
                    f"allocations {launching} == ['aten.index_select'] (of {len(log.ops)} "
                    f"dispatched); profiler kernels {kernels or 'none recorded'}")


# -- phases 24-25: storage-backed preemption, prefix sharing, session parking -----------


P24_REQUESTS, P24_SESSIONS, P24_PROMPT, P24_MAX_NEW = 16, 8, 512, 32
P24_IDLE = 8                       # (a): idle_preempt_steps
P24_SYS, P24_UNIQUE = 384, 128     # (b): a shared system prompt + unique tokens
P24_TURNS, P24_TURN_TOKENS = 3, 64  # (c): turns per session, user tokens per turn
P24_SMALL_POOL_SPARE = 16          # (c'): pages past 8 parked first-turn journals
P25_SESSIONS, P25_TURNS, P25_PROMPT, P25_MAX_NEW = 8, 2, 2300, 16
P25_TURN_TOKENS, P25_SLOTS = 64, 4  # fewer slots than sessions: parked slots get evicted
P25_PREEMPT_AFTER = 4              # a forced preemption takes a slot this many tokens in

_CHECKED = None


def checked_scheduler():
    """``DecodeScheduler`` instrumented for phases 24-25 (defined on first
    use: the port is imported only once a card is known to be there).

    - ``audit()`` after every ``step()``; each failure is kept.
    - Step times on the host clock, synchronized, without the audit and the
      checks below (as ``TimedScheduler`` splits them: steps that prefilled
      vs decode-only steps).
    - Every sampling's logits kept on the card, by (request, token index):
      the decode graph copies its logits into a static buffer.  With
      ``forced`` (request -> tokens) every token is taken from that stream
      instead of sampled, on the card inside the graph (teacher forcing).
    - After a restore completes, a copy-on-write split, an unpark and an
      index hit, the next decode replay is checked against the eager step on
      a copy of the state (every cache leaf, the token buffers, the logits,
      bitwise); the eager step's launches are taken back from the counts.
    - ``_extract`` (gather + copy to the host: preemptions, journal
      offloads) and each restore chunk timed; every blob leaf's device kept.
    - Parked and published pages, and parked rows, snapshotted on the card
      and held bitwise when they come back: published pages at the end
      (``index_unchanged``), parked pages and rows at the unpark, a
      park-blob restore's pages against the pages parked, an evicted
      slot's host snapshot and its reinstall against the rows parked.
    - ``preempt_budget`` forced preemptions: each takes the first ACTIVE
      slot ``P25_PREEMPT_AFTER`` tokens into its request.
    """
    global _CHECKED
    if _CHECKED is not None:
        return _CHECKED
    import numpy as np
    import torch

    from repro_torch.models import kvcache
    from repro_torch.serve.graphs import _add, _launch_counts
    from repro_torch.serve.lifecycle import SlotState
    from repro_torch.serve.scheduler import DecodeScheduler

    def equal(a, b) -> bool:
        return a.shape == b.shape and torch.equal(a.to(b.device), b)

    class CheckedScheduler(DecodeScheduler):
        def __init__(self, model, *, forced=None, **kw):
            super().__init__(model, **kw)
            self.forced = forced
            vocab = model.cfg.padded_vocab
            self._logit_buf = torch.zeros((self.n_slots, vocab), dtype=torch.float32,
                                          device=self.device)
            self._force_buf = torch.zeros((self.n_slots,), dtype=torch.int32,
                                          device=self.device)
            self._in_step = False
            self._act_slot = None
            self.logits = {}
            self.audit_errors = []
            self.pending_checks = set()
            self.checks = []            # (event, ok, what)
            self.excluded = 0.0
            self.chunk_s = self.decode_s = 0.0
            self.chunk_tokens = self.decode_only_tokens = self.decode_only_steps = 0
            self.extract_s, self.extract_bytes, self.extracts = 0.0, 0, 0
            self.restore_s, self.restore_bytes, self.restore_calls = 0.0, 0, 0
            self.blob_devices = set()
            self.preempt_budget = 0
            self.forced_preempts = []   # request ids
            self.index_snap = {}        # chain hash -> (kp, vp) at publish
            self.park_snap = {}         # session -> (pages (kp, vp), rows) at park
            self.unchanged = []         # (what, ok)
            extract = self._extract

            def timed_extract(cache, ids):
                sync()
                t0 = time.perf_counter()
                blob = extract(cache, ids)
                sync()
                self.extract_s += time.perf_counter() - t0
                self.extract_bytes += kvcache.blob_nbytes(blob)
                self.extracts += 1
                self.blob_devices |= {leaf.device.type for leaf in blob.values()}
                return blob
            self._extract = timed_extract

        # -- excluded-time helpers --
        def _timed_out(self, fn):
            sync()
            t0 = time.perf_counter()
            out = fn()
            sync()
            self.excluded += time.perf_counter() - t0
            return out

        def _pages(self, ids):
            idx = torch.as_tensor([int(i) for i in ids], device=self.device)
            return tuple(self.cache[k].index_select(1, idx) for k in ("kp", "vp"))

        # -- sampling: logits kept, tokens optionally forced --
        def _sample(self, logits):
            if self._in_step:
                self._logit_buf.copy_(logits)
                if self.forced is not None:
                    return self._force_buf.clone()
                return super()._sample(logits)
            slot = self._act_slot
            rid = slot.req.request_id
            self.logits[(rid, 0)] = logits[0].float().clone()
            if self.forced is not None:
                return torch.tensor([int(self.forced[rid][0])], dtype=torch.int32,
                                    device=self.device)
            return super()._sample(logits)

        def _activate(self, slot, logits):
            self._act_slot = slot
            try:
                super()._activate(slot, logits)
            finally:
                self._act_slot = None

        def _step_impl(self, *args):
            self._in_step = True
            try:
                super()._step_impl(*args)
            finally:
                self._in_step = False

        def _decode(self):
            rows = [(s.index, s.req.request_id, s.n_out) for s in self.slots if s.decoding]
            if self.forced is not None:
                force = np.zeros((self.n_slots,), np.int32)
                for i, rid, idx in rows:
                    force[i] = self.forced[rid][idx]
                self._force_buf.copy_(torch.from_numpy(force))
            check = (self.pending_checks and self.graphs is not None
                     and "decode" in self.graphs)
            if check:
                start = self._timed_out(lambda: step_state(self))
            super()._decode()
            logits = self._logit_buf.clone()
            if check:
                self._timed_out(lambda: self._check_replay(start, logits))
            for i, rid, idx in rows:
                self.logits[(rid, idx)] = logits[i]

        def _check_replay(self, start, logits):
            replayed = step_state(self)
            before = _launch_counts()
            self._step_impl(*start, self._active)
            after = _launch_counts()
            _add({k: n - before.get(k, 0) for k, n in after.items()}, -1)
            bad = state_diff(replayed, start)
            # the pool's last page is the scratch page: rows with an unmapped
            # table (parked, preempted, empty slots) write there, colliding
            # writes of one launch land in no fixed order, and nothing reads it
            scratch = []
            for key in ("kp", "vp"):
                if f"cache.{key}" in bad:
                    pages = (replayed[0][key] != start[0][key]).flatten(2).any(-1).any(0)
                    where = torch.nonzero(pages).flatten().tolist()
                    if where == [self.n_pages]:
                        bad.remove(f"cache.{key}")
                        scratch.append(key)
            same = torch.equal(logits, self._logit_buf)
            note = f", the scratch page's {scratch} aside" if scratch else ""
            for event in sorted(self.pending_checks):
                self.checks.append((event, not bad and same,
                                    f"after {event}: decode replay bitwise the eager step "
                                    f"(logits {'equal' if same else 'DIFFER'}, "
                                    f"{'every leaf equal' if not bad else f'differ in {bad}'}"
                                    f"{note})"))
            self.pending_checks = set()

        # -- events that call for a replay check, and the snapshots --
        def _run_restore_chunk(self, slot):
            done0 = self.restored_pages
            sync()
            t0 = time.perf_counter()
            super()._run_restore_chunk(slot)
            sync()
            self.restore_s += time.perf_counter() - t0
            self.restore_calls += 1
            self.restore_bytes += ((self.restored_pages - done0) * self.page_size
                                   * kvcache.kv_bytes_per_token(self.cache))
            if slot.state is SlotState.ACTIVE:
                self.pending_checks.add("restore")

        def _prepare_write_span(self, slot, pos0, count):
            cow = self.cow_splits
            super()._prepare_write_span(slot, pos0, count)
            if self.cow_splits > cow:
                self.pending_checks.add("copy-on-write split")

        def _publish_index(self, row, history, hashes=None):
            had = set(self.prefix_index._pages)
            super()._publish_index(row, history, hashes)

            def snap():
                for h, pid in self.prefix_index._pages.items():
                    if h not in had:
                        self.index_snap[h] = self._pages([pid])
            self._timed_out(snap)

        def index_unchanged(self):
            """Every page still indexed, bitwise as it was published."""
            bad = [h for h, pid in self.prefix_index._pages.items()
                   if not all(equal(a, b) for a, b in zip(self._pages([pid]),
                                                          self.index_snap[h], strict=True))]
            return len(self.prefix_index), bad

        def _park_slot(self, slot, req, tokens):
            index = slot.index
            super()._park_slot(slot, req, tokens)
            rec = self._parked[req.session]

            def snap():
                npg = -(-rec.consumed // self.page_size)
                rows = kvcache.gather_slot_state(self.cache, index)
                self.park_snap[req.session] = (self._pages(rec.page_row[:npg]), rows)
            self._timed_out(snap)

        def _evict_parked_slot(self, rec):
            super()._evict_parked_slot(rec)
            snap = self.park_snap.get(rec.session)
            if snap is not None:
                ok = all(equal(rec.state[k], v) for k, v in snap[1].items())
                self.unchanged.append((f"evicted parked slot's host snapshot ({rec.session}) "
                                       "bitwise the rows parked", ok))

        def _admit_paged(self, slot, req, plan):
            moved = plan.record is not None and plan.record.slot != slot.index
            super()._admit_paged(slot, req, plan)
            if plan.kind == "index":
                self.pending_checks.add("index hit")
            if plan.kind not in ("park", "park-blob"):
                return
            self.pending_checks.add("unpark" if plan.kind == "park" else "park-blob restore")
            snap = self.park_snap.get(req.session)
            if snap is None:
                return

            def compare():
                pages, rows = snap
                npg = -(-plan.C // self.page_size)
                mine = self._pages(self._page_rows[slot.index, :npg])
                ok = all(equal(a, b[:, :npg]) for a, b in zip(mine, pages, strict=True))
                if plan.kind == "park-blob":
                    what = "park-blob restore: the restored pages bitwise the pages parked"
                else:
                    theirs = self._pages(plan.record.page_row[:npg])
                    ok = ok and all(equal(a, b[:, :npg])
                                    for a, b in zip(theirs, pages, strict=True))
                    what = ("unpark: the slot's mapped (and copy-on-write) pages and the "
                            "journal's own pages bitwise the pages parked")
                self.unchanged.append((what, ok))
                now = kvcache.gather_slot_state(self.cache, slot.index)
                rows_ok = all(equal(now[k], v) for k, v in rows.items() if k != "length")
                rows_ok = rows_ok and int(now["length"][0]) == plan.C
                how = "reinstalled in another slot" if moved else "kept in the slot"
                self.unchanged.append((f"unparked rows ({sorted(rows)}, {how}) bitwise the "
                                       f"rows parked, length set to {plan.C}", rows_ok))
            self._timed_out(compare)

        def step(self):
            if self.preempt_budget:
                victim = next((s for s in self.slots if s.state is SlotState.ACTIVE
                               and s.pages and s.n_out >= P25_PREEMPT_AFTER), None)
                if victim is not None:
                    self.forced_preempts.append(victim.req.request_id)
                    self.preempt(victim.index)
                    self.preempt_budget -= 1
            pf0, dec0 = self.prefill_tokens, self.decode_tokens
            self.excluded = 0.0
            sync()
            t0 = time.perf_counter()
            out = super().step()
            sync()
            dt = time.perf_counter() - t0 - self.excluded
            if self.prefill_tokens > pf0:
                self.chunk_s += dt
                self.chunk_tokens += self.prefill_tokens - pf0
            elif self.decode_tokens > dec0:
                self.decode_s += dt
                self.decode_only_tokens += self.decode_tokens - dec0
                self.decode_only_steps += 1
            try:
                self.audit()
            except AssertionError as e:
                self.audit_errors.append(f"step {self.steps}: {e}")
            return out

    _CHECKED = CheckedScheduler
    return CheckedScheduler


def reset_launch_counts() -> None:
    """Every kernel wrapper's launch counts to 0."""
    from repro_torch.kernels.flash_attention import (flash_attention_backward_kernel,
                                                     flash_attention_kernel)
    from repro_torch.kernels.moe_experts import (moe_combine_kernel, moe_experts_kernel,
                                                 moe_route_kernel)
    from repro_torch.kernels.paged_attention import paged_attention_kernel
    from repro_torch.kernels.rglru_scan import rglru_scan_backward_kernel, rglru_scan_kernel
    from repro_torch.kernels.ssd_scan import ssd_scan_backward_kernel, ssd_scan_kernel

    for w in (paged_attention_kernel, rglru_scan_kernel, ssd_scan_kernel,
              flash_attention_kernel, moe_experts_kernel, moe_route_kernel, moe_combine_kernel,
              flash_attention_backward_kernel, rglru_scan_backward_kernel,
              ssd_scan_backward_kernel, *moe_backward_wrappers().values()):
        w.launches = 0
        for name, val in list(vars(w).items()):
            if name.startswith("launches_by_"):
                setattr(w, name, dict.fromkeys(val, 0))


def serve_turn(cloud, front, reqs) -> None:
    """Submit ``reqs`` (each session's in order, on its own FIFO channel, all
    sessions at once) through the frontend and run the cloud dry."""
    by_session = {}
    for r in reqs:
        by_session.setdefault(r.session, []).append(r)

    def driver(rs):
        for r in rs:
            yield from front.submit(r)

    for sess, rs in by_session.items():
        cloud.spawn(driver(rs), name=f"client:{sess}")
    cloud.run()


def tokens_by_request(front) -> dict:
    import numpy as np

    return {rid: np.asarray(t) for sess, ids in front.completions.items()
            for rid, t in zip(ids, front.results[sess], strict=True)}


def p24_serve(fails, model, cfg, seed, label, turns, *, slots=SLOTS, max_seq, forced=None,
              preempts_per_turn=0, **kw):
    """Serve ``turns`` (each a function of the frontend so far that returns the
    turn's ``InferenceRequest``s) through ``ServingFrontend`` ->
    ``CheckedScheduler(attn_backend='paged_kernel')``, turn after turn, and
    check what every phase 24-25 sub-run must hold.  Returns the scheduler,
    the frontend and the launch counts."""
    import torch

    from repro_torch.coord.serving_front import ServingFrontend
    from repro_torch.core import SimCloud
    from repro_torch.kernels.paged_attention import paged_attention_kernel
    from repro_torch.kernels.rglru_scan import rglru_scan_kernel

    sched = checked_scheduler()(model, forced=forced, n_slots=slots, max_seq=max_seq,
                                page_size=PAGE, prefill_chunk=CHUNK,
                                attn_backend="paged_kernel", seed=seed, device=DEVICE, **kw)
    cloud = SimCloud(seed=seed)
    front = ServingFrontend(cloud, scheduler=sched, batch_size=slots)
    sync()
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    n_requests = 0
    t0 = time.perf_counter()
    for make in turns:
        sched.preempt_budget = preempts_per_turn
        reqs = make(front)
        n_requests += len(reqs)
        serve_turn(cloud, front, reqs)
    sync()
    wall = time.perf_counter() - t0
    counts = {"paged_attention": paged_attention_kernel.launches,
              "rglru_scan": rglru_scan_kernel.launches,
              "steps": sched.steps, "chunks": sched.prefill_chunks}
    served = sum(len(v) for v in front.completions.values())
    fails.check(served == n_requests, f"{label}: served {served}/{n_requests} requests")
    fifo = all(ids == sorted(ids, key=lambda r: int(r[1:]))
               for ids in front.completions.values())
    fails.check(fifo, f"{label}: per-session FIFO over {len(front.completions)} sessions")
    fails.check(not sched.audit_errors,
                f"{label}: audit() clean after every one of {sched.steps} decode steps"
                + (f" ({sched.audit_errors[:3]})" if sched.audit_errors else ""))
    n_attn = model.n_kv_layers
    fails.check(counts["paged_attention"] == n_attn * sched.steps,
                f"{label}: paged kernel launches {counts['paged_attention']} == {n_attn} "
                f"attention layers x {sched.steps} decode steps")
    if cfg.family == "hybrid":
        n_rec = cfg.n_layers - n_attn
        fails.check(counts["rglru_scan"] == n_rec * (sched.steps + sched.prefill_chunks),
                    f"{label}: rglru launches {counts['rglru_scan']} == {n_rec} RG-LRU layers "
                    f"x ({sched.steps} decode steps + {sched.prefill_chunks} chunks)")
    if sched.graphs is not None:
        caps = [key for key, _ in sched.graphs.captures]
        fails.check(caps.count("decode") == 1,
                    f"{label}: exactly one decode-graph capture (captures {caps})")
    for event, ok, what in sched.checks:
        fails.check(ok, f"{label}: {what}")
    for what, ok in sched.unchanged:
        fails.check(ok, f"{label}: {what}")
    st = front.serving_stats()
    dec_ms = 1e3 * sched.decode_s / max(sched.decode_only_steps, 1)
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
    print(f"  {label}: {wall:.3f} s wall, {sched.steps} decode steps, {st['prefill_chunks']} "
          f"chunks, {st['prefill_tokens']} prefill + {st['decode_tokens']} decode tokens; "
          f"TPOT {dec_ms:.2f} ms ({sched.decode_only_steps} decode-only steps, "
          f"{sched.decode_only_tokens / max(sched.decode_s, 1e-9):.1f} decode tok/s), "
          f"prefill {sched.chunk_tokens / max(sched.chunk_s, 1e-9):.1f} tok/s; peak "
          f"{peak / 2**30:.3f} GiB (check copies of the pool included); pool "
          f"{st['kv_pages']} pages, high water {st['kv_pages_high_water']}")
    keys = ("preemptions", "restores", "restore_chunks", "offload_pages", "restored_pages",
            "offload_bytes", "restore_bytes", "shared_prefix_tokens", "index_hits",
            "park_hits", "park_misses", "parks", "park_evictions", "park_offloads",
            "cow_splits", "offload_storage_ops", "offload_storage_usd", "park_storage_usd")
    if any(k in st for k in keys):
        print(f"  {label}: " + ", ".join(f"{k} {st[k]}" for k in keys if k in st))
    if sched.extracts:
        print(f"  {label}: {sched.extracts} gathers to the host (preemptions + journal "
              f"offloads): {1e3 * sched.extract_s / sched.extracts:.3f} ms and "
              f"{sched.extract_bytes / sched.extracts / 1e6:.1f} MB each, "
              f"{sched.extract_bytes / max(sched.extract_s, 1e-9) / 1e9:.2f} GB/s")
    if sched.restore_calls:
        print(f"  {label}: {sched.restore_calls} restore chunks: "
              f"{1e3 * sched.restore_s / sched.restore_calls:.3f} ms and "
              f"{sched.restore_bytes / sched.restore_calls / 1e6:.1f} MB each, "
              f"{sched.restore_bytes / max(sched.restore_s, 1e-9) / 1e9:.2f} GB/s")
    counts.update(wall=wall, tpot_ms=dec_ms, peak=peak,
                  decode_tok_s=sched.decode_only_tokens / max(sched.decode_s, 1e-9))
    return sched, front, counts


def conversation(front, first, user, s: int, t: int):
    """Session ``s``'s turn-``t`` prompt: its first prompt, then for each
    earlier turn the tokens the frontend returned and that turn's
    ``user[t']`` tokens."""
    import numpy as np

    parts = [first]
    for j in range(t):
        parts += [np.asarray(front.results[f"s{s}"][j], np.int32), user[j + 1]]
    return np.concatenate(parts)


def host_copy_breakdown(cache, n_pages: int) -> None:
    """Where a preemption's time goes: one ``n_pages``-page blob gathered
    on the card, then copied to the host four ways — into fresh pinned
    memory (what the store keeps: the caching host allocator has no free
    block to reuse while earlier blobs are held), into pinned memory it
    reuses, into a pinned buffer given in advance, and into pageable
    memory.  Host clock, synchronized, mean of 5 (the fresh one: once)."""
    import torch

    if DEVICE != "cuda":
        print("  host copies: not measured off the card (no pinned memory)")
        return

    from repro_torch.models import kvcache

    def timed(fn, iters=5):
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        sync()
        return 1e3 * (time.perf_counter() - t0) / iters, out

    ids = list(range(n_pages))
    gather_ms, blob = timed(lambda: kvcache.gather_pages(cache, ids))
    nbytes = kvcache.blob_nbytes(blob)
    held = []
    fresh_ms, _ = timed(lambda: held.append(kvcache.to_host(blob)), iters=1)
    held.clear()
    reused_ms, _ = timed(lambda: kvcache.to_host(blob))
    buf = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True) for k, v in blob.items()}

    def into():
        for k, v in blob.items():
            buf[k].copy_(v, non_blocking=True)
    given_ms, _ = timed(into)
    pageable_ms, _ = timed(lambda: {k: v.cpu() for k, v in blob.items()})
    rates = ", ".join(f"{what} {ms:.3f} ms ({nbytes / ms / 1e6:.2f} GB/s)"
                      for what, ms in (("fresh pinned", fresh_ms), ("reused pinned", reused_ms),
                                       ("given pinned buffer", given_ms),
                                       ("pageable", pageable_ms)))
    print(f"  a {n_pages}-page blob ({nbytes / 1e6:.1f} MB): gather on the card "
          f"{gather_ms:.3f} ms; to the host: {rates}")


def logit_agreement(fails, label, off, on, vocab) -> None:
    """The forced run's logits against the free run's, on the free run's
    token stream: within ``AGREE_REL_TOL`` of the logit scale (phase 4's
    check), and the token streams the forced run would have produced
    unforced counted (argmax equal to the stream at every position)."""
    import torch

    keys = sorted(off.logits)
    if not fails.check(set(on.logits) == set(keys),
                       f"{label}: logits for the same {len(keys)} (request, token) positions"):
        return
    a = torch.stack([off.logits[k][:vocab] for k in keys]).float()
    b = torch.stack([on.logits[k][:vocab] for k in keys]).float()
    diff, scale = (a - b).abs().max().item(), a.abs().max().item()
    want = torch.tensor([int(on.forced[rid][i]) for rid, i in keys], device=b.device)
    flips = {keys[j][0] for j in torch.nonzero(b.argmax(-1) != want).flatten().tolist()}
    rids = {rid for rid, _ in keys}
    row = ((a - b).abs().amax(-1) / a.abs().amax(-1)).max().item()
    print(f"  {label}: {len(rids) - len(flips)} of {len(rids)} token streams identical "
          f"(unforced argmax equal to the feature-off stream at every position); worst "
          f"row max |delta| / its max |logit| {row:.4f}")
    fails.check(math.isfinite(diff) and diff <= AGREE_REL_TOL * scale,
                f"{label}: logits vs the feature-off run, teacher-forced on its stream: max "
                f"|delta| {diff:.4g} <= {AGREE_REL_TOL} x {scale:.4f}")


def phase_offload_sharing(fails: Failures, model, cfg, seed: int, p3: dict) -> None:
    """Phase 24 on phase 3's model: (a) storage-backed preemption, (b) prefix
    sharing, (c) session parking, (c') parking on a pool small enough that
    journals offload."""
    import numpy as np

    from repro_torch.coord.serving_front import InferenceRequest

    rng = np.random.default_rng(seed + 24)
    V = cfg.vocab

    def one_turn(reqs):
        return [lambda front: reqs]

    # (a) offload: a pool of 4 slots' worst case for 8 slots
    max_seq = P24_PROMPT + P24_MAX_NEW
    worst = -(-(max_seq - 1) // PAGE)
    reqs = [InferenceRequest(f"s{i % P24_SESSIONS}", f"r{i}",
                             rng.integers(0, V, size=P24_PROMPT).astype(np.int32), P24_MAX_NEW)
            for i in range(P24_REQUESTS)]
    base, bfront, _ = p24_serve(fails, model, cfg, seed, "(a) unpressured", one_turn(reqs),
                                max_seq=max_seq)
    want = tokens_by_request(bfront)
    del base
    sched, front, c = p24_serve(fails, model, cfg, seed, "(a) offload", one_turn(reqs),
                                max_seq=max_seq, kv_pages=4 * worst, offload=True,
                                idle_preempt_steps=P24_IDLE)
    got = tokens_by_request(front)
    fails.check(sched.preemptions >= 1,
                f"(a) {sched.preemptions} preemptions under a {4 * worst}-page pool (>= 1)")
    fails.check(sched.restores == sched.preemptions,
                f"(a) restores {sched.restores} == preemptions {sched.preemptions}")
    fails.check(sched.blob_devices == {"cpu"} and sched.extracts >= 1,
                f"(a) every blob leaf on the host (devices {sorted(sched.blob_devices)})")
    same = [rid for rid in want if np.array_equal(got.get(rid), want[rid])]
    fails.check(len(same) == len(want),
                f"(a) tokens of all {len(want)} requests bitwise the unpressured run's "
                f"({len(same)} equal; preempted requests included)")
    print(f"  (a) TPOT {c['tpot_ms']:.2f} ms, {c['decode_tok_s']:.1f} decode tok/s (phase 3: "
          f"{p3['tpot_ms']:.2f} ms, {p3['decode_tok_s']:.1f} tok/s)")
    host_copy_breakdown(sched.cache, worst)
    del sched, front
    release()

    # (b) prefix sharing: a shared system prompt ahead of unique tokens
    sys_prompt = rng.integers(0, V, size=P24_SYS).astype(np.int32)
    reqs = [InferenceRequest(f"s{i % P24_SESSIONS}", f"r{i}", np.concatenate(
        [sys_prompt, rng.integers(0, V, size=P24_UNIQUE).astype(np.int32)]), P24_MAX_NEW)
        for i in range(P24_REQUESTS)]
    off, ofront, _ = p24_serve(fails, model, cfg, seed, "(b) sharing off", one_turn(reqs),
                               max_seq=max_seq)
    on, front, c = p24_serve(fails, model, cfg, seed, "(b) sharing", one_turn(reqs),
                             max_seq=max_seq, prefix_sharing=True,
                             forced=tokens_by_request(ofront))
    fails.check(on.index_hits >= P24_SESSIONS,
                f"(b) index hits {on.index_hits} >= {P24_SESSIONS}")
    fails.check(on.shared_prefix_tokens == on.index_hits * P24_SYS,
                f"(b) shared prefix tokens {on.shared_prefix_tokens} == {on.index_hits} hits x "
                f"{P24_SYS}")
    n_idx, bad = on.index_unchanged()
    fails.check(n_idx > 0 and not bad,
                f"(b) all {n_idx} indexed pages bitwise as published, at the end "
                f"({len(bad)} changed)")
    logit_agreement(fails, "(b)", off, on, V)
    print(f"  (b) prefill tokens saved {on.shared_prefix_tokens}; TPOT {c['tpot_ms']:.2f} ms "
          f"(phase 3: {p3['tpot_ms']:.2f})")
    del off, on, front, ofront
    release()

    # (c) parking: multi-turn sessions, each turn 64 user tokens past the last
    user = rng.integers(0, V, size=(P24_TURNS, P24_SESSIONS, P24_TURN_TOKENS)).astype(np.int32)
    first = rng.integers(0, V, size=(P24_SESSIONS, P24_PROMPT)).astype(np.int32)
    max_seq = P24_PROMPT + (P24_TURNS - 1) * (P24_MAX_NEW + P24_TURN_TOKENS) + P24_MAX_NEW

    def turn(t):
        def make(front):
            return [InferenceRequest(f"s{s}", f"r{t * P24_SESSIONS + s}",
                                     conversation(front, first[s], user[:, s], s, t),
                                     P24_MAX_NEW) for s in range(P24_SESSIONS)]
        return make

    turns = [turn(t) for t in range(P24_TURNS)]
    off, ofront, _ = p24_serve(fails, model, cfg, seed, "(c) parking off", turns,
                               max_seq=max_seq)
    forced = tokens_by_request(ofront)
    # room for every session's journal beside every slot's worst case: no
    # journal offloads here, (c') is the run under pool pressure
    roomy = 2 * SLOTS * -(-max_seq // PAGE)
    on, front, c = p24_serve(fails, model, cfg, seed, "(c) parking", turns, max_seq=max_seq,
                             park_sessions=True, forced=forced, kv_pages=roomy)
    hits = (P24_TURNS - 1) * P24_SESSIONS
    fails.check(on.park_hits == hits, f"(c) park hits {on.park_hits} == {hits}")
    fails.check(on.cow_splits >= hits,
                f"(c) copy-on-write splits {on.cow_splits} >= {hits} (each reused span ends "
                "inside a page)")
    logit_agreement(fails, "(c)", off, on, V)
    print(f"  (c) prefill tokens saved {on.shared_prefix_tokens} (of {off.prefill_tokens} the "
          f"feature-off run prefilled); TPOT {c['tpot_ms']:.2f} ms (phase 3: "
          f"{p3['tpot_ms']:.2f})")
    del on, front
    release()
    first_turn = P24_SESSIONS * -(-(P24_PROMPT + P24_MAX_NEW - 1) // PAGE)
    small, front, _ = p24_serve(fails, model, cfg, seed, "(c') parking, small pool", turns,
                                max_seq=max_seq, park_sessions=True, forced=forced,
                                kv_pages=first_turn + P24_SMALL_POOL_SPARE)
    fails.check(small.park_offloads >= 1,
                f"(c') parked journals offloaded under pool pressure: {small.park_offloads}")
    blob = [ok for what, ok in small.unchanged if what.startswith("park-blob")]
    fails.check(len(blob) >= 1 and all(blob) and small.blob_devices == {"cpu"},
                f"(c') {len(blob)} park-blob restores bitwise the pages parked, blobs on "
                f"the host ({sorted(small.blob_devices)})")
    logit_agreement(fails, "(c')", off, small, V)
    print(f"  (c') replay checks after: {sorted({e for e, _, _ in small.checks})}")
    del off, ofront, small, front
    release()


def phase_hybrid_parking(fails: Failures, model, cfg, seed: int) -> None:
    """Phase 25 on phase 6's model: two turns of 8 sessions on 4 slots,
    parking and offload on, two preemptions forced mid-decode, against the
    same run without them."""
    import numpy as np

    from repro_torch.coord.serving_front import InferenceRequest

    rng = np.random.default_rng(seed + 25)
    V = cfg.vocab
    first = rng.integers(0, V, size=(P25_SESSIONS, P25_PROMPT)).astype(np.int32)
    user = rng.integers(0, V, size=(P25_TURNS, P25_SESSIONS, P25_TURN_TOKENS)).astype(np.int32)
    max_seq = P25_PROMPT + P25_MAX_NEW + P25_TURN_TOKENS + P25_MAX_NEW
    kv_pages = 2 * P25_SESSIONS * -(-max_seq // PAGE)   # every journal beside every slot

    def turn(t):
        def make(front):
            return [InferenceRequest(f"s{s}", f"r{t * P25_SESSIONS + s}",
                                     conversation(front, first[s], user[:, s], s, t),
                                     P25_MAX_NEW) for s in range(P25_SESSIONS)]
        return make

    turns = [turn(t) for t in range(P25_TURNS)]
    kw = dict(slots=P25_SLOTS, max_seq=max_seq, kv_pages=kv_pages, park_sessions=True,
              offload=True)
    base, bfront, _ = p24_serve(fails, model, cfg, seed, "unpreempted", turns, **kw)
    want = tokens_by_request(bfront)
    del base, bfront
    release()
    sched, front, _ = p24_serve(fails, model, cfg, seed, "two forced preemptions", turns,
                                preempts_per_turn=1, **kw)
    got = tokens_by_request(front)
    pre = sched.forced_preempts
    fails.check(len(pre) == 2 and sched.restores == sched.preemptions == 2,
                f"two preemptions forced mid-decode ({pre}), both restored "
                f"({sched.restores})")
    fails.check(all(np.array_equal(got.get(r), want[r]) for r in pre),
                f"the preempted requests' tokens {pre} bitwise the unpreempted run's")
    same = sum(np.array_equal(got.get(r), w) for r, w in want.items())
    print(f"  {same} of {len(want)} requests' tokens bitwise the unpreempted run's")
    evicted = [ok for what, ok in sched.unchanged if what.startswith("evicted")]
    rows = [(ok, "reinstalled" in what) for what, ok in sched.unchanged
            if what.startswith("unparked rows")]
    moved = sum(m for _, m in rows)
    fails.check(sched.park_evictions >= 1 and len(evicted) >= 1 and all(evicted),
                f"{sched.park_evictions} parked-slot evictions, {len(evicted)} host snapshots "
                "bitwise the h, conv and length rows parked")
    fails.check(len(rows) == sched.park_hits >= 1 and moved >= 1 and all(ok for ok, _ in rows),
                f"{len(rows)} unparks ({sched.park_hits} park hits, {moved} of them reinstalled "
                "in another slot after an eviction): h and conv bitwise the rows parked, "
                "length the reused span")
    print(f"  replay checks after: {sorted({e for e, _, _ in sched.checks})}")
    del sched, front
    release()


# -- phase 26: draft-and-verify speculative decoding ----------------------------------

SPEC_K = 3
P26_RESEED = 7                     # 26a's reject path: the target's config from seed + 7
H26_REQUESTS, H26_SLOTS = 8, 4     # 26b, recurrentgemma-2b
M26_REQUESTS, M26_SLOTS = 4, 4     # 26c, moonshot-v1-16b-a3b
P26_CHECK_PROMPT, P26_CHECK_NEW = CHUNK - 56, 300   # replay checks: one eager chunk each


class SpecTimed(TimedScheduler):
    """A :class:`TimedScheduler` that audits after every step (outside the
    timed span) and times, synchronized, the speculative round's eager
    parts: each catch-up call and each hybrid rollback replay."""

    def __init__(self, sched):
        super().__init__(sched)
        self.catchup_ms, self.rollback_ms, self.audit_errors = [], [], []
        self._in_round = False
        if not sched._spec:
            return
        catchup, chunk_logits, spec_round = (sched._draft_catchup, sched._chunk_logits,
                                             sched._spec_round)

        def timed(fn, into):
            def call(*args):
                sync()
                t0 = time.perf_counter()
                out = fn(*args)
                sync()
                into.append(1e3 * (time.perf_counter() - t0))
                return out
            return call

        timed_replay = timed(chunk_logits, self.rollback_ms)

        def chunk(*args):
            return (timed_replay if self._in_round else chunk_logits)(*args)

        def round_(*args):
            self._in_round = True
            try:
                return spec_round(*args)
            finally:
                self._in_round = False

        sched._draft_catchup = timed(catchup, self.catchup_ms)
        sched._chunk_logits = chunk
        sched._spec_round = round_

    def step(self):
        out = super().step()
        try:
            self.sched.audit()
        except AssertionError as e:
            self.audit_errors.append(str(e))
        return out


def workload_prompts(vocab: int, n_requests: int, prompt_len: int, seed: int) -> dict:
    """The prompts ``spawn_workload`` draws, by request id."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {f"r{i}": rng.integers(0, vocab, size=prompt_len).astype(np.int32)
            for i in range(n_requests)}


def spec_serve(fails: Failures, model, cfg, seed: int, label: str, *, draft=None, k=SPEC_K,
               n_requests, sessions, prompt, max_new, slots) -> dict:
    """Serve the workload through ``ServingFrontend`` -> ``DecodeScheduler(
    kv_mode='paged', attn_backend='gather')``, greedy, with speculation when
    ``draft`` is given; launch counts set to 0 just before the run and read
    just after.  Checks every request served in per-session FIFO order,
    tokens in the vocab, and ``audit()`` clean after every step."""
    import torch

    from repro_torch.coord.serving_front import ServingFrontend
    from repro_torch.core import SimCloud
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.moe_experts import (moe_combine_kernel, moe_experts_kernel,
                                                 moe_route_kernel)
    from repro_torch.kernels.paged_attention import paged_attention_kernel
    from repro_torch.kernels.rglru_scan import rglru_scan_kernel
    from repro_torch.launch.serve import spawn_workload
    from repro_torch.serve.scheduler import DecodeScheduler

    sched = DecodeScheduler(model, n_slots=slots, max_seq=prompt + max_new, page_size=PAGE,
                            prefill_chunk=CHUNK, attn_backend="gather", seed=seed,
                            device=DEVICE, draft_model=draft,
                            spec_k=k if draft is not None else 0)
    timed = SpecTimed(sched)
    cloud = SimCloud(seed=seed)
    front = ServingFrontend(cloud, scheduler=timed, batch_size=slots)
    spawn_workload(cloud, front, vocab=cfg.vocab, n_requests=n_requests, sessions=sessions,
                   prompt_len=prompt, max_new=max_new, seed=seed)
    sync()
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    cloud.run()
    sync()
    wall = time.perf_counter() - t0
    counts = {"paged_attention": paged_attention_kernel.launches,
              "flash_attention": flash_attention_kernel.launches,
              "rglru_scan": rglru_scan_kernel.launches,
              "moe_experts": moe_experts_kernel.launches,
              "moe_route": moe_route_kernel.launches,
              "moe_combine": moe_combine_kernel.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30 if DEVICE == "cuda" else 0.0
    served = sum(len(v) for v in front.completions.values())
    fails.check(served == n_requests, f"{label}: served {served}/{n_requests} requests")
    fifo = all(ids == sorted(ids, key=lambda r: int(r[1:]))
               for ids in front.completions.values())
    fails.check(fifo and len(front.completions) == sessions,
                f"{label}: per-session FIFO over {len(front.completions)} sessions")
    toks = tokens_by_request(front)
    fails.check(all(t.shape == (max_new,) and (t >= 0).all() and (t < cfg.vocab).all()
                    for t in toks.values()),
                f"{label}: every token in [0, {cfg.vocab}), {max_new} per request")
    fails.check(not timed.audit_errors,
                f"{label}: audit() clean after every one of {sched.steps} steps"
                + (f" ({timed.audit_errors[0]})" if timed.audit_errors else ""))
    st = sched.stats()
    ms_tok = 1e3 * timed.decode_s / max(timed.decode_only_tokens, 1)
    out = {"label": label, "sched": sched, "tokens": toks, "counts": counts, "wall_s": wall,
           "peak_gib": peak, "ms_per_token": ms_tok,
           "decode_tok_s": timed.decode_only_tokens / max(timed.decode_s, 1e-9),
           "catchup_ms": timed.catchup_ms, "rollback_ms": timed.rollback_ms, "stats": st}
    print(f"  {label}: {wall:.3f} s wall, {sched.steps} steps, {st['decode_tokens']} decode + "
          f"{st['prefill_tokens']} prefill tokens; steps without a chunk: "
          f"{timed.decode_only_tokens} tokens in {timed.decode_only_steps} steps, "
          f"{ms_tok:.3f} ms per emitted token, {out['decode_tok_s']:.1f} decode tok/s; "
          f"peak {peak:.3f} GiB")
    if sched._spec:
        cu, rb = timed.catchup_ms, timed.rollback_ms
        print(f"  {label}: k={k}, {st['spec_rounds']} rounds, acceptance "
              f"{st['spec_acceptance_rate']} ({st['spec_accepted']}/{st['spec_proposed']}), "
              f"{st['spec_steps_per_token']} verify steps per token ({st['spec_emitted']} "
              f"emitted); eager catch-up {len(cu)} calls, {sum(cu) / max(len(cu), 1):.3f} ms "
              f"mean, {max(cu, default=0.0):.3f} max; hybrid rollbacks "
              f"{st['spec_rollbacks']}, {sum(rb) / max(len(rb), 1):.3f} ms mean")
    print(f"  {label}: launches {counts}")
    return out


def spec_margins(fails: Failures, model, cfg, label: str, plain: dict, spec: dict,
                 prompts: dict, than: str = "the run without speculation") -> int:
    """Count the token streams the speculative run shares with the plain
    one; at each diverging stream's first diverging token the target,
    teacher-forced on the plain stream (a drop-free prefill of the prompt
    and the plain tokens before it), must have its top-2 logits within
    ``AGREE_REL_TOL`` of the logit scale: a near-tie that a chunk's GEMM
    order may swap.  Returns the identical count."""
    import numpy as np
    import torch

    same = [rid for rid in plain["tokens"]
            if np.array_equal(plain["tokens"][rid], spec["tokens"][rid])]
    print(f"  {label}: {len(same)} of {len(plain['tokens'])} token streams identical to "
          f"{than}")
    for rid in sorted(set(plain["tokens"]) - set(same), key=lambda r: int(r[1:])):
        a, b = plain["tokens"][rid], spec["tokens"][rid]
        j = int(np.argmax(a != b))
        ctx = np.concatenate([prompts[rid], a[:j]]).astype(np.int32)
        with torch.no_grad():
            logits, _ = model.prefill(torch.from_numpy(ctx)[None].to(DEVICE))
        row = logits[0, -1, :cfg.vocab].float()
        top = row.topk(2).values
        margin, scale = (top[0] - top[1]).item(), row.abs().max().item()
        fails.check(margin <= AGREE_REL_TOL * scale,
                    f"{label} {rid}: first divergence at token {j} ({int(a[j])} vs "
                    f"{int(b[j])}), teacher-forced top-2 margin {margin:.4g} <= "
                    f"{AGREE_REL_TOL} x {scale:.4f}")
    return len(same)


def spec_state(sched) -> dict:
    """Every tensor the draft or the verify step writes."""
    out = {f"cache.{k}": v for k, v in sched.cache.items()}
    out.update({f"draft.{k}": v for k, v in sched.draft_cache.items()})
    out.update({f"rows.{k}": v for k, v in sched._spec_rows.items()})
    out.update(last_tokens=sched.last_tokens, out_buf=sched.out_buf,
               out_pos=sched.out_pos, vtok=sched._vtok, dtok=sched._dtok)
    return out


def spec_replay_checks(fails: Failures, sched, cfg, seed: int, label: str) -> dict:
    """With every slot decoding (prompts of one eager chunk, a long budget)
    after two rounds: from one state, the draft graph's replay and the
    eager draft step, then the verify graph's replay and the eager verify
    step, every leaf they write bitwise the same (the pool's scratch page
    aside: unmapped rows write there in no fixed order, and nothing reads
    it).  Then each graph's replay timed."""
    import numpy as np

    sched.reset()
    rng = np.random.default_rng(seed + 26)
    for i in range(sched.n_slots):
        sched.submit(f"c{i}", f"c{i}",
                     rng.integers(0, cfg.vocab, size=P26_CHECK_PROMPT).astype(np.int32),
                     P26_CHECK_NEW)
    r0 = sched.spec_rounds
    for _ in range(4 * sched.n_slots):
        if all(s.decoding for s in sched.slots) and sched.spec_rounds >= r0 + 2:
            break
        sched.step()
    if not fails.check(all(s.decoding for s in sched.slots),
                       f"{label}: every slot decoding for the replay checks"):
        return {}
    for key, eager in (("draft", sched._draft_step_impl), ("verify", sched._verify_impl)):
        state = spec_state(sched)
        start = {n: v.clone() for n, v in state.items()}
        got = sched.graphs.replay(key)
        got = None if got is None else [t.clone() for t in got]
        replayed = {n: v.clone() for n, v in state.items()}
        for n, v in state.items():
            v.copy_(start[n])
        want = eager()
        sync()
        diff = [n for n, v in state.items()
                if not (v[:, :-1].equal(replayed[n][:, :-1]) if n in ("cache.kp", "cache.vp")
                        else v.equal(replayed[n]))]
        if got is not None:
            diff += [f"out{i}" for i, (g, w) in enumerate(zip(got, want, strict=True))
                     if not g.equal(w)]
        fails.check(not diff, f"{label}: {key} graph replay bitwise its eager step over "
                              f"{len(state)} leaves (scratch page aside): {diff or 'all equal'}")
        del start, replayed
    times = {key: host_ms(lambda key=key: sched.graphs.replay(key), 10)
             for key in ("draft", "verify")}
    print(f"  {label}: replayed draft step {times['draft']:.3f} ms, verify step "
          f"{times['verify']:.3f} ms (10 each, host clock, synchronized)")
    graph_report(label, sched)
    return times


def phase_spec(fails: Failures, model, cfg, seed: int, name: str, drafts, *, n_requests,
               sessions, prompt, max_new, slots, min_acceptance=None) -> list:
    """Phase 26 for one target: the run without speculation, then each
    ``(label, draft, k)`` of ``drafts`` on the same requests, each held
    against it (:func:`spec_margins`); exact launch counts of the RG-LRU
    and MoE kernels; the graphs' replay checks on the first speculative
    scheduler.  Returns one summary per run."""
    from repro_torch.models.config import layer_pattern

    if DEVICE == "cuda":
        print(f"  card: {smi_line()}")
    kw = dict(n_requests=n_requests, sessions=sessions, prompt=prompt, max_new=max_new,
              slots=slots)
    prompts = workload_prompts(cfg.vocab, n_requests, prompt, seed)
    plain = spec_serve(fails, model, cfg, seed, f"{name} without speculation", **kw)
    plain.pop("sched")
    runs = [plain]
    n_rec = layer_pattern(cfg).count("r") if cfg.family == "hybrid" else 0
    L = cfg.n_layers if cfg.family == "moe" else 0
    st = plain["stats"]
    calls = st["steps"] + st["prefill_chunks"]
    fails.check(plain["counts"]["rglru_scan"] == n_rec * calls
                and plain["counts"]["moe_experts"] == 2 * L * calls
                and plain["counts"]["moe_route"] == plain["counts"]["moe_combine"] == L * calls
                and plain["counts"]["paged_attention"] == plain["counts"]["flash_attention"] == 0,
                f"{plain['label']}: rglru {plain['counts']['rglru_scan']} == {n_rec} x "
                f"{calls}, moe_experts {plain['counts']['moe_experts']} == 2 x {L} x {calls}, "
                f"route {plain['counts']['moe_route']} and combine "
                f"{plain['counts']['moe_combine']} == {L} x {calls} (decode steps + "
                f"chunks), no paged or flash launch")
    for i, (label, draft, k) in enumerate(drafts):
        run = spec_serve(fails, model, cfg, seed, f"{name} {label}", draft=draft, k=k, **kw)
        st = run["stats"]
        rounds, chunks, rb = st["spec_rounds"], st["prefill_chunks"], st["spec_rollbacks"]
        moe_calls = chunks + rounds * (k + 1) if draft is model else chunks + rounds
        c = run["counts"]
        fails.check(c["rglru_scan"] == n_rec * (rounds + chunks + rb)
                    and c["moe_experts"] == 2 * L * moe_calls
                    and c["moe_route"] == c["moe_combine"] == L * moe_calls
                    and c["paged_attention"] == c["flash_attention"] == 0,
                    f"{run['label']}: rglru {c['rglru_scan']} == {n_rec} x ({rounds} verify "
                    f"rounds + {chunks} chunks + {rb} rollback replays); moe_experts "
                    f"{c['moe_experts']} == 2 x {L} x {moe_calls}, route {c['moe_route']} and "
                    f"combine {c['moe_combine']} "
                    f"== {L} x {moe_calls} (target: chunks and verifies"
                    f"{'; self-draft: a catch-up and ' + str(k - 1) + ' draft steps a round' if draft is model else ''}); "
                    f"no paged or flash launch")
        if n_rec:
            fails.check(rb > 0, f"{run['label']}: {rb} hybrid rollbacks replayed")
        run["identical"] = spec_margins(fails, model, cfg, run["label"], plain, run, prompts)
        if min_acceptance is not None and i == 0:
            fails.check(st["spec_acceptance_rate"] >= min_acceptance,
                        f"{run['label']}: acceptance {st['spec_acceptance_rate']} >= "
                        f"{min_acceptance}")
        sched = run.pop("sched")
        if i == 0:
            run["replay_ms"] = spec_replay_checks(fails, sched, cfg, seed, run["label"])
        del sched
        runs.append(run)
        release()
    release()
    return runs


# -- phase 27: the elastic fleet -------------------------------------------------------

P27_WORKERS, P27_SLOTS = 3, 4            # 27a: minicpm-2b workers, slots each
P27_SESSIONS, P27_PER_SESSION = 6, 4     # 24 requests: A, B, C fresh, D extends C
P27_SYS_PAGES, P27_TURN_TOKENS = 2, 16   # shared system prompt; user tokens of a turn
P27_CRASHES = {("fleet:w0", "mid-decode"): 24, ("fleet:w1", "mid-restore"): 1}
P27_WEDGE_TICK, P27_SWEEP_AFTER = 30, 6  # wedge w2 at this tick, sweep this many later
H27_WORKERS, H27_SLOTS, H27_REQUESTS = 2, 4, 8   # 27b: recurrentgemma-2b

_FLEET_WORKER = None


def fleet_worker():
    """``CheckedScheduler`` as a fleet worker (defined on first use): the
    phase 24 checks, except that the decode replay is checked against its
    eager step only after the fleet's own events — every index adoption
    (a cold start scattering journaled pages into the pool the graphs
    captured) and every meta restore (a park-blob restore of a journal
    another worker left; phase 24 checks the others) — plus

    - each adopted index page held bitwise against the journal blob it
      came from (its time kept apart, ``adopt_check_s``);
    - park snapshots shared by every worker (a session's latest park,
      wherever it was, is what its meta holds);
    - the graphs captured in each incarnation (between two ``reset()``s);
    - each ``step()``'s whole wall time, checks and audit included, so the
      controller's own time per tick is what is left of a tick.
    Logits are not kept (nothing here teacher-forces)."""
    global _FLEET_WORKER
    if _FLEET_WORKER is not None:
        return _FLEET_WORKER
    import torch

    from repro_torch.models import kvcache

    class FleetWorker(checked_scheduler()):
        shared_snaps = {}               # cleared by phase_fleet when it ends
        FLEET_EVENTS = frozenset({"index adoption", "meta restore"})

        def __init__(self, model, **kw):
            super().__init__(model, **kw)
            self.park_snap = self.shared_snaps
            self.adopt_check_s = 0.0
            self.step_wall = 0.0
            self.incarnation_caps = []
            self._caps_mark = 0
            self._adopted = set()
            self.adoption_checks = []     # (pages adopted, pages bitwise their blobs)

        def captures(self):
            return [key for key, _ in self.graphs.captures] if self.graphs is not None else []

        def _decode(self):
            if not self.pending_checks & self.FLEET_EVENTS:
                self.pending_checks = set()
            super()._decode()
            self.logits.clear()

        def step(self):
            sync()
            t0 = time.perf_counter()
            out = super().step()
            sync()
            self.step_wall += time.perf_counter() - t0
            return out

        def reset(self, **kw):
            n = len(self.captures())
            self.incarnation_caps.append(n - self._caps_mark)
            self._caps_mark = n
            self._adopted.clear()
            super().reset(**kw)

        def adopt_index_journal(self):
            had = set(self.prefix_index._pages)
            n = super().adopt_index_journal()
            if n:
                self.pending_checks.add("index adoption")
                new = [(h, pid) for h, pid in self.prefix_index._pages.items() if h not in had]
                sync()
                t0 = time.perf_counter()
                ok = sum(all(torch.equal(a.cpu(), b) for a, b in zip(
                    self._pages([pid]), (self.blob_store.blobs[
                        kvcache.PrefixIndex.journal_key(h)][k] for k in ("kp", "vp")),
                    strict=True)) for h, pid in new)
                self.adoption_checks.append((len(new), ok))
                self.adopt_check_s += time.perf_counter() - t0
            return n

        def adopt_parked(self, rec):
            super().adopt_parked(rec)
            self._adopted.add(rec.session)

        def _admit_paged(self, slot, req, plan):
            super()._admit_paged(slot, req, plan)
            if plan.kind == "park-blob" and req.session in self._adopted:
                self.pending_checks.add("meta restore")
                self._adopted.discard(req.session)

    _FLEET_WORKER = FleetWorker
    return FleetWorker


@contextlib.contextmanager
def scheduler_class(cls):
    """``launch.serve.build_frontend`` builds its workers from ``cls``."""
    from repro_torch.launch import serve

    saved = serve.DecodeScheduler
    serve.DecodeScheduler = cls
    try:
        yield
    finally:
        serve.DecodeScheduler = saved


def fleet_quiescent(fleet) -> list:
    """Blobs the shared store must not hold when the fleet is idle: preempt
    spills, and park journals no ``park-meta`` points at."""
    metas = {m["blob_key"] for m in fleet._iter_metas().values()}
    return [k for k in fleet.blob_store.blobs
            if k.startswith("kv/") or (k.startswith("park/") and k not in metas)]


def phase_fleet(fails: Failures, model, cfg, seed: int, label: str, *, workers: int, slots: int,
                max_seq: int, max_new: int, turns: list, cold, crashes=None,
                wedge=None) -> dict:
    """Phase 27: serve ``turns`` (each a function of the frontend so far
    that returns the turn's ``InferenceRequest``s, so a turn can extend
    the streams of the turns before it) through one unfleeted
    ``DecodeScheduler`` of a worker's shape, turn after turn (the reference
    streams); then all of them as one burst through
    ``build_frontend(fleet_size=workers)`` -> ``ServingFrontend(fleet=
    FleetController)``, membership on the port's ``FaaSKeeperService``,
    ``crashes`` the ``FaultPlan``, ``wedge`` a (tick, worker id) to wedge,
    swept ``P27_SWEEP_AFTER`` ticks later.  The fleet scales to zero, and
    ``cold``'s requests (one burst) cold-start it from the store.  Launch
    counts are set to 0 just before the fleet run and read just after."""
    import numpy as np
    import torch

    from repro_torch.coord import MembershipService
    from repro_torch.coord.serving_front import ServingFrontend
    from repro_torch.core import FaaSKeeperService, FaultPlan, SimCloud
    from repro_torch.kernels.paged_attention import paged_attention_kernel
    from repro_torch.kernels.rglru_scan import rglru_scan_kernel
    from repro_torch.launch.serve import build_frontend
    from repro_torch.serve.scheduler import DecodeScheduler

    sharing = cfg.family in ("dense", "moe")
    common = dict(page_size=PAGE, prefill_chunk=CHUNK, attn_backend="paged_kernel", seed=seed,
                  prefix_sharing=sharing, device=DEVICE)

    # the unfleeted reference: one scheduler of a worker's shape, turn by turn
    ref = TimedScheduler(DecodeScheduler(model, n_slots=slots, max_seq=max_seq,
                                         park_sessions=True, **common))
    rcloud = SimCloud(seed=seed)
    rfront = ServingFrontend(rcloud, scheduler=ref, batch_size=slots)
    by_turn = []
    for make in turns + [cold]:
        by_turn.append(make(rfront))
        serve_turn(rcloud, rfront, by_turn[-1])
    burst, cold_reqs = [r for t in by_turn[:-1] for r in t], by_turn[-1]
    everything = burst + cold_reqs
    want = tokens_by_request(rfront)
    ref_tok_s = ref.decode_only_tokens / max(ref.decode_s, 1e-9)
    ref_ms = 1e3 * ref.decode_s / max(ref.decode_only_steps, 1)
    ref_occ = ref.decode_only_tokens / max(ref.decode_only_steps, 1)
    del ref, rfront
    release()

    with scheduler_class(fleet_worker()):
        cloud = SimCloud(seed=seed)
        front = build_frontend(cloud, cfg, model, mode="continuous", batch_size=slots,
                               max_new=max_new, prompt_len=max_seq - max_new,
                               fleet_size=workers,
                               scale_to_zero=True, **common)
    fleet = front.fleet
    scheds = list(fleet._pool)
    mcloud = SimCloud(seed=seed)
    svc = FaaSKeeperService(mcloud, regions=("region-0",))
    fleet.membership = MembershipService(svc)
    fleet.faults = FaultPlan(crashes=dict(crashes or {}))

    def sweep():
        svc.start_heartbeat(period=1.0, max_runs=1)
        mcloud.run()

    tick_s, audits, wedged = [0.0], [], {}
    step = fleet.step

    def checked_step():
        if wedge is not None and fleet.steps == wedge[0] and wedge[1] in fleet.workers:
            fleet.fail_worker(wedge[1])
            wedged["at"] = fleet.steps
        if "at" in wedged and fleet.steps == wedged["at"] + P27_SWEEP_AFTER:
            sweep()
        sync()
        t0 = time.perf_counter()
        out = step()
        sync()
        tick_s[0] += time.perf_counter() - t0
        try:
            fleet.audit()
        except AssertionError as e:
            audits.append(f"tick {fleet.steps}: {e}")
        return out

    fleet.step = checked_step
    # the controller's own work outside its workers' steps, by kind
    parts = {"_spawn": 0.0, "_finish_drain": 0.0, "_kill": 0.0}

    def timed_part(name):
        fn = getattr(fleet, name)

        def call(*args):
            sync()
            t1 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                sync()
                parts[name] += time.perf_counter() - t1
        setattr(fleet, name, call)

    for name in parts:
        timed_part(name)
    before = {id(s): (s.steps, s.prefill_chunks) for s in scheds}
    sync()
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    serve_turn(cloud, front, burst)
    zero_after_burst = fleet.live_workers()
    quiet = fleet_quiescent(fleet)
    metas = len(fleet._iter_metas())
    caps_before_cold = sum(len(s.captures()) for s in scheds)
    spawns_before_cold = fleet.spawns
    serve_turn(cloud, front, cold_reqs)
    sync()
    wall = time.perf_counter() - t0
    steps = sum(s.steps - before[id(s)][0] for s in scheds)
    chunks = sum(s.prefill_chunks - before[id(s)][1] for s in scheds)
    counts = {"paged_attention": paged_attention_kernel.launches,
              "rglru_scan": rglru_scan_kernel.launches, "steps": steps, "chunks": chunks}
    sweep()
    members = fleet.membership.members()
    st = front.serving_stats()

    n = len(everything)
    got = tokens_by_request(front)
    served = sum(len(v) for v in front.completions.values())
    once = all(len(ids) == len(set(ids)) for ids in front.completions.values())
    fails.check(served == n and once and set(got) == set(want),
                f"{label}: every one of {n} requests served exactly once ({served} completions)")
    fifo = all(ids == sorted(ids, key=lambda r: int(r[1:]))
               for ids in front.completions.values())
    fails.check(fifo, f"{label}: per-session FIFO over {len(front.completions)} sessions")
    fails.check(all(t.shape == (max_new,) and (t >= 0).all() and (t < cfg.vocab).all()
                    for t in got.values()), f"{label}: every token in [0, {cfg.vocab})")
    fails.check(not audits and fleet.steps > 0,
                f"{label}: fleet.audit() clean after every one of {fleet.steps} ticks"
                + (f" ({audits[:2]})" if audits else ""))
    errs = [e for s in scheds for e in s.audit_errors]
    fails.check(not errs, f"{label}: every worker's audit() clean after every step"
                + (f" ({errs[:2]})" if errs else ""))
    fails.check(zero_after_burst == 0 and fleet.live_workers() == 0 and members == [],
                f"{label}: scaled to zero after each burst ({zero_after_burst}, "
                f"{fleet.live_workers()} live; membership {members})")
    fails.check(not quiet and not fleet_quiescent(fleet),
                f"{label}: at quiescence the store holds only committed journals, metas and "
                f"index blobs ({metas} park-metas after the burst; stray {quiet})")
    fails.check(fleet.cold_starts_from_zero == 2 and fleet.meta_adoptions >= 1,
                f"{label}: the cold start woke the fleet from zero "
                f"({fleet.cold_starts_from_zero} starts from zero) and adopted a park-meta "
                f"({fleet.meta_adoptions})")
    if sharing:
        adopted = [c for s in scheds for c in s.adoption_checks]
        fails.check(fleet.fleet_stats()["index_adopted"] > 0 and adopted
                    and all(k == ok for k, ok in adopted),
                    f"{label}: cold starts re-adopted the index journal, every page bitwise "
                    f"its blob ({adopted})")
    if crashes:
        fails.check(fleet.crashes == len(crashes),
                    f"{label}: {fleet.crashes} fail-stop crashes == the FaultPlan's "
                    f"{len(crashes)} ({sorted(p for _, p in crashes)})")
    if wedge is not None:
        fails.check(fleet.evictions == 1 and "at" in wedged,
                    f"{label}: worker {wedge[1]} wedged at tick {wedged.get('at')}, reaped by "
                    f"a heartbeat sweep ({fleet.evictions} evictions)")

    # streams against the unfleeted scheduler's
    prompts = {r.request_id: np.asarray(r.prompt, np.int32) for r in everything}
    same = spec_margins(fails, model, cfg, label, {"tokens": want}, {"tokens": got}, prompts,
                        than="the unfleeted scheduler's")

    # replay checks, captures
    checks = [(e, ok, what) for s in scheds for e, ok, what in s.checks]
    for e, ok, what in checks:
        if not ok:
            fails.check(ok, f"{label}: {what}")
    events = sorted({e for e, _, _ in checks})
    need = {"meta restore"} | ({"index adoption"} if sharing else set())
    fails.check(need <= set(events) and all(ok for _, ok, _ in checks),
                f"{label}: {len(checks)} decode replays bitwise their eager steps after "
                f"{events}")
    for s in scheds:
        for what, ok in s.unchanged:
            if not ok:
                fails.check(ok, f"{label}: {what}")
    caps = [s.captures() for s in scheds]
    recycled = caps_before_cold == sum(len(c) for c in caps)
    fails.check(all(sorted(c) == ["chunk", "decode"] for c in caps) and recycled,
                f"{label}: each worker captured its decode and chunk graphs once over "
                f"{[len(s.incarnation_caps) for s in scheds]} incarnations (captures per "
                f"incarnation {[s.incarnation_caps for s in scheds]}); the cold start's "
                f"recycled incarnation captured 0")

    n_attn = model.n_kv_layers
    fails.check(counts["paged_attention"] == n_attn * steps and counts["paged_attention"] > 0,
                f"{label}: paged kernel launches {counts['paged_attention']} == {n_attn} "
                f"attention layers x {steps} worker decode steps")
    if cfg.family == "hybrid":
        n_rec = cfg.n_layers - n_attn
        fails.check(counts["rglru_scan"] == n_rec * (steps + chunks) and chunks > 0,
                    f"{label}: rglru launches {counts['rglru_scan']} == {n_rec} RG-LRU layers x "
                    f"({steps} worker decode steps + {chunks} chunks)")

    dec_s = sum(s.decode_s for s in scheds)
    dec_tok = sum(s.decode_only_tokens for s in scheds)
    dec_steps = sum(s.decode_only_steps for s in scheds)
    ticks = fleet.steps
    # the adoption checks ran inside spawns: not the controller's time
    checks_s = sum(s.adopt_check_s for s in scheds)
    parts["_spawn"] -= checks_s
    ctrl_ms = (1e3 * (tick_s[0] - sum(s.step_wall for s in scheds) - checks_s)
               / max(ticks, 1))
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
    pools = [s.graphs.pool_bytes() / 2**20 for s in scheds if s.graphs is not None]
    print(f"  {label} [{smi_line()}]: {wall:.3f} s wall, {ticks} controller ticks, {steps} "
          f"worker decode steps, {chunks} chunks; spawns {fleet.spawns} (before the cold "
          f"start {spawns_before_cold}), retires {fleet.retires}, crashes {fleet.crashes}, "
          f"evictions {fleet.evictions}, cold starts from zero {fleet.cold_starts_from_zero}")
    print(f"  {label}: park-metas put {st['meta_puts']}, adopted {st['meta_adoptions']}, "
          f"dropped {st['meta_dropped']}; index journal puts {st['index_journal_puts']}, "
          f"pages adopted {st['index_adopted']}; blobs garbage-collected {st['gc_blobs']}")
    print(f"  {label}: captures per worker {[len(c) for c in caps]}, graph pools "
          f"{[round(p, 1) for p in pools]} MiB; peak device memory {peak / 2**30:.3f} GiB "
          f"(check copies of the pools and park snapshots included)")
    print(f"  {label}: fleet decode tok/s {dec_tok / max(dec_s, 1e-9):.1f} ({dec_tok} tokens "
          f"in {dec_steps} decode-only worker steps, {dec_s:.3f} s: "
          f"{1e3 * dec_s / max(dec_steps, 1):.2f} ms and {dec_tok / max(dec_steps, 1):.2f} "
          f"slots a step; the workers step one after another) against the unfleeted "
          f"scheduler's {ref_tok_s:.1f} ({ref_ms:.2f} ms and {ref_occ:.2f} slots a step)")
    print(f"  {label}: {ctrl_ms:.3f} ms per controller tick beyond its workers' steps "
          f"({ticks} ticks, {tick_s[0]:.3f} s in ticks, "
          f"{sum(s.step_wall for s in scheds):.3f} s in worker steps, {checks_s:.3f} s in "
          f"adoption checks); of the controller's "
          f"time: spawns (index adoption) {parts['_spawn']:.3f} s, drains (journals "
          f"externalized, then retire) {parts['_finish_drain']:.3f} s, kills (crash, "
          f"eviction and the drains' retire) {parts['_kill']:.3f} s")
    n_ext = sum(s.extracts for s in scheds)
    ext_s = sum(s.extract_s for s in scheds)
    ext_b = sum(s.extract_bytes for s in scheds)
    print(f"  {label}: {n_ext} gathers to the host ({st['index_journal_puts']} of them index "
          f"journal pages, the rest parked journals and spills; in worker steps and in "
          f"drains): {ext_s:.3f} s, {ext_b / 1e9:.3f} GB, "
          f"{1e3 * ext_s / max(n_ext, 1):.3f} ms each")
    print(f"  {label}: simulated {st['invocations']} serving invocations, "
          f"{st['worker_invocations']} worker invocations (${st['worker_cost_usd']:.6f}), "
          f"total ${st['cost_usd']:.6f}, storage ${st['offload_storage_usd']:.6f} in "
          f"{st['offload_storage_ops']} ops + ${st['park_storage_usd']:.9f} retention, "
          f"{cloud.now:.3f} s simulated")
    print(f"  {label}: kernel launches {counts}")
    out = dict(counts, same=same, n=n, decode_tok_s=dec_tok / max(dec_s, 1e-9),
               ref_tok_s=ref_tok_s, ctrl_ms=ctrl_ms)
    fleet_worker().shared_snaps.clear()
    del front, fleet, scheds
    release()
    return out


def p27_dense_turns(cfg, seed: int):
    """27a's traffic: 6 sessions x 4 requests of ``PROMPT`` tokens (a shared
    2-page system prompt, then unique tokens): A, B and C fresh, D
    extending C's stream by ``P27_TURN_TOKENS`` user tokens; the cold
    start's request extends session s0's D the same way.  Returns
    ``(turns, cold, max_seq)``."""
    import numpy as np

    from repro_torch.coord.serving_front import InferenceRequest

    rng = np.random.default_rng(seed + 27)
    V, S = cfg.vocab, P27_SESSIONS
    sys_p = rng.integers(0, V, size=P27_SYS_PAGES * PAGE).astype(np.int32)
    fresh = [[np.concatenate([sys_p, rng.integers(0, V, size=PROMPT - len(sys_p)).astype(
        np.int32)]) for _ in range(3)] for _ in range(S)]
    user = rng.integers(0, V, size=(S, 2, P27_TURN_TOKENS)).astype(np.int32)

    def rid(s, j):
        return f"r{P27_PER_SESSION * s + j}"

    def tok(front, r):
        return tokens_by_request(front)[r].astype(np.int32)

    def extension(front, s):
        return np.concatenate([fresh[s][2], tok(front, rid(s, 2)), user[s, 0]])

    turns = [lambda front: [InferenceRequest(f"s{s}", rid(s, j), fresh[s][j], MAX_NEW)
                            for s in range(S) for j in range(3)],
             lambda front: [InferenceRequest(f"s{s}", rid(s, 3), extension(front, s), MAX_NEW)
                            for s in range(S)]]

    def cold(front):
        return [InferenceRequest("s0", rid(S, 0), np.concatenate(
            [extension(front, 0), tok(front, rid(0, 3)), user[0, 1]]), MAX_NEW)]

    return turns, cold, PROMPT + 2 * (MAX_NEW + P27_TURN_TOKENS) + MAX_NEW


def p27_hybrid_turns(cfg, seed: int):
    """27b's traffic: ``H27_REQUESTS`` sessions of one ``H_PROMPT``-token
    request each; the cold start's request extends session s0's stream by
    ``P27_TURN_TOKENS`` user tokens (its park-meta carries the recurrent
    rows).  Returns ``(turns, cold, max_seq)``."""
    import numpy as np

    from repro_torch.coord.serving_front import InferenceRequest

    rng = np.random.default_rng(seed + 127)
    V = cfg.vocab
    first = rng.integers(0, V, size=(H27_REQUESTS, H_PROMPT)).astype(np.int32)
    user = rng.integers(0, V, size=P27_TURN_TOKENS).astype(np.int32)
    turns = [lambda front: [InferenceRequest(f"s{s}", f"r{s}", first[s], H_MAX_NEW)
                            for s in range(H27_REQUESTS)]]

    def cold(front):
        return [InferenceRequest("s0", f"r{H27_REQUESTS}", np.concatenate(
            [first[0], tokens_by_request(front)["r0"].astype(np.int32), user]), H_MAX_NEW)]

    return turns, cold, H_PROMPT + 2 * H_MAX_NEW + P27_TURN_TOKENS


# -- phase 28: whisper-base and internvl2-2b on the whole-batch serving path ----------------

WHISPER = "whisper-base"
W_REQUESTS, W_SESSIONS, W_BATCH, W_PROMPT, W_MAX_NEW = 16, 4, 8, 4, 224
VLM = "internvl2-2b"
V_REQUESTS, V_SESSIONS, V_BATCH, V_PROMPT, V_MAX_NEW = 8, 4, 4, 4096, 32
V_PATCH_TEXT = 512              # text tokens after the image prefix in 28b's patch check
P28_FORCED = 16                 # teacher-forced decode steps of the frame and patch checks


def launch_counts() -> dict:
    """Every kernel wrapper's launch count (flash also on its tensor-core route)."""
    from repro_torch.kernels.flash_attention import (flash_attention_backward_kernel,
                                                     flash_attention_kernel)
    from repro_torch.kernels.moe_experts import (moe_combine_kernel, moe_experts_kernel,
                                                 moe_route_kernel)
    from repro_torch.kernels.paged_attention import paged_attention_kernel
    from repro_torch.kernels.rglru_scan import rglru_scan_backward_kernel, rglru_scan_kernel
    from repro_torch.kernels.ssd_scan import ssd_scan_backward_kernel, ssd_scan_kernel

    return {"paged_attention": paged_attention_kernel.launches,
            "flash_attention_backward": flash_attention_backward_kernel.launches,
            "flash_backward_tensor_core":
                flash_attention_backward_kernel.launches_by_route["tensor_core"],
            "rglru_scan_backward": rglru_scan_backward_kernel.launches,
            "rglru_scan": rglru_scan_kernel.launches,
            "ssd_scan": ssd_scan_kernel.launches,
            "ssd_tensor_core": ssd_scan_kernel.launches_by_route["tensor_core"],
            "ssd_scan_backward": ssd_scan_backward_kernel.launches,
            "ssd_backward_tensor_core":
                ssd_scan_backward_kernel.launches_by_route["tensor_core"],
            "flash_attention": flash_attention_kernel.launches,
            "flash_tensor_core": flash_attention_kernel.launches_by_route["tensor_core"],
            "moe_experts": moe_experts_kernel.launches,
            "moe_experts_swiglu": moe_experts_kernel.launches_by_mode["swiglu"],
            "moe_route": moe_route_kernel.launches,
            "moe_combine": moe_combine_kernel.launches,
            **{name: w.launches for name, w in moe_backward_wrappers().items()}}


def moe_backward_wrappers() -> dict:
    """The MoE backward's wrappers by record name (each counts its own
    launches)."""
    from repro_torch.kernels.moe_experts import kernel as mk

    return {"moe_combine_backward": mk.moe_combine_backward_kernel,
            "moe_down_grad": mk.moe_down_grad_kernel,
            "moe_weight_grad": mk.moe_weight_grad_kernel,
            "moe_up_grad": mk.moe_up_grad_kernel,
            "moe_route_backward": mk.moe_route_backward_kernel}


class TimedModel:
    """Times each outer ``prefill`` and ``decode_step`` call of a model on
    the host clock, synchronized with the card, by shadowing the two
    methods on the instance (the decode step a prefill runs inside is part
    of the prefill); ``restore()`` removes the shadows."""

    def __init__(self, model):
        self.model = model
        self.prefill_s, self.step_s = [], []
        self.prefill_tokens = self.step_tokens = 0
        self._inside = False
        self.model.prefill = self._timed(model.prefill, lambda a: a[0], "prefill")
        self.model.decode_step = self._timed(model.decode_step, lambda a: a[1], "step")

    def _timed(self, fn, tokens_of, kind: str):
        def run(*args, **kw):
            if self._inside:
                return fn(*args, **kw)
            self._inside = True
            try:
                sync()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                sync()
            finally:
                self._inside = False
            tokens = tokens_of(args)
            if kind == "prefill":
                self.prefill_s.append(time.perf_counter() - t0)
                self.prefill_tokens += tokens.numel()
            else:
                self.step_s.append(time.perf_counter() - t0)
                self.step_tokens += tokens.shape[0]
            return out

        return run

    def restore(self) -> None:
        for name in ("prefill", "decode_step"):
            vars(self.model).pop(name, None)


def phase_whole_batch(fails: Failures, model, cfg, seed: int, label: str, *, n_requests: int,
                      sessions: int, batch: int, prompt: int, max_new: int) -> dict:
    """Serve the workload through ``launch/serve.build_frontend(mode=
    'continuous')``, which for a family without a per-slot decode path
    falls back to the shared whole-batch flavour (one prefill and greedy
    decode steps over each dispatched batch, on rings sized prompt + budget,
    no frames and no patches).  Launch counts are set to 0 just before the
    run and read just after.  Checks: the fallback, sampling flags refused
    there, every request served exactly once in per-session FIFO order, and
    each stream equal to the model's solo ``generate`` (B = 1) or split at
    a near-tie (phase 26's judge).  Returns the counts and the timings."""
    import numpy as np
    import torch

    from repro_torch.core import SimCloud
    from repro_torch.launch.serve import build_frontend, spawn_workload
    from repro_torch.serve.engine import generate

    kw = dict(mode="continuous", batch_size=batch, max_new=max_new, prompt_len=prompt,
              device=DEVICE)
    try:
        build_frontend(SimCloud(seed=seed), cfg, model, temperature=0.8, **kw)
        fails.check(False, f"{label}: sampling refused on the whole-batch path")
    except ValueError as e:
        fails.check("continuous scheduler" in str(e),
                    f"{label}: sampling refused on the whole-batch path ({e})")
    cloud = SimCloud(seed=seed)
    front = build_frontend(cloud, cfg, model, **kw)
    fails.check(front.scheduler is None and front.fleet is None and front.mode == "shared",
                f"{label}: mode='continuous' falls back to the shared whole-batch flavour "
                f"(mode {front.mode!r}, scheduler {front.scheduler})")
    spawn_workload(cloud, front, vocab=cfg.vocab, n_requests=n_requests, sessions=sessions,
                   prompt_len=prompt, max_new=max_new, seed=seed)
    timed = TimedModel(model)
    sync()
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        cloud.run()
        sync()
    finally:
        timed.restore()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30 if DEVICE == "cuda" else 0.0

    ids = [rid for rids in front.completions.values() for rid in rids]
    fails.check(sorted(ids) == sorted(f"r{i}" for i in range(n_requests)),
                f"{label}: {len(ids)} of {n_requests} requests served, each exactly once")
    fifo = all(rids == sorted(rids, key=lambda r: int(r[1:]))
               for rids in front.completions.values())
    fails.check(fifo and len(front.completions) == sessions,
                f"{label}: per-session FIFO over {len(front.completions)} sessions")
    served = tokens_by_request(front)
    fails.check(all(t.shape == (max_new,) and (t >= 0).all() and (t < cfg.vocab).all()
                    for t in served.values()),
                f"{label}: every token in [0, {cfg.vocab}), {max_new} per request")
    batches = len(timed.prefill_s)
    fails.check(batches >= -(-n_requests // batch) and len(timed.step_s) == batches * (max_new - 1),
                f"{label}: {batches} prefill batches (at least ceil({n_requests}/{batch})), "
                f"{len(timed.step_s)} decode steps == {batches} x {max_new - 1}")
    pf_s, st_s = sum(timed.prefill_s), sum(timed.step_s)
    out = {"counts": counts, "batches": batches, "wall_s": wall, "peak_gib": peak,
           "prefill_ms": 1e3 * pf_s / max(batches, 1),
           "prefill_tok_s": timed.prefill_tokens / max(pf_s, 1e-9),
           "step_ms": 1e3 * st_s / max(len(timed.step_s), 1),
           "decode_tok_s": timed.step_tokens / max(st_s, 1e-9)}
    st = front.serving_stats()
    print(f"  {label}: served in {wall:.3f} s wall, {batches} batches, prefill "
          f"{out['prefill_ms']:.3f} ms a batch "
          f"({', '.join(f'{1e3 * t:.3f}' for t in timed.prefill_s)}; "
          f"{timed.prefill_tokens} tokens, "
          f"{out['prefill_tok_s']:.1f} tok/s), decode {out['step_ms']:.3f} ms a step "
          f"({len(timed.step_s)} steps, {out['decode_tok_s']:.1f} tok/s), peak device memory "
          f"{peak:.3f} GiB; {st['invocations']} invocations, ${st['cost_usd']:.6f}")
    print(f"  {label}: kernel launches {counts}")

    prompts = workload_prompts(cfg.vocab, n_requests, prompt, seed)
    t0 = time.perf_counter()
    with torch.no_grad():
        solo = {rid: generate(model, torch.from_numpy(p)[None].to(DEVICE), max_new,
                              seq_len=prompt + max_new)[0].cpu().numpy()
                for rid, p in prompts.items()}
    print(f"  {label}: {n_requests} solo generates (B = 1) in {time.perf_counter() - t0:.1f} s")
    out["identical"] = spec_margins(fails, model, cfg, label, {"tokens": solo},
                                    {"tokens": served}, prompts, than="solo generate (B = 1)")
    return out


def phase_extra_inputs(fails: Failures, model, cfg, label: str, prompt, extra) -> None:
    """``generate`` with frames or patches, then its stream teacher-forced:
    the prefill's logits and ``P28_FORCED`` decode steps' logits within
    ``AGREE_REL_TOL`` of the logit scale of ``apply(tokens, *extra)`` on
    the same tokens."""
    import torch

    from repro_torch.serve.engine import generate

    P, V = prompt.shape[1], cfg.vocab
    seq_len = P + P28_FORCED + 1
    with torch.no_grad():
        stream = generate(model, prompt, P28_FORCED + 1, *extra, seq_len=seq_len)
        ctx = torch.cat([prompt, stream[:, :P28_FORCED]], dim=1)
        ref = model.apply(ctx, *extra)[..., :V].float()
        logits, cache = model.prefill(prompt, *extra, seq_len=seq_len)
        errs = [(logits[..., :V].float() - ref[:, :P]).abs().max().item()]
        for j in range(P28_FORCED):
            logits, cache = model.decode_step(cache, stream[:, j:j + 1])
            errs.append((logits[:, 0, :V].float() - ref[:, P + j]).abs().max().item())
    scale = ref.abs().max().item()
    fails.check(bool(torch.isfinite(ref).all()) and max(errs) <= AGREE_REL_TOL * scale,
                f"{label}: prefill logits (max err {errs[0]:.4g}) and {P28_FORCED} teacher-forced "
                f"decode steps (max err {max(errs[1:]):.4g}) within {AGREE_REL_TOL} x "
                f"{scale:.4f} of apply(tokens, {', '.join(str(tuple(e.shape)) for e in extra)})")


def phase_chunked_prompt(fails: Failures, model, cfg, seed: int, label: str, prompt: int) -> None:
    """A ``prompt``-token text prefill (flash, fresh and aligned) against
    the same prompt as two ``decode_step`` chunks on a fresh ring (the
    second chunk is offset into the ring, so it takes the plain path): the
    last position's logits within ``AGREE_REL_TOL`` of their scale."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed + 28)
    toks = torch.randint(0, cfg.vocab, (1, prompt), generator=gen, device=DEVICE,
                         dtype=torch.int32)
    half = prompt // 2
    with torch.no_grad():
        reset_launch_counts()
        flash, _ = model.prefill(toks)
        n_flash = launch_counts()
        cache = model.init_cache(1, prompt)
        _, cache = model.decode_step(cache, toks[:, :half])
        chunked, _ = model.decode_step(cache, toks[:, half:])
        n_chunks = launch_counts()
    a, b = flash[0, -1, :cfg.vocab].float(), chunked[0, -1, :cfg.vocab].float()
    err, scale = (a - b).abs().max().item(), b.abs().max().item()
    fails.check(n_flash["flash_attention"] == n_flash["flash_tensor_core"] == cfg.n_layers
                and n_chunks["flash_attention"] == cfg.n_layers,
                f"{label}: the {prompt}-token prefill launched flash {n_flash['flash_attention']} "
                f"times ({n_flash['flash_tensor_core']} on the tensor cores) == {cfg.n_layers} "
                f"layers, the two {half}-token chunks none")
    fails.check(err <= AGREE_REL_TOL * scale,
                f"{label}: flash prefill vs two {half}-token chunks, last position's logits max "
                f"err {err:.4g} <= {AGREE_REL_TOL} x {scale:.4f}")


def phase_whisper(fails: Failures, seed: int) -> None:
    """28a: full-width whisper-base, whole-batch serving and frames."""
    import torch

    from repro_torch import configs
    from repro_torch.models import build_model

    cfg = configs.get(WHISPER)
    ed = cfg.encdec
    print(f"[28a] full-width {WHISPER} (whole-batch): {ed.n_encoder_layers} encoder + "
          f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, {cfg.n_heads}x"
          f"{cfg.the_head_dim()} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}, {ed.n_frames} frames; "
          f"{cfg.param_count() / 1e6:.3f} M params; {W_REQUESTS} requests over {W_SESSIONS} "
          f"sessions, batch {W_BATCH}, prompt {W_PROMPT}, {W_MAX_NEW} new")
    t28 = time.perf_counter()
    model = build_model(cfg, device=DEVICE, seed=seed)
    wbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"  weights {sum(p.numel() for p in model.parameters()) / 1e6:.3f} M, "
          f"{wbytes / 1e9:.4f} GB")
    out = phase_whole_batch(fails, model, cfg, seed, WHISPER, n_requests=W_REQUESTS,
                            sessions=W_SESSIONS, batch=W_BATCH, prompt=W_PROMPT,
                            max_new=W_MAX_NEW)
    fails.check(not any(out["counts"].values()),
                f"{WHISPER}: no hand-written kernel launched ({out['counts']})")
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 28)
    frames = torch.randn(W_BATCH, ed.n_frames, cfg.d_model, generator=gen, device=DEVICE)
    prompt = torch.randint(0, cfg.vocab, (W_BATCH, W_PROMPT), generator=gen, device=DEVICE,
                           dtype=torch.int32)
    if DEVICE == "cuda":
        with torch.no_grad():
            enc_ms = cuda_time_ms(lambda i: model.encode(frames), 20, warmup=3)
        print(f"  {WHISPER}: encoder {enc_ms:.4f} ms for B = {W_BATCH} x {ed.n_frames} frames "
              f"(CUDA events)")
    reset_launch_counts()
    phase_extra_inputs(fails, model, cfg, f"{WHISPER} generate with frames", prompt, (frames,))
    counts = launch_counts()
    fails.check(not any(counts.values()),
                f"{WHISPER}: no hand-written kernel launched with frames ({counts})")
    del model
    release()
    print(f"  phase 28a wall {time.perf_counter() - t28:.1f} s")


def phase_vlm(fails: Failures, seed: int) -> dict:
    """28b: full-width internvl2-2b, whole-batch serving (flash prefill),
    the flash prefill against chunks, patches, and flash timed at the
    prefill's shape; returns flash's record for the kernels line."""
    import torch

    from repro_torch import configs
    from repro_torch.models import build_model

    cfg = configs.get(VLM)
    print(f"[28b] full-width {VLM} (whole-batch): {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}x{cfg.the_head_dim()} heads over {cfg.n_kv_heads}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}, {cfg.vlm.n_patches} patches of {cfg.vlm.patch_dim}; param_count "
          f"{cfg.param_count() / 1e9:.3f} B (no projector); {V_REQUESTS} requests over "
          f"{V_SESSIONS} sessions, batch {V_BATCH}, text prompt {V_PROMPT}, {V_MAX_NEW} new")
    t28 = time.perf_counter()
    model = build_model(cfg, device=DEVICE, seed=seed)
    wbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"  weights {sum(p.numel() for p in model.parameters()) / 1e9:.4f} B, "
          f"{wbytes / 1e9:.3f} GB")
    out = phase_whole_batch(fails, model, cfg, seed, VLM, n_requests=V_REQUESTS,
                            sessions=V_SESSIONS, batch=V_BATCH, prompt=V_PROMPT,
                            max_new=V_MAX_NEW)
    c = out["counts"]
    fails.check(c["flash_attention"] == c["flash_tensor_core"] == cfg.n_layers * out["batches"],
                f"{VLM}: flash launches {c['flash_attention']} == {cfg.n_layers} layers x "
                f"{out['batches']} prefill batches, {c['flash_tensor_core']} on the tensor cores")
    fails.check(not any(c[k] for k in ("paged_attention", "rglru_scan", "ssd_scan",
                                       "moe_experts", "moe_route", "moe_combine")),
                f"{VLM}: no paged, RG-LRU, SSD or MoE launch")
    phase_chunked_prompt(fails, model, cfg, seed, VLM, V_PROMPT)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 29)
    patches = torch.randn(1, cfg.vlm.n_patches, cfg.vlm.patch_dim, generator=gen, device=DEVICE)
    text = torch.randint(0, cfg.vocab, (1, V_PATCH_TEXT), generator=gen, device=DEVICE,
                         dtype=torch.int32)
    reset_launch_counts()
    phase_extra_inputs(fails, model, cfg, f"{VLM} generate with patches", text, (patches,))
    n = launch_counts()["flash_attention"]
    fails.check(n == 0, f"{VLM}: no flash launch with {cfg.vlm.n_patches} patches and "
                f"{V_PATCH_TEXT} text tokens ({n})")
    del model
    release()
    record = None
    if DEVICE == "cuda":
        record = phase_flash_timing(fails, seed, VLM, (1, V_PROMPT, cfg.n_heads, cfg.n_kv_heads,
                                                       cfg.the_head_dim()), None,
                                    c["flash_attention"])
    print(f"  phase 28b wall {time.perf_counter() - t28:.1f} s")
    return record


# -- phases 29-30: the flash backward and the RG-LRU backward ---------------------------------


FLASH_BWD_CASES = [  # (B, S, H, Hkv, D, window)
    (1, 16, 1, 1, 8, None),              # D 8, G 1
    (2, 77, 4, 2, 16, 8),                # G 2, window 8, S off the tile, B 2
    (1, 130, 10, 1, 256, 8),             # D 256, G 10
    (2, 300, 40, 8, 128, None),          # G 5
    (1, 333, 4, 4, 64, 2048),            # a window longer than S
    (2, 700, 8, 2, 64, None),
    (1, 2100, 10, 1, 256, 2048),         # the hybrid's window in play
    (1, 1000, 36, 36, 64, None),         # minicpm-2b's heads
]
LSE_TOL = 1e-5
RGLRU_BWD_SHAPES = [(B, L, W, kind) for B, L, W, kind in RGLRU_CASES] + [(1, 4096, 2560, "random")]


def flash_grads_plain32(q, k, v, do, window):
    """The plain fp32 forward (o, lse) and backward on fp32 copies of the inputs."""
    from repro_torch.kernels.flash_attention import (flash_attention_backward_plain,
                                                     flash_attention_plain)

    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    o32, lse32 = flash_attention_plain(q32, k32, v32, window=window, return_lse=True)
    return o32, lse32, flash_attention_backward_plain(q32, k32, v32, o32, lse32, do32,
                                                      window=window)


def bwd_bound_check(fails: Failures, label: str, got, q, k, v, o, lse, do, window) -> tuple:
    """Each bf16 gradient element within ``ref.py::bf16_backward_rounding_bound``
    of the fp32 plain backward on the same inputs (the kernel forward's o and
    lse).  Also prints the share of elements whose |plain value| exceeds its
    bound (a kernel that wrote zeros there would fail).  Returns (want, bound)."""
    from repro_torch.kernels.flash_attention.ref import bf16_backward_rounding_bound

    want, bound = bf16_backward_rounding_bound(q, k, v, o, lse, do, window=window)
    parts = []
    ok = True
    for gname, g, w, b in zip(("dq", "dk", "dv"), got, want, bound, strict=True):
        d = (g.float() - w).abs()
        worst = (d / b).max().item()
        above = (w.abs() > b).float().mean().item()
        ok = ok and worst <= 1.0
        parts.append(f"{gname} worst err/bound {worst:.3g} ({above:.0%} of |plain| above it)")
        del d
    fails.check(ok, f"{label}: every bf16 gradient element within bf16_backward_rounding_bound "
                f"of the fp32 plain backward on the same inputs: " + ", ".join(parts))
    return want, bound


def bwd_rows(q, k, v, o, lse, do, rows: slice, keys: slice, window):
    """(p, dS, scaled q, dO, scale) of query ``rows`` against ``keys`` alone,
    fp32, each group's heads on their own axis (B, Hkv, G, rows, keys)."""
    import torch

    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q[:, rows].float().reshape(B, -1, Hkv, G, D)
    dog = do[:, rows].float().reshape(B, -1, Hkv, G, D)
    delta = (do[:, rows].float() * o[:, rows].float()).sum(-1)
    delta = delta.reshape(B, -1, Hkv, G).permute(0, 2, 3, 1)
    s = torch.einsum("bshgd,bthd->bhgst", qg, k[:, keys].float()) * scale
    i = torch.arange(S, device=q.device)[rows][:, None]
    j = torch.arange(S, device=q.device)[keys][None, :]
    mask = j <= i
    if window is not None:
        mask = mask & (j > i - window)
    p = torch.exp(s - lse.reshape(B, Hkv, G, S)[..., rows, None]).masked_fill(~mask, 0.0)
    dp = torch.einsum("bshgd,bthd->bhgst", dog, v[:, keys].float())
    return p, p * (dp - delta[..., None]), qg, dog, scale


def dropped_bwd_tile_effects(q, k, v, o, lse, do, window, tile: int = DROP_TILE) -> dict:
    """What a backward that left out one tile would get wrong, fp32: for dK
    and dV the middle ``tile``-key tile's gradients without the last
    ``tile`` query rows that see it (all of the group's heads), for dQ the
    last row's without the middle key tile of its attended keys.  Returns
    {name: (max |change|, the keys or row it is on)}."""
    import torch

    S = q.shape[1]
    c0 = tile * ((S // 2) // tile)
    hi = S if window is None else min(S, c0 + window)
    keys = slice(c0, c0 + tile)
    p, ds, qg, dog, scale = bwd_rows(q, k, v, o, lse, do, slice(hi - tile, hi), keys, window)
    dv = torch.einsum("bhgst,bshgd->bthd", p, dog).abs().max().item()
    dk = (torch.einsum("bhgst,bshgd->bthd", ds, qg) * scale).abs().max().item()
    i = S - 1
    lo = 0 if window is None else max(0, i - window + 1)
    c = tile * ((lo + i + 1) // (2 * tile))
    _, ds, _, _, scale = bwd_rows(q, k, v, o, lse, do, slice(i, i + 1), slice(c, c + tile),
                                  window)
    dq = (torch.einsum("bhgst,bthd->bshgd", ds, k[:, c:c + tile].float()) * scale)
    return {"dq": (dq.abs().max().item(), slice(i, i + 1)), "dk": (dk, keys),
            "dv": (dv, keys)}


def phase_flash_backward_cases(fails: Failures, seed: int) -> None:
    import torch

    from repro_torch.kernels.flash_attention import (flash_attention_backward_kernel,
                                                     flash_attention_kernel)
    from repro_torch.kernels.flash_attention.kernel import library_plan, route
    from repro_torch.kernels.flash_attention.plan import HEAD_DIMS, plan

    gen = torch.Generator(device="cuda").manual_seed(seed)
    bwd = flash_attention_backward_kernel
    flash_bwd_ptxas_report(fails)
    for D in HEAD_DIMS:
        fails.check(library_plan(D) == plan(D)._asdict(),
                    f"the wgmma backward's tiles at D={D} as the library states them "
                    f"{library_plan(D)} are plan.py's")
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        tol = TOL[name]
        for B, S, H, Hkv, D, window in FLASH_BWD_CASES:
            q, k, v = flash_inputs(gen, B, S, S, H, Hkv, D, dtype)
            do = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
            path = route(dtype, D)
            label = (f"flash backward ({path}) {name} [B={B} S={S} H={H} Hkv={Hkv} D={D} "
                     f"window={window}]")
            o0 = flash_attention_kernel(q, k, v, window=window)
            o, lse = flash_attention_kernel(q, k, v, window=window, return_lse=True)
            o32, lse32, want = flash_grads_plain32(q, k, v, do, window)
            lse_err = (lse - lse32).abs().max().item()
            fails.check(torch.equal(o0, o) and lse_err <= LSE_TOL,
                        f"{label}: the forward with lse is bitwise the forward without it; "
                        f"lse within {LSE_TOL} of the plain version's (max err {lse_err:.3g})")
            n0, r0 = bwd.launches, bwd.launches_by_route[path]
            d0 = dict(bwd.launches_by_design)
            got = bwd(q, k, v, o, lse, do, window=window)
            again = bwd(q, k, v, o, lse, do, window=window)
            sync()
            design = [d for d in d0 if bwd.launches_by_design[d] != d0[d]]
            want_design = ("cuda_core" if path == "cuda_core"
                           else "wgmma" if D in HEAD_DIMS else "mma_sync")
            fails.check(design == [want_design] and bwd.launches_by_design[want_design]
                        == d0[want_design] + 2,
                        f"{label}: both calls on the {want_design} design ({design})")
            errs = {}
            for gname, g, w in zip(("dq", "dk", "dv"), got, want, strict=True):
                scale = w.abs().max().item()
                errs[gname] = (g.float() - w).abs().max().item() / max(scale, 1e-30)
            finite = all(torch.isfinite(g).all().item() for g in got)
            fails.check(bwd.launches == n0 + 2 and bwd.launches_by_route[path] == r0 + 2
                        and finite and all(e <= tol for e in errs.values()),
                        f"{label}: max err / max |plain fp32 grad| "
                        + ", ".join(f"{g} {e:.3g}" for g, e in errs.items()) + f" <= {tol}")
            fails.check(all(torch.equal(a, b) for a, b in zip(got, again, strict=True)),
                        f"{label}: two launches bitwise equal")
            if dtype == torch.bfloat16:
                bwd_bound_check(fails, label, got, q, k, v, o, lse, do, window)
            if dtype == torch.bfloat16 and D % 16 == 0:
                fails.check(path == "tensor_core", f"{label}: took the tensor-core route")
    q, k, v = flash_inputs(gen, 1, 64, 64, 2, 1, 64, torch.bfloat16)
    o, lse = flash_attention_kernel(q, k, v, return_lse=True)
    k2, v2 = k[:, :32].contiguous(), v[:, :32].contiguous()
    for label, call in (("a non-causal mask", lambda: bwd(q, k, v, o, lse, o, causal=False)),
                        ("S != T", lambda: bwd(q, k2, v2, o, lse, o))):
        try:
            call()
            fails.check(False, f"flash backward refuses {label}")
        except NotImplementedError as e:
            fails.check(True, f"flash backward refuses {label}: {e}")


def phase_rglru_backward_cases(fails: Failures, seed: int) -> None:
    import torch

    from repro_torch.kernels.rglru_scan import (rglru_scan, rglru_scan_backward_kernel,
                                                rglru_scan_backward_plain, rglru_scan_plain)

    gen = torch.Generator().manual_seed(seed)
    for B, L, W, kind in RGLRU_BWD_SHAPES:
        a, _ = rglru_inputs(gen, B, L, W, kind, torch.float32)
        g = torch.randn(B, L, W, generator=gen).to(DEVICE)
        n0 = rglru_scan_backward_kernel.launches
        got = rglru_scan_backward_kernel(a, g)
        want = rglru_scan_backward_plain(a, g)
        sync()
        err = (got - want).abs().max().item()
        fails.check(rglru_scan_backward_kernel.launches == n0 + 1 and torch.equal(got, want),
                    f"rglru backward (one reverse-mode launch) vs the plain reverse fold fp32 "
                    f"[B={B} L={L} W={W} {kind}]: bitwise (max err {err:.3g})")
    a, b = rglru_inputs(gen, 2, 300, 2560, "resets", torch.float32)
    g = torch.randn(2, 300, 2560, generator=gen).to(DEVICE)
    grads = []
    for fn in (rglru_scan, rglru_scan_plain):
        a1, b1 = a.clone().requires_grad_(), b.clone().requires_grad_()
        fn(a1, b1).backward(g)
        grads.append((a1.grad, b1.grad))
    fails.check(all(torch.equal(x, y) for x, y in zip(*grads, strict=True)),
                "rglru_scan's autograd Function (kernel forward and backward) vs autograd "
                "through the plain fold [2, 300, 2560 resets]: da and db bitwise")


def attention_pairs(S: int, window) -> int:
    """(row, key) pairs a causal self-attention of S rows attends."""
    return sum(min(i + 1, window or S) for i in range(S))


def flash_bwd_bound(B, S, H, Hkv, D, window):
    """(bytes, operations) of the backward: q, k, v, o and dO read once
    (bf16), lse read (fp32), dq, dk and dv written once; 10 D operations
    (S = QK^T, dP = dO V^T, dV, dK and dQ, 2 each) per query head and
    attended pair, 2.5x the forward's."""
    nbytes = B * ((4 * S * H * D + 4 * S * Hkv * D) * 2 + 4 * H * S)
    return nbytes, 10 * D * H * attention_pairs(S, window) * B


def phase_flash_backward_timing(fails: Failures, seed: int, label: str, shape,
                                window) -> list:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention_backward_kernel,
                                                     flash_attention_backward_plain,
                                                     flash_attention_kernel,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_attention.kernel import route
    from repro_torch.kernels.flash_attention.ref import bf16_rounding_bound

    B, S, H, Hkv, D = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def make(i):
        q, k, v = flash_inputs(gen, B, S, S, H, Hkv, D, torch.bfloat16)
        do = (0.1 * torch.randn(B, S, H, D, generator=gen, device="cuda")).to(torch.bfloat16)
        o, lse = flash_attention_kernel(q, k, v, window=window, return_lse=True)
        return q, k, v, o, lse, do

    nbytes, ops = flash_bwd_bound(B, S, H, Hkv, D, window)
    sets = input_sets(make, nbytes)
    n = len(sets)
    q, k, v, o, lse, do = sets[0]
    bwd = flash_attention_backward_kernel
    d0 = dict(bwd.launches_by_design)
    got = bwd(q, k, v, o, lse, do, window=window)
    design = [d for d in d0 if bwd.launches_by_design[d] != d0[d]]
    fails.check(design == ["wgmma"], f"flash backward at {label} {shape} on the wgmma design "
                f"({design})")
    o32, lse32, want = flash_grads_plain32(q, k, v, do, window)
    err = max((g.float() - w).abs().max().item() / w.abs().max().item()
              for g, w in zip(got, want, strict=True))
    abs_err = max((g.float() - w).abs().max().item() for g, w in zip(got, want, strict=True))
    fails.check(err <= TOL["bfloat16"], f"flash backward vs plain fp32 at {label} {shape}: "
                f"max err / max |grad| {err:.3g} (max abs err {abs_err:.3g})")
    fwd_err = (o.float() - o32).abs().max().item()
    lse_err = (lse - lse32).abs().max().item()
    fails.check(fwd_err <= TOL["bfloat16"] and lse_err <= LSE_TOL,
                f"flash forward with lse vs plain fp32 at {label} {shape}: o max err "
                f"{fwd_err:.3g}, lse max err {lse_err:.3g} <= {LSE_TOL}")
    del want, o32, lse32
    # per element: the backward within its rounding bound, which leaving out
    # one tile must exceed; o within the forward's (phase 16's) bound
    _, bound = bwd_bound_check(fails, f"flash backward at {label} {shape}", got,
                               q, k, v, o, lse, do, window)
    drops = dropped_bwd_tile_effects(q, k, v, o, lse, do, window)
    tols = {g: b[:, at].max().item() for (g, (_, at)), b in zip(drops.items(), bound,
                                                               strict=True)}
    fails.check(all(tols[g] < d for g, (d, _) in drops.items()),
                f"flash backward at {label}: leaving out one {DROP_TILE}-row tile moves the "
                f"gradient past its bound: " + ", ".join(
                    f"{g} by up to {d:.3g} (bound there at most {tols[g]:.3g})"
                    for g, (d, _) in drops.items())
                + " (dk, dv: the middle key tile without the last q tile that sees it; dq: "
                "the last row without the middle key tile)")
    del bound
    want_o, bound_o = bf16_rounding_bound(q, k, v, window=window)
    o_excess = ((o.float() - want_o).abs() - bound_o).max().item()
    o_last_tol = bound_o[:, -1].max().item()
    o_drop = dropped_tile_effect(*(t.float() for t in (q, k, v)), window)
    fails.check(o_excess <= 0 and o_last_tol < o_drop,
                f"flash forward with lse at {label}: o within bf16_rounding_bound of the fp32 "
                f"plain version per element (worst margin {-o_excess:.3g}); on the last row "
                f"that bound is at most {o_last_tol:.3g}, and leaving out its middle "
                f"{DROP_TILE}-key tile moves it by up to {o_drop:.3g}")
    del want_o, bound_o
    mask = None
    if window is not None:
        i = torch.arange(S, device="cuda")
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)

    kw = dict(is_causal=True) if mask is None else dict(attn_mask=mask)

    def library(j):
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in sets[j % n][:3])
        out = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=H != Hkv, **kw)
        out.backward(sets[j % n][5].transpose(1, 2))

    # SDPA's backward alone: its forward runs before the timed region and
    # keeps its graph
    graphs = []
    for j in range(n):
        ins = tuple(t.transpose(1, 2).detach().requires_grad_() for t in sets[j][:3])
        out = F.scaled_dot_product_attention(*ins, enable_gqa=H != Hkv, **kw)
        graphs.append((out, ins, sets[j][5].transpose(1, 2)))

    def library_bwd(j):
        out, ins, g = graphs[j % n]
        torch.autograd.grad(out, ins, g, retain_graph=True)

    # one library call that returns o and the log-sum-exp: k and v expanded
    # to H heads before the timed region (neither call takes GQA)
    lse_ins = [(t[0].transpose(1, 2), *(x.transpose(1, 2).repeat_interleave(H // Hkv, dim=1)
                                        for x in t[1:3])) for t in sets]
    if window is None:
        lse_name = "aten._scaled_dot_product_flash_attention (causal)"

        def library_lse(j):
            return torch.ops.aten._scaled_dot_product_flash_attention(
                *lse_ins[j % n], 0.0, True, False)[:2]
    else:
        lse_name = "aten._scaled_dot_product_efficient_attention (the window's mask as a bias)"
        bias = torch.zeros(S, S, dtype=torch.bfloat16, device="cuda").masked_fill(
            ~mask, float("-inf")).expand(B, H, S, S)

        def library_lse(j):
            return torch.ops.aten._scaled_dot_product_efficient_attention(
                *lse_ins[j % n], bias, True, 0.0, False)[:2]

    def backward(j):
        flash_attention_backward_kernel(*sets[j % n], window=window)

    def forward(j):
        flash_attention_kernel(*sets[j % n][:3], window=window, return_lse=True)

    iters = max(n, 10)
    ms = cuda_time_ms(backward, iters, warmup=2)
    by_kernel = {name: device_ms_per_launch(backward, 5, f"flash_bwd_{name}_wgmma")
                 for name in ("dq", "dkdv")}
    fwd_ms = cuda_time_ms(forward, iters, warmup=2)
    library_ms = cuda_time_ms(library, iters, warmup=2)
    library_bwd_ms = cuda_time_ms(library_bwd, iters, warmup=2)
    del graphs
    try:
        lib_o, lib_lse = library_lse(0)
        lse_gap = (lib_lse[..., :S].float() - lse).abs().max().item()   # may be padded
        o_gap = (lib_o.transpose(1, 2).float() - o.float()).abs().max().item()
        library_lse_ms = cuda_time_ms(library_lse, iters, warmup=2)
        print(f"  {lse_name}: {library_lse_ms:.4f} ms; its lse within {lse_gap:.3g} of the "
              f"kernel's, o within {o_gap:.3g}")
        del lib_o, lib_lse
    except (RuntimeError, TypeError) as e:        # a build of torch without that call
        library_lse_ms = None
        print(f"  {lse_name}: not timed ({type(e).__name__}: {str(e).splitlines()[0][:160]})")
    del lse_ins
    plain_ms = cuda_time_ms(lambda j: flash_attention_backward_plain(*sets[j % n],
                                                                     window=window), 1, warmup=1)
    plain_fwd_ms = cuda_time_ms(lambda j: flash_attention_plain(*sets[j % n][:3], window=window,
                                                                return_lse=True), 1, warmup=1)
    fwd_bytes, fwd_ops = flash_bound(S, S, H, Hkv, D, window, 2)
    fwd_bytes, fwd_ops = B * fwd_bytes + 4 * B * H * S, B * fwd_ops
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    f_bytes, f_ops = fwd_bytes / HBM_BYTES_PER_S, fwd_ops / BF16_FLOPS_PER_S
    fwd_bound = max(f_bytes, f_ops) * 1e3
    print(f"  flash backward {label} {shape} window={window} bf16 ({n} input sets): kernel "
          f"{ms:.4f} ms ({ops / (ms * 1e-3) / 1e12:.2f} TFLOP/s), bound {bound_ms:.4f} ms "
          f"({ops / 1e9:.1f} GFLOP); forward with lse {fwd_ms:.4f} ms (bound "
          f"{fwd_bound:.4f}); design {design}, device ms a launch by kernel {by_kernel}; "
          f"SDPA backward alone {library_bwd_ms:.4f} ms; "
          f"forward + backward {fwd_ms + ms:.4f} ms against SDPA forward + backward "
          f"{library_ms:.4f} ms; plain backward {plain_ms:.2f} ms, plain forward with lse "
          f"{plain_fwd_ms:.2f} ms")
    common = {"route": "cuda", "kernel_route": route(torch.bfloat16, D),
              "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
              "replaces": "src/repro/kernels/flash_attention/kernel.py:73",
              "shape": f"{label} train: q {B}x{S}x{H}x{D}, kv heads {Hkv}, "
                       f"{'causal' if window is None else f'window {window}'}, bf16",
              "launches": 0}
    return [dict(common, name="flash_attention_backward", design=design[0] if design else None,
                 max_abs_err=abs_err, max_err_over_max_grad=err, ms=ms, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by="bytes" if t_bytes >= t_ops else "operations",
                 library_ms=library_bwd_ms, library="SDPA backward (torch.autograd.grad)",
                 sdpa_fwd_plus_bwd_ms=library_ms, fwd_plus_bwd_ms=fwd_ms + ms,
                 device_ms_by_kernel=by_kernel,
                 dropped_tile_effect={g: d for g, (d, _) in drops.items()},
                 bound_where_dropped=tols),
            dict(common, name="flash_attention_lse", max_abs_err=fwd_err, max_abs_err_lse=lse_err,
                 ms=fwd_ms, plain_ms=plain_fwd_ms, bound_ms=fwd_bound,
                 bound_by="bytes" if f_bytes >= f_ops else "operations",
                 library_ms=library_lse_ms, library=lse_name)]


def phase_rglru_backward_timing(fails: Failures, seed: int, shape) -> dict:
    import torch

    from repro_torch.kernels.rglru_scan import (rglru_scan_backward_kernel,
                                                rglru_scan_backward_plain)

    B, L, W = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def make(i):
        a = torch.sigmoid(torch.randn(B, L, W, generator=gen, device="cuda")) * 0.98 + 0.01
        return a, torch.randn(B, L, W, generator=gen, device="cuda")

    sets = input_sets(make, 12 * B * L * W)
    n = len(sets)
    k0 = dict(rglru_scan_backward_kernel.launches_by_kernel)
    got = rglru_scan_backward_kernel(*sets[0])
    kernel = [k for k in k0 if rglru_scan_backward_kernel.launches_by_kernel[k] != k0[k]]
    want = rglru_scan_backward_plain(*sets[0])
    max_err = (got - want).abs().max().item()
    fails.check(torch.equal(got, want), f"rglru backward vs the plain reverse fold at {shape} "
                f"fp32: bitwise (max err {max_err:.3g})")
    iters = max(n, 20)
    ms = cuda_time_ms(lambda i: rglru_scan_backward_kernel(*sets[i % n]), iters, warmup=2)
    plain_ms = cuda_time_ms(lambda i: rglru_scan_backward_plain(*sets[i % n]), 1, warmup=1)
    elems = B * L * W
    t_bytes = 12 * elems / HBM_BYTES_PER_S          # read a and g, write dh (fp32)
    t_ops = 2 * elems / FP32_FLOPS_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    print(f"  rglru backward {shape} fp32 ({n} input sets): one reverse-mode launch ({kernel}) "
          f"{ms:.4f} ms, plain reverse fold {plain_ms:.2f} ms, bound {bound_ms:.5f} ms")
    return {"name": "rglru_scan_backward", "route": "cuda",
            "kernel_route": kernel[0] if kernel else None,
            "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
            "replaces": "src/repro/kernels/rglru_scan/kernel.py:54",
            "shape": f"a,g {B}x{L}x{W} fp32 (backward)", "launches": 0,
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None}


# -- phases 34-35: the SSD scan's backward ---------------------------------------------------


SSD_BWD_CASES = [  # (B, L, H, P, N, h0, dh_final, kind, dtype)
    (2, 300, 64, 64, 128, False, False, "random", "bfloat16"),    # mamba2-1.3b, as it trains
    (1, 2048, 64, 64, 128, True, True, "random", "bfloat16"),
    (1, 130, 64, 64, 128, True, True, "big_decay", "bfloat16"),
    (1, 256, 64, 64, 128, True, True, "random", "float32"),
    (2, 37, 6, 16, 64, True, True, "big_decay", "float32"),      # ragged, one short chunk
    (3, 200, 8, 48, 256, True, False, "dt_zero", "bfloat16"),    # N 256: 32-token chunks
    (2, 70, 6, 4, 8, False, True, "dt_zero", "bfloat16"),        # the CUDA-core forward's dims
    (2, 1, 8, 16, 64, True, True, "random", "bfloat16"),         # L = 1
    (1, 1, 6, 4, 8, False, False, "random", "float32"),
]
SSD_BWD_DROP_CHUNK = 64         # the plain version's chunk when a chunk's share is left out


def ssd_bwd_inputs(gen, B, L, H, P, N, h0, dh_final, kind, dtype):
    """``ssd_inputs`` with the backward's dy (x's dtype) and dh_final (fp32 or None)."""
    import torch

    args = ssd_inputs(gen, B, L, H, P, N, h0, kind, dtype, "cuda")
    dy = torch.randn(B, L, H, P, generator=gen, device="cuda").to(dtype)
    dhf = torch.randn(B, H, P, N, generator=gen, device="cuda") if dh_final else None
    return (*args, dy, dhf)


def ssd_bwd_margins(got, args) -> dict:
    """Each gradient of the kernel against the fp32 plain backward and
    ``bf16_backward_rounding_bound`` on the route and chunk the library
    gives these inputs: {name: (max |err|, max err / bound, within the bound
    everywhere, max effect / bound of a dropped chunk)}."""
    from repro_torch.kernels.ssd_scan.kernel import backward_chunk, backward_route
    from repro_torch.kernels.ssd_scan.ref import (BACKWARD_NAMES, bf16_backward_rounding_bound,
                                                  dropped_chunk_effects)

    x, Bm = args[0], args[3]
    _, L, _, P = x.shape
    N = Bm.shape[-1]
    want, bound = bf16_backward_rounding_bound(
        *args, kernel_chunk=backward_chunk(x.dtype, L, P, N),
        kernel_route=backward_route(x.dtype, P, N))
    effects = dropped_chunk_effects(*args, chunk=SSD_BWD_DROP_CHUNK)
    out = {}
    for name, g, w, b in zip(BACKWARD_NAMES, got, want, bound, strict=True):
        if w is None:
            continue
        err = (g.double() - w.double()).abs()
        b = b.double()
        ok = bool((err <= b).all().item())
        ratio = (err / b.clamp_min(1e-300)).max().item()
        eff = effects.get(name)
        drop = None if eff is None else (eff.double() / b.clamp_min(1e-300)).max().item()
        out[name] = (err.max().item(), ratio, ok, drop)
    return out


def phase_ssd_backward_cases(fails: Failures, seed: int) -> float:
    """34: the backward kernel against the plain backward on the card, every
    case once on the route ``backward_route`` names (the tensor-core route
    for the bf16 cases at P a multiple of 16 and N 64/128/256, the CUDA-core
    route for fp32 and P 4 / N 8), each gradient per element within
    ``bf16_backward_rounding_bound`` on that route and its chunk (its fp32
    analogue for fp32 inputs); the change a dropped chunk makes must exceed
    the bound somewhere (where an earlier chunk or h0 is there to reach,
    and not at big decay); two launches bitwise equal.  Returns the worst
    err / bound."""
    import torch

    from repro_torch.kernels.ssd_scan import ssd_scan_backward_kernel
    from repro_torch.kernels.ssd_scan.kernel import backward_route

    gen = torch.Generator(device="cuda").manual_seed(seed + 34)
    worst = 0.0
    for B, L, H, P, N, h0, dhf, kind, dt_name in SSD_BWD_CASES:
        dtype = getattr(torch, dt_name)
        path = backward_route(dtype, P, N)
        label = (f"ssd backward ({B}, {L}, {H}, {P}, {N}) {dt_name} {kind} h0={h0} "
                 f"dh_final={dhf} [{path}]")
        args = ssd_bwd_inputs(gen, B, L, H, P, N, h0, dhf, kind, dtype)
        n0 = dict(ssd_scan_backward_kernel.launches_by_route)
        got = ssd_scan_backward_kernel(*args)
        n1 = ssd_scan_backward_kernel.launches_by_route
        fails.check({k: n1[k] - n0[k] for k in n1} == {k: int(k == path) for k in n1},
                    f"{label}: one launch, on the {path} route")
        again = ssd_scan_backward_kernel(*args)
        fails.check(all((a is None and b is None) or torch.equal(a, b)
                        for a, b in zip(got, again, strict=True)),
                    f"{label}: two launches bitwise equal")
        fails.check(all(g is None or torch.isfinite(g).all().item() for g in got),
                    f"{label}: every gradient finite")
        m = ssd_bwd_margins(got, args)
        for name, (err, ratio, ok, _) in m.items():
            worst = max(worst, ratio)
            fails.check(ok, f"{label}: {name} per element within the bound (max err {err:.3g}, "
                        f"err / bound {ratio:.3g})")
        drops = {k: v[3] for k, v in m.items() if v[3] is not None}
        if (L > SSD_BWD_DROP_CHUNK or h0) and kind != "big_decay":
            # (at big decay the share that crosses a chunk boundary is
            # scaled by exp(cums) of -10 and below: under bf16's resolution)
            fails.check(max(drops.values(), default=0.0) > 1.0,
                        f"{label}: leaving out one chunk's share of the state's adjoint "
                        f"exceeds the bound (effect / bound {drops})")
        print(f"  {label}: err / bound " + ", ".join(f"{k} {v[1]:.3g}" for k, v in m.items())
              + "; dropped chunk effect / bound " + ", ".join(f"{k} {v:.3g}"
                                                             for k, v in drops.items()))
    print(f"  ssd backward: worst err / bound over {len(SSD_BWD_CASES)} cases {worst:.4g}")
    return worst


def ssd_bwd_bound(B, L, H, P, N, elt: int, Q: int):
    """(bytes, operations) of the backward: x, dy, B, C (``elt`` bytes) and
    dt read once, dx, dB, dC and ddt written once; the operations of the
    chunked adjoint at chunk ``Q``, counted once where heads share them:
    per chunk of q tokens C B^T and the intra-chunk dC and dB products
    (6 q^2 N, dG summed over heads first), and per head dy x^T and W^T dy
    (4 q^2 P), the state terms of dx, dC and dB and the two state passes
    (10 q P N)."""
    nbytes = (B * L * H * P * elt * 3            # x, dy in; dx out
              + B * L * N * elt * 4              # B, C in; dB, dC out
              + B * L * H * 4 * 2 + H * 4 * 2)   # dt in, ddt out; A, dA
    ops = 0
    for lo in range(0, L, Q):
        q = min(Q, L - lo)
        ops += B * (6 * q * q * N + H * (4 * q * q * P + 10 * q * P * N))
    return nbytes, ops


SSD_BWD_PLAN_DIMS = [(P, N) for N in (64, 128, 256) for P in (16, 48, 64, 128)]


def ssd_bwd_ptxas_report(fails: Failures) -> None:
    """Prints ``ptxas -v``'s registers, shared memory and spills for the
    tensor-core backward's kernels (the passes at N 64/128/256 and 16 or 32
    state rows, the chunk kernel at N 64/128/256); fails unless all nine are
    in the build's log."""
    from repro_torch.kernels import build

    name, seen = None, set()
    for line in build.build_log("ssd_scan").splitlines():
        m = re.search(r"(tc_state_pass_kernel|tc_chunk_kernel)ILi(\d+)E(?:Li(\d+)E)?", line)
        if "Compiling entry" in line:
            name = m and (f"{m.group(1)}<{m.group(2)}" + (f", {m.group(3)}" if m.group(3) else "")
                          + ">")
            if name:
                seen.add(name)
        elif name and ("Used" in line or "spill" in line):
            print(f"  ptxas {name}: {line.strip().replace('ptxas info    : ', '')}")
    fails.check(len(seen) == 9, f"ptxas report of ssd_scan.cu: {len(seen)} of 9 tensor-core "
                f"backward kernels ({sorted(seen)})")


def ssd_bwd_device_ms(fn, calls: int) -> dict:
    """Device ms a call by kernel of namespace ``bwd`` over ``calls`` calls
    of ``fn(i)``, from a ``torch.profiler`` trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(i)
        sync()
    by_kernel: dict = {}
    for name, start, end in kernel_intervals(prof):
        if "::bwd::" in name:
            k = name.split("::bwd::")[1].split("(")[0]
            by_kernel[k] = by_kernel.get(k, 0.0) + (end - start) / 1e3 / calls
    return by_kernel


def phase_ssd_backward_timing(fails: Failures, seed: int, shape) -> list:
    """35: the backward at the training shape (bf16, no h0, no gradient on
    the final state, as mamba2 trains) on its route, the tensor cores: CUDA
    events over launches that rotate two input sets, beside the plain
    backward; the device time of each of its kernels from a trace; the
    library's plan against ``plan.py`` for every (P, N) of
    ``SSD_BWD_PLAN_DIMS`` and the kernels' ``ptxas`` report.  Then the
    CUDA-core route at the same dims (fp32 inputs: the route's rule gives
    it fp32) timed the same way.  Returns one record a route."""
    import torch

    from repro_torch.kernels.ssd_scan import (plan, ssd_scan_backward_kernel,
                                              ssd_scan_backward_plain)
    from repro_torch.kernels.ssd_scan.kernel import backward_chunk, backward_route, library_plan

    B, L, H, P, N = shape
    bad = [(p, n) for p, n in SSD_BWD_PLAN_DIMS
           if library_plan(B, L, H, p, n) != plan.plan(B, L, H, p, n)._asdict()]
    pl = library_plan(B, L, H, P, N)
    fails.check(not bad, f"ssd backward plan: the library's equals plan.py's at (P, N) in "
                f"{SSD_BWD_PLAN_DIMS} (differs at {bad}); at {shape}: {pl}")
    print(f"  ssd backward tensor-core plan at {shape}: {pl}; plan.py agrees at "
          f"{len(SSD_BWD_PLAN_DIMS) - len(bad)} of {len(SSD_BWD_PLAN_DIMS)} (P, N)")
    ssd_bwd_ptxas_report(fails)
    records = []
    gen = torch.Generator(device="cuda").manual_seed(seed + 35)
    for dtype in (torch.bfloat16, torch.float32):
        elt = 2 if dtype == torch.bfloat16 else 4
        path = backward_route(dtype, P, N)
        sets = [ssd_bwd_inputs(gen, B, L, H, P, N, False, False, "random", dtype)
                for _ in range(2)]
        Q = backward_chunk(dtype, L, P, N)
        nbytes, ops = ssd_bwd_bound(B, L, H, P, N, elt, Q)
        n0 = dict(ssd_scan_backward_kernel.launches_by_route)
        got = ssd_scan_backward_kernel(*sets[0])
        fails.check(ssd_scan_backward_kernel.launches_by_route[path] == n0[path] + 1,
                    f"ssd backward at {shape} {dtype}: launched on the {path} route")
        m = ssd_bwd_margins(got, sets[0])
        worst = max(v[1] for v in m.values())
        fails.check(all(v[2] for v in m.values()),
                    f"ssd backward at {shape} {dtype} [{path}] within the bound "
                    f"(err / bound {worst:.3g})")
        max_err = max(v[0] for v in m.values())
        del got
        ms = cuda_time_ms(lambda i: ssd_scan_backward_kernel(*sets[i % 2]), 10, warmup=2)
        plain_ms = cuda_time_ms(lambda i: ssd_scan_backward_plain(*sets[i % 2]), 2, warmup=1)
        by_kernel = ssd_bwd_device_ms(lambda i: ssd_scan_backward_kernel(*sets[i % 2]), 4)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS_PER_S
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_fp32_ms = max(t_bytes, ops / FP32_FLOPS_PER_S) * 1e3
        print(f"  ssd backward {shape} {dtype} [{path}] (chunk {Q}): {ms:.4f} ms a call, device "
              f"ms a call by kernel {({k: round(v, 4) for k, v in by_kernel.items()})}; plain "
              f"backward {plain_ms:.2f} ms; bound {bound_ms:.5f} ms ({nbytes / 1e6:.1f} MB, "
              f"{ops / 1e9:.1f} GFLOP at {BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s bf16; "
              f"{bound_fp32_ms:.4f} ms at {FP32_FLOPS_PER_S / 1e12:.0f} TFLOP/s fp32); "
              f"err / bound {worst:.3g}")
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        records.append({
            "name": "ssd_scan_backward", "route": "cuda", "kernel_route": path,
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan/kernel.py:68",
            "shape": f"x, dy {B}x{L}x{H}x{P} {tag}, N={N}, no h0, no dh_final (backward)",
            "launches": 0, "max_abs_err": max_err, "max_err_over_bound": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_fp32_ms": bound_fp32_ms, "device_ms_by_kernel": by_kernel,
            "library_ms": None, "library": "none: no PyTorch call computes the SSD adjoint"})
        del sets
        release()
    fails.check(records[0]["kernel_route"] == "tensor_core"
                and records[1]["kernel_route"] == "cuda_core",
                f"ssd backward routes at {shape}: bf16 on {records[0]['kernel_route']}, fp32 on "
                f"{records[1]['kernel_route']}")
    return records


# -- phases 31-33: training on the card --------------------------------------------------------

TRAIN_LR = 3e-4                 # AdamWConfig's default (run_training's 3e-3 suits reduced configs)
T31_SEQ, T31_BATCH, T31_ACCUM, T31_STEPS = 4096, 8, 4, 6
T32_SEQ, T32_BATCH, T32_ACCUM, T32_STEPS = 4096, 4, 4, 4
T36_SEQ, T36_BATCH, T36_ACCUM, T36_STEPS = 4096, 8, 4, 4
T39_SEQ, T39_BATCH, T39_ACCUM, T39_STEPS, T39_LAYERS = 4096, 8, 4, 4, 4
T33_LAYERS, T33_BATCH, T33_STEPS, T33_EVERY, T33_CRASH = 2, 2, 8, 3, 7
T33_LOSS_REL, T33_GRAD_REL = 1e-3, 3e-2


def ssd_forward_flops(cfg, seq: int) -> float:
    """FLOPs of one sequence's SSD scans, forward, all layers: the JAX
    package's chunked form at the config's chunk Q (``ssd_chunked``), per
    chunk of q tokens C B^T once (2 q^2 N, one group for every head) and
    per head the (q, q) product with x (2 q^2 P), the chunk's state (2 q P
    N) and its read-out through C (2 q P N)."""
    s = cfg.ssm
    H, P, N, Q = s.n_heads(cfg.d_model), s.head_dim, s.d_state, s.chunk
    per_seq = 0
    for lo in range(0, seq, Q):
        q = min(Q, seq - lo)
        per_seq += 2 * q * q * N + H * (2 * q * q * P + 4 * q * P * N)
    return per_seq * cfg.n_layers


def active_params(cfg, n_params: int) -> int:
    """The parameters a token runs through: every one, but for the ``moe``
    family only top-k of the E routed experts of each layer (the router,
    the shared expert, attention, embedding and head all count)."""
    if cfg.family != "moe":
        return n_params
    m = cfg.moe
    per_expert = (3 if cfg.mlp == "swiglu" else 2) * cfg.d_model * m.d_expert
    return n_params - cfg.n_layers * (m.n_experts - m.top_k) * per_expert


def train_flops(cfg, n_params: int, tokens: int, seq: int) -> float:
    """Model FLOPs of one step: 6 N a token (N every parameter, the tied
    head's matmul included; for ``moe`` the active parameters,
    ``active_params``) and 12 D H a causal attended pair (forward 4,
    backward 8); for the ``ssm`` family, which attends to nothing, 3 x the
    SSD scans' forward FLOPs (``ssd_forward_flops``: forward once, backward
    twice) instead; remat's recompute not counted."""
    from repro_torch.models.config import layer_pattern

    n_params = active_params(cfg, n_params)
    if cfg.family == "ssm":
        return 6 * n_params * tokens + 3 * ssd_forward_flops(cfg, seq) * (tokens // seq)
    if cfg.family == "hybrid":
        n_attn, window = layer_pattern(cfg).count("a"), cfg.hybrid.local_window
    else:
        n_attn, window = cfg.n_layers, cfg.sliding_window
    seqs = tokens // seq
    attn = 12 * cfg.the_head_dim() * cfg.n_heads * attention_pairs(seq, window) * n_attn * seqs
    return 6 * n_params * tokens + attn


def microstep_and_optimizer(fails: Failures, cfg, seed: int, seq: int, rows: int) -> float:
    """On a fresh full model built for training: one microstep (``rows`` x
    ``seq`` tokens, forward and backward) traced by kernel class, then the
    ms of one ``adamw_update`` over its gradients (CUDA events, after a
    warm-up)."""
    import torch

    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.models import build_model
    from repro_torch.models.config import ShapeSpec
    from repro_torch.train import AdamWConfig, adamw_update
    from repro_torch.train.step import (TrainStepConfig, decay_mask, init_train_state,
                                        make_loss_fn, trainable)

    release()
    model = build_model(cfg, device=DEVICE, seed=seed, train=True)
    batch = SyntheticPipeline(cfg, ShapeSpec("t", seq, rows, "train"), DataConfig(seed=seed),
                              device=DEVICE).host_batch(0)
    if DEVICE == "cuda":
        profile_train_step(model, make_loss_fn(model, TrainStepConfig()), batch, cfg.name)
    params = trainable(model)
    make_loss_fn(model, TrainStepConfig())(batch)[0].backward()
    grads = {k: p.grad for k, p in params.items()}
    state = init_train_state(params)
    opt = AdamWConfig(lr=TRAIN_LR)
    decay = decay_mask(model)
    box = [state]

    def update(i):
        box[0] = adamw_update(grads, box[0], params, opt, decay)[0]

    if DEVICE != "cuda":
        update(0)
        return 0.0
    ms = cuda_time_ms(update, 3, warmup=1)
    fails.check(all(torch.isfinite(p).all().item() for p in list(params.values())[:4]),
                f"{cfg.name}: the timed optimiser updates leave finite weights")
    del model, params, state, grads, box, batch
    release()
    return ms


def kernel_intervals(prof) -> dict:
    """The device kernels of a trace, each once: {(name, start us, end
    us): name} from ``prof.events()`` (device type CUDA)."""
    from torch.autograd import DeviceType

    return {(e.name, e.time_range.start, e.time_range.end): e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start}


def union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def profile_train_step(model, loss_fn, batch, label: str) -> None:
    """Device time of one forward + backward by kernel class, from
    ``torch.profiler`` (a breakdown of the step, not a check).  Busy time
    is the union of the kernels' intervals on the device's clock, each
    kernel counted once; the classes sum their kernels' durations, and
    their total is printed beside the union (more than it only where
    kernels overlapped)."""
    from torch.profiler import ProfilerActivity, profile

    loss_fn(batch)[0].backward()
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss_fn(batch)[0].backward()
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    for p in model.parameters():
        p.grad = None
    kernels = kernel_intervals(prof)
    groups: dict = {}
    for (_, start, end), name in kernels.items():
        name = name.lower()
        if any(t in name for t in ("moe_data_grad", "moe_weight_grad", "moe_combine_backward",
                                    "moe_route_backward")):
            g = "MoE backward"
        elif any(t in name for t in ("moe_experts_kernel", "moe_route_kernel",
                                      "moe_combine_kernel")):
            g = "MoE forward"
        elif "flash_bwd" in name:
            g = "flash backward"
        elif "flash_attn" in name:
            g = "flash forward"
        elif "::bwd::" in name and ("state_pass" in name or "chunk_kernel" in name
                                     or "reduce_kernel" in name):
            g = "SSD backward"
        elif "ssd_" in name:
            g = "SSD forward"
        elif "rglru" in name:
            g = "rglru scan"
        elif any(t in name for t in ("gemm", "xmma", "cutlass", "cublas", "sm90", "nvjet")):
            g = "matmuls"
        elif any(t in name for t in ("softmax", "logsumexp", "nll", "cross_entropy")):
            g = "loss"
        elif "reduce" in name:
            g = "reductions"
        else:
            g = "elementwise and copies"
        n, t = groups.get(g, (0, 0.0))
        groups[g] = (n + 1, t + (end - start) / 1e3)
    busy = union_us(k[1:] for k in kernels) / 1e3
    summed = sum(t for _, t in groups.values())
    span = ((max(k[2] for k in kernels) - min(k[1] for k in kernels)) / 1e3 if kernels else 0.0)
    parts = ", ".join(f"{g} {t:.2f} ms ({n} kernels)" for g, (n, t) in
                      sorted(groups.items(), key=lambda kv: -kv[1][1]))
    print(f"  {label}: trace of one microstep's forward + backward: wall {wall:.1f} ms, "
          f"{len(kernels)} kernels from first start to last end {span:.2f} ms, device busy "
          f"{busy:.2f} ms (union of kernel intervals; their durations sum to {summed:.2f}), "
          f"idle {1 - busy / wall:.3f}: {parts or 'no device event'}")


def phase_train(fails: Failures, seed: int, arch: str, *, seq: int, global_batch: int,
                accum: int, steps: int, n_layers=None) -> dict:
    """``run_training(..., smoke=False, device=DEVICE)`` at full width and
    depth (``n_layers`` cuts the depth); every launch of the step counted
    and checked."""
    import torch

    from repro_torch import configs
    from repro_torch.launch.train import run_training
    from repro_torch.models.config import layer_pattern

    cfg = configs.get(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    n_moe = cfg.n_layers if cfg.family == "moe" else 0
    n_ssd = 0
    if cfg.family == "hybrid":
        pat = layer_pattern(cfg)
        n_attn, n_rec = pat.count("a"), pat.count("r")
    elif cfg.family == "ssm":
        n_attn, n_rec, n_ssd = 0, 0, cfg.n_layers
    else:
        n_attn, n_rec = cfg.n_layers, 0
    micro = steps * accum
    release()
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = run_training(arch, steps, smoke=False, device=DEVICE, seq_len=seq,
                       global_batch=global_batch, accum_steps=accum, lr=TRAIN_LR, seed=seed,
                       log_every=1, n_layers=n_layers)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30 if DEVICE == "cuda" else 0.0
    losses, gnorms = out["losses"], out["grad_norms"]
    fails.check(len(losses) == steps and all(math.isfinite(x) for x in losses + gnorms),
                f"{arch}: {steps} steps, every loss and grad norm finite (losses "
                f"{[round(x, 4) for x in losses]}, grad norms {[round(x, 3) for x in gnorms]})")
    fails.check(losses[-1] < losses[0], f"{arch}: the last loss {losses[-1]:.4f} below the "
                f"first {losses[0]:.4f}")
    fails.check(out["params_without_grad"] == 0,
                f"{arch}: every parameter of {out['n_params'] / 1e9:.3f} B received a gradient "
                f"at every step ({out['params_without_grad']} without)")
    fails.check(counts["flash_attention"] == 2 * n_attn * micro
                and counts["flash_attention_backward"] == n_attn * micro
                and counts["flash_tensor_core"] == counts["flash_attention"]
                and counts["flash_backward_tensor_core"] == counts["flash_attention_backward"],
                f"{arch}: flash forward launches {counts['flash_attention']} == 2 x {n_attn} "
                f"attention layers x {micro} microsteps (forward and remat recompute), backward "
                f"{counts['flash_attention_backward']} == {n_attn} x {micro}, all on the tensor "
                f"cores")
    fails.check(counts["rglru_scan"] == 2 * n_rec * micro
                and counts["rglru_scan_backward"] == n_rec * micro,
                f"{arch}: rglru forward launches {counts['rglru_scan']} == 2 x {n_rec} RG-LRU "
                f"layers x {micro}, backward {counts['rglru_scan_backward']} == {n_rec} x {micro}")
    fails.check(counts["ssd_scan"] == 2 * n_ssd * micro
                and counts["ssd_tensor_core"] == counts["ssd_scan"]
                and counts["ssd_scan_backward"] == n_ssd * micro
                and counts["ssd_backward_tensor_core"] == counts["ssd_scan_backward"],
                f"{arch}: ssd forward launches {counts['ssd_scan']} == 2 x {n_ssd} SSD layers x "
                f"{micro} (forward and remat recompute), {counts['ssd_tensor_core']} on the "
                f"tensor cores; backward {counts['ssd_scan_backward']} == {n_ssd} x {micro}, "
                f"{counts['ssd_backward_tensor_core']} on the tensor cores")
    bwd = {name: counts[name] for name in moe_backward_wrappers()}
    fails.check(counts["moe_route"] == 2 * n_moe * micro
                and counts["moe_experts"] == 4 * n_moe * micro
                and counts["moe_experts_swiglu"] == (2 * n_moe * micro if cfg.mlp == "swiglu"
                                                     else 0)
                and counts["moe_combine"] == 3 * n_moe * micro
                and all(n == n_moe * micro for n in bwd.values()),
                f"{arch}: MoE forward launches route {counts['moe_route']} == 2 x {n_moe} MoE "
                f"layers x {micro} (forward and remat recompute), experts {counts['moe_experts']} "
                f"== 4 x {n_moe} x {micro} (gate/up {counts['moe_experts_swiglu']}), combine "
                f"{counts['moe_combine']} == 3 x {n_moe} x {micro} (the forward twice and the "
                f"gather's backward); each backward kernel {bwd} == {n_moe} x {micro}")
    fails.check(counts["paged_attention"] == 0, f"{arch}: no paged launch in training")
    step_s = out["step_s"][1:] or out["step_s"]
    step_ms = 1e3 * sorted(step_s)[len(step_s) // 2]
    tokens = global_batch * seq
    flops = train_flops(cfg, out["n_params"], tokens, seq)
    mfu = flops / (step_ms * 1e-3) / BF16_FLOPS_PER_S
    opt_ms = microstep_and_optimizer(fails, cfg, seed, seq, global_batch // accum)
    active = active_params(cfg, out["n_params"])
    print(f"  {arch} training ({cfg.n_layers} layers): {steps} steps of {global_batch} x {seq} "
          f"tokens in {accum} microbatches, first step {out['step_s'][0] * 1e3:.1f} ms, median "
          f"step after it {step_ms:.1f} ms, {tokens / (step_ms * 1e-3):.0f} tokens/s, MFU "
          f"{mfu:.4f} ({flops / 1e12:.1f} TFLOP a step from {active / 1e9:.3f} B active of "
          f"{out['n_params'] / 1e9:.3f} B parameters, against {BF16_FLOPS_PER_S / 1e12:.0f} "
          f"TFLOP/s bf16 dense), peak memory {peak:.2f} GiB, optimiser update {opt_ms:.1f} ms; "
          f"run_training wall {wall:.1f} s; launches {counts}")
    return {"counts": counts, "micro": micro, "step_ms": step_ms, "mfu": mfu,
            "peak_gib": peak, "opt_ms": opt_ms, "losses": losses}


def phase_train_agreement(fails: Failures, seed: int) -> None:
    """33a: one train step of minicpm-2b at full width and 2 layers through
    the kernel Function and through the plain attention (the plain forward
    and backward of ``ref.py``), same weights and batch."""
    import torch

    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.kernels.flash_attention import (flash_attention_backward_plain,
                                                     flash_attention_plain, ops)
    from repro_torch.models import build_model
    from repro_torch.models.config import ShapeSpec
    from repro_torch.train.step import TrainStepConfig, make_loss_fn

    cfg = dataclasses.replace(configs.get(ARCH), n_layers=T33_LAYERS)
    model = build_model(cfg, device=DEVICE, seed=seed, train=True)
    batch = SyntheticPipeline(cfg, ShapeSpec("t", T31_SEQ, T33_BATCH, "train"),
                              DataConfig(seed=seed), device=DEVICE).host_batch(0)
    loss_fn = make_loss_fn(model, TrainStepConfig())
    def plain_backward(q, k, v, o, lse, do, *, causal, window):
        assert causal
        return flash_attention_backward_plain(q, k, v, o, lse, do, window=window)

    kernels = ops.flash_attention_kernel, ops.flash_attention_backward_kernel
    runs = []
    for fwd, bwd in (kernels, (flash_attention_plain, plain_backward)):
        # the Function's two module-level calls, the kernels or their plain versions
        ops.flash_attention_kernel, ops.flash_attention_backward_kernel = fwd, bwd
        try:
            loss, _ = loss_fn(batch)
            loss.backward()
        finally:
            ops.flash_attention_kernel, ops.flash_attention_backward_kernel = kernels
        runs.append((loss.item(), {k: p.grad for k, p in model.named_parameters()}))
        for p in model.parameters():
            p.grad = None
    (l_k, g_k), (l_p, g_p) = runs
    rel = {k: ((g_k[k] - g_p[k]).abs().max() / g_p[k].abs().max().clamp_min(1e-30)).item()
           for k in g_p}
    worst_leaf = max(rel, key=rel.get)
    worst = rel[worst_leaf]
    fails.check(abs(l_k - l_p) <= T33_LOSS_REL * abs(l_p) and worst <= T33_GRAD_REL,
                f"33a {ARCH} ({T33_LAYERS} layers, full width, {T33_BATCH} x {T31_SEQ}): kernel "
                f"loss {l_k:.6f} vs plain attention {l_p:.6f} (rel {abs(l_k - l_p) / l_p:.2e} <= "
                f"{T33_LOSS_REL}); worst leaf's gradient difference {worst:.3g} of its largest "
                f"|value| <= {T33_GRAD_REL} ({worst_leaf})")
    del model, runs, g_k, g_p
    release()



def phase_train_resume(fails: Failures, seed: int) -> None:
    """33b: crash at step 7 and resume through the FaaSKeeper manifest."""
    import shutil

    from repro_torch.launch.train import run_training

    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    kw = dict(smoke=False, device=DEVICE, seq_len=T31_SEQ, global_batch=T33_BATCH,
              lr=TRAIN_LR, seed=seed, n_layers=T33_LAYERS, log_every=100)
    t0 = time.perf_counter()
    full = run_training(ARCH, T33_STEPS, **kw)
    release()
    t1 = time.perf_counter()
    out1 = run_training(ARCH, T33_STEPS, ckpt_dir=str(ckpt), ckpt_every=T33_EVERY,
                        simulate_failure=T33_CRASH, **kw)
    release()
    t2 = time.perf_counter()
    try:
        out2 = run_training(ARCH, T33_STEPS, ckpt_dir=str(ckpt), resume=True, **kw)
        restored = True
    except IOError as e:
        out2, restored = {"start_step": None, "losses": []}, False
        print(f"  restore refused: {e}")
    t3 = time.perf_counter()
    release()
    resume_at = (T33_CRASH // T33_EVERY) * T33_EVERY
    fails.check(out1.get("crashed_at") == T33_CRASH and out2["start_step"] == resume_at,
                f"33b crashed at step {out1.get('crashed_at')}, resumed at step "
                f"{out2['start_step']} == {resume_at} through the FaaSKeeper manifest")
    fails.check(restored, "33b every restored leaf is bitwise what was saved (sha256 of the "
                "saved bytes, of the file read back and of the copy on the card)")
    want = full["losses"][resume_at:]
    got = out2["losses"]
    rel = max((abs(a - b) / abs(b) for a, b in zip(got, want, strict=True)), default=1.0)
    fails.check(len(got) == len(want) and rel <= T33_LOSS_REL,
                f"33b resumed losses {[round(x, 5) for x in got]} within {T33_LOSS_REL} "
                f"relative of the uninterrupted run's {[round(x, 5) for x in want]} (worst "
                f"{rel:.2e})")
    shutil.rmtree(ckpt, ignore_errors=True)
    fails.check(not ckpt.exists(), f"33b checkpoint directory {ckpt.name} removed")
    print(f"  33b walls: uninterrupted {t1 - t0:.1f} s, crashed run {t2 - t1:.1f} s (2 saves "
          f"of ~4.9 GB), resumed {t3 - t2:.1f} s")


def phase_train_refusal(fails: Failures, seed: int) -> None:
    """33c: every family trains on the card now; the paged decode kernel,
    which serves only, still refuses a CUDA input that requires grad."""
    import torch

    from repro_torch.kernels.paged_attention import paged_attention_kernel

    dev = torch.device(DEVICE)
    q = torch.randn(1, 1, 1, 64, device=dev, requires_grad=True)
    kp = torch.randn(1, 16, 1, 64, device=dev)
    table = torch.zeros(1, 1, dtype=torch.int32, device=dev)
    lens = torch.ones(1, dtype=torch.int32, device=dev)
    reset_launch_counts()
    try:
        paged_attention_kernel(q, kp, kp, table, lens, lens)
        refused = None
    except NotImplementedError as e:
        refused = str(e)
    fails.check(refused is not None and launch_counts()["paged_attention"] == 0,
                f"33c the paged kernel (serving only) refuses a query that requires grad on the "
                f"card, before any launch: {refused}")


# -- phases 37-39: the MoE backward and moonshot-v1-16b-a3b training -----------------------

# (T, E, k, D, F, shared, mode, drops): T = 1, drops with and without the
# shared expert, GELU experts, ragged segments, moonshot's widths; every
# case routes no pair to expert 0 and exactly one to expert 1
MOE_BWD_CASES = [
    (1, 4, 2, 64, 32, False, "swiglu", False),
    (37, 8, 2, 64, 48, True, "swiglu", True),
    (13, 16, 4, 128, 40, False, "gelu", True),
    (300, 64, 6, 256, 176, True, "swiglu", False),
    (512, 64, 6, 2048, 1408, True, "swiglu", True),
    (512, 64, 6, 2048, 1408, False, "swiglu", False),
    (4095, 40, 5, 1536, 96, False, "swiglu", False),   # the route backward's ragged tiles
]
# The grouped products' outputs are bf16 roundings of fp32 sums that the
# kernel and the plain version (a cuBLAS product per segment, its bf16
# reductions in fp32) take in other orders: where a rounding falls the
# other way an element moves by one bf16 step (2^-8 of itself), and the
# SwiGLU epilogue chains three roundings (dh, dh b, the products).  So each
# is held to 4 steps of its largest |element|.  Leaving one expert's
# segment out must exceed that.
MOE_BWD_TOL = 4 * 2.0 ** -8
# The route backward: dx (bf16, one rounding of an fp32 sum over E) within
# 2 steps of its largest |element|; dw (fp32 sums over T tokens in two
# orders: the kernel's an FMA chain over each split of up to 1024 tokens in
# order, the splits' partials added in split order, the plain version's
# cuBLAS's; within T 2^-24 of the sum of |terms| at worst, about sqrt(T)
# 2^-24 ~ 5e-6 of the largest |dw| at T = 8192 on these inputs) within
# 1e-4 of it, which leaving out one 64-token tile must exceed.
ROUTE_BWD_DX_TOL = 2 * 2.0 ** -8
ROUTE_BWD_DW_TOL = 1e-4
T38 = 8192                       # moonshot's training microstep: 2 x 4096 tokens


@contextlib.contextmanager
def fp32_reductions():
    """The plain versions' bf16 cuBLAS products reduce in fp32 (torch's
    default lets split-K partial sums round to bf16)."""
    import torch

    m = torch.backends.cuda.matmul
    old = m.allow_bf16_reduced_precision_reduction
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_bf16_reduced_precision_reduction = old


def moe_bwd_inputs(gen, T, E, k, D, F, shared, mode, cap, special=True):
    """One layer's forward state on the card, as ``MoEFFN`` saves it: x, the
    router's route at forced experts (distinct a token; with ``special``
    expert 0 gets no pair and expert 1 exactly one), the gathered rows, the
    gate/up pre-activations and h (both launches' outputs), ys, the
    capacity mask, and the weights (a shared expert 2F wide)."""
    import torch

    from repro_torch.kernels.moe_experts import expert_ffn, moe_route_kernel

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device=gen.device) * scale).to(
            device=DEVICE, dtype=dtype)

    lo = 2 if special and E >= k + 2 else 0
    pool = torch.arange(lo, E, device=DEVICE, dtype=torch.int32)
    pick = torch.rand(T, E - lo, generator=gen, device=gen.device).to(DEVICE).argsort(-1)[:, :k]
    idx = pool[pick].contiguous()
    if lo:
        idx[0, -1] = 1
    x = rnd(T, D)
    w = rnd(D, E, scale=D ** -0.5, dtype=torch.float32)
    r = moe_route_kernel(x, w, k, forced=idx)
    exp = {"w_up": rnd(E, D, F, scale=D ** -0.5), "w_down": rnd(E, F, D, scale=F ** -0.5)}
    if mode == "swiglu":
        exp["w_gate"] = rnd(E, D, F, scale=D ** -0.5)
    sh = None
    if shared:
        sh = {"w_gate": rnd(D, 2 * F, scale=D ** -0.5), "w_up": rnd(D, 2 * F, scale=D ** -0.5),
              "w_down": rnd(2 * F, D, scale=(2 * F) ** -0.5)}
    xs = x.index_select(0, r.tok)
    ys, y_s, (a, b, a_s, b_s, h, h_s) = expert_ffn(mode, xs, r.offsets, exp,
                                                   None if sh is None else (x, sh), save=True)
    ys2, y_s2 = expert_ffn(mode, xs, r.offsets, exp, None if sh is None else (x, sh))
    kept = None if cap is None else r.rank < cap
    return dict(x=x, w=w, r=r, exp=exp, sh=sh, xs=xs, a=a, b=b, a_s=a_s, b_s=b_s, h=h, h_s=h_s,
                ys=ys, kept=kept, same_forward=torch.equal(ys, ys2) and
                (y_s is None or torch.equal(y_s, y_s2)),
                dout=rnd(T, D), dgates=rnd(T, E, scale=1e-2, dtype=torch.float32))


def rel_max(got, want) -> float:
    """max |got - want| over max |want| (0 for an all-zero want)."""
    scale = want.float().abs().max().item()
    return (got.float() - want.float()).abs().max().item() / scale if scale else 0.0


def moe_bwd_calls(st, mode):
    """The five backward wrappers' calls on one layer's state, as
    ``MoEFFN.backward`` makes them, each with its plain version and what
    leaving one piece out does: {name: (kernel(), plain(), drop(want))}."""
    import torch

    from repro_torch.kernels.moe_experts import kernel as mk
    from repro_torch.kernels.moe_experts import ref

    r, exp, sh = st["r"], st["exp"], st["sh"]
    sw = mode == "swiglu"
    T, k = r.weights.shape
    dys, dwt = mk.moe_combine_backward_kernel(st["dout"], st["ys"], r.pos, r.weights, st["kept"])
    sh_down = None if sh is None else (st["dout"], sh["w_down"], st["a_s"], st["b_s"])
    da, db, d_s = mk.moe_down_grad_kernel(mode, dys, r.offsets, exp["w_down"], st["a"], st["b"],
                                          sh_down)
    w1, w2 = (exp["w_gate"], exp["w_up"]) if sw else (exp["w_up"], None)
    jobs = []
    if sh is not None:
        jobs += [(st["h_s"], st["dout"], None), (st["x"], d_s[0], None)]
        jobs += [(st["x"], d_s[1], None)] if sw else []
    jobs += [(st["h"], dys, r.offsets), (st["xs"], da, r.offsets)]
    jobs += [(st["xs"], db, r.offsets)] if sw else []
    sh_up = None if sh is None else (d_s[0], d_s[1], sh["w_gate"] if sw else sh["w_up"],
                                     sh["w_up"] if sw else None)
    bounds = r.offsets.tolist()
    big = max(range(len(bounds) - 1), key=lambda e: bounds[e + 1] - bounds[e])
    lo, hi = bounds[big], bounds[big + 1]

    def drop_rows(n):
        def drop(outs):         # the largest expert's segment of the n routed outputs left out
            outs = [o.clone() for o in outs]
            for o in outs[:n]:
                o[lo:hi] = 0
            return outs
        return drop

    def drop_expert(outs):
        outs = [o.clone() for o in outs]
        for o, (_, _, off) in zip(outs, jobs):
            if off is not None:
                o[big] = 0
        return outs

    ones = torch.ones(T, k, device=DEVICE)
    dxs = st["xs"].clone().normal_(generator=torch.Generator(device=DEVICE).manual_seed(T))
    dx_s = st["x"].clone().normal_(generator=torch.Generator(device=DEVICE).manual_seed(T + 1))
    tiles = min(64, T)

    def route_drop(want):
        keep = torch.ones(T, 1, device=DEVICE)
        keep[:tiles] = 0
        return list(ref.moe_route_backward_plain(st["x"], st["w"], r.gates, r.weights, r.idx,
                                                 dwt * keep, st["dgates"] * keep))

    def flat(out):
        da_, db_, ds_ = out
        return [t for t in (da_, db_, *(ds_ or ())) if t is not None]

    return {
        "moe_combine_backward": (
            lambda: mk.moe_combine_backward_kernel(st["dout"], st["ys"], r.pos, r.weights,
                                                   st["kept"]),
            lambda: ref.moe_combine_backward_plain(st["dout"], st["ys"], r.pos, r.weights,
                                                   st["kept"]), None),
        "moe_gather_backward": (
            lambda: (mk.moe_combine_kernel(dxs, r.pos, ones, None, dx_s),),
            lambda: (ref.moe_gather_backward_plain(dxs, r.pos, k, dx_s),), None),
        "moe_down_grad": (
            lambda: flat(mk.moe_down_grad_kernel(mode, dys, r.offsets, exp["w_down"], st["a"],
                                                 st["b"], sh_down)),
            lambda: flat(ref.moe_down_grad_plain(mode, dys, r.offsets, exp["w_down"], st["a"],
                                                 st["b"], sh_down)), drop_rows(2 if sw else 1)),
        "moe_weight_grad": (lambda: mk.moe_weight_grad_kernel(jobs),
                            lambda: [ref.moe_weight_grad_plain(*j) for j in jobs], drop_expert),
        "moe_up_grad": (
            lambda: [t for t in mk.moe_up_grad_kernel(da, db, r.offsets, w1, w2, sh_up)
                     if t is not None],
            lambda: [t for t in ref.moe_up_grad_plain(da, db, r.offsets, w1, w2, sh_up)
                     if t is not None], drop_rows(1)),
        "moe_route_backward": (
            lambda: mk.moe_route_backward_kernel(st["x"], st["w"], r.gates, r.weights, r.idx, dwt,
                                                 st["dgates"]),
            lambda: ref.moe_route_backward_plain(st["x"], st["w"], r.gates, r.weights, r.idx,
                                                 dwt, st["dgates"]), route_drop),
    }


def moe_bwd_check(fails: Failures, label: str, name: str, got, again, want, drop) -> float:
    """Two launches bitwise; against the plain version bitwise (combine,
    gather) or within the stated bound, which leaving a piece out exceeds.
    Returns the worst err / bound (0 for the bitwise ones)."""
    import torch

    twice = all(torch.equal(g, a) for g, a in zip(got, again))
    if drop is None:
        ok = all(torch.equal(g, w) for g, w in zip(got, want))
        fails.check(twice and ok, f"{name} {label}: two launches bitwise, bitwise the plain "
                    f"version ({len(got)} outputs)")
        return 0.0
    tols = ([ROUTE_BWD_DX_TOL, ROUTE_BWD_DW_TOL] if name == "moe_route_backward"
            else [MOE_BWD_TOL] * len(want))
    errs = [rel_max(g, w) for g, w in zip(got, want)]
    dropped = [rel_max(d, w) for d, w in zip(drop(want), want)]
    beyond = any(d > t for d, t in zip(dropped, tols))
    worst = max(e / t for e, t in zip(errs, tols))
    finite = all(torch.isfinite(g.float()).all().item() for g in got)
    fails.check(twice and finite and worst <= 1.0 and beyond,
                f"{name} {label}: two launches bitwise; err / largest |want| "
                f"{[f'{e:.3g}' for e in errs]} within {[f'{t:.3g}' for t in tols]} (worst "
                f"{worst:.3f} of the bound); leaving a piece out gives "
                f"{[f'{d:.3g}' for d in dropped]}, beyond the bound: {beyond}")
    return worst


def moe_bwd_neighbours(fails: Failures, label: str, st, gen) -> float:
    """The weight gradient's segment ends: the routed jobs (h with dys, xs
    with da and db; random bf16 of their shapes) with every odd expert's
    rows set to NaN (a) and Inf (b), then scaled by 1e4.  A segment's last
    ring stage also holds the next expert's rows, which the kernel clears
    before its wgmma reads them; every even expert's dW must stay finite
    and within MOE_BWD_TOL of the plain version (which slices the segments
    exactly), and leaving the clearing out would put NaN or 1e8-scaled
    terms there.  Returns the worst err / bound."""
    import torch

    from repro_torch.kernels.moe_experts import kernel as mk
    from repro_torch.kernels.moe_experts import ref

    offsets = st["r"].offsets
    bounds = offsets.tolist()
    E, P = len(bounds) - 1, bounds[-1]
    odd = torch.zeros(P, dtype=torch.bool, device=DEVICE)
    for e in range(1, E, 2):
        odd[bounds[e]:bounds[e + 1]] = True
    even = torch.arange(0, E, 2, device=DEVICE)
    F, D = st["h"].shape[1], st["xs"].shape[1]
    worst = 0.0
    for kind in ("NaN / Inf", "1e4-scaled"):
        jobs = []
        for a, n in ((st["h"], D), (st["xs"], F)):
            a = a.clone()
            b = torch.randn(P, n, generator=gen, device=gen.device).to(DEVICE, torch.bfloat16)
            if kind == "NaN / Inf":
                a[odd], b[odd] = float("nan"), float("inf")
            else:
                a[odd], b[odd] = a[odd] * 1e4, b[odd] * 1e4
            jobs.append((a, b, offsets))
        got = mk.moe_weight_grad_kernel(jobs)
        want = [ref.moe_weight_grad_plain(*j) for j in jobs]
        sync()
        finite = all(torch.isfinite(g[even].float()).all().item() for g in got)
        errs = [rel_max(g[even], w[even]) for g, w in zip(got, want)]
        worst = max(worst, max(errs) / MOE_BWD_TOL)
        fails.check(finite and max(errs) <= MOE_BWD_TOL,
                    f"moe_weight_grad {label}, every odd expert's rows {kind}: the even experts' "
                    f"dW finite ({finite}), err / largest |want| {[f'{e:.3g}' for e in errs]} "
                    f"within {MOE_BWD_TOL:.3g}")
    return worst


def phase_moe_backward_cases(fails: Failures, seed: int) -> dict:
    """37: every backward kernel against its plain version on the card."""
    import torch

    from repro_torch.kernels.moe_experts import route_backward_plan
    from repro_torch.kernels.moe_experts.route_plan import (backward_library_fields,
                                                            route_backward_shape)

    gen = torch.Generator(device=DEVICE).manual_seed(seed + 37)
    worst = {}
    for T, E, k, D, F, shared, mode, drops in MOE_BWD_CASES + [(T38, 64, 6, 2048, 0, 0, 0, 0)]:
        want_pl = backward_library_fields(route_backward_shape(T, D, E))
        fails.check(tuple(route_backward_plan(T, D, E, k)) == want_pl,
                    f"moe_route_backward plan [T={T} D={D} E={E}]: the library's "
                    f"{tuple(route_backward_plan(T, D, E, k))} == route_plan.py's {want_pl}")
    for T, E, k, D, F, shared, mode, drops in MOE_BWD_CASES:
        P = T * k
        cap = max(1, P // E // 2) if drops else None
        st = moe_bwd_inputs(gen, T, E, k, D, F, shared, mode, cap)
        counts = (st["r"].offsets[1:] - st["r"].offsets[:-1]).tolist()
        n_drop = 0 if cap is None else int((~st["kept"]).sum())
        label = (f"[T={T} E={E} k={k} D={D} F={F} {mode}, shared {shared}, {n_drop} pairs "
                 f"dropped, expert 0 {counts[0]} rows, expert 1 {counts[1]}]")
        fails.check(st["same_forward"] and counts[0] == 0 and counts[1] == 1,
                    f"moe_experts {label}: the gate/up launch that saves a and b gives the "
                    f"same h and ys bitwise; expert 0 empty, expert 1 one row")
        with fp32_reductions():
            for name, (kern, plain, drop) in moe_bwd_calls(st, mode).items():
                got, again = kern(), kern()
                want = plain()
                sync()
                w = moe_bwd_check(fails, label, name, got, again, want, drop)
                worst[name] = max(worst.get(name, 0.0), w)
            w = moe_bwd_neighbours(fails, label, st, gen)
            worst["moe_weight_grad, neighbours"] = max(worst.get("moe_weight_grad, neighbours",
                                                                 0.0), w)
        del st
        torch.cuda.empty_cache()
    worst["moe_route_backward, odd rows"] = route_backward_odd_rows(fails, gen)
    print(f"  worst err / bound by kernel: {worst}")
    return worst


def route_backward_odd_rows(fails: Failures, gen) -> float:
    """The route backward where the rows of x (D = 1030) and w (E = 6) are
    no 16-byte multiples (4-byte copies, the scalar tail of dx's loop), 50
    tokens: within ROUTE_BWD_DX_TOL / ROUTE_BWD_DW_TOL of the plain version,
    two launches bitwise.  Returns the worst err / bound."""
    import torch

    from repro_torch.kernels.moe_experts import kernel as mk
    from repro_torch.kernels.moe_experts import ref

    T, D, E, k = 50, 1030, 6, 2
    x = torch.randn(T, D, generator=gen, device=gen.device).to(DEVICE, torch.bfloat16)
    w = (torch.randn(D, E, generator=gen, device=gen.device) * D ** -0.5).to(DEVICE)
    r = mk.moe_route_kernel(x, w, k)
    dwt = torch.randn(T, k, generator=gen, device=gen.device).to(DEVICE)
    dgates = (torch.randn(T, E, generator=gen, device=gen.device) * 1e-2).to(DEVICE)
    got = mk.moe_route_backward_kernel(x, w, r.gates, r.weights, r.idx, dwt, dgates)
    again = mk.moe_route_backward_kernel(x, w, r.gates, r.weights, r.idx, dwt, dgates)
    with fp32_reductions():
        want = ref.moe_route_backward_plain(x, w, r.gates, r.weights, r.idx, dwt, dgates)
    sync()
    errs = [rel_max(g, w_) for g, w_ in zip(got, want)]
    tols = [ROUTE_BWD_DX_TOL, ROUTE_BWD_DW_TOL]
    twice = all(torch.equal(a, b) for a, b in zip(got, again))
    worst = max(e / t for e, t in zip(errs, tols))
    fails.check(twice and worst <= 1.0,
                f"moe_route_backward [T={T} D={D} E={E} k={k}: rows no 16-byte multiples]: two "
                f"launches bitwise {twice}; err / largest |want| {[f'{e:.3g}' for e in errs]} "
                f"within {[f'{t:.3g}' for t in tols]}")
    return worst


def moe_bwd_bounds(T, P, E, D, F, mode, shared):
    """{name: (bytes, operations, peak rate)} of each backward kernel at one
    layer: each input read once, each output written once."""
    n = 2 if mode == "swiglu" else 1
    Fs = 2 * F
    out = {
        "moe_combine_backward": (T * D * 2 + 2 * P * D * 2 + P * (4 + 4 + 1 + 4),
                                 3 * P * D, FP32_FLOPS_PER_S),
        "moe_down_grad": (P * D * 2 + E * F * D * 2 + 2 * n * P * F * 2 +
                          (T * D * 2 + Fs * D * 2 + 2 * n * T * Fs * 2 if shared else 0),
                          2 * P * D * F + (2 * T * D * Fs if shared else 0), BF16_FLOPS_PER_S),
        "moe_weight_grad": (2 * P * D * 2 + (n + 1) * P * F * 2 + (n + 1) * E * D * F * 2 +
                            ((n + 1) * T * Fs * 2 + T * D * 2 * 2 + (n + 1) * D * Fs * 2
                             if shared else 0),
                            (n + 1) * 2 * P * D * F + ((n + 1) * 2 * T * D * Fs if shared else 0),
                            BF16_FLOPS_PER_S),
        "moe_up_grad": (n * P * F * 2 + n * E * D * F * 2 + P * D * 2 +
                        (n * T * Fs * 2 + n * D * Fs * 2 + T * D * 2 if shared else 0),
                        n * 2 * P * F * D + (n * 2 * T * Fs * D if shared else 0),
                        BF16_FLOPS_PER_S),
    }
    return out


def grouped_mm_backward(st, mode):
    """Each grouped backward product through ``torch._grouped_mm`` (the
    yardstick, never on the port's path; the shared expert's by a plain
    matmul): {name: fn}, empty where this torch has no grouped product."""
    import torch

    mm = getattr(torch, "_grouped_mm", None)
    if mm is None:
        return {}
    r, exp, sh = st["r"], st["exp"], st["sh"]
    ends = r.offsets[1:]
    dys, da, db = st["ys"], st["a"], st["b"]    # stand-ins of the same shapes
    x_s = st["x"]

    def down():
        return mm(dys, exp["w_down"].transpose(1, 2), offs=ends), st["dout"] @ sh["w_down"].t()

    def up():
        return (mm(da, exp["w_gate"].transpose(1, 2), offs=ends) +
                mm(db, exp["w_up"].transpose(1, 2), offs=ends),
                st["a_s"] @ sh["w_gate"].t() + st["b_s"] @ sh["w_up"].t())

    def weight():
        return (mm(st["h"].t(), dys, offs=ends), mm(st["xs"].t(), da, offs=ends),
                mm(st["xs"].t(), db, offs=ends), st["h_s"].t() @ st["dout"],
                x_s.t() @ st["a_s"], x_s.t() @ st["b_s"])

    return {"moe_down_grad": down, "moe_up_grad": up, "moe_weight_grad": weight}


def moe_bwd_schedules(fails: Failures, st, T, P, E, D, F, mlp) -> dict:
    """The grouped products' launches at phase 38's shapes: the library's
    plan held equal to ``backward_plan.py``'s model, and the work items per
    SM that the model's map counts over these offsets (the kernels' own
    lists stay on the device).  Returns {name: printed schedule}."""
    import torch

    from repro_torch.kernels.moe_experts import backward_plan as bp
    from repro_torch.kernels.moe_experts import data_grad_plan, plan, weight_grad_plan

    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    offs = st["r"].offsets.tolist()
    out = {}
    for name, epi, n0, n1 in (("moe_down_grad", mlp, F, 2 * F), ("moe_up_grad", "plain", D, D)):
        lib = data_grad_plan(epi, P, E, n0, T, n1)
        model = bp.data_grad_plan(epi, P, E, n0, T, n1, n_sms)
        n = len(plan.items(offs, P, n0, T, n1, bm=lib.bm))
        per = plan.items_per_block(n, lib.grid)
        out[name] = f"{lib}; {n} work items, {n / lib.grid:.2f} per SM ({min(per)}-{max(per)})"
        fails.check(lib == model, f"{name} plan: the library's {lib} == backward_plan.py's")
    dims = [(T, 1, 2 * F, D), (T, 1, D, 2 * F), (T, 1, D, 2 * F), (P, E, F, D), (P, E, D, F),
            (P, E, D, F)]
    lib, model = weight_grad_plan(dims), bp.weight_grad_plan(dims, n_sms)
    jobs = [(r, M, N, None if e == 1 else offs) for r, e, M, N in dims]
    items = bp.weight_grad_items(jobs)
    stages = [len(bp.weight_grad_stages(it.lo, it.hi)) for it in items]
    per = plan.items_per_block(len(items), lib.grid)
    out["moe_weight_grad"] = (f"{lib}; {len(items)} work items, {len(items) / lib.grid:.2f} per "
                              f"SM ({min(per)}-{max(per)}), {sum(stages) / lib.grid:.1f} ring "
                              f"stages per SM")
    fails.check(lib == model and lib.items == len(items),
                f"moe_weight_grad plan: the library's {lib} == backward_plan.py's")
    for name, sched in out.items():
        print(f"  {name} schedule: {sched}")
    return out


def phase_moe_backward_timing(fails: Failures, seed: int) -> list:
    """38: each backward kernel at moonshot's training microstep (T = 8192
    tokens, P = 49152 pairs, uniform routing, capacity 1.25, the shared
    expert): CUDA-event ms, device ms (``queued_device_ms``), the plain version's ms, the
    bound, and the library yardstick (``torch._grouped_mm`` for the grouped
    products, the plain torch sequence replayed as one graph for combine
    and route)."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels.moe_experts import route_backward_plan
    from repro_torch.models.moe import capacity

    cfg = configs.get(MOE)
    m = cfg.moe
    E, k, D, F = m.n_experts, m.top_k, cfg.d_model, m.d_expert
    T, P = T38, T38 * m.top_k
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 38)
    st = moe_bwd_inputs(gen, T, E, k, D, F, True, cfg.mlp, capacity(T, m), special=False)
    calls = moe_bwd_calls(st, cfg.mlp)
    bounds = moe_bwd_bounds(T, P, E, D, F, cfg.mlp, True)
    bounds["moe_route_backward"] = (T * D * 2 + D * E * 4 + 2 * T * E * 4 + 3 * T * k * 4 +
                                    T * D * 2 + D * E * 4, 4 * T * D * E, FP32_FLOPS_PER_S)
    library = grouped_mm_backward(st, cfg.mlp)
    schedules = moe_bwd_schedules(fails, st, T, P, E, D, F, cfg.mlp)
    ptxas_report(fails, "moe_backward", "moe_data_grad_kernel", 6)
    ptxas_report(fails, "moe_backward", "moe_weight_grad_kernel", 1)
    replaces = {
        "moe_combine_backward": "src/repro/models/moe.py:90-94 (the combine's backward, XLA's "
                                "autodiff of _dispatch_ffn); no Pallas kernel",
        "moe_down_grad": "src/repro/models/moe.py:79-81 (the down einsum's and the SwiGLU's "
                         "backward, XLA's autodiff); no Pallas kernel",
        "moe_weight_grad": "src/repro/models/moe.py:79-84 (the expert einsums' weight "
                           "gradients, XLA's autodiff); no Pallas kernel",
        "moe_up_grad": "src/repro/models/moe.py:79-80 (the gate/up einsums' data gradient, "
                       "XLA's autodiff); no Pallas kernel",
        "moe_route_backward": "src/repro/models/moe.py:171-174 (the router einsum, softmax, "
                              "top_k and renormalisation's backward, XLA's autodiff); no Pallas "
                              "kernel"}
    n_drop = int((~st["kept"]).sum())
    out = []
    with fp32_reductions():
        for name, (kern, plain, drop) in calls.items():
            if name == "moe_gather_backward":
                continue            # the forward combine kernel (its record is moe_combine)
            got, again, want = kern(), kern(), plain()
            sync()
            worst = moe_bwd_check(fails, f"[moonshot training microstep T={T} P={P}, "
                                  f"{n_drop} pairs dropped]", name, got, again, want, drop)
            max_err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
            del got, again, want
            ms = cuda_time_ms(lambda i: kern(), 10, warmup=2)
            dev = queued_device_ms(lambda i: kern(), 5)
            fails.check(dev is not None, f"{name} at T={T}: device time per launch {dev} ms "
                        f"(5 launches queued behind a device sleep)")
            plain_ms = cuda_time_ms(lambda i: plain(), 2, warmup=1)
            again_ms = cuda_time_ms(lambda i: kern(), 10, warmup=0)
            lib_ms, graph_ms, note = None, None, ""
            if name in library:
                try:
                    lib_ms = cuda_time_ms(lambda i: library[name](), 10, warmup=2)
                    note = f"torch._grouped_mm (+ the shared expert's matmuls) {lib_ms:.4f} ms"
                except (RuntimeError, TypeError, ValueError, NotImplementedError) as e:
                    note = f"torch._grouped_mm refused: {str(e).splitlines()[0][:160]}"
            elif name in ("moe_combine_backward", "moe_route_backward"):
                try:
                    replay, _ = graphed(plain)
                    graph_ms = cuda_time_ms(lambda i: replay(), 10)
                    note = f"plain sequence as one replayed graph {graph_ms:.4f} ms"
                    del replay
                except RuntimeError as e:
                    note = f"the plain sequence did not capture: {str(e)[:160]}"
            nbytes, ops, rate = bounds[name]
            tb, to = nbytes / HBM_BYTES_PER_S, ops / rate
            bound = max(tb, to) * 1e3
            extra = ""
            if name == "moe_route_backward":
                extra = f"plan {route_backward_plan(T, D, E, k)}; "
            if name in schedules:
                extra = "wgmma, persistent; "
            print(f"  {name} at T={T} P={P}: {extra}kernel {ms:.4f} ms (again {again_ms:.4f}; "
                  f"device time per launch {dev} ms), {ops / (ms * 1e-3) / 1e12:.1f} TFLOP/s, "
                  f"{nbytes / (ms * 1e-3) / 1e12:.2f} TB/s; plain {plain_ms:.4f} ms; {note}; "
                  f"bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP)")
            out.append({"name": name, "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/moe_backward.cu",
                        "replaces": replaces[name],
                        "shape": f"moonshot training microstep: T={T} tokens, P={P} pairs, D={D} "
                                 f"F={F}, shared 2F, capacity {capacity(T, m)}",
                        "launches": None, "max_abs_err": max_err, "err_over_bound": worst,
                        "ms": ms, "device_ms": dev, "plain_ms": plain_ms,
                        "graphed_plain_ms": graph_ms, "bound_ms": bound,
                        "bound_by": "bytes" if tb >= to else "operations",
                        "library_ms": lib_ms, "schedule": schedules.get(name)})
    del st, calls, library
    release()
    return out


# -- phases 40-42: the paged kernel per shard, sharded serving -------------------------

# (label, paged_case kwargs, mode, shard counts): lane shards at minicpm-2b's
# decode, moonshot's (G = 1, D = 128) and recurrentgemma-2b's (D = 256, a
# 2048 window past the context's start, so window_first_page runs with
# lane_base > 0); head shards at a page size neither count divides
SHARD_CASES = [
    ("minicpm-2b decode", dict(B=8, Hkv=36, G=1, D=64, ps=16, mp=34, n_pages=300, fill=1.0,
                               min_len=512), "lane", (2, 4)),
    ("moonshot decode", dict(B=8, Hkv=16, G=1, D=128, ps=16, mp=146, n_pages=1200, fill=1.0,
                             min_len=2300, holes=1), "lane", (2, 4)),
    ("recurrentgemma-2b decode", dict(B=8, Hkv=1, G=10, D=256, ps=16, mp=145, n_pages=1200,
                                      window=2048, post=True, fill=1.0, min_len=2100),
     "lane", (2, 4)),
    ("recurrentgemma-2b, a 3-token slot", dict(B=3, Hkv=1, G=10, D=256, ps=16, mp=40,
                                               n_pages=130, window=100, short=True,
                                               unmapped=True), "lane", (2, 4)),
    ("Hkv 36, page 9", dict(B=8, Hkv=36, G=1, D=64, ps=9, mp=60, n_pages=500, fill=1.0,
                            min_len=512, holes=1), "head", (2, 4)),
    ("Hkv 8 (G 5, D 128), page 9", dict(B=4, Hkv=8, G=5, D=128, ps=9, mp=40, n_pages=200,
                                        window=100), "head", (2, 4)),
]
SHARD_MESHES = ((1, 2), (2, 2))
SH_REQUESTS, SH_SESSIONS, SH_PROMPT, SH_MAX_NEW = 8, 4, 256, 16       # phase 41
SHH_REQUESTS, SHH_PROMPT, SHH_MAX_NEW = 8, 2100, 8                    # phase 42


def shard_inputs(gen, c, dtype):
    q, kp, vp, pt, lengths, k_new, v_new = paged_case(
        gen, B=c["B"], Hkv=c["Hkv"], G=c["G"], D=c["D"], ps=c["ps"], mp=c["mp"],
        n_pages=c["n_pages"], dtype=dtype, holes=c.get("holes", 0), fill=c.get("fill", 0.8),
        min_len=c.get("min_len", 1))
    if c.get("unmapped"):
        pt[1] = -1
        lengths[1] = 0
    if c.get("short"):
        lengths[0] = 3
    post = c.get("post", False)
    return dict(q=q, kp=kp, vp=vp, pt=pt, lengths=lengths,
                q_pos=lengths - 1 if post else lengths,
                k_new=None if post else k_new, v_new=None if post else v_new)


def phase_shard_cases(fails: Failures, seed: int) -> None:
    """Each shard's launch against its plain version on the same slice (as
    phase 2), and the merged shards against the unsharded kernel."""
    import torch

    from repro_torch.kernels.paged_attention import (paged_attention, paged_attention_kernel,
                                                     paged_attention_plain,
                                                     paged_shard_partials, pool_shard,
                                                     sharded_paged_attention_local)

    gen = torch.Generator().manual_seed(seed)
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[str(dtype).split(".")[-1]]
        for label, c, mode, counts in SHARD_CASES:
            x = shard_inputs(gen, c, dtype)
            B, Hkv, G, D, ps = c["B"], c["Hkv"], c["G"], c["D"], c["ps"]
            qg = x["q"].reshape(B, Hkv, G, D).contiguous()
            window = c.get("window")
            for m in counts:
                worst, splits = 0.0, []
                for r in range(m):
                    kp_s, vp_s = pool_shard(x["kp"], r, m, mode), pool_shard(x["vp"], r, m, mode)
                    args = (x["pt"], x["lengths"], x["q_pos"])
                    acc, mx, l = paged_shard_partials(qg, kp_s, vp_s, *args, shard=r, n_shards=m,
                                                      mode=mode, page_size=ps, window=window)
                    splits.append(paged_attention_kernel.last_splits)
                    if mode == "lane":
                        w = ps // m
                        racc, rm, rl = paged_attention_plain(qg, kp_s, vp_s, *args,
                                                             lane_base=r * w, pos_stride=ps,
                                                             window=window)
                    else:
                        h = Hkv // m
                        racc, rm, rl = paged_attention_plain(
                            qg[:, r * h:(r + 1) * h].contiguous(), kp_s, vp_s, *args,
                            window=window)
                    sync()
                    o = acc / l.clamp(min=1e-30)[..., None]
                    ro = racc / rl.clamp(min=1e-30)[..., None]
                    err = max((o - ro).abs().max().item(), (mx - rm).abs().max().item(),
                              ((l - rl).abs() / rl.clamp(min=1.0)).max().item())
                    fails.check(err <= tol and bool(torch.isfinite(o).all()),
                                f"{label} {mode} shard {r + 1} of {m} {str(dtype)[6:]}: kernel "
                                f"vs plain max err {err:.3g} <= {tol}")
                    worst = max(worst, err)
                kw = dict(q_pos=x["q_pos"], k_new=x["k_new"], v_new=x["v_new"], window=window)
                merged = sharded_paged_attention_local(x["q"], x["kp"], x["vp"], x["pt"],
                                                       x["lengths"], n_shards=m, mode=mode, **kw)
                whole = paged_attention(x["q"], x["kp"], x["vp"], x["pt"], x["lengths"], **kw)
                err = (merged.float() - whole.float()).abs().max().item()
                fails.check(err <= tol, f"{label} {mode} x{m} {str(dtype)[6:]}: merged shards "
                            f"vs the unsharded kernel max err {err:.3g} <= {tol} (splits per "
                            f"shard {splits})")


def shard_bound(qg, pt, lengths, q_pos, window, ps, lane_lo, lane_hi) -> tuple:
    """(bytes, flops) that one lane shard's launch must move and compute on
    this run's data: q, its live K/V lanes, their table entries, the
    lengths and its fp32 state."""
    import numpy as np

    B, Hs, G, D = qg.shape
    L = lengths.cpu().numpy()
    Q = q_pos.cpu().numpy()
    P = pt.cpu().numpy()
    live = pages = 0
    for b in range(B):
        lo_pos = -1 if window is None else int(Q[b]) - window
        for j in range(P.shape[1]):
            if P[b, j] < 0:
                continue
            pos = j * ps + np.arange(lane_lo, lane_hi)
            n = int(((pos < L[b]) & (pos > lo_pos)).sum())
            live += n
            pages += n > 0
    elt = qg.element_size()
    nbytes = (B * Hs * G * D * elt + 2 * live * Hs * D * elt + pages * 4 + 2 * B * 4
              + B * Hs * G * (D + 2) * 4)
    return nbytes, 4 * live * Hs * G * D


def phase_shard_timing(fails: Failures, seed: int, label: str, c: dict, m: int, launches,
                       wire: int, layers: int) -> dict:
    """Shard 1 of ``m`` of a lane-sharded pool at a serving shape, one pool
    per layer for ``layers`` layers: the per-shard launch (CUDA events, and
    device ms queued behind a sleep), its plain version, gather + SDPA over
    the shard's lanes, the in-process merge of the ``m`` states with the
    new token's splice, and the unsharded launch; the shard's bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import (merge_shard_states, paged_attention_plain,
                                                     paged_shard_partials, pool_shard)
    from repro_torch.kernels.paged_attention.kernel import paged_attention_kernel
    from repro_torch.kernels.paged_attention.ops import _finish

    gen = torch.Generator().manual_seed(seed)
    x = shard_inputs(gen, c, torch.bfloat16)
    B, Hkv, G, D, ps = c["B"], c["Hkv"], c["G"], c["D"], c["ps"]
    window = c.get("window")
    w = ps // m
    kps = [pool_shard(torch.randn_like(x["kp"]) if i else x["kp"], 0, m, "lane")
           for i in range(layers)]
    vps = [pool_shard(torch.randn_like(x["vp"]) if i else x["vp"], 0, m, "lane")
           for i in range(layers)]
    qg = x["q"].reshape(B, Hkv, G, D).contiguous()
    args = (x["pt"], x["lengths"], x["q_pos"])

    def shard(i):
        return paged_shard_partials(qg, kps[i % layers], vps[i % layers], *args, shard=0,
                                    n_shards=m, mode="lane", page_size=ps, window=window)

    def plain(i):
        return paged_attention_plain(qg, kps[i % layers], vps[i % layers], *args, lane_base=0,
                                     pos_stride=ps, window=window)

    T = c["mp"] * w
    pos = (torch.arange(c["mp"], device="cuda")[:, None] * ps
           + torch.arange(w, device="cuda")[None]).reshape(-1)
    mask = (pos[None] < x["lengths"][:, None]) & (x["pt"] >= 0).repeat_interleave(w, dim=1)
    if window is not None:
        mask &= pos[None] > (x["q_pos"] - window)[:, None]
    mask = mask[:, None, None, :]

    def library(i):
        k = kps[i % layers][x["pt"].long().clamp(min=0)].reshape(B, T, Hkv, D).transpose(1, 2)
        v = vps[i % layers][x["pt"].long().clamp(min=0)].reshape(B, T, Hkv, D).transpose(1, 2)
        return F.scaled_dot_product_attention(qg, k, v, attn_mask=mask)

    acc, mx, l = shard(0)
    racc, rm, rl = plain(0)
    live = rl > 0
    o = (acc / l.clamp(min=1e-30)[..., None])[live]
    ro = (racc / rl.clamp(min=1e-30)[..., None])[live]
    max_err = (o - ro).abs().max().item()
    fails.check(max_err <= PAGED_SUM_REL * ro.abs().max().item(),
                f"{label} lane shard 1 of {m}: kernel vs plain max err {max_err:.3g} <= "
                f"{PAGED_SUM_REL} x max |o|")
    states = [paged_shard_partials(qg, pool_shard(x["kp"], r, m, "lane"),
                                   pool_shard(x["vp"], r, m, "lane"), *args, shard=r,
                                   n_shards=m, mode="lane", page_size=ps, window=window)
              for r in range(m)]
    stacked = [torch.stack(s) for s in zip(*states)]

    def merge(i):
        return _finish(x["q"], qg, *merge_shard_states(*stacked, mode="lane"), x["k_new"],
                       x["v_new"], x["kp"].dtype)

    def unsharded(i):
        return paged_attention_kernel(qg, x["kp"], x["vp"], *args, window=window)

    ms = cuda_time_ms(shard, 200, warmup=20)
    dev_ms = queued_device_ms(shard, 100)
    plain_ms = cuda_time_ms(plain, 20)
    library_ms = cuda_time_ms(library, 20)
    merge_ms = cuda_time_ms(merge, 100)
    whole_dev_ms = queued_device_ms(unsharded, 100)
    nbytes, flops = shard_bound(qg, x["pt"], x["lengths"], x["q_pos"], window, ps, 0, w)
    tb, to = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    bound_ms = max(tb, to) * 1e3
    print(f"  {label}, lane shard 1 of {m} ({w} of {ps} lanes): kernel {ms:.4f} ms (device "
          f"{dev_ms} ms), plain {plain_ms:.4f} ms, gather+SDPA {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({nbytes / 1e6:.3f} MB); merge of {m} states + splice "
          f"{merge_ms:.4f} ms; unsharded launch device {whole_dev_ms} ms; {wire} collective "
          f"bytes per decode step on the mesh")
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention/kernel.py:99",
            "shape": f"{label}: lane shard 1 of {m}, B={B} Hkv={Hkv} G={G} D={D}, {w} of {ps} "
                     f"lanes a page, bf16",
            "launches": launches, "max_abs_err": max_err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if tb >= to else "operations", "library_ms": library_ms,
            "merge_ms": merge_ms, "unsharded_device_ms": whole_dev_ms,
            "collective_bytes_per_step": wire}


def sharded_judge(fails: Failures, label: str, res: dict, model_fn, cfg, prompts,
                  matched: bool, launches_per_step: dict) -> None:
    """The checks of one mesh run (``sharded_smoke.verdicts``): the tokens
    (identical to ``mesh=None``, or split at a near-tie the unsharded model
    shows teacher-forced; the hybrid against its mesh-matched run), every
    rank's pool 1/m of the whole, the collective bytes flat at 4x the pool,
    and the kernels launched on every decode step of every rank."""
    import numpy as np

    mp = int(res["mesh"].split("x")[1])
    print(f"  {label} on {res['mesh']}: mesh=None {res['single_step_ms']} ms per decode step; "
          f"sharded {[round(x, 3) for x in res['sharded_step_ms']]} ms per decode step, "
          f"{[round(x, 2) for x in res['sharded_tok_s']]} tok/s, peak "
          f"{[b and round(b / 2**30, 2) for b in res['peak_bytes']]} GiB by rank; pool "
          f"{res['pool']}; launches by rank {res['launches']}")
    fails.check(res["ranks_agree"], f"{label} {res['mesh']}: every rank's tokens agree")
    if matched:
        fails.check(res["matched_identical"], f"{label} {res['mesh']}: tokens identical to the "
                    f"mesh-matched run (the same sharded scheduler, one request at a time)")
    elif not res["identical_outputs"]:
        to_np = lambda d: {k: np.asarray(v) for k, v in d.items()}  # noqa: E731
        spec_margins(fails, model_fn(), cfg, f"{label} {res['mesh']}",
                     {"tokens": to_np(res["tokens_single"])},
                     {"tokens": to_np(res["tokens_sharded"])}, prompts, than="mesh=None")
    else:
        fails.check(True, f"{label} {res['mesh']}: tokens identical to mesh=None")
    fails.check(res["pool_split"], f"{label} {res['mesh']}: each rank's pool "
                f"{res['pool_bytes_rank']} B == 1/{mp} of {res['pool_bytes_single']} B")
    fails.check(res["wire_flat"], f"{label} {res['mesh']}: collective bytes per decode step "
                f"{res['wire_per_step']} equal at a 4x pool {res['wire_per_step_big']}")
    for name, per_step in launches_per_step.items():
        for r, got in enumerate(res["launches"]):
            want = per_step(r)
            fails.check(got[name] == want > 0, f"{label} {res['mesh']} rank {r}: {name} "
                        f"launches {got[name]} == {want}")


class MeshJobs:
    """The mesh phases' workloads (41-42, 44-46, 48-51) gathered by mesh
    shape, so that each shape is one spawn of ranks on the card (a spawn
    pays its ranks' start, CUDA and gloo set-up once): each job is a
    workload, whether it is held to its mesh-matched run, and its
    ``mesh=None`` run: a dict made beforehand, or a function that makes it
    in this process while the first spawn's ranks serve (this process
    would idle otherwise).  A ``late`` job runs last in its spawn, and in
    the first spawn only once those functions are done and their models
    freed: its ranks need the card to themselves (two ranks of moonshot
    hold 62 GiB)."""

    def __init__(self):
        self.jobs: dict = {}        # (dp, mp) -> [job dicts]

    def add(self, mesh: tuple, key: str, w, single, matched: bool = False,
            late: bool = False) -> None:
        self.jobs.setdefault(mesh, []).append(
            {"key": key, "w": w, "matched": matched, "single": single, "late": late})

    def run(self, device: str = "cuda") -> dict:
        """Every mesh shape's jobs in one spawn; ``{(key, mesh): verdicts}``."""
        import os
        import resource
        import shutil
        import tempfile

        from repro_torch.launch import sharded_smoke as ss

        out = {}
        pending = [j for jobs in self.jobs.values() for j in jobs if callable(j["single"])]
        for (dp, mp), jobs in self.jobs.items():
            jobs = sorted(jobs, key=lambda j: j["late"])
            gate, gate_dir = None, None
            if pending and any(j["late"] for j in jobs):
                gate_dir = tempfile.mkdtemp(prefix="mesh_jobs_")
                gate = (next(i for i, j in enumerate(jobs) if j["late"]),
                        os.path.join(gate_dir, "go"))
            if device == "cuda":
                print(f"  ({dp}, {mp}) spawn: this process before it {parent_state()}")
            t0 = time.perf_counter()
            cpu0 = resource.getrusage(resource.RUSAGE_SELF)
            ranks = ss.Ranks(ss.serve_rank_jobs,
                             ([(j["w"], j["matched"]) for j in jobs], gate), dp=dp, mp=mp,
                             device=device)
            try:
                try:
                    if pending:
                        t1 = time.perf_counter()
                        for j in pending:
                            j["single"] = j["single"]()
                            if device == "cuda":
                                release()
                        print(f"  the mesh=None runs of {[j['key'] for j in pending]}, while "
                              f"the ranks served: {time.perf_counter() - t1:.1f} s")
                        pending = []
                    if gate is not None:
                        open(gate[1], "w").close()
                except BaseException:
                    ranks.kill()
                    raise
                results = ranks.join()
            finally:
                if gate_dir is not None:
                    shutil.rmtree(gate_dir, ignore_errors=True)
            cpu1 = resource.getrusage(resource.RUSAGE_SELF)
            print(f"  ({dp}, {mp}): {[j['key'] for j in jobs]} in {time.perf_counter() - t0:.1f} "
                  f"s with the spawn; this process's CPU over the spawn "
                  f"{cpu1.ru_utime - cpu0.ru_utime:.1f} s user, "
                  f"{cpu1.ru_stime - cpu0.ru_stime:.1f} s system")
            for i, j in enumerate(jobs):
                r = ss.verdicts(j["w"], j["single"], [ranks_out[i] for ranks_out in results],
                                dp=dp, mp=mp, device=device, mesh_matched=j["matched"])
                print(f"    job {j['key']} on ({dp}, {mp}): {[round(s, 1) for s in r['job_s']]} s "
                      f"by rank; a decode step (or round) "
                      f"{[x and round(x, 3) for x in r['sharded_step_ms']]} ms, in collectives "
                      f"{[x and round(x, 3) for x in r['wire_ms_per_step']]} ms"
                      + (f"; the ranks' probes {r['probe']}" if r["probe"][0] else ""))
                out[(j["key"], (dp, mp))] = r
        return out


def _memo(fn):
    """``fn`` called once: the first call's result, kept for the next."""
    kept = []

    def once():
        if not kept:
            kept.append(fn())
        return kept[0]

    return once


def _lazy_model(w, device: str):
    """A function building ``w``'s model, for a check that needs it only when tokens
    differ (the mesh runs hold no model in this process)."""
    from repro_torch.launch import sharded_smoke as ss

    return lambda: ss.build(w, device)


def plan_sharded_serving(jobs: MeshJobs, seed: int, *, device: str = "cuda",
                         reduced: bool = False, n_layers=None) -> dict:
    """Phases 41-42's workloads and their ``mesh=None`` runs: minicpm-2b at
    full width on (1, 2) and (2, 2) ranks of the one card
    (``paged_kernel``), recurrentgemma-2b at full width on (1, 2) against
    its mesh-matched run (``n_layers`` cuts both; ``reduced`` for a CPU
    rehearsal); the ``mesh=None`` runs are made while the ranks serve
    (:class:`MeshJobs`)."""
    from repro_torch.launch import sharded_smoke as ss

    w = ss.Workload(arch=ARCH, reduced=reduced, n_layers=n_layers, attn_backend="paged_kernel",
                    n_requests=SH_REQUESTS, sessions=SH_SESSIONS, prompt_len=SH_PROMPT,
                    max_new=SH_MAX_NEW, n_slots=SLOTS, page_size=PAGE, prefill_chunk=CHUNK,
                    seed=seed)
    hw = dataclasses.replace(w, arch=HYBRID, n_requests=SHH_REQUESTS, sessions=SHH_REQUESTS,
                             prompt_len=SHH_PROMPT, max_new=SHH_MAX_NEW)
    single = _memo(lambda: ss.run_single(w, device))
    for mesh in SHARD_MESHES:
        jobs.add(mesh, "41", w, single)
    jobs.add((1, 2), "42", hw, _memo(lambda: ss.run_single(hw, device)), matched=True)
    return {"w": w, "hw": hw, "device": device}


def judge_sharded_serving(fails: Failures, plan: dict, results: dict) -> dict:
    """Phases 41-42's checks on their mesh runs (:func:`sharded_judge`)."""
    from repro_torch.models.config import layer_pattern

    w, hw, device = plan["w"], plan["hw"], plan["device"]
    cfg, hcfg = w.config(), hw.config()
    print(f"[41] full-width {ARCH} at {cfg.n_layers} layers served on meshes {SHARD_MESHES} of "
          f"ranks on one card (gloo, paged_kernel): {SH_REQUESTS} requests over {SH_SESSIONS} "
          f"sessions, prompt {SH_PROMPT}, {SH_MAX_NEW} new, {SLOTS} slots, page {PAGE}")
    prompts = {f"r{i}": p for i, p in enumerate(w.prompts(cfg.vocab))}
    out = {}
    for mesh in SHARD_MESHES:
        res = results[("41", mesh)]
        res["launches"] = res.pop("launches_by_rank")
        sharded_judge(fails, ARCH, res, _lazy_model(w, device), cfg, prompts, False,
                      {"paged_attention": lambda r, res=res: cfg.n_layers * res["decode_steps"][r]})
        out[mesh] = res
    print(f"[42] full-width {HYBRID} at {hcfg.n_layers} layers on a (1, 2) mesh against its "
          f"mesh-matched run: {SHH_REQUESTS} requests, prompt {SHH_PROMPT} (past the "
          f"{hcfg.hybrid.local_window}-token window), {SHH_MAX_NEW} new, {SLOTS} slots")
    pat = layer_pattern(hcfg)
    n_rec, n_attn = pat.count("r"), pat.count("a")
    hprompts = {f"r{i}": p for i, p in enumerate(hw.prompts(hcfg.vocab))}
    res = results[("42", (1, 2))]
    res["launches"] = res.pop("launches_by_rank")
    sharded_judge(fails, HYBRID, res, _lazy_model(hw, device), hcfg, hprompts, True,
                  {"paged_attention": lambda r: n_attn * res["decode_steps"][r],
                   "rglru_scan": lambda r: n_rec * (res["decode_steps"][r]
                                                    + res["chunks_run"][r])})
    print(f"  {HYBRID} 1x2 vs mesh=None: tokens identical {res['identical_outputs']} "
          f"(not required: the recurrence feeds cross-shard summation order back)")
    out["hybrid"] = res
    return out


# -- phases 43-46: ring mode, the SSM family, offload, sharing and parking on a mesh --------

SSD_SHARDS = (2, 4)
# mamba2-1.3b's scan calls on the mesh path: a prefill chunk from a live
# state, and a decode step of the full batch
SSD_SHARD_SHAPES = ((1, CHUNK), (SLOTS, 1))
SF_SSM_REQUESTS, SF_SSM_PROMPT, SF_SSM_MAX_NEW = 4, 256, 16          # phase 44
SF_RING_REQUESTS, SF_RING_MAX_NEW = 2, 8                             # phase 45
SF_RING_PROMPT, SF_HRING_PROMPT = 4096, 2100
SF_SOUP = dict(events=16, sessions=4, fresh_len=(64, 128), extend_len=(8, 32),
               max_new=(8, 16))                                     # phase 46
SF_SOUP_SEQ, SF_SOUP_PAGES, SF_SOUP_CHUNK, SF_SOUP_TTL = 256, 32, 64, 8
# A mesh rank's page blob against its shard of mesh=None's on the card:
# layer 0's K/V come from the embeddings alone and must be bitwise (a
# stale or misrouted page shows there); every later layer's come from
# attention whose softmax sums run in another fp32 order across shards (and
# another GEMM row count on (2, 2)), so they differ by bf16 roundings (one
# bf16 rounding of a value is 2^-8 of it) that grow with depth, held to
# SOUP_BLOB_REL of the leaf's largest |K/V| and to SOUP_BLOB_LAYER_REL of
# their own layer's and kv head's.  The (1, 1) mesh, the same sharded
# scheduler with nothing split, must give mesh=None's blobs bitwise.
# Bitwise in the CPU tests.
SOUP_BLOB_REL, SOUP_BLOB_LAYER_REL = 3e-2, 5e-2


def phase_ssd_shards(fails: Failures, seed: int) -> list:
    """Phase 43: the SSD scan per head shard at mamba2-1.3b's serving
    shapes (a 256-token prefill chunk from a live state, a decode step at
    B = 8), bf16 x, B and C and fp32 dt, A and state, over 2 and 4 shards.
    Each shard's launch against its plain version (the scan's derived
    bf16 bound) and against the same heads of the unsharded launch
    (bitwise: the route depends on the dtype, P and N alone, and heads
    never mix); device ms of a shard's launch and of the unsharded one
    (queued behind a sleep), the wrapper's (its slicing copies included),
    the plain version's, and the shard's bound.  Returns the kernel records
    of the 2-way shards (their launches filled in from phase 44)."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels.ssd_scan import ssd_scan_kernel, ssd_scan_plain, ssd_scan_shard
    from repro_torch.kernels.ssd_scan.kernel import route

    cfg = configs.get(SSM)
    s = cfg.ssm
    H, P, N = s.n_heads(cfg.d_model), s.head_dim, s.d_state
    path = route(torch.bfloat16, P, N)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    records = []
    for B, L in SSD_SHARD_SHAPES:
        args = ssd_inputs(gen, B, L, H, P, N, True, "random", torch.bfloat16, "cuda")
        x, dt, A, Bm, Cm, h0 = args
        y, h = ssd_scan_kernel(*args)
        whole_ms = queued_device_ms(lambda i: ssd_scan_kernel(*args), 50)
        for m in SSD_SHARDS:
            w = H // m
            shards = []
            for r in range(m):
                sl = slice(r * w, (r + 1) * w)
                shards.append((x[:, :, sl].contiguous(), dt[:, :, sl].contiguous(),
                               A[sl].contiguous(), Bm, Cm, h0[:, sl].contiguous()))
            before = ssd_scan_kernel.launches_by_route[path]
            outs = [ssd_scan_shard(x, dt, A, Bm, Cm, own[5], shard=r, n_shards=m)
                    for r, own in enumerate(shards)]
            fails.check(ssd_scan_kernel.launches_by_route[path] == before + m,
                        f"{SSM} SSD scan over {m} head shards at B={B} L={L}: {m} launches on "
                        f"the {path} route")
            worst, bitwise = 0.0, True
            for r, ((ys, hs), own) in enumerate(zip(outs, shards)):
                worst = max(worst, ssd_bf16_check(
                    fails, f"{SSM} SSD shard {r + 1} of {m} at B={B} L={L} vs plain", ys, hs,
                    own, split=path == "tensor_core" and L > 1))
                sl = slice(r * w, (r + 1) * w)
                bitwise &= torch.equal(ys, y[:, :, sl]) and torch.equal(hs, h[:, sl])
            fails.check(bitwise, f"{SSM} SSD at B={B} L={L}: every one of {m} shards' y and "
                        f"final state bitwise the same heads of the unsharded launch (the "
                        f"{path} route at {w} heads as at {H})")
            own = shards[0]
            dev_ms = queued_device_ms(lambda i: ssd_scan_kernel(*own), 50)
            wrap_ms = cuda_time_ms(lambda i: ssd_scan_shard(x, dt, A, Bm, Cm, own[5], shard=0,
                                                            n_shards=m), 50)
            plain_ms = cuda_time_ms(lambda i: ssd_scan_plain(*own), 5, warmup=1)
            nbytes, ops = ssd_bound(B, L, w, P, N, 2, CHUNK)
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS_PER_S
            bound_ms = max(t_bytes, t_ops) * 1e3
            print(f"  {SSM} SSD at B={B} L={L}, shard 1 of {m} ({w} of {H} heads): kernel device "
                  f"{dev_ms} ms (unsharded launch {whole_ms} ms), the wrapper with its slicing "
                  f"{wrap_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
                  f"({nbytes / 1e6:.3f} MB, {ops / 1e9:.4f} GFLOP); inputs warm in L2")
            if m == 2:
                records.append({
                    "name": "ssd_scan", "route": "cuda", "kernel_route": path,
                    "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
                    "replaces": "src/repro/kernels/ssd_scan/kernel.py:68",
                    "shape": f"head shard 1 of 2: x {B}x{L}x{w}x{P} bf16, N={N}, h0 fp32",
                    "L": L, "launches": 0, "max_abs_err": worst, "ms": dev_ms,
                    "wrapper_ms": wrap_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": None, "unsharded_device_ms": whole_ms})
    return records


def features_judge(fails: Failures, label: str, res: dict, cfg, prompts, *, matched: bool,
                   launches: dict, model_fn) -> None:
    """The checks of one mesh run of phases 44-46 (``sharded_smoke.verdicts``):
    the tokens (identical to mesh=None, or split at a near-tie the unsharded
    model shows teacher-forced; the hybrid against its mesh-matched run),
    each rank's part of every split leaf, the collective bytes of a decode
    step flat, and every kernel of the path launched on every rank as
    counted (``launches``: name -> rank -> want)."""
    import numpy as np

    mesh = res["mesh"]
    print(f"  {label} on {mesh}: mesh=None {res['single_step_ms']} ms per decode step; sharded "
          f"{[x and round(x, 3) for x in res['sharded_step_ms']]} ms per decode step, chunk "
          f"steps {[x and round(x, 3) for x in res['sharded_chunk_ms']]} ms, "
          f"{[round(x, 2) for x in res['sharded_tok_s']]} tok/s; collective bytes per decode "
          f"step {res['wire_per_step']} (bigger pool or 2x max_seq {res['wire_per_step_big']}),"
          f" per chunk {res['chunk_wire']}; collective ms per decode step "
          f"{res['wire_ms_per_step']}, per chunk {res['wire_ms_per_chunk']}; peak "
          f"{[b and round(b / 2**30, 2) for b in res['peak_bytes']]} GiB; launches by rank "
          f"{res['launches_by_rank']}")
    fails.check(res["ranks_agree"], f"{label} {mesh}: every rank's tokens agree")
    if matched:
        fails.check(res["matched_identical"], f"{label} {mesh}: tokens identical to the "
                    f"mesh-matched run (the same sharded scheduler, one request at a time)")
    elif not res["identical_outputs"]:
        single, sharded = res["tokens_single"], res["tokens_sharded"]
        if fails.check(set(single) == set(sharded), f"{label} {mesh}: the same requests as "
                       f"mesh=None ({len(sharded)} of {len(single)})"):
            to_np = lambda d: {k: np.asarray(v) for k, v in d.items()}  # noqa: E731
            spec_margins(fails, model_fn(), cfg, f"{label} {mesh}", {"tokens": to_np(single)},
                         {"tokens": to_np(sharded)}, prompts, than="mesh=None")
    else:
        fails.check(True, f"{label} {mesh}: tokens identical to mesh=None")
    for key, what in (("pool", "pool"), ("ring", "ring K/V"), ("state", "SSD state")):
        if res.get(f"{key}_split") is not None:
            extra = (f" (+ {res['ring_scratch_bytes_rank']} B of scratch lanes)"
                     if key == "ring" else "")
            fails.check(res[f"{key}_split"], f"{label} {mesh}: each rank's {what} "
                        f"{res[f'{key}_bytes_rank']} B{extra} is its part of "
                        f"{res[f'{key}_bytes_single']} B (1/|model| of its data group's)")
    fails.check(res["wire_flat"], f"{label} {mesh}: collective bytes per decode step "
                f"{res['wire_per_step']} equal at the bigger pool or 2x max_seq "
                f"{res['wire_per_step_big']}")
    for name, want in launches.items():
        for r, got in enumerate(res["launches_by_rank"]):
            fails.check(got[name] == want(r) > 0, f"{label} {mesh} rank {r}: {name} launches "
                        f"{got[name]} == {want(r)}")


def soup_judge(fails: Failures, label: str, res: dict) -> None:
    """The event soup's own checks: blobs, journals, page moves, and the
    preemption and restore times beside mesh=None's."""
    mesh = res["mesh"]
    st, st1 = res["stats"], res["single_stats"]
    print(f"  {label} soup on {mesh}: {res['requests']} requests, {st['preemptions']} "
          f"preemptions / {st['restores']} restores, {st['park_hits']} park hits, "
          f"{st['index_hits']} index hits, {st['cow_splits']} CoW splits, "
          f"{st['park_evictions']} parked-slot evictions, {st['park_offloads']} parked offloads, "
          f"{st['park_expirations']} expirations (mesh=None: {st1['preemptions']} / "
          f"{st1['restores']} / {st1['park_hits']} / {st1['index_hits']}); {res['blobs']} "
          f"blobs; slot-row bytes over data {res['row_wire_bytes']}, K/V writes shared over "
          f"data {res['kv_share_bytes']} bytes; forced preemption "
          f"{res['sharded_preempt_ms']} ms by rank (mesh=None {res['single_preempt_ms']}), "
          f"step with a restore chunk {res['sharded_restore_ms']} ms (mesh=None "
          f"{res['single_restore_ms']})")
    fails.check(st["preemptions"] > 0 and st["restores"] == st["preemptions"] and res["blobs"],
                f"{label} {mesh}: the soup preempted and restored "
                f"({st['preemptions']} / {st['restores']}), {res['blobs']} blobs")
    fails.check(res["pages_move_no_bytes"], f"{label} {mesh}: page moves sent "
                f"{res['page_wire_bytes']} collective bytes, forced preemptions "
                f"{res['preempt_wire']}")
    fails.check(res["journals_equal"], f"{label} {mesh}: every rank's billed storage journal "
                f"equals mesh=None's")
    if fails.check(res["identical_outputs"], f"{label} {mesh}: the soup's requests and "
                   f"tokens are mesh=None's, so its blobs are comparable"):
        fails.check(res["blob_layer0_bitwise"], f"{label} {mesh}: layer 0 of each rank's "
                    f"{res['blobs']} blobs bitwise its lane shard of mesh=None's (layers "
                    f"bitwise per blob and rank {res['blob_layers_bitwise']})")
        whole = res["blob_rel_err_whole"]
        fails.check(whole is not None and whole <= SOUP_BLOB_REL, f"{label} {mesh}: each "
                    f"rank's blobs against its lane shard of mesh=None's: bitwise "
                    f"{res['blobs_bitwise']}; largest |difference| over the leaf's largest "
                    f"|value| {whole} <= {SOUP_BLOB_REL}")
        by_layer = res["blob_rel_err_by_layer"] or []
        fails.check(res["blob_rel_err"] is not None
                    and res["blob_rel_err"] <= SOUP_BLOB_LAYER_REL, f"{label} {mesh}: largest "
                    f"|difference| over the largest |value| of its layer and kv head "
                    f"{res['blob_rel_err']} <= {SOUP_BLOB_LAYER_REL}; by layer "
                    f"{[round(x, 5) for x in by_layer]}")


def plan_sharded_features(mesh_jobs: MeshJobs, seed: int, *, device: str = "cuda",
                          reduced: bool = False) -> dict:
    """Phases 44-46's workloads and their ``mesh=None`` runs, for ranks of
    the one card (gloo): mamba2-1.3b at full width, paged, its SSD state on
    heads; ring mode for minicpm-2b at full width with prompts of
    SF_RING_PROMPT tokens (each admission launches the flash kernel) and
    for recurrentgemma-2b at full width with a T-split ring (against its
    mesh-matched run), all on (1, 2); and the event soup of minicpm-2b at
    full width (paged_kernel, a pool of SF_SOUP_PAGES pages, parking with a
    TTL, prefix sharing over a shared system prompt) on (1, 2) and (2, 2),
    and on (1, 1) as the witness that the blobs' drift comes from the
    split.  ``reduced`` (and smaller SF_* sizes) cut them for a CPU
    rehearsal."""
    from repro_torch.launch import sharded_smoke as ss

    common = dict(reduced=reduced, seed=seed, page_size=PAGE)
    w44 = ss.Workload(arch=SSM, attn_backend="gather", n_requests=SF_SSM_REQUESTS,
                      sessions=SF_SSM_REQUESTS, prompt_len=SF_SSM_PROMPT, max_new=SF_SSM_MAX_NEW,
                      n_slots=SLOTS, prefill_chunk=CHUNK, **common)
    w45 = ss.Workload(arch=ARCH, kv_mode="ring", attn_backend="gather",
                      n_requests=SF_RING_REQUESTS, sessions=SF_RING_REQUESTS,
                      prompt_len=SF_RING_PROMPT, max_new=SF_RING_MAX_NEW, n_slots=SF_RING_REQUESTS,
                      prefill_chunk=CHUNK, **common)
    w45h = dataclasses.replace(w45, arch=HYBRID, prompt_len=SF_HRING_PROMPT)
    w46 = ss.Workload(arch=ARCH, attn_backend="paged_kernel", n_slots=4,
                      prefill_chunk=SF_SOUP_CHUNK, max_seq=SF_SOUP_SEQ, kv_pages=SF_SOUP_PAGES,
                      offload=True, prefix_sharing=True, park_sessions=True,
                      park_ttl_steps=SF_SOUP_TTL, soup=ss.Soup(**SF_SOUP), **common)
    jobs = [(w44, False), (w45, False), (w45h, True), (w46, False)]
    cfgs = [w.config() for w, _ in jobs]
    s = cfgs[0].ssm
    print(f"[44-46] on (1, 2) ranks of one card (gloo): {SSM} paged ({cfgs[0].n_layers} layers, "
          f"{s.n_heads(cfgs[0].d_model)} SSD heads on model), {SF_SSM_REQUESTS} requests, prompt "
          f"{SF_SSM_PROMPT}, {SF_SSM_MAX_NEW} new; rings: {ARCH} ({cfgs[1].n_layers} layers, "
          f"prompt {SF_RING_PROMPT}) and {HYBRID} (prompt {SF_HRING_PROMPT}), {SF_RING_REQUESTS} "
          f"requests, {SF_RING_MAX_NEW} new; the event soup of {ARCH} at {cfgs[3].n_layers} "
          f"layers (paged_kernel, "
          f"{SF_SOUP_PAGES} pages of {PAGE}, chunk {SF_SOUP_CHUNK}, max_seq {SF_SOUP_SEQ}, TTL "
          f"{SF_SOUP_TTL}: {SF_SOUP}), also on (2, 2)")
    singles = [_memo(lambda w=w: ss.run_single(w, device)) for w, _ in jobs]
    for key, (w, matched), single in zip(("44", "45", "45h", "46"), jobs, singles):
        mesh_jobs.add((1, 2), key, w, single, matched)
    for mesh in ((2, 2), (1, 1)):
        mesh_jobs.add(mesh, "46", jobs[3][0], singles[3])
    return {"jobs": jobs, "cfgs": cfgs, "device": device}


def judge_sharded_features(fails: Failures, plan: dict, results: dict) -> dict:
    """Phases 44-46's checks on their mesh runs.  Returns the mesh runs and
    the SSD launches of phase 44 by kind, summed over ranks from the
    wrapper's counts."""
    import numpy as np

    from repro_torch.models.config import layer_pattern

    (w44, _), (w45, _), (w45h, _), (w46, _) = plan["jobs"]
    cfgs, device = plan["cfgs"], plan["device"]
    res12 = [results[(key, (1, 2))] for key in ("44", "45", "45h", "46")]
    res22, res11 = results[("46", (2, 2))], results[("46", (1, 1))]

    def model_fn(w):
        return _lazy_model(w, device)

    def prompts(w):
        return {f"r{i}": p for i, p in enumerate(w.prompts(w.config().vocab))}

    on_card = device == "cuda"
    r44, r45, r45h, r46 = res12
    c44 = cfgs[0]
    print(f"[44] {SSM} at full width and depth on (1, 2), paged: SSD state on heads "
          f"{r44['ssm']}")
    features_judge(fails, SSM, r44, c44, prompts(w44), matched=False, model_fn=model_fn(w44),
                   launches={"ssd_scan": lambda r: c44.n_layers * (
                       r44["decode_steps"][r] + r44["chunks_run"][r])} if on_card else {})
    for r, kinds in enumerate(r44["ssd_launches_by_kind"] if on_card else []):
        want = {"chunk": c44.n_layers * r44["chunks_run"][r],
                "decode": c44.n_layers * r44["decode_steps"][r]}
        fails.check(kinds == want and min(kinds.values()) > 0, f"{SSM} (1, 2) rank {r}: SSD "
                    f"launches by kind {kinds} == {want} (a layer's chunk or decode step each)")
    print(f"[45] ring mode on (1, 2): {ARCH} ring {r45['ring']}, {HYBRID} ring {r45h['ring']}")
    features_judge(fails, f"{ARCH} rings", r45, cfgs[1], prompts(w45), matched=False,
                   model_fn=model_fn(w45),
                   launches={"flash_attention": lambda r: cfgs[1].n_layers * r45["chunks_run"][r]}
                   if on_card else {})
    n_rec = layer_pattern(cfgs[2]).count("r")
    features_judge(fails, f"{HYBRID} rings", r45h, cfgs[2], prompts(w45h), matched=True,
                   model_fn=model_fn(w45h),
                   launches={"rglru_scan": lambda r: n_rec * (r45h["decode_steps"][r]
                                                              + r45h["chunks_run"][r])}
                   if on_card else {})
    fails.check(r45h["ring"]["mode"] == "seq", f"{HYBRID}'s one kv head: the ring splits on T "
                f"({r45h['ring']})")
    print(f"[46] the event soup of {ARCH} on (1, 2) and (2, 2)")
    c46 = cfgs[3]
    for res in (r46, res22):
        soup_prompts = {c[1]: np.asarray(c[2], np.int32) for c in res["completions"]}
        features_judge(fails, f"{ARCH} soup", res, c46, soup_prompts, matched=False,
                       model_fn=model_fn(w46),
                       launches={"paged_attention": lambda r, res=res: c46.n_layers
                                 * res["decode_steps"][r]} if on_card else {})
        soup_judge(fails, ARCH, res)
    # the witness: the same sharded scheduler on (1, 1), nothing split and
    # eager as every mesh run, against mesh=None's replayed graphs
    print(f"  {ARCH} soup on 1x1: tokens identical {res11['identical_outputs']}, blobs bitwise "
          f"{res11['blobs_bitwise']} (largest |difference| {res11['blob_rel_err']})")
    fails.check(res11["identical_outputs"] and res11["blobs_bitwise"], f"{ARCH} soup on 1x1 "
                f"(nothing split): tokens and all {res11['blobs']} blobs bitwise mesh=None's, so "
                f"the deeper layers' drift on (1, 2) and (2, 2) comes from the split")
    if on_card:
        release()
    kinds = r44["ssd_launches_by_kind"]
    return {"ssd_launches": {kind: sum(k[kind] for k in kinds) for kind in ("chunk", "decode")},
            "mesh12": res12, "mesh22": res22, "mesh11": res11}


# -- phases 47-49: the MoE family on a mesh, each rank holding only its experts ---------

MOE_SHARDS = (2, 4)              # phase 47: expert shards of moonshot's 64 experts
MOE_SHARD_KINDS = ("decode", "chunk", "prefill")  # MOE_TIMED's shapes as the steps' kinds
MM_REQUESTS, MM_PROMPT, MM_MAX_NEW = 8, CHUNK, 4               # phase 48, paged
# phase 48, rings: one slot (a 4096-token ring's fresh whole prefill ring
# and twice max_seq for the wire check beside each rank's 29 GiB of weights)
MMR_REQUESTS, MMR_SLOTS, MMR_PROMPT, MMR_MAX_NEW = 2, 1, 4096, 4
M49_LAYERS = 4                   # phase 49: four ranks' weights on one card, in time


def bf16_ulp(t):
    """One bf16 step at each element's magnitude."""
    import torch

    a = t.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def phase_moe_shards(fails: Failures, seed: int) -> list:
    """Phase 47: the grouped expert kernel on one expert shard of moonshot's
    layer (``ops.layer_forward_shard``'s launches: the route's offsets
    viewed at the shard's experts, the shard's (E/m, ·, ·) weights, the
    shared expert in both launches) at the decode, chunk and ring prefill
    shapes, m = 2 and 4: each shard's rows bitwise the unsharded launch's
    rows for the same experts, its shared rows bitwise; the combine's fp32
    partial mode bitwise its plain version, and cast to bf16 bitwise the
    bf16 mode without the shared rows; the m partials summed in shard
    order and cast within one bf16 ulp of the unsharded combine (the count
    of differing elements printed); device ms of a shard's two launches
    beside the unsharded pair's, the plain version, ``torch._grouped_mm`` on
    the shard's segment and the bound.  Returns the kernel records of shard
    1 of 2 and of the partial combine, each with the step ``kind`` whose
    launches phase 48 fills in."""
    import torch

    from repro_torch.kernels.moe_experts import (combine, expert_ffn,
                                                 moe_combine_partial_plain, route, shard_kept)

    E, k, D, F = 64, 6, 2048, 1408
    records = []
    for (T, label), kind in zip(MOE_TIMED, MOE_SHARD_KINDS):
        gen = torch.Generator(device="cuda").manual_seed(seed + 47 + T)
        x, _, _, experts, sh = moe_inputs(gen, T, E, k, D, F, "random", True)
        w_router = (torch.randn(D, E, generator=gen, device="cuda") * D ** -0.5).float()
        r = route(x, w_router, k)
        xs = x.index_select(0, r.tok)
        P = T * k
        ys, y_s = expert_ffn("swiglu", xs, r.offsets, experts, (x, sh))
        whole = combine(ys, r.pos, r.weights)                  # bf16, no shared rows
        part_whole = combine(ys, r.pos, r.weights, partial=True)
        fails.check(torch.equal(part_whole.to(torch.bfloat16), whole),
                    f"moe_combine at {label}: the fp32 partial of every pair, cast, bitwise the "
                    f"bf16 mode without the shared rows")
        whole_ms = queued_device_ms(lambda i: expert_ffn("swiglu", xs, r.offsets, experts,
                                                         (x, sh)), 20)
        bf16_ms = queued_device_ms(lambda i: combine(ys, r.pos, r.weights), 50)
        offs = r.offsets.tolist()
        for m in MOE_SHARDS:
            w = E // m
            total, rows_ok, shared_ok, part_ok, err = None, True, True, True, 0.0
            for s in range(m):
                lo, hi = s * w, (s + 1) * w
                local = {n: t[lo:hi] for n, t in experts.items()}
                o = r.offsets[lo:hi + 1]
                ys_s, y_s_s = expert_ffn("swiglu", xs, o, local, (x, sh))
                a, b = offs[lo], offs[hi]
                rows_ok &= torch.equal(ys_s[a:b], ys[a:b])
                shared_ok &= torch.equal(y_s_s, y_s)
                kept = shard_kept(r.idx, lo, hi)
                part = combine(ys_s, r.pos, r.weights, kept, partial=True)
                plain = moe_combine_partial_plain(ys_s, r.pos, r.weights, kept)
                part_ok &= torch.equal(part, plain)
                err = max(err, (part - plain).abs().max().item())
                total = part if total is None else total + part
                if m == 2 and s == 0:
                    shard = (lo, hi, local, o, a, b, kept, ys_s, part)
            fails.check(rows_ok and shared_ok, f"moe_experts at {label} (P={P}): every one of "
                        f"{m} expert shards' rows bitwise the unsharded launch's rows for its "
                        f"experts, and its shared expert's rows bitwise")
            fails.check(part_ok, f"moe_combine fp32 partial at {label}, {m} shards: each bitwise "
                        f"its plain version (max |difference| {err})")
            summed = total.to(torch.bfloat16)
            d = (summed.float() - whole.float()).abs()
            n_diff = int((d > 0).sum())
            fails.check(bool((d <= bf16_ulp(whole)).all()), f"moe_combine at {label}: {m} "
                        f"partials summed in shard order and cast within one bf16 ulp of the "
                        f"unsharded combine at every element ({n_diff} of {d.numel()} differ, "
                        f"max {d.max().item():.3g})")
        lo, hi, local, o, a, b, kept, ys_s, part = shard
        hit = sum(1 for e in range(lo, hi) if offs[e + 1] > offs[e])
        P_s = b - a
        dev_ms = queued_device_ms(lambda i: expert_ffn("swiglu", xs, o, local, (x, sh)), 20)
        ms = cuda_time_ms(lambda i: expert_ffn("swiglu", xs, o, local, (x, sh)), 20)
        plain_ms = cuda_time_ms(lambda i: moe_plain_layer(x, xs, o, local, sh), 3, warmup=1)
        want = moe_plain_layer(x, xs, o, local, sh)
        got = expert_ffn("swiglu", xs, o, local, (x, sh))
        e_err, scale = moe_rel_err((got[0][a:b], got[1]), (want[0][a:b], want[1]))
        fails.check(e_err <= TOL["bfloat16"] * scale, f"moe_experts shard 1 of 2 at {label}: "
                    f"max err {e_err:.3g} <= 3e-2 x {scale:.4g} of its plain version")
        library_ms, lib_note = None, "torch._grouped_mm: absent"
        gmm = grouped_mm_layer(x, xs[a:b].contiguous(), (o - a).contiguous(), local, sh)
        if gmm is not None:
            try:
                gmm()
                library_ms = cuda_time_ms(lambda i: gmm(), 20)
                lib_note = f"torch._grouped_mm on the segment {library_ms:.4f} ms"
            except (RuntimeError, TypeError, ValueError, NotImplementedError) as e:
                lib_note = f"torch._grouped_mm refused: {str(e).splitlines()[0][:120]}"
        nbytes, ops = moe_bound(T, P_s, hit, D, F, True)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS_PER_S
        bound_ms = max(t_bytes, t_ops) * 1e3
        print(f"  moe_experts {label}, expert shard 1 of 2 ({P_s} of {P} pairs, {hit} of {E // 2} "
              f"experts hit, + the shared expert): device {dev_ms} ms for the two launches "
              f"(unsharded pair {whole_ms} ms; PERF.md section 6: 0.2612 / 0.4232 / 1.0657 ms "
              f"wall at P = 48 / 1536 / 24576), CUDA events {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, {lib_note}, bound {bound_ms:.5f} ms ({nbytes / 1e6:.1f} MB, "
              f"{ops / 1e9:.2f} GFLOP)")
        records.append({
            "name": "moe_experts", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/moe_experts.cu",
            "replaces": "src/repro/models/moe.py:204 (the shard_map body's _dispatch_ffn "
                        "einsums on a rank's experts; no Pallas kernel)",
            "shape": f"moonshot {label}, expert shard 1 of 2: experts [{lo}, {hi}), {P_s} of "
                     f"{P} pairs, {hit} hit, D={D} F={F}, shared 2F over {T} rows, bf16",
            "kind": kind, "launches": 0, "max_abs_err": e_err, "ms": dev_ms, "wall_ms": ms,
            "unsharded_device_ms": whole_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": library_ms})
        n_kept = int(kept.sum())
        c_ms = queued_device_ms(lambda i: combine(ys_s, r.pos, r.weights, kept, partial=True), 50)
        c_plain_ms = cuda_time_ms(lambda i: moe_combine_partial_plain(ys_s, r.pos, r.weights,
                                                                     kept), 5, warmup=1)
        c_bytes = n_kept * D * 2 + T * D * 4 + P * (4 + 4 + 1)
        c_bound = c_bytes / HBM_BYTES_PER_S * 1e3
        print(f"  moe_combine fp32 partial at {label}, shard 1 of 2 ({n_kept} of {P} pairs read): "
              f"device {c_ms} ms (the bf16 mode over every pair {bf16_ms} ms), plain "
              f"{c_plain_ms:.4f} ms, bound {c_bound:.5f} ms ({c_bytes / 1e6:.2f} MB)")
        records.append({
            "name": "moe_combine", "route": "cuda", "mode": "fp32 partial",
            "source": "src/repro_torch/kernels/csrc/moe_experts.cu",
            "replaces": "src/repro/models/moe.py:210 (the shard_map body's weighted combine "
                        "before its psum; no Pallas kernel)",
            "shape": f"moonshot {label}, shard 1 of 2: ys ({P}, {D}) bf16, {n_kept} pairs kept, "
                     f"top-{k}, out ({T}, {D}) fp32",
            "kind": kind, "launches": 0, "max_abs_err": err, "ms": c_ms, "plain_ms": c_plain_ms,
            "bound_ms": c_bound, "bound_by": "bytes", "library_ms": None})
        del x, experts, sh, r, xs, ys, y_s, shard, total
        release()
    return records


def moe_mesh_judge(fails: Failures, label: str, res: dict, *, matched: bool, n_layers: int,
                   paged: bool, ring: bool) -> None:
    """The checks of one MoE mesh run (``sharded_smoke.verdicts``): tokens
    against the mesh-matched run (or ``mesh=None``'s where nothing splits),
    each rank's expert bytes 1/m of the model's, routes and MoE inputs
    bitwise across every model group, the split state's bytes, the
    collective bytes of a decode step flat, and every wrapper's launches on
    every rank as the path makes them: route, combine (the fp32 partial
    where the experts split) and half the grouped kernel's once a layer a
    decode step, chunk or ring prefill, and so by the step kind the
    wrappers counted each launch under; the paged kernel once a layer a
    decode step; flash once a layer a ring prefill."""
    mesh = res["mesh"]
    split = res["experts"]["mode"] == "expert"
    print(f"  {label} on {mesh}: experts {res['experts']}; expert bytes by rank "
          f"{res['expert_bytes_rank']} of {res['expert_bytes_single']}; peak "
          f"{[b and round(b / 2**30, 3) for b in res['peak_bytes']]} GiB by rank; mesh=None "
          f"{res['single_step_ms']} ms per decode step, sharded "
          f"{[x and round(x, 3) for x in res['sharded_step_ms']]} ms per decode step, chunk "
          f"steps {[x and round(x, 3) for x in res['sharded_chunk_ms']]} ms; collective bytes "
          f"per decode step {res['wire_per_step']} (bigger pool or 2x max_seq "
          f"{res['wire_per_step_big']}), per chunk or ring prefill {res['chunk_wire']}; "
          f"collective ms per decode step {res['wire_ms_per_step']}, per chunk "
          f"{res['wire_ms_per_chunk']}; launches by rank {res['launches_by_rank']}, combine by "
          f"mode {res['combine_launches_by_mode']}; tokens identical to mesh=None "
          f"{res['identical_outputs']}")
    fails.check(res["ranks_agree"], f"{label} {mesh}: every rank's tokens agree")
    if matched:
        fails.check(res["matched_identical"], f"{label} {mesh}: tokens identical to the "
                    f"mesh-matched run (the same sharded scheduler, one request at a time)")
    else:
        fails.check(res["identical_outputs"], f"{label} {mesh}: tokens identical to mesh=None")
    fails.check(res["expert_split"], f"{label} {mesh}: each rank's expert bytes "
                f"{res['expert_bytes_rank']} are 1/{res['experts']['count']} of the model's "
                f"{res['expert_bytes_single']}")
    fails.check(res["routes_agree"], f"{label} {mesh}: every rank of each model group saw the "
                f"same MoE inputs and routed them to the same experts (digests of the first "
                f"MoE calls: the first chunks and decode steps)")
    for key in ("pool", "ring"):
        if res.get(f"{key}_split") is not None:
            fails.check(res[f"{key}_split"], f"{label} {mesh}: each rank's {key} "
                        f"{res[f'{key}_bytes_rank']} B is its part of {res[f'{key}_bytes_single']}")
    fails.check(res["wire_flat"], f"{label} {mesh}: collective bytes per decode step "
                f"{res['wire_per_step']} equal at the bigger pool or 2x max_seq "
                f"{res['wire_per_step_big']}")
    for r, (got, modes) in enumerate(zip(res["launches_by_rank"],
                                         res["combine_launches_by_mode"])):
        steps, chunks = res["decode_steps"][r], res["chunks_run"][r]
        layer_calls = n_layers * (steps + chunks)
        want = {"moe_route": layer_calls, "moe_experts": 2 * layer_calls,
                "moe_combine": layer_calls,
                "paged_attention": n_layers * steps if paged else 0,
                "flash_attention": n_layers * chunks if ring else 0}
        ok = all(got[n] == v for n, v in want.items()) and layer_calls > 0
        listed = ", ".join(f"{n}: {got[n]}" for n in want)
        fails.check(ok, f"{label} {mesh} rank {r}: launches {{{listed}}} "
                    f"== {want} ({n_layers} layers x ({steps} decode steps + {chunks} chunks "
                    f"or prefills))")
        mode = "fp32" if split else "bf16"
        fails.check(modes[mode] == layer_calls, f"{label} {mesh} rank {r}: every combine in "
                    f"the {mode} mode ({modes})")
        kinds = res["moe_launches_by_kind"][r]
        fill = "prefill" if ring else "chunk"
        for name, per in (("moe_route", 1), ("moe_experts", 2), ("moe_combine", 1)):
            want_k = {"decode": per * n_layers * steps, fill: per * n_layers * chunks}
            got_k = kinds[name]
            fails.check(all(got_k.get(kd, 0) == want_k.get(kd, 0) for kd in got_k),
                        f"{label} {mesh} rank {r}: {name} launches by kind {got_k}, "
                        f"{want_k} and none else")


def plan_moe_mesh(mesh_jobs: MeshJobs, seed: int, *, device: str = "cuda",
                  reduced: bool = False, layers49: int = M49_LAYERS) -> dict:
    """Phases 48-49's workloads and their ``mesh=None`` runs (one model at a
    time, each freed before the ranks spawn), for ranks of the one card
    (gloo), each rank holding only its experts (``build_model(...,
    mesh=)``): moonshot-v1-16b-a3b at full width and depth on (1, 2), paged
    (``paged_kernel``) and from a ring of MMR_PROMPT-token prompts (every
    admission launches flash), each against its mesh-matched run, and the
    paged workload on (1, 1) against ``mesh=None``; then the event soup at
    full width and ``layers49`` of its 48 layers on (2, 2) (four ranks'
    weights on one card) against its mesh-matched run; and phase 50b's
    speculation (a self-draft, gather) on (1, 2) against its mesh-matched
    run without speculation."""
    from repro_torch.launch import sharded_smoke as ss

    w48 = ss.Workload(arch=MOE, reduced=reduced, attn_backend="paged_kernel",
                      n_requests=MM_REQUESTS, sessions=MM_REQUESTS, prompt_len=MM_PROMPT,
                      max_new=MM_MAX_NEW, n_slots=SLOTS, page_size=PAGE, prefill_chunk=CHUNK,
                      seed=seed)
    w48r = dataclasses.replace(w48, kv_mode="ring", attn_backend="gather",
                               n_requests=MMR_REQUESTS, sessions=MMR_REQUESTS,
                               prompt_len=MMR_PROMPT, max_new=MMR_MAX_NEW, n_slots=MMR_SLOTS)
    w49 = ss.Workload(arch=MOE, reduced=reduced, n_layers=layers49, attn_backend="paged_kernel",
                      n_slots=4, page_size=PAGE, prefill_chunk=SF_SOUP_CHUNK,
                      max_seq=SF_SOUP_SEQ, kv_pages=SF_SOUP_PAGES, offload=True,
                      prefix_sharing=True, park_sessions=True, park_ttl_steps=SF_SOUP_TTL,
                      soup=ss.Soup(**SF_SOUP), seed=seed)
    t0 = time.perf_counter()
    model = ss.build(w48, device)
    s48 = ss.run_single(w48, device, model=model)
    s48r = ss.run_single(w48r, device, model=model)
    # phase 50b's mesh-matched claim needs no mesh=None run; this one (without
    # speculation, gather) is printed beside it
    w50b = dataclasses.replace(w48, attn_backend="gather", n_requests=M50_REQUESTS,
                               sessions=M50_REQUESTS, prompt_len=M50_PROMPT,
                               max_new=M50_MAX_NEW, spec=(MOE, seed, SPEC_K))
    s50b = ss.run_single(w50b, device, model=model)
    del model
    if device == "cuda":
        release()
    s49 = ss.run_single(w49, device)
    if device == "cuda":
        release()
    print(f"  the mesh=None runs of phases 48-49: {time.perf_counter() - t0:.1f} s")
    # the ranks of the first spawn serve these once the card is theirs
    mesh_jobs.add((1, 2), "48", w48, s48, matched=True, late=True)
    mesh_jobs.add((1, 2), "48r", w48r, s48r, matched=True, late=True)
    mesh_jobs.add((1, 1), "48", w48, s48, late=True)
    mesh_jobs.add((2, 2), "49", w49, s49, matched=True, late=True)
    mesh_jobs.add((1, 2), "50b", w50b, s50b, matched=True, late=True)
    return {"w48": w48, "w49": w49, "w50b": w50b}


def judge_moe_mesh(fails: Failures, plan: dict, results: dict) -> dict:
    """Phases 48-49's checks on their mesh runs (:func:`moe_mesh_judge`,
    and the soup's own).  Returns the runs."""
    cfg, cfg49 = plan["w48"].config(), plan["w49"].config()
    print(f"[48] {MOE} at full width and depth ({cfg.n_layers} layers, {cfg.moe.n_experts} "
          f"experts, each rank holding its half) on (1, 2) ranks of one card (gloo): paged "
          f"(paged_kernel) {MM_REQUESTS} requests, prompt {MM_PROMPT}, {MM_MAX_NEW} new, "
          f"{SLOTS} slots; rings {MMR_REQUESTS} x {MMR_PROMPT} tokens, {MMR_MAX_NEW} new, "
          f"{MMR_SLOTS} slot; each against its mesh-matched run; the paged workload on (1, 1) "
          f"against mesh=None")
    r48, r48r = results[("48", (1, 2))], results[("48r", (1, 2))]
    r11, r49 = results[("48", (1, 1))], results[("49", (2, 2))]
    L = cfg.n_layers
    moe_mesh_judge(fails, f"{MOE} paged", r48, matched=True, n_layers=L, paged=True, ring=False)
    moe_mesh_judge(fails, f"{MOE} rings", r48r, matched=True, n_layers=L, paged=False,
                   ring=True)
    fails.check(r48r["ring"]["mode"] == "head", f"{MOE} rings split on kv heads ({r48r['ring']})")
    moe_mesh_judge(fails, f"{MOE} paged", r11, matched=False, n_layers=L, paged=True,
                   ring=False)
    print(f"[49] the event soup of {MOE} at full width and {cfg49.n_layers} of 48 layers on "
          f"(2, 2) (paged_kernel, {SF_SOUP_PAGES} pages of {PAGE}, chunk {SF_SOUP_CHUNK}, "
          f"max_seq {SF_SOUP_SEQ}, TTL {SF_SOUP_TTL}: {SF_SOUP}) against its mesh-matched run")
    moe_mesh_judge(fails, f"{MOE} soup", r49, matched=True, n_layers=cfg49.n_layers, paged=True,
                   ring=False)
    st = r49["stats"]
    print(f"  {MOE} soup on 2x2: {r49['requests']} requests, {st['preemptions']} preemptions / "
          f"{st['restores']} restores, {st['park_hits']} park hits, {st['index_hits']} index "
          f"hits, {st['cow_splits']} CoW splits, {st['park_offloads']} parked offloads; "
          f"{r49['blobs']} blobs; slot-row bytes over data {r49['row_wire_bytes']}, K/V writes "
          f"shared over data {r49['kv_share_bytes']} bytes; forced preemption "
          f"{r49['sharded_preempt_ms']} ms by rank (mesh=None {r49['single_preempt_ms']})")
    fails.check(st["preemptions"] > 0 and st["restores"] == st["preemptions"],
                f"{MOE} soup 2x2: preempted and restored ({st['preemptions']} / "
                f"{st['restores']})")
    fails.check(r49["pages_move_no_bytes"], f"{MOE} soup 2x2: page moves sent "
                f"{r49['page_wire_bytes']} collective bytes, forced preemptions "
                f"{r49['preempt_wire']}")
    if r49["identical_outputs"]:
        fails.check(r49["journals_equal"], f"{MOE} soup 2x2: tokens identical to mesh=None, "
                    f"and every rank's billed storage journal equals mesh=None's")
    else:
        print(f"  {MOE} soup 2x2: tokens differ from mesh=None's (the routed sum's one-ulp "
              f"reassociation flips near-tied routes), so its journals are not comparable")
    return {"paged": r48, "rings": r48r, "mesh11": r11, "soup": r49}


# -- phases 50-51: speculation and the elastic fleet on a mesh --------------------

M50_REQUESTS, M50_PROMPT, M50_MAX_NEW = 4, CHUNK, 4    # phase 50b: moonshot, self-draft
P51_WORKERS = 2                  # phase 51: workers of SLOTS // 2 slots each
P51_CRASHES = (("w0", "mid-decode", 8), ("w1", "mid-restore", 0))


def plan_spec_fleet(mesh_jobs: MeshJobs, seed: int, *, device: str = "cuda",
                    reduced: bool = False, n_layers=None) -> dict:
    """Phases 50a and 51's workloads and their ``mesh=None`` runs (one
    minicpm-2b model at full width, freed before the ranks spawn): 50a,
    phase 41's workload served speculatively (gather, greedy) on (1, 2)
    with the self-draft at k = SPEC_K and a draft reseeded +P26_RESEED at
    k = 2, and on (2, 2) with the self-draft, each held to the ``mesh=None``
    run without speculation; 51, the fleet of P51_WORKERS workers
    (``paged_kernel``, parking, prefix sharing, the index journal) on
    (1, 2): phase 41's requests in one burst over a 2-page system prompt,
    P51_CRASHES, a scale to zero, a second turn on two sessions (the cold
    start adopting their parked records and the journaled index pages),
    held to the same fleet on ``mesh=None``.  ``reduced`` and ``n_layers``
    cut both for a CPU rehearsal.  The ``mesh=None`` runs are made while
    the ranks serve (:class:`MeshJobs`)."""
    from repro_torch.launch import sharded_smoke as ss

    base = ss.Workload(arch=ARCH, reduced=reduced, n_layers=n_layers, attn_backend="gather",
                       n_requests=SH_REQUESTS, sessions=SH_SESSIONS, prompt_len=SH_PROMPT,
                       max_new=SH_MAX_NEW, n_slots=SLOTS, page_size=PAGE, prefill_chunk=CHUNK,
                       seed=seed)
    w_self = dataclasses.replace(base, spec=(ARCH, seed, SPEC_K))
    w_other = dataclasses.replace(base, spec=(ARCH, seed + P26_RESEED, 2))
    w51 = dataclasses.replace(
        base, attn_backend="paged_kernel", n_slots=SLOTS // 2,
        max_seq=SH_PROMPT + 2 * SH_MAX_NEW + ss.FLEET_EXTEND,
        fleet=ss.Fleet(workers=P51_WORKERS, crashes=P51_CRASHES))
    @_memo
    def singles():
        model = ss.build(base, device)
        return {"50a": ss.run_single(w_self, device, model=model),    # without speculation
                "51": ss.run_single(w51, device, model=model)}

    single50, single51 = (_memo(lambda key=key: singles()[key]) for key in ("50a", "51"))
    mesh_jobs.add((1, 2), "50a", w_self, single50)
    mesh_jobs.add((1, 2), "50a-reseeded", w_other, single50)
    mesh_jobs.add((2, 2), "50a", w_self, single50)
    mesh_jobs.add((1, 2), "51", w51, single51)
    return {"w_self": w_self, "w_other": w_other, "w51": w51, "device": device}


def judge_spec_fleet(fails: Failures, plan: dict, moe_plan: dict, results: dict) -> dict:
    """Phases 50-51's checks on their mesh runs."""
    import numpy as np

    device = plan["device"]
    on_card = device == "cuda"
    cfg = plan["w_self"].config()
    prompts = {f"r{i}": p for i, p in enumerate(plan["w_self"].prompts(cfg.vocab))}
    print(f"[50a] {ARCH} at {cfg.n_layers} layers, speculative (gather, greedy) on meshes of ranks "
          f"of one card: {SH_REQUESTS} requests over {SH_SESSIONS} sessions, prompt {SH_PROMPT}, "
          f"{SH_MAX_NEW} new, {SLOTS} slots; each held to the mesh=None run without speculation")
    out = {}
    for key, mesh, w in (("50a", (1, 2), plan["w_self"]),
                         ("50a-reseeded", (1, 2), plan["w_other"]),
                         ("50a", (2, 2), plan["w_self"])):
        res = results[(key, mesh)]
        _, seed, k = w.spec
        label = f"{ARCH} {'self-draft' if seed == w.seed else f'draft +{P26_RESEED}'} k={k}"
        st = res["spec_stats"]
        print(f"  {label} on {res['mesh']}: one round's collective bytes {res['wire_one']} by rank "
              f"(at a 4x pool {res['wire_per_step_big']}), a round's collective ms "
              f"{res['wire_ms_per_step']}; a round "
              f"{[x and round(x, 3) for x in res['sharded_step_ms']]} ms by rank (mesh=None "
              f"without speculation {res['single_step_ms']} ms a decode step); acceptance "
              f"{[s['spec_acceptance_rate'] for s in st]}, {st[0]['spec_rounds']} rounds, "
              f"{st[0]['spec_emitted']} tokens; peak "
              f"{[b and round(b / 2**30, 2) for b in res['peak_bytes']]} GiB")
        fails.check(res["ranks_agree"], f"{label} {res['mesh']}: every rank's tokens agree")
        if res["identical_outputs"]:
            fails.check(True, f"{label} {res['mesh']}: tokens identical to mesh=None without "
                        f"speculation")
        else:
            to_np = lambda d: {r: np.asarray(v) for r, v in d.items()}  # noqa: E731
            spec_margins(fails, _lazy_model(w, device)(), cfg, f"{label} {res['mesh']}",
                         {"tokens": to_np(res["tokens_single"])},
                         {"tokens": to_np(res["tokens_sharded"])}, prompts,
                         than="mesh=None without speculation")
        fails.check(res["wire_flat"], f"{label} {res['mesh']}: a round's collective bytes "
                    f"{res['wire_one']} equal at a 4x pool {res['wire_per_step_big']}")
        if seed == w.seed:
            fails.check(min(s["spec_acceptance_rate"] for s in st) >= 0.5,
                        f"{label} {res['mesh']}: acceptance "
                        f"{[s['spec_acceptance_rate'] for s in st]} >= 0.5")
        out[(key, mesh)] = res
    w50b = moe_plan["w50b"]
    mcfg = w50b.config()
    L, k = mcfg.n_layers, w50b.spec[2]
    res = results[("50b", (1, 2))]
    st = res["spec_stats"]
    print(f"[50b] {MOE} at {L} layers, self-draft k={k} (gather) on (1, 2), each rank holding half "
          f"its experts: {M50_REQUESTS} requests, prompt {M50_PROMPT}, {M50_MAX_NEW} new, {SLOTS} "
          f"slots; peak {[b and round(b / 2**30, 3) for b in res['peak_bytes']]} GiB by rank; "
          f"one round's collective bytes {res['wire_one']}, ms {res['wire_ms_per_step']}; a "
          f"round {[x and round(x, 3) for x in res['sharded_step_ms']]} ms; acceptance "
          f"{[s['spec_acceptance_rate'] for s in st]}; tokens identical to mesh=None without "
          f"speculation {res['identical_outputs']}")
    fails.check(res["ranks_agree"], f"{MOE} spec (1, 2): every rank's tokens agree")
    if res["matched_identical"]:
        fails.check(True, f"{MOE} spec (1, 2): tokens identical to its mesh-matched run "
                    f"without speculation (one request at a time)")
    else:
        # as phase 26c holds moonshot's speculation: a verify chunk of k + 1
        # tokens and S=1 steps are bitwise alike on the CPU, not on the card
        # (its GEMMs reassociate by row count), so a stream may split where
        # the target is near-tied
        to_np = lambda d: {r: np.asarray(v) for r, v in d.items()}  # noqa: E731
        mprompts = {f"r{i}": p for i, p in enumerate(w50b.prompts(mcfg.vocab))}
        spec_margins(fails, _lazy_model(w50b, device)(), mcfg, f"{MOE} spec (1, 2)",
                     {"tokens": to_np(res["tokens_matched"])},
                     {"tokens": to_np(res["tokens_sharded"])}, mprompts,
                     than="its mesh-matched run without speculation")
        if on_card:
            release()
    fails.check(res["routes_agree"], f"{MOE} spec (1, 2): routes and MoE inputs bitwise across "
                f"model (digests of the first MoE calls)")
    fails.check(res["expert_split"], f"{MOE} spec (1, 2): each rank's expert bytes "
                f"{res['expert_bytes_rank']} half of {res['expert_bytes_single']}")
    fails.check(res["wire_flat"], f"{MOE} spec (1, 2): a round's collective bytes "
                f"{res['wire_one']} equal at a 4x pool {res['wire_per_step_big']}")
    for r, kinds in enumerate(res["moe_launches_by_kind"] if on_card else []):
        rounds, chunks = st[r]["spec_rounds"], res["chunks_run"][r]
        for name, per in (("moe_route", 1), ("moe_experts", 2), ("moe_combine", 1)):
            want = {"draft": per * L * rounds * k, "verify": per * L * rounds,
                    "chunk": per * L * chunks}
            got = kinds[name]
            fails.check(all(got.get(kd, 0) == want.get(kd, 0) for kd in got)
                        and min(want.values()) > 0,
                        f"{MOE} spec (1, 2) rank {r}: {name} launches by kind {got} == {want} "
                        f"({L} layers x {rounds} rounds of a catch-up and {k - 1} draft steps, "
                        f"and a verify; {chunks} chunks) and none else")
    out["50b"] = res
    w51 = plan["w51"]
    res = results[("51", (1, 2))]
    st, st1 = res["stats"], res["single_fleet"]["fleet"]
    print(f"[51] the elastic fleet of {ARCH} at {cfg.n_layers} layers on (1, 2): {P51_WORKERS} "
          f"workers of {w51.n_slots} slots (paged_kernel, parking, prefix sharing, the index "
          f"journal), {SH_REQUESTS} requests over {SH_SESSIONS} sessions in one burst, prompt "
          f"{SH_PROMPT}, {SH_MAX_NEW} new, crashes {P51_CRASHES}, a scale to zero, a second turn "
          f"on {w51.fleet.second} sessions: fleet {st}; worker decode steps "
          f"{res['worker_steps']} by rank; a worker decode step "
          f"{res['wire_per_step']} collective bytes; peak "
          f"{[b and round(b / 2**30, 2) for b in res['peak_bytes']]} GiB; {res['blobs']} blobs")
    fails.check(res["ranks_agree"] and res["fleet_agrees"], f"{ARCH} fleet (1, 2): every rank's "
                f"tokens, fleet stats, worker events and adoptions agree (an all-reduced digest)")
    fails.check(res["identical_outputs"], f"{ARCH} fleet (1, 2): all {res['requests']} requests' "
                f"tokens identical to the fleet on mesh=None")
    fails.check(res["fleet_record"]["fleet"] == st1
                and res["fleet_record"]["log"] == res["single_fleet"]["log"],
                f"{ARCH} fleet (1, 2): the fleet's stats and its log of events and adoptions "
                f"equal mesh=None's")
    fails.check(st["crashes"] == len(P51_CRASHES) and st["cold_starts_from_zero"] >= 2
                and st["meta_adoptions"] == w51.fleet.second and st["index_adopted"] > 0,
                f"{ARCH} fleet (1, 2): {st['crashes']} crashes, {st['cold_starts_from_zero']} "
                f"cold starts from zero, {st['meta_adoptions']} parked records and "
                f"{st['index_adopted']} index pages adopted")
    fails.check(res["wire_flat"], f"{ARCH} fleet (1, 2): a worker decode step's collective "
                f"bytes {res['wire_per_step']} equal at a 4x pool {res['wire_per_step_big']}")
    fails.check(res["pages_move_no_bytes"] and res["journals_equal"], f"{ARCH} fleet (1, 2): "
                f"page moves sent {res['page_wire_bytes']} collective bytes; every rank's "
                f"billed storage journal equals mesh=None's")
    if res["identical_outputs"]:
        fails.check(res["blob_layer0_bitwise"], f"{ARCH} fleet (1, 2): layer 0 of each rank's "
                    f"page blobs bitwise its shard of mesh=None's (layers bitwise per blob "
                    f"{res['blob_layers_bitwise']})")
        fails.check(res["blob_rel_err_whole"] is not None
                    and res["blob_rel_err_whole"] <= SOUP_BLOB_REL
                    and res["blob_rel_err"] <= SOUP_BLOB_LAYER_REL,
                    f"{ARCH} fleet (1, 2): each rank's blobs against its shard of mesh=None's: "
                    f"bitwise {res['blobs_bitwise']}; largest |difference| over the leaf's "
                    f"{res['blob_rel_err_whole']} <= {SOUP_BLOB_REL}, over its layer's and kv "
                    f"head's {res['blob_rel_err']} <= {SOUP_BLOB_LAYER_REL}")
    if on_card:
        for r, got in enumerate(res["launches_by_rank"]):
            want = cfg.n_layers * res["worker_steps"][r]
            fails.check(got["paged_attention"] == want > 0, f"{ARCH} fleet (1, 2) rank {r}: "
                        f"paged kernel launches {got['paged_attention']} == {cfg.n_layers} "
                        f"layers x {res['worker_steps'][r]} worker decode steps")
    out["51"] = res
    return out


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
    walls = Walls()
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

    walls.mark("1")
    print("[2] kernel vs plain version")
    phase_kernel_cases(fails, args.seed)
    cfg = configs.get(ARCH)
    record = phase_kernel_timing(fails, cfg, args.seed)

    walls.mark("2")
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

    walls.mark("3")
    print("[4] backend agreement at full width")
    phase_agreement(fails, model, cfg, args.seed)
    walls.mark("4")
    print(f"[20] graph replay vs eager: {ARCH}, paged_kernel and gather")
    phase_graph_replay(fails, model, cfg, args.seed, f"{ARCH} paged_kernel",
                       attn_backend="paged_kernel", trace=True)
    phase_graph_replay(fails, model, cfg, args.seed, f"{ARCH} gather")
    release()
    walls.mark("20 (minicpm)")
    print(f"[24] {ARCH}: storage-backed preemption, prefix sharing, session parking")
    t24 = time.perf_counter()
    phase_offload_sharing(fails, model, cfg, args.seed, counts)
    print(f"  phase 24 wall {time.perf_counter() - t24:.1f} s")
    release()
    walls.mark("24")
    print(f"[26a] {ARCH}: draft-and-verify speculative decoding on the paged pool (gather, "
          f"greedy), {N_REQUESTS} requests over {SESSIONS} sessions, prompt {PROMPT}, "
          f"{MAX_NEW} new, {SLOTS} slots")
    t26 = time.perf_counter()
    draft = build_model(cfg, device="cuda", seed=args.seed + P26_RESEED)
    phase_spec(fails, model, cfg, args.seed, ARCH,
               [(f"self-draft k={SPEC_K}", model, SPEC_K),
                (f"draft reseeded +{P26_RESEED} k=2", draft, 2)],
               n_requests=N_REQUESTS, sessions=SESSIONS, prompt=PROMPT, max_new=MAX_NEW,
               slots=SLOTS, min_acceptance=0.5)
    del draft
    print(f"  phase 26a wall {time.perf_counter() - t26:.1f} s")
    release()
    turns, cold, max_seq = p27_dense_turns(cfg, args.seed)
    walls.mark("26a")
    print(f"[27a] {ARCH}: the elastic fleet, {P27_WORKERS} workers of {P27_SLOTS} slots "
          f"(paged_kernel, parking, prefix sharing, the index journal), "
          f"{P27_SESSIONS * P27_PER_SESSION} requests over {P27_SESSIONS} sessions in one "
          f"burst, prompt {PROMPT} ({P27_SYS_PAGES}-page system prompt), {MAX_NEW} new; "
          f"crashes {sorted(P27_CRASHES)}, w2 wedged at tick {P27_WEDGE_TICK}; scale to "
          f"zero, then a cold start")
    t27 = time.perf_counter()
    f27 = phase_fleet(fails, model, cfg, args.seed, "27a", workers=P27_WORKERS,
                      slots=P27_SLOTS, max_seq=max_seq, max_new=MAX_NEW, turns=turns, cold=cold,
                      crashes=P27_CRASHES, wedge=(P27_WEDGE_TICK, "w2"))
    print(f"  phase 27a wall {time.perf_counter() - t27:.1f} s; paged kernel launches on the "
          f"fleet {f27['paged_attention']}")
    del model
    torch.cuda.empty_cache()

    walls.mark("27a")
    print("[5] RG-LRU scan kernel and the paged kernel at D=256 vs plain versions")
    phase_rglru_cases(fails, args.seed)
    phase_kernel_cases(fails, args.seed, cases=PAGED_CASES_D256)

    hcfg = configs.get(HYBRID)
    pat = layer_pattern(hcfg)
    n_rec, n_attn = pat.count("r"), pat.count("a")
    walls.mark("5")
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

    walls.mark("6")
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

    walls.mark("7")
    print("[8] backend agreement at full width (hybrid)")
    phase_agreement(fails, hmodel, hcfg, args.seed, prompt=H_PROMPT, max_new=H_MAX_NEW)

    walls.mark("8")
    print("[9] decode vs chunk prefill of one slot's recurrent rows (full width)")
    phase_recurrent_parity(fails, hmodel, hcfg, args.seed)
    walls.mark("9")
    print(f"[20] graph replay vs eager: {HYBRID}, paged_kernel")
    phase_graph_replay(fails, hmodel, hcfg, args.seed, f"{HYBRID} paged_kernel",
                       attn_backend="paged_kernel", trace=True)
    release()
    walls.mark("20 (hybrid)")
    print(f"[25] {HYBRID}: {P25_SESSIONS} sessions x {P25_TURNS} turns on {P25_SLOTS} slots, "
          f"parking and offload, two preemptions forced mid-decode")
    t25 = time.perf_counter()
    phase_hybrid_parking(fails, hmodel, hcfg, args.seed)
    print(f"  phase 25 wall {time.perf_counter() - t25:.1f} s")

    walls.mark("25")
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
    release()
    dcfg = dataclasses.replace(configs.get(ARCH), name=f"{ARCH}-4l-v{hcfg.vocab}", n_layers=4,
                               vocab=hcfg.vocab)
    walls.mark("19")
    print(f"[26b] {HYBRID}: speculative decoding, a seeded {dcfg.n_layers}-layer dense draft "
          f"of {ARCH}'s widths and vocab {dcfg.vocab}, {H26_REQUESTS} requests, prompt "
          f"{PROMPT}, {MAX_NEW} new, {H26_SLOTS} slots")
    t26 = time.perf_counter()
    draft = build_model(dcfg, device="cuda", seed=args.seed + P26_RESEED)
    phase_spec(fails, hmodel, hcfg, args.seed, HYBRID,
               [(f"4-layer dense draft k={SPEC_K}", draft, SPEC_K)],
               n_requests=H26_REQUESTS, sessions=H26_REQUESTS, prompt=PROMPT,
               max_new=MAX_NEW, slots=H26_SLOTS)
    del draft
    print(f"  phase 26b wall {time.perf_counter() - t26:.1f} s")
    release()
    turns, cold, max_seq = p27_hybrid_turns(hcfg, args.seed)
    walls.mark("26b")
    print(f"[27b] {HYBRID}: the elastic fleet, {H27_WORKERS} workers of {H27_SLOTS} slots "
          f"(paged_kernel, parking), {H27_REQUESTS} requests of {H_PROMPT} tokens, "
          f"{H_MAX_NEW} new; scale to zero, then a cold start from a park-meta that carries "
          f"recurrent rows")
    t27 = time.perf_counter()
    h27 = phase_fleet(fails, hmodel, hcfg, args.seed, "27b", workers=H27_WORKERS,
                      slots=H27_SLOTS, max_seq=max_seq, max_new=H_MAX_NEW, turns=turns,
                      cold=cold)
    print(f"  phase 27b wall {time.perf_counter() - t27:.1f} s; launches on the fleet: paged "
          f"{h27['paged_attention']}, rglru {h27['rglru_scan']}")
    del hmodel
    torch.cuda.empty_cache()

    walls.mark("27b")
    print("[10] SSD scan kernel vs its plain chunked form")
    phase_ssd_cases(fails, args.seed)

    scfg = configs.get(SSM)
    ss = scfg.ssm
    H, P, N = ss.n_heads(scfg.d_model), ss.head_dim, ss.d_state
    walls.mark("10")
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

    walls.mark("11")
    print(f"[12] SSD kernel at {SSM}'s serving shapes (CUDA events)")
    for shape, launches in (((1, CHUNK, H, P, N), scfg.n_layers * chunks),
                            ((SLOTS, 1, H, P, N), scfg.n_layers * steps),
                            ((1, 2048, H, P, N), 0)):
        records.append(phase_ssd_timing(fails, args.seed, shape, launches))

    walls.mark("12")
    print(f"[13] {SSM} decode step and prefill chunk: costs outside the kernel, traces")
    phase_ssm_steps(fails, smodel, scfg, args.seed)

    walls.mark("13")
    print("[14] decode vs chunk prefill of one SSM slot (full width)")
    phase_ssm_parity(fails, smodel, scfg, args.seed)
    walls.mark("14")
    print(f"[20] graph replay vs eager: {SSM}")
    phase_graph_replay(fails, smodel, scfg, args.seed, SSM)
    del smodel
    torch.cuda.empty_cache()

    walls.mark("20 (mamba2)")
    print("[15] flash-attention kernel vs its plain version")
    phase_flash_cases(fails, args.seed)

    qcfg = configs.get(DENSE_RING)
    walls.mark("15")
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

    walls.mark("16")
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

    walls.mark("17")
    print(f"[18] ring prefill (flash) vs paged chunked prefill at full width ({DENSE_RING})")
    phase_ring_agreement(fails, qmodel, qcfg, args.seed)
    walls.mark("18")
    print(f"[20] graph replay vs eager: {DENSE_RING} rings (decode)")
    phase_graph_replay(fails, qmodel, qcfg, args.seed, f"{DENSE_RING} ring", kv_mode="ring")
    del qmodel
    release()

    phase_whisper(fails, args.seed)
    v_flash = phase_vlm(fails, args.seed)
    records.append(v_flash)

    mcfg = configs.get(MOE)
    mm = mcfg.moe
    walls.mark("20 (qwen3 rings), 28a-b")
    print("[21] grouped expert, route and combine kernels vs their plain versions")
    ptxas_report(fails, "moe_experts", "moe_experts_kernel", 10)
    phase_moe_cases(fails, args.seed)
    phase_route_cases(fails, args.seed)
    walls.mark("21 (cases)")
    print(f"[21] kernels at {MOE}'s shapes (CUDA events)")
    moe_records = []
    for T, label in MOE_TIMED:
        moe_records.extend(phase_moe_timing(fails, args.seed, T, label))
        moe_records.extend(phase_route_timing(fails, args.seed, T, label))
    # the router at moonshot's training microstep (its launches counted in phase 39)
    route_train = phase_route_timing(fails, args.seed, T38, f"training microstep of {T38}",
                                     combine=False)
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
    walls.mark("21 (timing)")
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
                and mcounts["moe_route"] == mcounts["moe_combine"] == L * (steps + chunks),
                f"moe_experts launches {mcounts['moe_experts']} == 2 x {L} layers x ({steps} "
                f"decode steps + {chunks} chunks), half of them gate/up "
                f"({mcounts['moe_experts_swiglu']}); route {mcounts['moe_route']} and combine "
                f"{mcounts['moe_combine']} == {L} x ({steps} + {chunks})")
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
        rec["launches"] = mcounts[rec["name"]]
    release()
    walls.mark("22 (serving)")
    print(f"[22] backend agreement at full width ({MOE})")
    phase_agreement(fails, mmodel, mcfg, args.seed, prompt=M_PROMPT, max_new=M_MAX_NEW)
    release()
    walls.mark("22 (agreement)")
    print(f"[20] graph replay vs eager: {MOE}, paged_kernel")
    print("  figures before the route and combine kernels (PERF.md section 5): replayed "
          "decode 26.263 ms host, 26.11 ms busy, idle 0.523; replayed chunk of 256 35.650 ms "
          "host, 35.26 ms busy, idle 0.471; 7081 / 7265 host launch calls eager")
    phase_graph_replay(fails, mmodel, mcfg, args.seed, f"{MOE} paged_kernel",
                       attn_backend="paged_kernel", trace=True)
    walls.mark("20 (moonshot)")
    print(f"[22] decode vs chunk prefill of one slot's MoE layers (full width)")
    phase_moe_parity(fails, mmodel, mcfg, args.seed)
    walls.mark("22 (parity)")
    print(f"[22] one MoE layer's launches at decode, chunk and ring prefill sizes")
    phase_moe_launches(fails, mmodel, mcfg, args.seed)
    release()

    walls.mark("22 (launches)")
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
                and rcounts["moe_route"] == rcounts["moe_combine"] == L * (adm + steps),
                f"moe_experts launches {rcounts['moe_experts']} == 2 x {L} layers x ({adm} "
                f"admissions + {steps} decode steps); route {rcounts['moe_route']} and combine "
                f"{rcounts['moe_combine']} == {L} x ({adm} + {steps})")
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
    walls.mark("23 (serving)")
    print(f"[23] ring prefill (flash) vs paged chunked prefill at full width ({MOE})")
    phase_ring_agreement(fails, mmodel, mcfg, args.seed, prompt=MR_PROMPT,
                         max_new=MR_MAX_NEW)
    records.extend(moe_records + [m_paged, m_flash])
    release()
    walls.mark("23 (agreement)")
    print(f"[26c] {MOE}: speculative decoding, self-draft k={SPEC_K}, {M26_REQUESTS} requests, "
          f"prompt {PROMPT}, {MAX_NEW} new, {M26_SLOTS} slots")
    t26 = time.perf_counter()
    phase_spec(fails, mmodel, mcfg, args.seed, MOE, [(f"self-draft k={SPEC_K}", mmodel, SPEC_K)],
               n_requests=M26_REQUESTS, sessions=M26_REQUESTS, prompt=PROMPT, max_new=MAX_NEW,
               slots=M26_SLOTS)
    print(f"  phase 26c wall {time.perf_counter() - t26:.1f} s")
    del mmodel
    release()

    t29 = time.perf_counter()
    walls.mark("26c")
    print("[29] flash backward and the RG-LRU backward vs their plain versions")
    phase_flash_backward_cases(fails, args.seed)
    phase_rglru_backward_cases(fails, args.seed)
    walls.mark("29")
    print("[30] the backward kernels at the training shapes (CUDA events)")
    train_shapes = (
        (ARCH, (T31_BATCH // T31_ACCUM, T31_SEQ, cfg.n_heads, cfg.n_kv_heads,
                cfg.the_head_dim()), None),
        (HYBRID, (T32_BATCH // T32_ACCUM, T32_SEQ, hcfg.n_heads, hcfg.n_kv_heads,
                  hcfg.the_head_dim()), hcfg.hybrid.local_window),
        (DENSE_RING, (1, Q_PROMPT, qcfg.n_heads, qcfg.n_kv_heads, qcfg.the_head_dim()), None))
    train_records = {label: phase_flash_backward_timing(fails, args.seed, label, shape, window)
                     for label, shape, window in train_shapes}
    rglru_bwd = phase_rglru_backward_timing(fails, args.seed,
                                            (T32_BATCH // T32_ACCUM, T32_SEQ, W))
    print(f"  phases 29-30 wall {time.perf_counter() - t29:.1f} s")
    walls.mark("30")
    print(f"[31] full-depth, full-width {ARCH} training: {cfg.n_layers} layers, "
          f"{T31_STEPS} steps of {T31_BATCH} x {T31_SEQ} tokens in {T31_ACCUM} microbatches "
          f"(train_4k's global batch 256 cut to {T31_BATCH}), WSD at lr {TRAIN_LR}")
    t31 = time.perf_counter()
    r31 = phase_train(fails, args.seed, ARCH, seq=T31_SEQ, global_batch=T31_BATCH,
                      accum=T31_ACCUM, steps=T31_STEPS)
    print(f"  phase 31 wall {time.perf_counter() - t31:.1f} s")
    walls.mark("31")
    print(f"[32] full-width {HYBRID} training: {hcfg.n_layers} layers ({n_rec} RG-LRU, "
          f"{n_attn} local attention), {T32_STEPS} steps of {T32_BATCH} x {T32_SEQ} tokens in "
          f"{T32_ACCUM} microbatches, cosine at lr {TRAIN_LR}")
    t32 = time.perf_counter()
    r32 = phase_train(fails, args.seed, HYBRID, seq=T32_SEQ, global_batch=T32_BATCH,
                      accum=T32_ACCUM, steps=T32_STEPS)
    print(f"  phase 32 wall {time.perf_counter() - t32:.1f} s")
    for label, r in ((ARCH, r31), (HYBRID, r32)):
        bwd, lse = train_records[label]
        bwd["launches"] = r["counts"]["flash_attention_backward"]
        lse["launches"] = r["counts"]["flash_attention"]
    rglru_bwd["launches"] = r32["counts"]["rglru_scan_backward"]
    t34 = time.perf_counter()
    walls.mark("32")
    print("[34] the SSD scan's backward vs its plain version")
    ssd_worst = phase_ssd_backward_cases(fails, args.seed)
    walls.mark("34")
    print(f"[35] the SSD backward at {SSM}'s training shape, both routes (CUDA events)")
    ssd_bwd, ssd_bwd_cc = phase_ssd_backward_timing(
        fails, args.seed, (T36_BATCH // T36_ACCUM, T36_SEQ, H, P, N))
    ssd_bwd["worst_err_over_bound_34"] = ssd_worst
    walls.mark("35")
    print(f"[36] full-depth, full-width {SSM} training: {scfg.n_layers} layers, {T36_STEPS} "
          f"steps of {T36_BATCH} x {T36_SEQ} tokens in {T36_ACCUM} microbatches, cosine at lr "
          f"{TRAIN_LR}")
    t36 = time.perf_counter()
    r36 = phase_train(fails, args.seed, SSM, seq=T36_SEQ, global_batch=T36_BATCH,
                      accum=T36_ACCUM, steps=T36_STEPS)
    ssd_bwd["launches"] = r36["counts"]["ssd_backward_tensor_core"]
    ssd_bwd_cc["launches"] = r36["counts"]["ssd_scan_backward"] - ssd_bwd["launches"]
    print(f"  phase 36 wall {time.perf_counter() - t36:.1f} s; phases 34-36 "
          f"{time.perf_counter() - t34:.1f} s")
    t37 = time.perf_counter()
    walls.mark("36")
    print("[37] the MoE backward kernels (combine, the data and weight gradients, route; the "
          "gather's through the combine kernel) vs their plain versions")
    phase_moe_backward_cases(fails, args.seed)
    walls.mark("37")
    print(f"[38] the MoE backward kernels at {MOE}'s training microstep (CUDA events)")
    moe_bwd = phase_moe_backward_timing(fails, args.seed)
    print(f"  phases 37-38 wall {time.perf_counter() - t37:.1f} s")
    walls.mark("38")
    print(f"[39] full-width {MOE} training at {T39_LAYERS} of {mcfg.n_layers} layers: "
          f"{T39_STEPS} steps of {T39_BATCH} x {T39_SEQ} tokens in {T39_ACCUM} microbatches, "
          f"cosine at lr {TRAIN_LR}")
    t39 = time.perf_counter()
    r39 = phase_train(fails, args.seed, MOE, seq=T39_SEQ, global_batch=T39_BATCH,
                      accum=T39_ACCUM, steps=T39_STEPS, n_layers=T39_LAYERS)
    for rec in moe_bwd + route_train:
        rec["launches"] = r39["counts"][rec["name"]]
    print(f"  phase 39 wall {time.perf_counter() - t39:.1f} s")
    walls.mark("39")
    print(f"[33] {ARCH} at full width and {T33_LAYERS} layers: kernel vs plain attention, "
          f"crash and resume; the paged kernel (serving only) refuses grad")
    t33 = time.perf_counter()
    phase_train_agreement(fails, args.seed)
    phase_train_resume(fails, args.seed)
    phase_train_refusal(fails, args.seed)
    print(f"  phase 33 wall {time.perf_counter() - t33:.1f} s; phases 29-33 "
          f"{time.perf_counter() - t29:.1f} s")
    release()
    t40 = time.perf_counter()
    walls.mark("33")
    print("[40] the paged kernel per lane or head shard vs its plain version; the merged "
          "shards vs the unsharded kernel")
    phase_shard_cases(fails, args.seed)
    walls.mark("40")
    print(f"[43] the SSD scan per head shard at {SSM}'s serving shapes vs its plain version and "
          f"the unsharded launch")
    ssd_shards = phase_ssd_shards(fails, args.seed)
    walls.mark("43")
    print(f"[47] the grouped expert kernel per expert shard and the combine's fp32 partial at "
          f"{MOE}'s shapes vs the unsharded launch and the plain version")
    moe_shard_records = phase_moe_shards(fails, args.seed)
    print(f"  phases 40, 43, 47 wall {time.perf_counter() - t40:.1f} s")
    t41 = time.perf_counter()
    mesh_jobs = MeshJobs()
    walls.mark("47")
    print(f"[41-51] the mesh phases' workloads: one spawn of ranks on the card for each mesh "
          f"shape, the mesh=None runs made while the first one serves")
    plan41 = plan_sharded_serving(mesh_jobs, args.seed)
    plan44 = plan_sharded_features(mesh_jobs, args.seed)
    plan48 = plan_moe_mesh(mesh_jobs, args.seed)
    plan50 = plan_spec_fleet(mesh_jobs, args.seed)
    walls.mark("48-49, 50b (mesh=None runs)")
    results = mesh_jobs.run()
    print(f"  the mesh runs of phases 41-51: {time.perf_counter() - t41:.1f} s")
    walls.mark("41-51 (the spawns, the other mesh=None runs made meanwhile)")
    sharded = judge_sharded_serving(fails, plan41, results)
    features = judge_sharded_features(fails, plan44, results)
    moe_mesh = judge_moe_mesh(fails, plan48, results)
    judge_spec_fleet(fails, plan50, plan48, results)
    walls.mark("41-51 (the checks)")
    print("[40] the per-shard kernel at the sharded serving shapes (CUDA events)")
    mesh12, hyb = sharded[(1, 2)], sharded["hybrid"]
    records.append(phase_shard_timing(
        fails, args.seed, f"{ARCH} decode", SHARD_CASES[0][1], 2,
        sum(n["paged_attention"] for n in mesh12["launches"]), mesh12["wire_per_step"][0][0],
        cfg.n_layers))
    records.append(phase_shard_timing(
        fails, args.seed, f"{HYBRID} decode", SHARD_CASES[2][1], 2,
        sum(n["paged_attention"] for n in hyb["launches"]), hyb["wire_per_step"][0][0],
        n_attn))
    for rec in ssd_shards:
        rec["launches"] = features["ssd_launches"]["chunk" if rec.pop("L") > 1 else "decode"]
    records.extend(ssd_shards)
    for rec in moe_shard_records:
        kind = rec.pop("kind")
        run = moe_mesh["rings" if kind == "prefill" else "paged"]["moe_launches_by_kind"]
        rec["launches"] = sum(n[rec["name"]][kind] for n in run)
    records.extend(moe_shard_records)
    print(f"  phases 40-51 wall {time.perf_counter() - t40:.1f} s")
    release()
    for recs in train_records.values():
        records.extend(recs)
    records.append(rglru_bwd)
    records.extend([ssd_bwd, ssd_bwd_cc])
    records.extend(moe_bwd + route_train)

    walls.mark("40 and the kernel record")
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
