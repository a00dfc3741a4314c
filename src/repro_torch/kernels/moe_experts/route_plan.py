"""The routing kernels' shapes: the forward's grid, tiles, slice groups,
shared memory and workspace, and the route backward's two launches.

Plain Python, modelling ``kernels/csrc/moe_experts.cu::route_shape`` and
``kernels/csrc/moe_backward.cu::rb_shape`` for the CPU tests and
``chip_smoke.py``, which holds the library's own plans
(``kernel.route_plan``, ``kernel.route_backward_plan``) against this model.
Import names from this module (``from .route_plan import route_shape``):
the package's own ``route_plan`` is the wrapper that asks the library.

The forward (``moe_route_kernel``, then ``moe_route_sort_kernel`` when the
tokens span more than one tile).  Each logit is 32 slices of D, each an FMA
chain in d order from 0, the slice sums added in slice order; the slice
width depends on D alone, so a logit is the same sum whatever T is.  A
thread holds ``tm`` tokens x 8 experts of one slice (the experts padded to
``ep = 8 nc``, ``nc`` a power of two); a block's 8 warps are ``ws`` slice
warps x ``wt`` token warps; a tile is ``wt`` x ``btw`` tokens; the 32
slices of a tile go to ``groups`` blocks.  A ring stage holds, for each
of a block's ``ws`` slices, a box of x (``tt`` rows of ``ks`` bf16) and one
of w (``ks`` rows of ``ep`` fp32), loaded by TMA where ``tma`` (rows of x
and w 16-byte multiples), else by cp.async.  With one group a block folds
each round of ``ws`` slices through a buffer in shared memory; otherwise
every slice's chains meet in the workspace ``(32, tiles tt, ep)`` fp32,
followed by the tile counts ``(tiles, E)`` int32.

The backward.  The dx launch takes 64 tokens a block (their dlogits once,
kept in the workspace ``(T, E)`` fp32) and D in chunks of ``dc`` columns
through two stages of w rows (16-byte copies at a stride of ``wst``
floats); the dw launch takes (D tile, token split)
blocks, an FMA chain over a split's tokens in order, the splits' partials
``(splits, D, E)`` fp32 summed in split order.
"""

from __future__ import annotations

from typing import NamedTuple

from .plan import H100_SMS, SMEM_LIMIT

SLICES = 32                 # slices of D, summed in order
THREADS = 256               # the routing and sort launches, and the dx launch
WARPS = THREADS // 32
STAGES = 3                  # the routing launch's ring at most (2 at 8 tokens a thread)
STAGE_CAP = 32 * 1024       # bytes of w, and of x, one stage holds at most
SORT_BLOCKS = 256           # the sort launch's blocks (more only past its table)
SORT_TABLE = 160 * 1024     # bytes of the sort launch's tile bases
COUNTERS = 256              # kRouteCounters, kRbCounters
MAX_E, MAX_K, MAX_D = 128, 32, 4096
STATIC_SMEM = MAX_E * 4 + 64          # the routing launch's static shared memory, at most

RB_TOKENS = 64              # the dx launch: tokens a block
RB_DL_STRIDE = RB_TOKENS + 4
RB_STAGES = 2
RB_BATCH = 4                # tokens a warp takes through their dlogits at once
RB_W_THREADS = 128          # the dw launch: threads a half-block at most
RB_MAX_DT = 256             # its columns of D a block at most
RB_W_TOKENS = 32            # its tokens a stage
RB_W_STAGES = 4
RB_MAX_SPLITS = 8
RB_SPLIT_TOKENS = 1024


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def align128(n: int) -> int:
    return (n + 127) & ~127


def accepts(T: int, D: int, E: int, k: int) -> bool:
    """The shapes both wrappers take."""
    return T >= 1 and 2 <= D <= MAX_D and D % 2 == 0 and 1 <= k <= E <= MAX_E and k <= MAX_K


class RouteShape(NamedTuple):
    tm: int                 # tokens a thread
    nc: int                 # lanes across the experts
    ep: int                 # experts padded: 8 nc
    btw: int                # tokens a warp
    groups: int             # blocks a tile
    ws: int                 # slice warps a block
    wt: int                 # token warps a block
    tt: int                 # tokens a tile
    tiles: int
    rounds: int             # rounds of ws slices a block
    slice: int              # d values a slice
    stages: int             # the ring's stages
    ks: int                 # d values of each slice a stage holds
    subs: int               # stages a round
    xs_words: int           # 32-bit words a staged x row: ks / 2
    x_box: int              # bytes of a slice's x box (128-byte aligned)
    w_box: int              # bytes of a slice's w box
    x_bytes: int
    stage_bytes: int
    fold_bytes: int
    smem: int               # dynamic shared memory of the routing launch
    sort_chunk: int         # tiles a sort block
    sort_blocks: int        # 0: one tile, sorted in the routing launch
    sort_smem: int
    tma: bool               # stages by TMA (rows of x and w 16-byte multiples)
    part_floats: int
    workspace: int          # bytes


def slice_width(D: int) -> int:
    """d values a slice: ceil(D / 32) rounded up to even (D alone)."""
    return (cdiv(D, SLICES) + 1) & ~1


def slice_bounds(D: int):
    """The 32 slices' [d0, d0 + len) over D (trailing ones may be empty)."""
    w = slice_width(D)
    return [(min(D, s * w), min(D, min(D, s * w) + w)) for s in range(SLICES)]


def route_shape(T: int, D: int, E: int, k: int, sms: int = H100_SMS) -> RouteShape:
    """``route_shape`` of ``moe_experts.cu`` for (T, D, E, k) on ``sms`` SMs."""
    nc = 1
    while 8 * nc < E:
        nc *= 2
    ep = 8 * nc
    slice_ = slice_width(D)
    rows = 32 // nc
    tm = 8 if cdiv(T, rows * 8) * 4 >= sms else 2
    btw = rows * tm
    groups = 1
    if tm == 2:
        best = -1
        g = SLICES
        while g >= 1:
            ws = min(WARPS, SLICES // g)
            tt = WARPS // ws * btw
            tiles = cdiv(T, tt)
            if not (g > 1 and (tiles * g > sms or tiles >= COUNTERS - 1)):
                cost = (SLICES // g) * slice_ * ep * 4 + \
                    (min(tt, T) * ep * SLICES * 4 if g > 1 else 0)
                if best < 0 or cost < best:
                    best, groups = cost, g
            g //= 2
    ws = min(WARPS, SLICES // groups)
    wt = WARPS // ws
    tt = wt * btw
    tiles = cdiv(T, tt)
    rounds = SLICES // groups // ws
    stages = 2 if tm == 8 else STAGES       # two stages of twice the d at 8 tokens a thread
    cap = 2 * STAGE_CAP if tm == 8 else STAGE_CAP
    ks = min(slice_, cap // (ws * ep * 4), cap // (ws * tt * 2))
    ks = ks & ~7 if ks >= 8 else max(2, ks & ~1)
    subs = cdiv(slice_, ks)
    xs_words = ks // 2
    x_box, w_box = align128(tt * ks * 2), align128(ks * ep * 4)
    x_bytes = ws * x_box
    stage_bytes = x_bytes + ws * w_box
    fold_bytes = ws * tt * ep * 4 if groups == 1 else 0
    tma = D % 8 == 0 and E % 4 == 0 and ks % 8 == 0 and tt <= 256
    route_bytes = (tt * (ep + 1) + 3 * tt * k + WARPS * E) * 4
    smem = 128 + max(stages * stage_bytes + fold_bytes, route_bytes)
    part_floats = SLICES * tiles * tt * ep if groups > 1 else 0
    sort_chunk = max(1, min(cdiv(tiles, SORT_BLOCKS), SORT_TABLE // (E * 4)))
    sort_blocks = cdiv(tiles, sort_chunk) if tiles > 1 else 0
    return RouteShape(tm, nc, ep, btw, groups, ws, wt, tt, tiles, rounds, slice_, stages, ks,
                      subs, xs_words, x_box, w_box, x_bytes, stage_bytes, fold_bytes, smem,
                      sort_chunk, sort_blocks, sort_chunk * E * 4, tma, part_floats,
                      part_floats * 4 + tiles * E * 4)


def library_fields(s: RouteShape) -> tuple:
    """The fields ``moe_route_plan`` reports (``kernel.RoutePlan``)."""
    return (s.tt, s.groups, s.tiles, s.smem, min(s.workspace, 2 ** 31 - 1), s.tm, s.ws, s.ks,
            s.sort_blocks, int(s.tma))


class RouteBackwardShape(NamedTuple):
    token_tiles: int        # the dx launch's blocks
    ci: int                 # its columns a lane a chunk
    dc: int                 # its columns a chunk
    chunks: int
    dx_smem: int
    ne: int                 # the dw launch: lanes across the experts
    ep: int
    dt: int                 # its columns a tile
    threads: int            # its threads a block
    d_tiles: int
    split: int              # tokens a split
    splits: int
    dw_smem: int
    dl_floats: int
    part_floats: int
    workspace: int          # bytes


def route_backward_shape(T: int, D: int, E: int) -> RouteBackwardShape:
    """``rb_shape`` of ``moe_backward.cu`` (shapes alone, no SM count)."""
    ci = 8 if E <= 64 else 4
    dc = 32 * ci
    wst = ((E + 3) & ~3) + 4     # w rows' stride in floats: 4 mod 8 (E a multiple of 8)
    dx_smem = (E * RB_DL_STRIDE + 8 * RB_BATCH * E + RB_STAGES * dc * wst) * 4
    ne = 1
    while 8 * ne < E:
        ne *= 2
    ep = 8 * ne
    dt = 8 * min(RB_W_THREADS // ne, RB_MAX_DT // 8)
    threads = 2 * ne * dt // 8          # two halves of the stage's tokens
    want = min(RB_MAX_SPLITS, max(1, T // RB_SPLIT_TOKENS))
    split = cdiv(cdiv(T, want), RB_W_TOKENS) * RB_W_TOKENS
    splits = cdiv(T, split)
    dw_smem = RB_W_STAGES * RB_W_TOKENS * (dt * 2 + ep * 4)
    dl_floats = (T * E + 3) & ~3
    part_floats = splits * D * E if splits > 1 else 0
    return RouteBackwardShape(cdiv(T, RB_TOKENS), ci, dc, cdiv(D, dc), dx_smem, ne, ep, dt,
                              threads, cdiv(D, dt), split, splits, dw_smem, dl_floats,
                              part_floats, (dl_floats + part_floats) * 4)


def backward_library_fields(s: RouteBackwardShape) -> tuple:
    """The fields ``moe_route_backward_plan`` reports (``kernel.RouteBackwardPlan``)."""
    return (s.token_tiles, s.dc, s.dx_smem, min(s.workspace, 2 ** 31 - 1), s.d_tiles, s.dt,
            s.splits, s.split, s.threads, s.dw_smem)


def fits(T: int, D: int, E: int, k: int, sms: int = H100_SMS) -> bool:
    """Every launch's shared memory within the card's 227 KB a block."""
    f, b = route_shape(T, D, E, k, sms), route_backward_shape(T, D, E)
    return (f.smem + STATIC_SMEM <= SMEM_LIMIT and f.sort_smem <= SMEM_LIMIT - 4 * 1024
            and b.dx_smem <= SMEM_LIMIT and b.dw_smem <= SMEM_LIMIT - 1024)
