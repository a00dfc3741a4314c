"""The grouped expert kernel's schedule: tile height, ring depth, grid and work items.

Plain Python, modelling ``kernels/csrc/moe_experts.cu`` (``make_plan`` and
``item_of``) for the CPU tests and ``chip_smoke.py``'s printed schedule;
the kernel computes the same map on the device, where the offsets live,
and the wrapper counts each launch under the plan the library reports
(``kernel.library_plan``), which ``chip_smoke.py`` holds against this
model.

A launch is a persistent grid of at most one block an SM.  Its work items
are (expert, row tile of ``BM`` rows, ``BN`` output columns): group 0's
experts in order, each its column tiles with the row tiles innermost (so
blocks running together share a weight tile in L2), then group 1 (the
shared expert, one segment of ``rows1`` rows) the same way.  Item ``i``
runs on block ``i % grid``.  ``BM`` is 128 (two consumer warpgroups) where
group 0's segments average 128 rows or more, else 64; the grid comes from
shapes alone, so a CUDA graph can hold the launch.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

H100_SMS = 132
BN = 128                  # output columns per item
BK = 64                   # K per ring stage
WG_ROWS = 64              # rows per consumer warpgroup
MAX_STAGES = 8
TALL_STAGES = 4           # ring depth cap on 128-row tiles (bound by operations)
SMEM_LIMIT = 227 * 1024
MODES = ("swiglu", "gelu", "plain")


class Item(NamedTuple):
    group: int            # 0 the routed pairs, 1 the second group
    expert: int
    r0: int               # rows [r0, r1) of the group's x and out
    r1: int
    n0: int               # columns [n0, min(n0 + BN, N))


class Plan(NamedTuple):
    bm: int               # rows per tile
    stages: int           # ring depth
    smem: int             # dynamic shared memory bytes
    grid: int             # blocks
    max_items: int        # the item bound the grid was sized from


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def stage_bytes(mode: str, bm: int) -> int:
    """One ring stage: the x tile and one 64 x 128 tile of each weight matrix."""
    return bm * BK * 2 + (2 if mode == "swiglu" else 1) * BK * BN * 2


def table_bytes(stages: int, n_exp: int) -> int:
    """The ring's full and empty barriers, the clamped offsets and the
    experts' first items."""
    return stages * 16 + 2 * (n_exp + 1) * 4


def make_plan(mode: str, rows0: int, n_exp: int, N0: int, rows1: int = 0, N1: int = 0,
              n_sms: int = H100_SMS) -> Plan:
    """The plan ``moe_experts_launch`` makes (``moe_experts_plan`` in the
    library reports the card's own): 128-row tiles where group 0's segments
    average 128 rows or more, else 64."""
    bm = 2 * WG_ROWS if rows0 >= 2 * WG_ROWS * n_exp else WG_ROWS
    free = SMEM_LIMIT - 1024 - table_bytes(MAX_STAGES, n_exp)
    stages = min(TALL_STAGES if bm > WG_ROWS else MAX_STAGES, free // stage_bytes(mode, bm))
    smem = 1024 + stages * stage_bytes(mode, bm) + table_bytes(stages, n_exp)
    max_items = (rows0 // bm + n_exp) * _cdiv(N0, BN)
    if rows1 > 0:
        max_items += _cdiv(rows1, bm) * _cdiv(N1, BN)
    return Plan(bm, stages, smem, min(max_items, n_sms), max_items)


def items(offsets: Sequence[int], rows0: int, N0: int, rows1: int = 0, N1: int = 0,
          bm: int = WG_ROWS) -> List[Item]:
    """Every work item of a launch, in the kernel's order; ``offsets`` are
    group 0's (E + 1) segment bounds, clamped to ``[0, rows0]`` as the
    kernel clamps them."""
    offs = [min(max(int(o), 0), rows0) for o in offsets]
    out = []
    for e in range(len(offs) - 1):
        lo, hi = offs[e], offs[e + 1]
        rt = max(hi - lo + bm - 1, 0) // bm
        for c in range(_cdiv(N0, BN) if rt else 0):
            for r in range(rt):
                r0 = lo + r * bm
                out.append(Item(0, e, r0, min(r0 + bm, hi), c * BN))
    rt1 = _cdiv(rows1, bm) if rows1 > 0 else 0
    for c in range(_cdiv(N1, BN) if rt1 else 0):
        for r in range(rt1):
            out.append(Item(1, 0, r * bm, min(r * bm + bm, rows1), c * BN))
    return out


def items_per_block(n_items: int, grid: int) -> List[int]:
    """Items each block runs (item ``i`` on block ``i % grid``)."""
    return [len(range(b, n_items, grid)) for b in range(grid)]
