"""The MoE backward's grouped products' schedules: tile height, ring depth, grid and work items.

Plain Python, modelling ``kernels/csrc/moe_backward.cu`` (``dg_plan``,
``dg_item``, ``wg_plan`` and ``wg_item``) for the CPU tests and
``chip_smoke.py``'s printed schedules; the kernels compute the same maps on
the device, where the offsets live, and the library reports the plan it
makes (``kernel.data_grad_plan``, ``kernel.weight_grad_plan``), which
``chip_smoke.py`` holds against this model.

Both launches are persistent grids of at most one block an SM; item ``i``
runs on block ``i % grid``.

* The data gradient walks the forward's item map, :func:`.plan.items`:
  (expert, row tile of ``BM`` rows, 128 output columns), group 0's experts
  in order, each its column tiles with the row tiles innermost, then the
  shared expert as group 1.  ``BM`` is 128 (two consumer warpgroups) where
  group 0's segments average 128 rows or more, else 64.  Beside the ring
  it holds the epilogue's tiles: the staged dh, and SwiGLU's a and b or
  GELU's a.
* The weight gradient walks a static list of (job, expert, 128 rows of M,
  256 columns of N): jobs in the order given, experts in order, the M tiles,
  the N tiles innermost.  Each item walks its segment's rows ``[lo, hi)``
  from ``lo`` in stages of ``BK`` rows, in order; in the last stage the rows
  at or past ``hi`` (the next expert's, or zeros past the tensor) are
  cleared before the products read them (:func:`weight_grad_stages`).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

from .plan import BK, BN, H100_SMS, MAX_STAGES, SMEM_LIMIT, WG_ROWS

BOX = BK * 64 * 2                    # one TMA box: 64 rows x 64 columns of bf16
MAX_EXPERTS = 256
MAX_JOBS = 6
TALL_STAGES = 6                      # the data gradient's ring on 128-row tiles
WG_BN = 256                          # the weight gradient's output columns per item
WG_STAGE = 6 * BOX                   # its stage: A's 128 columns and B's 256
WG_OUT = 8 * BOX                     # its two consumer warpgroups' staged 64 x 256 output tiles


class DataGradPlan(NamedTuple):
    bm: int               # rows per tile
    stages: int           # ring depth
    smem: int             # dynamic shared memory bytes
    grid: int             # blocks
    max_items: int        # the item bound the grid was sized from


class WeightGradPlan(NamedTuple):
    stages: int           # ring depth
    smem: int             # dynamic shared memory bytes
    grid: int             # blocks
    items: int            # work items


class WeightItem(NamedTuple):
    job: int
    expert: int
    m0: int               # rows [m0, m0 + BN) of the job's out[expert] (M)
    n0: int               # columns [n0, n0 + WG_BN) (N)
    lo: int               # the segment's rows [lo, hi) of a and b (K)
    hi: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def data_grad_stage_bytes(bm: int) -> int:
    """One ring stage: the A tile (bm rows x 64 k) and a weight tile (128 n x 64 k)."""
    return bm * BK * 2 + BN * BK * 2


def pre_tiles(epi: str) -> int:
    """BM x 128 pre-activation tiles the data gradient's epilogue reads
    from shared memory: SwiGLU a and b, GELU a, plain none."""
    return {"swiglu": 2, "gelu": 1, "plain": 0}[epi]


def data_grad_table_bytes(stages: int, n_exp: int) -> int:
    """The ring's barriers, the epilogue's four, the clamped offsets and
    the experts' first items."""
    return (stages + 2) * 16 + 2 * (n_exp + 1) * 4


def data_grad_plan(epi: str, rows0: int, n_exp: int, N0: int, rows1: int = 0, N1: int = 0,
                   n_sms: int = H100_SMS) -> DataGradPlan:
    """The plan ``moe_data_grad_launch`` makes for epilogue ``epi``
    (``moe_data_grad_plan`` in the library reports the card's own)."""
    bm = 2 * WG_ROWS if rows0 >= 2 * WG_ROWS * n_exp else WG_ROWS
    epi_bytes = (pre_tiles(epi) + 1) * bm * BN * 2      # the pre-activations and staged dh
    free = SMEM_LIMIT - 1024 - epi_bytes - data_grad_table_bytes(MAX_STAGES, n_exp)
    stages = min(TALL_STAGES if bm > WG_ROWS else MAX_STAGES, free // data_grad_stage_bytes(bm))
    smem = (1024 + stages * data_grad_stage_bytes(bm) + epi_bytes +
            data_grad_table_bytes(stages, n_exp))
    max_items = (rows0 // bm + n_exp) * _cdiv(N0, BN)
    if rows1 > 0:
        max_items += _cdiv(rows1, bm) * _cdiv(N1, BN)
    return DataGradPlan(bm, stages, smem, min(max_items, n_sms), max_items)


def weight_grad_plan(dims: Sequence[Tuple[int, int, int, int]],
                     n_sms: int = H100_SMS) -> WeightGradPlan:
    """The plan ``moe_weight_grad_launch`` makes for jobs of ``(rows,
    n_exp, M, N)`` (``moe_weight_grad_plan`` reports the card's own)."""
    stages = min(MAX_STAGES, (SMEM_LIMIT - 1024 - WG_OUT - MAX_STAGES * 16) // WG_STAGE)
    smem = 1024 + stages * WG_STAGE + WG_OUT + stages * 16
    items = sum(n_exp * _cdiv(M, BN) * _cdiv(N, WG_BN) for _, n_exp, M, N in dims)
    return WeightGradPlan(stages, smem, min(items, n_sms), items)


def weight_grad_items(jobs: Sequence[Tuple[int, int, int, Optional[Sequence[int]]]]
                      ) -> List[WeightItem]:
    """Every work item of a weight-gradient launch, in the kernel's order;
    ``jobs`` are ``(rows, M, N, offsets or None)``, offsets clamped to
    ``[0, rows]`` as the kernel clamps them."""
    out = []
    for jb, (rows, M, N, offsets) in enumerate(jobs):
        bounds = [0, rows] if offsets is None else [int(o) for o in offsets]
        for e in range(len(bounds) - 1):
            lo = min(max(bounds[e], 0), rows)
            hi = min(max(bounds[e + 1], lo), rows)
            for mt in range(_cdiv(M, BN)):
                for nt in range(_cdiv(N, WG_BN)):
                    out.append(WeightItem(jb, e, mt * BN, nt * WG_BN, lo, hi))
    return out


def weight_grad_stages(lo: int, hi: int) -> List[Tuple[int, int]]:
    """An item's stages in order: (first row, rows of the segment in it);
    the stage holds ``BK`` rows from its first, those past the count
    cleared."""
    return [(r, min(BK, hi - r)) for r in range(lo, hi, BK)]
