"""The tensor-core SSD backward's plan, in plain Python.

A model of ``kernels/csrc/ssd_scan.cu``'s tensor-core backward (namespace
``bwd``: ``BwdTile``, ``PassTile``, ``tc_plan_n``) for the CPU tests, which
hold that every (P, N) the route takes fits one block's shared memory.
``chip_smoke.py`` holds :func:`plan` against the built library's
``ssd_scan_backward_plan`` (``kernel.library_plan``).

* The state passes: one block of 4 warps per (head, slab of ``pass_rows``
  state rows, batch row) and direction (``pass_grid[2]`` = 2: forwards from
  h0, backwards from dh_final), walking the chunks in turn with the slab in
  registers; two stages of a chunk's B or C, x or dy and dt.
* The chunk kernel: one block of 8 warps per (chunk, batch row), walking the
  heads in ascending order (``head_order``), each head's P in slabs of
  ``p_slab`` rows, two stages deep.  Per chunk it holds C, B and the W (then
  sum_h dG) tiles; per stage x, dy (chunk x slab), h_prev and dh as hi + lo
  (slab x N) and dt.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

SMEM_LIMIT = 232448       # dynamic shared memory a block may use on the H100
STATE_DIMS = (64, 128, 256)
CHUNK_WARPS = 8
PASS_WARPS = 4
HEAD_ORDER = "ascending"


class Plan(NamedTuple):
    chunk: int                          # tokens a chunk (Q)
    p_slab: int                         # rows of P a chunk-kernel unit stages
    pass_rows: int                      # state rows a pass block owns
    chunk_grid: Tuple[int, int, int]    # (chunks, batch rows, 1)
    chunk_threads: int
    chunk_smem: int
    pass_grid: Tuple[int, int, int]     # (heads x slabs, batch rows, 2 directions)
    pass_threads: int
    pass_smem: int
    head_order: str


def takes(P: int, N: int) -> bool:
    """The route's rule on the dims (bf16 inputs assumed): P a multiple of 16,
    N 64, 128 or 256."""
    return P >= 16 and P % 16 == 0 and N in STATE_DIMS


def chunk_len(N: int) -> int:
    """Q: 64 tokens, 32 at N = 256 (``BwdTile<N>::Q``)."""
    return 32 if N > 128 else 64


def p_slab(N: int) -> int:
    """Rows of P one unit stages: 64 at N = 64, else 32 (``BwdTile<N>::PS``)."""
    return 32 if N > 64 else 64


def pass_rows(P: int) -> int:
    return 32 if P % 32 == 0 else 16


def chunk_smem(N: int) -> int:
    """``BwdTile<N>::BYTES``: C, B, W hi + lo; two stages of x, dy, h_prev
    hi + lo, dh hi + lo and dt; cums, exp(cums), exp(cums_last - cums); the
    partial sums of rowR, colE, S, T and dh . h_prev.  bf16 rows padded by 8."""
    Q, PS = chunk_len(N), p_slab(N)
    mt = Q // 16
    wn = CHUNK_WARPS // mt
    qt = max(mt * mt // CHUNK_WARPS, 1)
    wq = (mt * mt // qt) // mt
    ldn, lds, ldq = N + 8, PS + 8, Q + 8
    fixed = 2 * Q * ldn * 2 + 2 * Q * ldq * 2
    stage = 2 * Q * lds * 2 + 4 * PS * ldn * 2 + Q * 4
    per_head = 3 * Q * 4 + (wq + mt + 2 * wn) * Q * 4 + CHUNK_WARPS * 4
    return fixed + 2 * stage + per_head


def pass_smem(N: int, rows: int) -> int:
    """``PassTile<N, rows>::BYTES``: two stages of B or C, x or dy and dt; U
    hi + lo; cums, coef; the chunk's decay."""
    Q = chunk_len(N)
    stage = Q * (N + 8) * 2 + Q * (rows + 8) * 2 + Q * 4
    return 2 * stage + 2 * rows * (Q + 8) * 2 + 2 * Q * 4 + 16


def plan(B: int, L: int, H: int, P: int, N: int) -> Plan:
    """The route's plan at these dims (``ssd_scan_backward_plan``)."""
    if not takes(P, N):
        raise ValueError(f"the tensor-core backward takes P a multiple of 16 and N in "
                         f"{STATE_DIMS}, got P={P}, N={N}")
    Q, rows = chunk_len(N), pass_rows(P)
    return Plan(chunk=Q, p_slab=p_slab(N), pass_rows=rows, chunk_grid=(-(-L // Q), B, 1),
                chunk_threads=32 * CHUNK_WARPS, chunk_smem=chunk_smem(N),
                pass_grid=(H * (P // rows), B, 2), pass_threads=32 * PASS_WARPS,
                pass_smem=pass_smem(N, rows), head_order=HEAD_ORDER)
