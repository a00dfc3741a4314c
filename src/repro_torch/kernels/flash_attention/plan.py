"""The wgmma flash backward's tiles and walks, in plain Python.

A model of the two kernels of ``kernels/csrc/flash_attention.cu``'s
namespace ``wg`` (bf16 at D = 64, 128, 256) for the CPU tests, which hold
that every attended (query row, key) pair is covered exactly once by each
kernel's walk and that no tile a warpgroup multiplies lacks an attended
pair.  ``chip_smoke.py`` holds :func:`plan` against the built library's
``flash_attention_backward_plan`` (``kernel.library_plan``).

* dQ (launched first): one block per (q tile of ``q_rows`` rows, head,
  batch row), blocks in the grid's order taking the longest rows first.
  Consumer warpgroup ``w`` owns rows ``[q0 + 64 w, q0 + 64 w + 64)``.  The
  block streams the kv tiles of ``kv_tile`` rows holding a key some of its
  rows attend; a warpgroup multiplies the contiguous run of them that
  holds one of its own pairs and only waits for and releases the others.
* dK/dV: one block per (kv tile of ``kv_rows`` rows, kv head, batch row).
  Its items are (q tile of ``q_tile`` rows, query head of the group), the
  heads innermost, over the q tiles holding a row that attends one of its
  keys.  At D <= 128 warpgroup ``w`` owns kv rows ``[k0 + 64 w, k0 + 64 w
  + 64)``; at D = 256 (``split_columns``) both own the block's 64 rows and
  128 columns each, so they walk the same items.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

TILE = 64                 # q rows of a dK/dV item, kv rows of a dQ step, rows of a warpgroup
SMEM_LIMIT = 232448       # dynamic shared memory a block may use on the H100
HEAD_DIMS = (64, 128, 256)


class Plan(NamedTuple):
    kv_rows: int          # kv rows of a dK/dV block
    q_tile: int           # q rows of one of its items
    split_columns: int    # 1: its two warpgroups split D over the same rows
    q_rows: int           # q rows of a dQ block
    kv_tile: int          # kv rows of one of its steps
    kv_stages: int        # the dK/dV ring's depth
    q_stages: int         # the dQ ring's depth


def plan(head_dim: int) -> Plan:
    """The tiles at this head dim (``wg::Cfg<D>``)."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"the wgmma backward takes D in {HEAD_DIMS}, got {head_dim}")
    split = head_dim > 128
    kv_stages = {64: 6, 128: 3, 256: 2}[head_dim]
    q_stages = {64: 6, 128: 5, 256: 2}[head_dim]
    return Plan(kv_rows=64 if split else 128, q_tile=TILE, split_columns=int(split),
                q_rows=64 if split else 128, kv_tile=TILE, kv_stages=kv_stages,
                q_stages=q_stages)


def smem_bytes(head_dim: int) -> Tuple[int, int]:
    """(dK/dV, dQ) dynamic shared memory of a block: 1024 for alignment, the
    stationary tiles, the ring (and the dK/dV ring's lse and delta rows),
    the D = 256 hand-over buffers, the barriers."""
    p = plan(head_dim)
    tile = TILE * head_dim * 2
    handover = (TILE * TILE * 4 + 128 * 16 * 4) if p.split_columns else 0
    kv = (1024 + 2 * p.kv_rows * head_dim * 2 + p.kv_stages * 2 * tile
          + p.kv_stages * TILE * 8 + handover + (2 * p.kv_stages + 1) * 8)
    q = (1024 + 2 * p.q_rows * head_dim * 2 + p.q_stages * 2 * tile + p.q_rows * 4
         + (2 * p.q_stages + 1) * 8)
    return kv, q


class Block(NamedTuple):
    start: int                            # first row the block owns (k0 or q0)
    walk: List[Tuple[int, int]]           # (first row of the streamed tile, head in group)
    live: List[Tuple[int, int, int]]      # per warpgroup: (first row it owns, a, z)


def dkdv_walk(S: int, G: int, head_dim: int, window: Optional[int]) -> List[Block]:
    """The dK/dV blocks of one (kv head, batch row): each block's items
    (q0, g) and, per consumer warpgroup, the items [a, z) it multiplies."""
    p = plan(head_dim)
    w = window or 0
    blocks = []
    for k0 in range(0, S, p.kv_rows):
        k_hi = min(k0 + p.kv_rows, S) - 1
        q_last = min(S - 1, k_hi + w - 1) if w > 0 else S - 1
        qt_lo = k0 // TILE
        n_items = (q_last // TILE + 1 - qt_lo) * G
        walk = [((qt_lo + n // G) * TILE, n % G) for n in range(n_items)]
        live = []
        for cwg in range(2):
            j0 = k0 + TILE * (0 if p.split_columns else cwg)
            a = z = 0
            if j0 < S:
                j_hi = min(j0 + TILE - 1, S - 1)
                top = min(S - 1, j_hi + w - 1) if w > 0 else S - 1
                a = (max(j0 // TILE, qt_lo) - qt_lo) * G
                z = min((top // TILE + 1 - qt_lo) * G, n_items)
            live.append((j0, a, max(a, z)))
        blocks.append(Block(k0, walk, live))
    return blocks


def dq_walk(S: int, head_dim: int, window: Optional[int]) -> List[Block]:
    """The dQ blocks of one (head, batch row) in the grid's order (longest
    rows first): each block's kv tiles (k0, 0) and, per consumer warpgroup,
    the tiles [a, z) it multiplies."""
    p = plan(head_dim)
    w = window or 0
    n_blocks = -(-S // p.q_rows)
    blocks = []
    for x in range(n_blocks):
        q0 = (n_blocks - 1 - x) * p.q_rows
        q_hi = min(q0 + p.q_rows, S) - 1
        kt_lo = (max(0, q0 - w + 1) if w > 0 else 0) // TILE
        n_tiles = q_hi // TILE + 1 - kt_lo
        walk = [((kt_lo + n) * TILE, 0) for n in range(n_tiles)]
        live = []
        for cwg in range(p.q_rows // TILE):
            w0 = q0 + TILE * cwg
            a = z = 0
            if w0 < S:
                i_hi = min(w0 + TILE - 1, S - 1)
                lo = max(0, w0 - w + 1) if w > 0 else 0
                a = max(lo // TILE - kt_lo, 0)
                z = min(i_hi // TILE + 1 - kt_lo, n_tiles)
            live.append((w0, a, max(a, z)))
        blocks.append(Block(q0, walk, live))
    return blocks


def attends(i: int, j: int, S: int, window: Optional[int]) -> bool:
    """Query row i attends key j: causal, within the window, both in range."""
    return 0 <= j <= i < S and (not window or i - j < window)
