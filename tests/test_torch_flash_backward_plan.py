"""The wgmma flash backward's walks (``kernels/flash_attention/plan.py``),
on the CPU: every attended (query row, key) pair of every query head is
covered exactly once by the dK/dV kernel's walk and once by the dQ
kernel's, no tile a warpgroup multiplies lacks an attended pair, every
streamed tile holds a pair for some warpgroup, the dQ blocks take the
longest rows first, and each design's shared memory fits a block."""

from __future__ import annotations

import numpy as np
import pytest

from repro_torch.kernels.flash_attention.plan import (HEAD_DIMS, SMEM_LIMIT, TILE, dkdv_walk,
                                                      dq_walk, plan, smem_bytes)

# (S, window, G): S on and off the tile; windows shorter than, equal to and
# longer than S
CASES = [
    (1, None, 1),
    (63, None, 2),
    (64, 64, 1),
    (65, None, 5),
    (130, 8, 10),
    (200, 200, 2),
    (333, 2048, 5),
    (333, 100, 1),
    (700, None, 10),
    (700, 64, 2),
    (1000, 129, 1),
    (257, 1, 5),
]


def mask(S, window):
    i = np.arange(S)[:, None]
    j = np.arange(S)[None, :]
    m = j <= i
    if window:
        m &= i - j < window
    return m


def ids(case):
    S, window, G = case
    return f"S{S}-w{window}-G{G}"


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("case", CASES, ids=ids)
def test_dkdv_walk_covers_every_pair_once(case, D):
    S, window, G = case
    m = mask(S, window)
    p = plan(D)
    cover = np.zeros((G, S, S), np.int32)
    for blk in dkdv_walk(S, G, D, window):
        assert blk.walk, "a block with no item"
        keys = slice(blk.start, min(blk.start + p.kv_rows, S))
        for q0, _ in blk.walk[::G]:
            assert m[q0:q0 + TILE, keys].any(), f"streamed tile q0={q0} holds no pair"
        owners = blk.live[:1] if p.split_columns else blk.live
        if p.split_columns:
            assert blk.live[0][1:] == blk.live[1][1:], "the column halves walk apart"
        for j0, a, z in owners:
            rows = slice(j0, min(j0 + TILE, S))
            for n in range(len(blk.walk)):
                q0, g = blk.walk[n]
                tile = m[q0:q0 + TILE, rows]
                if a <= n < z:
                    assert tile.any(), f"warpgroup rows {j0} multiply an empty item {n}"
                    cover[g, q0:q0 + TILE, rows] += tile
                else:
                    assert not tile.any(), f"warpgroup rows {j0} skip pairs of item {n}"
    assert np.array_equal(cover, np.broadcast_to(m, cover.shape).astype(np.int32))


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("case", CASES, ids=ids)
def test_dq_walk_covers_every_pair_once(case, D):
    S, window, _ = case
    m = mask(S, window)
    p = plan(D)
    cover = np.zeros((S, S), np.int32)
    blocks = dq_walk(S, D, window)
    starts = [blk.start for blk in blocks]
    assert starts == sorted(starts, reverse=True), "the longest rows do not go first"
    assert starts == list(range(0, S, p.q_rows))[::-1]
    for blk in blocks:
        rows_blk = slice(blk.start, min(blk.start + p.q_rows, S))
        for k0, _ in blk.walk:
            assert m[rows_blk, k0:k0 + TILE].any(), f"streamed kv tile {k0} holds no pair"
        for w0, a, z in blk.live:
            rows = slice(w0, min(w0 + TILE, S))
            for n, (k0, _) in enumerate(blk.walk):
                tile = m[rows, k0:k0 + TILE]
                if a <= n < z:
                    assert tile.any(), f"warpgroup rows {w0} multiply an empty tile {n}"
                    cover[rows, k0:k0 + TILE] += tile
                else:
                    assert not tile.any(), f"warpgroup rows {w0} skip pairs of tile {n}"
    assert np.array_equal(cover, m.astype(np.int32))


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_plan_fits_a_block(D):
    p = plan(D)
    kv, q = smem_bytes(D)
    assert kv <= SMEM_LIMIT and q <= SMEM_LIMIT
    # a consumer warpgroup's fp32 accumulators: dK and dV of 64 rows over
    # its columns, dQ of 64 rows over D, each within 240 registers a thread
    cols = D // 2 if p.split_columns else D
    assert 2 * (64 * cols) // 128 <= 128 and (64 * D) // 128 <= 128
    with pytest.raises(ValueError):
        plan(96)
