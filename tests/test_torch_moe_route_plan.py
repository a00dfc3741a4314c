"""The routing kernels' shapes (``kernels/moe_experts/route_plan.py``), on the CPU.

``moe_route`` sums each logit over 32 slices of D in slice order, each
slice an FMA chain in d order; ``moe_route_backward`` takes two launches
over a workspace of dlogits and split partials.  The CUDA sources compute
their grids from (T, D, E, k) and the SM count alone; the model mirrors
them.  These tests hold that the slice partition depends on D alone (so a
logit is the same sum whatever T and the grid are: the route is
row-invariant), that the grids cover every token, slice and column once,
that every shape the wrappers accept fits the H100's 227 KB of shared
memory a block, that the workspace formulas hold, and (``gpu``) that the
library's own plans equal the model.
"""

from __future__ import annotations

import re

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.moe_experts import route_plan as wrapper_plan
from repro_torch.kernels.moe_experts import route_backward_plan as wrapper_backward_plan
from repro_torch.kernels.moe_experts.route_plan import (COUNTERS, SLICES, WARPS,
                                                        accepts, backward_library_fields,
                                                        fits, library_fields,
                                                        route_backward_shape, route_shape,
                                                        slice_bounds, slice_width)
from repro_torch.kernels.moe_experts.plan import H100_SMS, SMEM_LIMIT

TS = [1, 2, 7, 8, 37, 64, 256, 300, 1000, 4095, 4096, 8192, 65536]
DS = [2, 64, 1030, 1536, 2048, 4096]
ES = [1, 4, 6, 8, 40, 64, 100, 128]
# (T, D, E, k): moonshot's decode, chunk, ring prefill and training
# microstep, and the chip run's other cases
LIBRARY_CASES = [(1, 2048, 64, 6), (8, 2048, 64, 6), (256, 2048, 64, 6), (4096, 2048, 64, 6),
                 (8192, 2048, 64, 6), (37, 4096, 128, 8), (300, 2048, 64, 6),
                 (4095, 1536, 40, 5), (50, 1030, 6, 2), (2048, 1030, 40, 5), (2, 64, 4, 2),
                 (13, 128, 16, 4)]


def ks_of(E):
    return sorted({1, min(E, 6), min(E, 32)})


@pytest.mark.parametrize("D", DS)
def test_slice_partition_depends_on_d_alone(D):
    """The 32 slices tile [0, D) in order, even widths, and every plan over
    any T, E, k and SM count uses the width of D alone."""
    bounds = slice_bounds(D)
    assert len(bounds) == SLICES and bounds[0][0] == 0 and bounds[-1][1] == D
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all(lo <= hi for lo, hi in bounds) and slice_width(D) % 2 == 0
    for T in TS:
        for E in (6, 64, 128):
            for sms in (H100_SMS, 16, 200):
                assert route_shape(T, D, E, min(E, 6), sms).slice == slice_width(D)


@pytest.mark.parametrize("E", ES)
def test_every_accepted_shape_fits_and_covers(E):
    """Every (T, D, E, k) the wrappers take: shared memory within 227 KB a
    block for the routing launch (with its static arrays), the sort launch
    and both backward launches; tiles cover T, slice warps x token warps =
    8, rounds x slice warps x groups = 32, a stage's d values cover a slice,
    TMA only for rows of 16-byte multiples and boxes it takes, and a split
    grid within the SMs and the tile counters."""
    for T in TS:
        for D in DS:
            for k in ks_of(E):
                assert accepts(T, D, E, k)
                s = route_shape(T, D, E, k)
                assert fits(T, D, E, k), (T, D, E, k, s.smem)
                assert s.smem <= SMEM_LIMIT and (s.tiles - 1) * s.tt < T <= s.tiles * s.tt
                assert s.ws * s.wt == WARPS and s.rounds * s.ws * s.groups == SLICES
                assert s.ep % 8 == 0 and E <= s.ep < max(16, 2 * E)
                assert s.ks % 2 == 0 and s.subs * s.ks >= s.slice
                assert s.stage_bytes % 128 == 0 and s.x_box % 128 == 0
                if s.tma:
                    assert D % 8 == 0 and E % 4 == 0 and s.ks % 8 == 0 and s.tt <= 256
                if s.groups > 1:
                    assert s.tiles * s.groups <= H100_SMS and s.tiles < COUNTERS - 1
                    assert s.tm == 2
                assert (s.sort_blocks == 0) == (s.tiles == 1)
                if s.sort_blocks:
                    assert (s.sort_blocks - 1) * s.sort_chunk < s.tiles
                    assert s.sort_blocks * s.sort_chunk >= s.tiles
                b = route_backward_shape(T, D, E)
                assert b.splits * b.split >= T > (b.splits - 1) * b.split
                assert b.split % 32 == 0 and b.splits <= 8
                assert b.threads <= 256 and b.dt <= 256 and b.d_tiles * b.dt >= D
                assert b.chunks * b.dc >= D and b.token_tiles * 64 >= T
                assert b.d_tiles <= COUNTERS
    assert not accepts(1, 3, E, 1) and not accepts(1, 8192, E, 1)


@pytest.mark.parametrize("T,D,E,k", LIBRARY_CASES)
def test_workspace_formulas(T, D, E, k):
    """The routing workspace: each slice's partial sums (32, tiles tt, ep)
    fp32 when a tile's slices split over blocks, then the tile counts
    (tiles, E) int32.  The backward's: the dlogits (T, E) fp32, padded to 16
    bytes, then the splits' partials (splits, D, E) fp32."""
    s = route_shape(T, D, E, k)
    part = 32 * s.tiles * s.tt * s.ep if s.groups > 1 else 0
    assert s.part_floats == part and s.workspace == 4 * part + 4 * s.tiles * E
    b = route_backward_shape(T, D, E)
    dl = -(-T * E // 4) * 4
    assert b.dl_floats == dl and b.dl_floats * 4 % 16 == 0
    assert b.workspace == 4 * dl + (4 * b.splits * D * E if b.splits > 1 else 0)


def test_moonshot_plans():
    """moonshot's shapes on the H100: decode splits 32 slices over 32 blocks
    of one tile; the chunk 8 groups of 16 tiles; the prefill and the training
    microstep 8 tokens a thread in tiles of 32, one group, two TMA stages of
    32 d a slice and a sort launch; the backward at T = 8192 in 8 splits of
    1024 tokens."""
    dec = route_shape(8, 2048, 64, 6)
    assert (dec.tm, dec.groups, dec.tiles, dec.stages, dec.sort_blocks, dec.tma) == \
        (2, 32, 1, 3, 0, True)
    chunk = route_shape(256, 2048, 64, 6)
    assert (chunk.groups, chunk.tiles, chunk.tt) == (8, 16, 16)
    for T in (4096, 8192):
        s = route_shape(T, 2048, 64, 6)
        assert (s.tm, s.groups, s.tt, s.tiles, s.stages, s.ks, s.tma) == \
            (8, 1, 32, T // 32, 2, 32, True)
        assert s.sort_blocks == T // 32
    b = route_backward_shape(8192, 2048, 64)
    assert (b.token_tiles, b.dc, b.splits, b.split, b.d_tiles, b.threads) == \
        (128, 256, 8, 1024, 16, 256)


def test_constants_match_the_sources():
    """The model's constants are the CUDA sources' own."""
    fwd = (build.CSRC / "moe_experts.cu").read_text()
    bwd = (build.CSRC / "moe_backward.cu").read_text()
    for name, value in (("kRouteSlices", 32), ("kRouteThreads", 256), ("kRouteStages", 3),
                        ("kRouteSortBlocks", 256), ("kRouteCounters", 256),
                        ("kRouteMaxE", 128), ("kRouteMaxK", 32), ("kRouteMaxD", 4096)):
        assert re.search(rf"constexpr int {name} = {value};", fwd), name
    assert "constexpr int kRouteStageCap = 32 * 1024;" in fwd
    assert "constexpr int kRouteSortTable = 160 * 1024;" in fwd
    for name, value in (("kRbTokens", 64), ("kRbStages", 2), ("kRbBatch", 4),
                        ("kRbWThreads", 128), ("kRbMaxDt", 256), ("kRbWTokens", 32),
                        ("kRbWStages", 4), ("kRbMaxSplits", 8), ("kRbSplitTokens", 1024)):
        assert re.search(rf"constexpr int {name} = {value};", bwd), name


@pytest.mark.gpu
def test_library_plans_equal_the_model():
    """On the card: ``moe_route_plan`` and ``moe_route_backward_plan`` report
    the model's shapes for this device's SM count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the plans come from the built library")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for T, D, E, k in LIBRARY_CASES:
        assert tuple(wrapper_plan(T, D, E, k)) == library_fields(route_shape(T, D, E, k, sms))
        assert tuple(wrapper_backward_plan(T, D, E, k)) == \
            backward_library_fields(route_backward_shape(T, D, E))
