"""The MoE backward's grouped products' schedules (``moe_experts/backward_plan.py``), on the CPU.

The CUDA kernels (``kernels/csrc/moe_backward.cu``) walk the same maps on
the device.  These tests hold the mirror: every output tile of both
launches is covered by exactly one work item, in the stated order; the
grids come from shapes alone; each weight-gradient item walks its
segment's rows from ``lo`` in order; and an fp32 emulation of that walk,
with the rows past a segment's end cleared, gives the plain
``moe_weight_grad_plain`` result within its bound even where the
neighbouring expert's rows hold NaN and Inf (and does not without the
clearing).  The constants are held against the kernel's source.

Tolerance: ``GROUPED_TOL`` (4 bf16 steps, 4 x 2^-8, of the largest
|element|), the grouped products' bound on the card: the emulation and
the plain version sum each element's fp32 terms in other orders, and the
one bf16 rounding may fall the other way.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.moe_experts import backward_plan as bp
from repro_torch.kernels.moe_experts import plan, ref

GROUPED_TOL = 4 * 2.0 ** -8

# (label, segment lengths of the routed experts, shared rows, N0, N1)
DATA_CASES = [
    ("an empty expert and a one-row expert", [0, 1, 37, 0, 200, 5], 0, 136, 0),
    ("segments not a multiple of 16", [15, 17, 33, 130, 1, 63], 0, 40, 0),
    ("the shared group", [0, 1, 90, 300], 64, 48, 96),
    ("only the shared group", [0, 0, 0, 0], 9, 176, 352),
    ("long segments: 128-row tiles", [500, 700, 129, 800], 300, 264, 520),
    ("moonshot down, uniform routing", "random:2048", 2048, 1408, 2816),
]

# (label, jobs as (segment lengths or None for one segment of `rows`, rows, M, N))
WEIGHT_CASES = [
    ("an empty expert and a one-row expert", [([0, 1, 70, 13, 64, 129], 277, 136, 40)]),
    ("segments not a multiple of 16", [([15, 17, 33, 130, 1, 63], 259, 64, 48)]),
    ("the shared jobs first", [(None, 41, 96, 64), (None, 41, 64, 176),
                               ([0, 1, 40, 0], 41, 176, 64), ([0, 1, 40, 0], 41, 64, 96)]),
    ("six jobs, no rows", [(None, 0, 8, 8)] * 3 + [([0, 0, 0], 0, 16, 24)] * 3),
]


def segment_lengths(spec, seed: int = 0):
    """A list as given, or ``random:T``: T tokens routed top-6 over 64
    experts uniformly (k distinct experts per token)."""
    if not isinstance(spec, str):
        return list(spec)
    T = int(spec.split(":")[1])
    rng = np.random.default_rng(seed)
    experts = np.argsort(rng.random((T, 64)), axis=1)[:, :6]
    return np.bincount(experts.reshape(-1), minlength=64).tolist()


def offsets_of(lens):
    return [0, *np.cumsum(lens).tolist()]


def weight_jobs(spec):
    """``(rows, M, N, offsets or None)`` for :func:`.backward_plan.weight_grad_items`."""
    return [(rows, M, N, None if lens is None else offsets_of(lens)) for lens, rows, M, N in spec]


@pytest.mark.parametrize("epi", ref.MODES)
@pytest.mark.parametrize("label,lens,rows1,N0,N1", DATA_CASES, ids=[c[0] for c in DATA_CASES])
def test_data_grad_items_cover_every_output_once_in_order(label, lens, rows1, N0, N1, epi):
    """Every (row, column) of both groups' outputs in exactly one item;
    group 0's experts in order, each its column tiles with the row tiles
    innermost, then group 1; the grid, from shapes alone, holds them."""
    lens = segment_lengths(lens)
    offs = offsets_of(lens)
    P, E = offs[-1], len(lens)
    pl = bp.data_grad_plan(epi, P, E, N0, rows1, N1)
    bm = pl.bm
    assert bm == (128 if P >= 128 * E else 64)
    items = plan.items(offs, P, N0, rows1, N1, bm=bm)
    cover0 = np.zeros((P, N0), np.uint8)
    cover1 = np.zeros((rows1, N1), np.uint8)
    for it in items:
        assert it.r0 < it.r1 <= it.r0 + bm and it.n0 % bp.BN == 0
        lo = offs[it.expert] if it.group == 0 else 0
        hi = offs[it.expert + 1] if it.group == 0 else rows1
        assert lo <= it.r0 and it.r1 <= hi and (it.r0 - lo) % bm == 0
        (cover0 if it.group == 0 else cover1)[it.r0:it.r1, it.n0:it.n0 + bp.BN] += 1
    assert (cover0 == 1).all() and (cover1 == 1).all()
    keys = [(it.group, it.expert, it.n0, it.r0) for it in items]
    assert keys == sorted(keys)
    assert len(items) <= pl.max_items and 1 <= pl.grid <= min(plan.H100_SMS, pl.max_items)
    per = plan.items_per_block(len(items), pl.grid)
    assert sum(per) == len(items) and max(per) - min(per) <= 1


@pytest.mark.parametrize("label,spec", WEIGHT_CASES, ids=[c[0] for c in WEIGHT_CASES])
def test_weight_grad_items_cover_every_tile_once_in_order(label, spec):
    """Every (job, expert, M tile, N tile) in exactly one item, jobs in the
    order given, experts in order, the N tiles innermost; each item's rows
    are its expert's clamped segment, walked from lo in stages of 64 rows,
    in order, the last one partly past hi at most."""
    jobs = weight_jobs(spec)
    items = bp.weight_grad_items(jobs)
    want = []
    for jb, (rows, M, N, offs) in enumerate(jobs):
        bounds = [0, rows] if offs is None else offs
        want += [(jb, e, m0, n0) for e in range(len(bounds) - 1)
                 for m0 in range(0, M, bp.BN) for n0 in range(0, N, bp.WG_BN)]
    assert [(it.job, it.expert, it.m0, it.n0) for it in items] == want
    pl = bp.weight_grad_plan([(rows, 1 if offs is None else len(offs) - 1, M, N)
                              for rows, M, N, offs in jobs])
    assert pl.items == len(items) and 1 <= pl.grid <= min(plan.H100_SMS, len(items))
    for it in items:
        rows, _, _, offs = jobs[it.job]
        lo, hi = (0, rows) if offs is None else (offs[it.expert], offs[it.expert + 1])
        assert (it.lo, it.hi) == (lo, hi)
        stages = bp.weight_grad_stages(it.lo, it.hi)
        assert [r for r, _ in stages] == list(range(lo, hi, bp.BK))
        assert sum(v for _, v in stages) == hi - lo
        assert all(v == bp.BK for _, v in stages[:-1]) and all(0 < v <= bp.BK for _, v in stages)


@pytest.mark.parametrize("epi", ref.MODES)
def test_grids_and_plans_depend_on_shapes_only(epi):
    """Two routings of the same shapes give the same plan (a launch is
    capturable), and each routing's items fit the grid's bound; the ring
    is as deep as 227 KiB allows beside the epilogue's tiles, at most 8
    stages, 6 on 128-row tiles."""
    plans = set()
    for seed in range(4):
        lens = segment_lengths("random:512", seed)
        offs = offsets_of(lens)
        pl = bp.data_grad_plan(epi, offs[-1], 64, 1408, 512, 2816)
        plans.add(pl)
        assert len(plan.items(offs, offs[-1], 1408, 512, 2816, bm=pl.bm)) <= pl.max_items
    assert len(plans) == 1
    for rows0, n_exp in ((48, 64), (8191, 64), (8192, 64), (49152, 64), (3, 256)):
        pl = bp.data_grad_plan(epi, rows0, n_exp, 1408, 8, 2816)
        stage = bp.data_grad_stage_bytes(pl.bm)
        assert pl.smem <= plan.SMEM_LIMIT and pl.stages >= 2
        cap = bp.TALL_STAGES if pl.bm == 128 else bp.MAX_STAGES
        assert pl.stages == cap or pl.smem + stage > plan.SMEM_LIMIT
    wp = bp.weight_grad_plan([(49152, 64, 1408, 2048), (8192, 1, 2816, 2048)])
    assert wp.smem <= plan.SMEM_LIMIT and wp.smem + bp.WG_STAGE > plan.SMEM_LIMIT
    assert wp.grid == plan.H100_SMS and wp.items == 64 * 11 * 8 + 22 * 8


def emulate_weight_grad(a, b, offsets, clear: bool):
    """The kernel's stage walk in fp32 for one job: each item's segment
    from lo in 64-row stages (rows past the tensor read as zeros, as TMA
    fills them), with the rows at or past hi cleared (``clear``) or not,
    then one bf16 rounding."""
    rows, M = a.shape
    N = b.shape[1]
    E = offsets.shape[0] - 1
    pad = bp.BK
    az = torch.cat([a.float(), a.new_zeros(pad, M).float()])
    bz = torch.cat([b.float(), b.new_zeros(pad, N).float()])
    out = torch.zeros(E, M, N)
    items = bp.weight_grad_items([(rows, M, N, offsets.tolist())])
    for it in items:
        acc = torch.zeros(min(bp.BN, M - it.m0), min(bp.WG_BN, N - it.n0))
        for r, valid in bp.weight_grad_stages(it.lo, it.hi):
            sa = az[r:r + bp.BK, it.m0:it.m0 + bp.BN].clone()
            sb = bz[r:r + bp.BK, it.n0:it.n0 + bp.WG_BN].clone()
            if clear:
                sa[valid:] = 0
                sb[valid:] = 0
            acc += sa.t() @ sb
        out[it.expert, it.m0:it.m0 + bp.BN, it.n0:it.n0 + bp.WG_BN] = acc
    return out.to(a.dtype)


@pytest.mark.parametrize("neighbours", ["nan and inf", "1e4-scaled", "finite"])
def test_stage_walk_emulation_matches_plain_weight_grad(neighbours):
    """The stage walk with the tail rows cleared gives moe_weight_grad_plain
    within GROUPED_TOL on every expert whose own rows are finite, though
    every odd expert's rows hold NaN (a) and Inf (b), or are scaled by 1e4;
    without the clearing those experts' gradients differ."""
    rng = np.random.default_rng(7)
    lens = [0, 1, 70, 13, 64, 129, 5, 30, 17]
    offs = torch.tensor(offsets_of(lens), dtype=torch.int32)
    rows, M, N = offs[-1].item(), 136, 40
    a = torch.from_numpy(rng.standard_normal((rows, M))).to(torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((rows, N))).to(torch.bfloat16)
    odd = torch.zeros(rows, dtype=torch.bool)
    for e in range(1, len(lens), 2):
        odd[offs[e]:offs[e + 1]] = True
    if neighbours == "nan and inf":
        a[odd], b[odd] = float("nan"), float("inf")
    elif neighbours == "1e4-scaled":
        a[odd], b[odd] = a[odd] * 1e4, b[odd] * 1e4
    even = list(range(0, len(lens), 2))
    want = ref.moe_weight_grad_plain(a, b, offs)[even].float()
    got = emulate_weight_grad(a, b, offs, clear=True)[even].float()
    assert torch.isfinite(got).all()
    scale = want.abs().max()
    assert ((got - want).abs().max() <= GROUPED_TOL * scale).item()
    loose = emulate_weight_grad(a, b, offs, clear=False)[even].float()
    if neighbours == "finite":
        # the even experts' tails read the next expert's finite rows
        assert not torch.allclose(loose, want, rtol=0, atol=GROUPED_TOL * scale.item())
    else:
        bad = ~torch.isfinite(loose) | ((loose - want).abs() > GROUPED_TOL * scale)
        assert bad.any()


def test_mirror_matches_the_kernel_source():
    """The constants backward_plan.py mirrors, as moe_backward.cu states
    them."""
    src = (build.CSRC / "moe_backward.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (consts["kBN"], consts["kBK"], consts["kWgRows"], consts["kWgBN"], consts["kMaxStages"],
            consts["kTallStages"], consts["kMaxExperts"], consts["kMaxJobs"]) == (
        bp.BN, bp.BK, bp.WG_ROWS, bp.WG_BN, bp.MAX_STAGES, bp.TALL_STAGES, bp.MAX_EXPERTS,
        bp.MAX_JOBS)


def test_forward_callers_keep_their_transpose_bits():
    """moe_experts.cu calls the m64n128k16 wgmma without template arguments:
    TA = 0, TB = 1, the bits it always had (A K-major, B N-major)."""
    src = (build.CSRC / "moe_experts.cu").read_text()
    calls = re.findall(r"wgmma_m64n128k16_bf16(<[^>]*>)?\(", src)
    assert calls and all(c == "" for c in calls)
