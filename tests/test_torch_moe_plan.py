"""The grouped expert kernel's schedule (``kernels/moe_experts/plan.py``), on the CPU.

The CUDA kernel walks the same item map on the device; these tests hold
the mirror: every routed row and every output column is covered by exactly
one work item, an item never crosses a segment, the grid sized from shapes
alone holds every item, and the constants match the kernel's source.  The
build's library hash covers the headers under ``csrc/``.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.moe_experts import moe_experts_kernel, plan
from repro_torch.kernels.moe_experts.kernel import ROUTES

# (label, segment lengths of the routed experts, shared rows, N0, N1)
CASES = [
    ("empty experts", [0, 5, 0, 0, 130, 0, 1, 0], 0, 96, 0),
    ("every pair on one expert", [0, 0, 300, 0], 50, 64, 128),
    ("P = 1", [0, 1, 0, 0], 0, 32, 0),
    ("P = 0 with a shared group", [0, 0, 0, 0], 7, 1408, 2816),
    ("segments not a multiple of the tile", [63, 64, 65, 127, 128, 129, 1, 200], 9, 136, 8),
    ("long segments: 128-row tiles", [500, 700, 129, 800], 300, 264, 520),
    ("moonshot decode, P = 48", "random:8", 8, 1408, 2816),
    ("moonshot chunk, P = 1536", "random:256", 256, 1408, 2816),
    ("moonshot ring prefill, P = 24576", "random:4096", 4096, 1408, 2816),
    ("moonshot down, P = 24576", "random:4096", 4096, 2048, 2048),
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


@pytest.mark.parametrize("label,lens,rows1,N0,N1", CASES, ids=[c[0] for c in CASES])
def test_items_cover_every_row_and_column_once(label, lens, rows1, N0, N1):
    lens = segment_lengths(lens)
    offs = offsets_of(lens)
    P, E = offs[-1], len(lens)
    pl = plan.make_plan("swiglu", P, E, N0, rows1, N1)
    bm = pl.bm
    assert bm == (128 if P >= 128 * E else 64)
    items = plan.items(offs, P, N0, rows1, N1, bm=bm)
    cover0 = np.zeros((P, N0), np.uint8)
    cover1 = np.zeros((rows1, N1), np.uint8)
    for it in items:
        assert it.r0 < it.r1 <= it.r0 + bm and it.n0 % plan.BN == 0
        if it.group == 0:
            # inside one expert's segment, starting on its tile grid
            assert offs[it.expert] <= it.r0 and it.r1 <= offs[it.expert + 1]
            assert (it.r0 - offs[it.expert]) % bm == 0 and it.n0 < N0
            cover0[it.r0:it.r1, it.n0:it.n0 + plan.BN] += 1
        else:
            assert it.expert == 0 and it.r0 % bm == 0 and it.n0 < N1
            cover1[it.r0:it.r1, it.n0:it.n0 + plan.BN] += 1
    assert (cover0 == 1).all() and (cover1 == 1).all()
    # the grid, from shapes alone, holds every item; item i on block i % grid
    assert len(items) <= pl.max_items
    assert 1 <= pl.grid <= plan.H100_SMS and pl.grid <= pl.max_items
    per = plan.items_per_block(len(items), pl.grid)
    assert sum(per) == len(items) and max(per) - min(per) <= 1
    # row tiles innermost: an expert's items walk one column tile at a time
    for e in range(E):
        cols = [it.n0 for it in items if it.group == 0 and it.expert == e]
        assert cols == sorted(cols)
    assert 2 <= pl.stages <= plan.MAX_STAGES and pl.smem <= plan.SMEM_LIMIT


@pytest.mark.parametrize("mode", plan.MODES)
@pytest.mark.parametrize("rows0,n_exp,want", [(48, 64, 64), (1536, 64, 64), (8191, 64, 64),
                                               (8192, 64, 128), (24576, 64, 128),
                                               (0, 4, 64), (1, 1, 64), (128, 1, 128)])
def test_route_and_ring_depth_from_shapes(mode, rows0, n_exp, want):
    """BM 128 exactly where group 0's segments average 128 rows or more;
    the ring as deep as 227 KiB of shared memory allows, at most 8 stages
    on 64-row tiles and 4 on 128-row tiles."""
    pl = plan.make_plan(mode, rows0, n_exp, 1408, 8, 2816)
    assert pl.bm == want and f"wgmma_bm{want}" in ROUTES
    stage = plan.stage_bytes(mode, pl.bm)
    assert pl.smem == 1024 + pl.stages * stage + plan.table_bytes(pl.stages, n_exp)
    cap = plan.MAX_STAGES if want == 64 else plan.TALL_STAGES
    assert pl.stages == cap or pl.smem + stage > plan.SMEM_LIMIT


def test_mirror_matches_the_kernel_source():
    """The constants plan.py mirrors, as the kernel's source states them."""
    src = (build.CSRC / "moe_experts.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (consts["kBN"], consts["kBK"], consts["kWgRows"], consts["kMaxStages"],
            consts["kTallStages"]) == (plan.BN, plan.BK, plan.WG_ROWS, plan.MAX_STAGES,
                                       plan.TALL_STAGES)
    assert "kSmemLimit = 227 * 1024" in src and plan.SMEM_LIMIT == 227 * 1024
    assert '#include "hopper.cuh"' in src and "hopper.cuh" in [p.name for p in build.headers()]
    assert "wgmma.mma_async" in (build.CSRC / "hopper.cuh").read_text()
    assert "mma.sync" not in src          # one instruction family for every row


def test_cpu_call_counts_no_route():
    x = torch.zeros(3, 16, dtype=torch.bfloat16)
    w = torch.zeros(2, 16, 8, dtype=torch.bfloat16)
    before = dict(moe_experts_kernel.launches_by_route)
    moe_experts_kernel("plain", x, torch.tensor([0, 1, 3], dtype=torch.int32), w)
    assert moe_experts_kernel.launches_by_route == before
    assert set(before) == set(ROUTES)


@pytest.mark.parametrize("edit", ["header", "source", "new header", "nothing"])
def test_library_hash_covers_headers(monkeypatch, tmp_path, edit):
    """An edited header under csrc/ renames (so rebuilds) every library;
    an unchanged tree keeps its name."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "common.cuh"\nint k() { return 1; }\n')
    (csrc / "common.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    before = build.library_path("k")
    assert build.sources() == ("k",) and [p.name for p in build.headers()] == ["common.cuh"]
    if edit == "header":
        (csrc / "common.cuh").write_text("#pragma once\n#define X 1\n")
    elif edit == "source":
        (csrc / "k.cu").write_text('#include "common.cuh"\nint k() { return 2; }\n')
    elif edit == "new header":
        (csrc / "other.h").write_text("int y;\n")
    after = build.library_path("k")
    assert after.parent == tmp_path / "build" and after.name.startswith("k.")
    assert (after == before) == (edit == "nothing")
