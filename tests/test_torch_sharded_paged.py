"""The paged decode kernel run per shard of a split pool, against the JAX
package's ``paged_attention``.

``sharded_paged_attention`` (the reference's shard_map decomposition,
``src/repro/kernels/paged_attention/ops.py``) runs the paged kernel once
per shard — over a lane slice of every page through ``lane_base`` and
``pos_stride``, or over a head slice — and merges the shards' softmax
states.  Its in-process form (the shards stacked in one process) is held
to the JAX ``paged_attention`` (the Pallas kernel in interpret mode, as
the JAX package's tests run it on the CPU) at the JAX kernel tests'
tolerances, fp32 2e-4 and bf16 3e-2, in append, post-update
(``include_new``) and windowed modes, with an unmapped slot and a slot
whose lanes leave most shards empty.  Its collective form, over 2 and 4
shards of spawned gloo ranks, is held to the in-process form at 1e-6, and the bytes
it sends do not grow with the pool; a chunk's attention over a split pool
(``kvcache.attend_cache``, plain torch) is held to the unsharded call.  On the CPU the kernel's plain version
runs; the card runs the CUDA kernel per shard in ``chip_smoke.py``.
"""

from __future__ import annotations

import functools
import inspect
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attention as jax_paged_attention
from repro_torch.kernels.paged_attention import (merge_shard_states, paged_attention,
                                                 paged_shard_partials, pool_shard,
                                                 sharded_paged_attention_local)

ROOT = Path(__file__).resolve().parents[1]
ATOL = {"float32": 2e-4, "bfloat16": 3e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
B, HKV, G, D, PS, MP, N_PAGES = 4, 4, 2, 16, 8, 6, 28


def sharded_inputs(seed: int):
    """numpy fp32 pool, scrambled tables with a hole; slot 0 unmapped (its
    length says 5), slot 1 holding 2 tokens (lanes 0-1 of its first page:
    every lane shard but the first is empty for it)."""
    rng = np.random.default_rng(seed)
    arrs = dict(q=rng.standard_normal((B, 1, HKV * G, D), np.float32),
                kp=rng.standard_normal((N_PAGES, PS, HKV, D), np.float32),
                vp=rng.standard_normal((N_PAGES, PS, HKV, D), np.float32),
                k_new=rng.standard_normal((B, 1, HKV, D), np.float32),
                v_new=rng.standard_normal((B, 1, HKV, D), np.float32))
    lengths = np.array([5, 2, 37, 46], np.int32)
    pt = np.full((B, MP), -1, np.int32)
    for b in range(1, B):
        need = -(-int(lengths[b]) // PS)
        pt[b, :need] = rng.choice(N_PAGES, size=need, replace=False)
    pt[2, 1] = -1
    return arrs, pt, lengths


CALLS = {"append": dict(), "window": dict(window=13), "include_new": dict(post=True)}


def _call(call, arrs, pt, lengths, dtype, fn, to):
    kw = dict(CALLS[call])
    post = kw.pop("post", False)
    x = {k: to(v, dtype) for k, v in arrs.items()}
    if post:        # the token is in the pool: lane ``pos`` attended, lengths pos + 1
        return fn(x["q"], x["kp"], x["vp"], to(pt, None), to(lengths + 1, None),
                  q_pos=to(lengths, None))
    return fn(x["q"], x["kp"], x["vp"], to(pt, None), to(lengths, None),
              k_new=x["k_new"], v_new=x["v_new"], **kw)


def _jax(v, dtype):
    return jnp.asarray(v, dtype) if dtype else jnp.asarray(v)


def _torch(v, dtype):
    return torch.from_numpy(v).to(TDT[dtype]) if dtype else torch.from_numpy(v)


@functools.lru_cache(maxsize=None)
def jax_want(dtype: str, call: str) -> np.ndarray:
    """The JAX ``paged_attention`` (interpret mode) on one call's inputs,
    shared by every decomposition of them."""
    arrs, pt, lengths = sharded_inputs(len(call))
    return np.asarray(_call(call, arrs, pt, lengths, dtype, jax_paged_attention, _jax),
                      np.float32)


@pytest.mark.parametrize("call", list(CALLS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,n", [("lane", 2), ("lane", 4), ("head", 2), ("head", 4)])
def test_decomposition_matches_jax(mode, n, dtype, call):
    arrs, pt, lengths = sharded_inputs(len(call))
    want = jax_want(dtype, call)
    got = _call(call, arrs, pt, lengths, dtype,
                lambda *a, **k: sharded_paged_attention_local(*a, n_shards=n, mode=mode, **k),
                _torch)
    whole = _call(call, arrs, pt, lengths, dtype, paged_attention, _torch)
    assert got.dtype == TDT[dtype] and got.shape == (B, 1, HKV * G, D)
    for out in (got, whole):
        np.testing.assert_allclose(out.float().numpy(), want, atol=ATOL[dtype],
                                   rtol=ATOL[dtype])
    if call == "include_new":
        assert not got[0].float().abs().any(), "an unmapped slot with no token attends nothing"


def test_shard_states_and_the_merge():
    """Each lane shard's state covers its lanes only (an empty shard is
    (0, -1e30, 0)); the merged lane states and the concatenated head states
    are the whole pool's up to fp32 order."""
    arrs, pt, lengths = sharded_inputs(3)
    t = {k: torch.from_numpy(v) for k, v in arrs.items()}
    qg = t["q"].reshape(B, HKV, G, D)
    pt_t, len_t = torch.from_numpy(pt), torch.from_numpy(lengths)
    from repro_torch.kernels.paged_attention import paged_attention_plain
    whole = paged_attention_plain(qg, t["kp"], t["vp"], pt_t, len_t, len_t)
    for mode, n in (("lane", 2), ("lane", 4), ("head", 4)):
        parts = [paged_shard_partials(qg, pool_shard(t["kp"], r, n, mode),
                                      pool_shard(t["vp"], r, n, mode), pt_t, len_t, len_t,
                                      shard=r, n_shards=n, mode=mode, page_size=PS)
                 for r in range(n)]
        if mode == "lane":
            for r in range(1, n):       # slot 1's two tokens sit in shard 0's lanes
                assert parts[r][1][1].eq(-1e30).all() and not parts[r][2][1].any()
        merged = merge_shard_states(*(torch.stack(x) for x in zip(*parts)), mode=mode)
        for got, want in zip(merged, whole):
            live = want > -1e29 if got.ndim == 3 else torch.ones_like(want, dtype=torch.bool)
            np.testing.assert_allclose(got[live].numpy(), want[live].numpy(), atol=1e-5,
                                       rtol=1e-5)
    with pytest.raises(ValueError, match="mode"):
        pool_shard(t["kp"], 0, 2, "page")
    with pytest.raises(ValueError, match="does not split"):
        pool_shard(t["kp"], 0, 3, "lane")


COLLECTIVE_SCRIPT = textwrap.dedent("""
    import json
    import numpy as np
    import torch
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels.paged_attention import (pool_shard, sharded_paged_attention,
                                                     sharded_paged_attention_local)
    from repro_torch.launch.sharded_smoke import spawn_ranks

    def rank(mesh):
        m = mesh.shape[1]
        r = mesh.get_coordinate()[1]
        out = {}
        for mode in ("lane", "head"):
            for dtype in (torch.float32, torch.bfloat16):
                for pages in (1, 4):
                    arrs, pt, lengths = sharded_inputs(7)
                    t = {k: torch.from_numpy(v).to(dtype) for k, v in arrs.items()}
                    if pages > 1:     # the same live pages in a 4x pool
                        for key in ("kp", "vp"):
                            t[key] = torch.cat([t[key]] + [torch.zeros_like(t[key])] * 3)
                    pool = shd.PoolShard(mode, r, m, PS, HKV)
                    policy = shd.ShardingPolicy.default(mesh, pool=pool)
                    args = (torch.from_numpy(pt), torch.from_numpy(lengths))
                    kw = dict(k_new=t["k_new"], v_new=t["v_new"], window=13)
                    got = sharded_paged_attention(
                        t["q"], pool_shard(t["kp"], r, m, mode), pool_shard(t["vp"], r, m, mode),
                        *args, policy=policy, **kw)
                    want = sharded_paged_attention_local(t["q"], t["kp"], t["vp"], *args,
                                                         n_shards=m, mode=mode, **kw)
                    key = f"{mode}/{str(dtype)[6:]}/{pages}x"
                    out[key] = [float((got.float() - want.float()).abs().max()),
                                policy.collective_bytes(), policy.wire.calls]
        return out

    def chunk_rank(mesh):
        # kvcache.attend_cache over this rank's shard of a pool vs the
        # unsharded call over the whole pool: S = 1, a chunk, a window, and
        # a chunk over 4096 lanes (the streaming branch)
        from repro_torch.models import kvcache
        m, r = mesh.shape[1], mesh.get_coordinate()[1]
        out = {}
        for mode in ("lane", "head"):
            for dtype in (torch.float32, torch.bfloat16):
                for S, mp, ps, window in ((1, 6, 8, None), (5, 6, 8, 9), (3, 256, 16, None)):
                    g = torch.Generator().manual_seed(S * 100 + mp)
                    Bc, Hkv, G, Dh = 2, 4, 2, 16
                    n_pages = Bc * mp
                    kp = torch.randn(n_pages + 1, ps, Hkv, Dh, generator=g).to(dtype)
                    vp = torch.randn(n_pages + 1, ps, Hkv, Dh, generator=g).to(dtype)
                    pt = torch.randperm(n_pages, generator=g).reshape(Bc, mp).to(torch.int32)
                    pt[0, 1] = -1
                    pos = torch.tensor([mp * ps // 2, mp * ps - S - 1], dtype=torch.int32)
                    q = torch.randn(Bc, S, Hkv * G, Dh, generator=g).to(dtype)
                    positions = pos[:, None] + torch.arange(S, dtype=torch.int32)
                    whole = {"kp": kp, "vp": vp, "page_table": pt}
                    want = kvcache.attend_cache(whole, q, positions, pos + S, window=window)
                    pool = shd.PoolShard(mode, r, m, ps, Hkv)
                    policy = shd.ShardingPolicy.default(mesh, pool=pool)
                    local = {"kp": pool_shard(kp, r, m, mode), "vp": pool_shard(vp, r, m, mode),
                             "page_table": pt}
                    with shd.activation_sharding(policy):
                        got = kvcache.attend_cache(local, q, positions, pos + S, window=window)
                    key = f"{mode}/{str(dtype)[6:]}/S{S}/T{mp * ps}"
                    out[key] = float((got.float() - want.float()).abs().max())
        return out

    def every(mesh):
        # the (2, 2) mesh's model groups shard 2 ways; a (1, 4) mesh over
        # the same four ranks shards 4 ways
        from repro_torch.dist.compat import init_device_mesh
        wide = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
        return rank(mesh), rank(wide), chunk_rank(mesh)

    if __name__ == "__main__":
        ranks = spawn_ranks(every, dp=2, mp=2, device="cpu", timeout_s=120)
        print(json.dumps({2: [r[0] for r in ranks], 4: [r[1] for r in ranks]}))
        print(json.dumps([r[2] for r in ranks]))
""")


def test_collective_form_matches_the_in_process_form(tmp_path):
    script = tmp_path / "collective.py"
    consts = f"B, HKV, G, D, PS, MP, N_PAGES = {(B, HKV, G, D, PS, MP, N_PAGES)}\n"
    script.write_text(COLLECTIVE_SCRIPT.replace(
        "from repro_torch.dist import sharding as shd\n",
        "from repro_torch.dist import sharding as shd\n" + consts
        + textwrap.dedent(inspect.getsource(sharded_inputs)), 1))
    out = subprocess.run([sys.executable, str(script)],
                         capture_output=True, text=True, cwd=ROOT, timeout=240,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    res, chunk = json.loads(lines[-2]), json.loads(lines[-1])
    # a chunk's attention over a split pool (the chunk path and the gather
    # backend), assembled across two ranks, against the unsharded call:
    # fp32 to summation order, bf16 to one rounding of the output
    for r in chunk:
        assert len(r) == 12
        for key, err in r.items():
            assert err <= (1e-5 if "float32" in key else ATOL["bfloat16"]), (key, err)
    assert set(res) == {"2", "4"}
    for m, ranks in res.items():
        assert len(ranks) == 4
        for r in ranks:
            for key, (err, sent, calls) in r.items():
                assert err <= 1e-6, (m, key, err)
                mode = key.split("/")[0]
                assert calls == (2 if mode == "lane" else 1), (m, key, calls)
            for mode in ("lane", "head"):
                for dt in ("float32", "bfloat16"):
                    # the merge ships softmax statistics: the same bytes at 4x the pool
                    assert r[f"{mode}/{dt}/1x"][1] == r[f"{mode}/{dt}/4x"][1] > 0
