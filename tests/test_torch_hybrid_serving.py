"""``RecurrentLM`` and its serving path in the port against the JAX package.

Weights come from the JAX package's ``RecurrentLM.init(key)`` and reach the
port through ``params_from_jax`` as numpy arrays.  Configs are
``recurrentgemma-2b``'s ``reduced()`` (3 layers, ``rra``) and, where the
super-block tail matters, the same with 5 layers (``rrarr``: one stacked
super-block and an unstacked ``rr`` tail).

Logit tolerance: 5% of the largest logit magnitude.  Each component agrees
with the JAX one to one bf16 step (the RG-LRU mixer, the MLP), but the
frameworks accumulate bf16 matmuls in different orders and the hybrid's
random-init logits are a near-cancelling sum over a small tied embedding
(largest logit about 0.6), so those steps add up to 2.2-3.6% of the largest
logit over seeds 0-2 at the reduced width.  Argmax must agree wherever the
JAX top-2 margin exceeds twice the tolerance.

Port-internal contracts are exact: S=1 decode is the chunk path at S=1
(pool bytes, ``h`` and ``conv`` rows and logits bitwise across chunkings);
the paged-kernel backend, the gather backend and solo ``generate`` give the
same greedy tokens; a request in a reused slot decodes as it does alone.
"""

from __future__ import annotations

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model as jax_build_model
from repro.models import kvcache as jkv
from repro.serve.engine import make_chunk_step as jax_make_chunk_step
from repro.serve.scheduler import DecodeScheduler as JaxDecodeScheduler
from repro_torch import configs
from repro_torch.kernels.rglru_scan import rglru_scan_kernel
from repro_torch.launch.serve import run_serving
from repro_torch.models import build_model, kvcache
from repro_torch.models.config import layer_pattern
from repro_torch.serve.engine import generate, make_chunk_step
from repro_torch.serve.scheduler import DecodeScheduler
from repro_torch.weights import params_from_jax, params_to_numpy
from test_torch_scheduler import ForcedScheduler, run_all, staggered

torch.set_num_threads(2)

ARCH = "recurrentgemma-2b"
REL_TOL = 5e-2
GATES = ("gate_w_a", "gate_b_a", "gate_w_x", "gate_b_x", "a_param")


@functools.lru_cache(maxsize=None)
def jax_and_port(n_layers=None, seed=0):
    """(jax model, jax params, port model) on the same weights; shared by
    the tests, which do not modify them."""
    over = {} if n_layers is None else {"n_layers": n_layers}
    jcfg = dataclasses.replace(jconfigs.get(ARCH).reduced(), **over)
    tcfg = dataclasses.replace(configs.get(ARCH).reduced(), **over)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.key(seed))
    tm = build_model(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu"))
    return jm, jp, tm


def assert_logits_agree(got, want, vocab):
    got = np.asarray(got, np.float32)[..., :vocab]
    want = np.asarray(want, np.float32)[..., :vocab]
    tol = REL_TOL * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    top2 = np.sort(want, axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > 2 * tol
    np.testing.assert_array_equal(got.argmax(-1)[decisive], want.argmax(-1)[decisive])


def tiny(seed=0):
    cfg = configs.get(ARCH).reduced()
    return cfg, build_model(cfg, device="cpu", seed=seed)


@functools.lru_cache(maxsize=None)
def jax_apply(n_layers):
    jm, _, _ = jax_and_port(n_layers=n_layers)
    return jax.jit(jm.apply)


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_logits_match_jax_with_tail(seed):
    """20 tokens: past the window (8) and past the JAX left-fold limit (16)."""
    jm, jp, tm = jax_and_port(n_layers=5, seed=seed)
    assert layer_pattern(tm.cfg) == "rrarr" and "tail" in jp
    toks = np.random.default_rng(seed).integers(0, tm.cfg.vocab, size=(2, 20)).astype(np.int32)
    want = jax_apply(5)(jp, {"tokens": jnp.asarray(toks)})
    got = tm.apply(torch.from_numpy(toks))
    assert got.shape == (2, 20, tm.cfg.padded_vocab) and got.dtype == torch.bfloat16
    assert_logits_agree(got.float(), want, tm.cfg.vocab)


def test_paged_decode_step_matches_jax():
    """Two slots on scrambled page tables, prompts longer than the window
    prefilled in chunks, then one batched S=1 step: the port's gather and
    paged-kernel (post-update) backends against the JAX gather path, and
    the recurrent rows the chunks left against JAX's."""
    jm, jp, tm = jax_and_port(n_layers=5)
    ps, n_pages, mp = 4, 12, 5
    rows = [np.asarray([7, 2, 9, 4, 0], np.int32), np.asarray([3, 11, 5, -1, -1], np.int32)]
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, tm.cfg.vocab, size=n).astype(np.int32) for n in (13, 9)]
    jc = jkv.paged_cache(jm, 2, page_size=ps, n_pages=n_pages, max_pages=mp)
    tc = kvcache.paged_cache(tm, 2, page_size=ps, n_pages=n_pages, max_pages=mp)
    for b, row in enumerate(rows):
        jc = jkv.set_page_row(jc, b, row)
        kvcache.set_page_row(tc, b, row)
    jchunk, tchunk = jax.jit(jax_make_chunk_step(jm)), make_chunk_step(tm)
    for b, p in enumerate(prompts):
        for lo in range(0, len(p), 5):
            piece = p[lo:lo + 5][None]
            _, jc = jchunk(jp, jc, jnp.asarray(piece), b)
            _, tc = tchunk(tc, torch.from_numpy(piece), b)
    # layer 0 is the first 'r' of the stacked super-block
    jh = np.asarray(jc["blocks"]["l0"]["h"][0])
    np.testing.assert_allclose(tc["h"][0].numpy(), jh, atol=2e-2 * np.abs(jh).max())
    last = np.asarray([[17], [42]], np.int32)
    want, _ = jax.jit(jm.decode_step)(jp, jc, jnp.asarray(last))
    assert tc["length"].tolist() == [13, 9]
    fused = copy.copy(tm)
    fused.cfg = dataclasses.replace(tm.cfg, attn_backend="paged_kernel")
    got_kernel, _ = fused.decode_step(tc, torch.from_numpy(last))
    got_gather, new = tm.decode_step(tc, torch.from_numpy(last))
    assert new["length"].tolist() == [14, 10]
    assert_logits_agree(got_gather.float(), want, tm.cfg.vocab)
    assert_logits_agree(got_kernel.float(), want, tm.cfg.vocab)


def _one_slot(tm, n_pages, ps):
    cache = kvcache.paged_cache(tm, 1, page_size=ps, n_pages=n_pages, max_pages=n_pages)
    cache["page_table"][0] = torch.arange(n_pages, dtype=torch.int32)
    return cache


def test_decode_is_bitwise_chunked_prefill():
    """One token stream fed as one chunk, mixed chunks (past the window
    and past 16 tokens, where the JAX package reassociates) or single
    steps leaves bitwise identical pool bytes, ``h`` and ``conv`` rows and
    per-position logits."""
    cfg = dataclasses.replace(configs.get(ARCH).reduced(), n_layers=5)
    tm = build_model(cfg, device="cpu", seed=3)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, size=23).astype(np.int32)
    results = []
    for chunks in ([23], [5, 7, 1, 10], [1] * 23):
        cache, out, i = _one_slot(tm, 4, 8), [], 0
        for c in chunks:
            logits, cache = tm.decode_step(cache, torch.from_numpy(toks[None, i:i + c]))
            out.append(logits[0])
            i += c
        results.append((torch.cat(out), cache))
    logits0, cache0 = results[0]
    assert cache0["h"].shape == (4, 1, 64) and cache0["conv"].shape == (4, 1, 3, 64)
    for logits, cache in results[1:]:
        assert torch.equal(logits, logits0)
        for key in ("kp", "vp"):
            assert torch.equal(cache[key][:, :4], cache0[key][:, :4]), key
        for key in ("h", "conv"):
            assert torch.equal(cache[key], cache0[key]), key


def test_weights_round_trip_keeps_gates_fp32():
    """JAX tree (blocks + tail) -> port -> numpy gives the bf16-rounded
    tree with the RG-LRU gates exact in fp32, and port -> numpy -> port is
    exact."""
    jm, jp, tm = jax_and_port(n_layers=5)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    back = params_to_numpy(tm.state_dict(), tm.cfg)
    flat_t = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_t) == len(flat_b)
    for path, a in flat_t:
        name = jax.tree_util.keystr(path)
        expect = a if any(g in name for g in GATES) else \
            np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(flat_b[path], expect, err_msg=name)
    sd = params_from_jax(back, tm.cfg, "cpu")
    for k, v in tm.state_dict().items():
        assert torch.equal(sd[k], v) and sd[k].dtype == v.dtype, k
    for name in GATES:
        assert sd[f"layers.0.rec.{name}"].dtype == torch.float32, name
        assert sd[f"layers.4.rec.{name}"].dtype == torch.float32, name
    for name in ("w_x", "w_y", "w_out", "conv_w", "conv_b"):
        assert sd[f"layers.3.rec.{name}"].dtype == torch.bfloat16, name
    assert sd["layers.2.attn.wq"].dtype == torch.bfloat16
    assert sum(k.startswith("layers.2.rec.") for k in sd) == 0


def test_slot_surgery_masks_clears_and_writes_back_recurrent_rows():
    cfg, model = tiny()
    cache = kvcache.paged_cache(model, 3, page_size=4, n_pages=6, max_pages=2)
    assert cache["kp"].shape[0] == 1                 # the one 'a' layer of 'rra'
    assert cache["h"].shape == (2, 3, 64) and cache["h"].dtype == torch.float32
    assert cache["conv"].shape == (2, 3, 3, 64) and cache["conv"].dtype == torch.bfloat16
    new = dict(cache, h=torch.ones_like(cache["h"]), conv=torch.ones_like(cache["conv"]),
               length=cache["length"] + 1)
    keep = torch.tensor([True, False, True])
    out = kvcache.mask_slot_rows(new, cache, keep)
    assert out["h"][:, 1].eq(0).all() and out["h"][:, [0, 2]].eq(1).all()
    assert out["conv"][:, 1].eq(0).all() and out["conv"][:, [0, 2]].eq(1).all()
    assert out["length"].tolist() == [1, 0, 1]
    one = kvcache.cache_slot_view(out, 2)
    assert one["h"].shape == (2, 1, 64)
    one = dict(one, h=one["h"] + 1, conv=one["conv"] + 1, length=one["length"] + 3)
    kvcache.cache_insert_slot(out, one, 2)
    assert out["h"][:, 2].eq(2).all() and out["conv"][:, 2].eq(2).all()
    assert out["length"].tolist() == [1, 0, 4]
    kvcache.cache_clear_slot(out, 0)
    assert out["h"][:, 0].eq(0).all() and out["conv"][:, 0].eq(0).all()
    assert out["h"][:, 2].eq(2).all() and int(out["length"][0]) == 0


def test_paged_kernel_equals_gather_equals_solo_and_reused_slot():
    """Prompts longer than the window, admitted at different steps and
    prefilled in chunks of 5 over 2 slots, so the third request takes a
    slot another request used: both backends equal solo ``generate`` token
    for token (a stale recurrent row in the reused slot would not), with
    ``audit()`` every step."""
    cfg, model = tiny()
    prompts, submits = staggered(cfg, 3, lengths=(6, 12, 20), max_new=5)
    max_seq, N = 28, 5
    solo = {i: generate(model, torch.from_numpy(p)[None], N, seq_len=max_seq)[0].numpy()
            for i, p in enumerate(prompts)}
    kw = dict(n_slots=2, max_seq=max_seq, page_size=4, prefill_chunk=5, device="cpu")
    gather_sched = DecodeScheduler(model, **kw)
    gather = run_all(gather_sched, submits, audit=True)
    assert gather_sched.admitted == 3 > gather_sched.n_slots
    fused_sched = DecodeScheduler(model, attn_backend="paged_kernel", **kw)
    before = rglru_scan_kernel.launches
    fused = run_all(fused_sched, submits, audit=True)
    assert rglru_scan_kernel.launches == before       # CPU: plain version only
    assert sorted(gather) == sorted(fused) == [0, 1, 2]
    for i in range(3):
        np.testing.assert_array_equal(fused[i], gather[i], err_msg=f"r{i} kernel != gather")
        np.testing.assert_array_equal(fused[i], solo[i], err_msg=f"r{i} kernel != solo")
    assert fused_sched.allocator.free_count == fused_sched.n_pages
    assert (fused_sched.cache["page_table"] == -1).all()


def test_decode_rows_equal_chunked_prefill_in_scheduler():
    """The recurrent rows and pool bytes a request's batched S=1 decode
    steps leave are bitwise what one chunked prefill of the consumed
    tokens leaves, while another slot decodes beside it."""
    cfg, model = tiny()
    ps, P, N = 4, 13, 7
    prompt = np.random.default_rng(5).integers(0, cfg.vocab, size=P).astype(np.int32)
    other = np.random.default_rng(6).integers(0, cfg.vocab, size=9).astype(np.int32)
    sched = DecodeScheduler(model, n_slots=3, max_seq=24, page_size=ps, prefill_chunk=5,
                            device="cpu")
    sched.submit("a", "r0", prompt, N)
    sched.submit("b", "r1", other, N)
    slot = sched.slots[0]
    while not (slot.decoding and slot.n_out == N - 1):
        sched.step()
    consumed = slot.len
    history = np.concatenate([prompt, sched.out_buf[0, :consumed - P].numpy()])
    row = sched._page_rows[0].copy()
    ref = _one_slot(model, 8, ps)
    for lo in range(0, consumed, 6):
        _, ref = model.decode_step(ref, torch.from_numpy(history[None, lo:lo + 6]))
    for key in ("kp", "vp"):
        got = sched.cache[key][:, row[row >= 0]].flatten(1, 2)[:, :consumed]
        want = ref[key][:, :8].flatten(1, 2)[:, :consumed]
        assert torch.equal(got, want), key
    for key in ("h", "conv"):
        assert torch.equal(sched.cache[key][:, 0], ref[key][:, 0]), key


def test_scheduler_matches_jax_scheduler_teacher_forced():
    """The port's scheduler, teacher-forced on the JAX scheduler's token
    stream, gives logits that agree with the JAX model's on that stream."""
    jm, jp, tm = jax_and_port()
    prompts, submits = staggered(tm.cfg, 11, lengths=(7, 12, 17), max_new=5)
    kw = dict(n_slots=3, max_seq=24, page_size=8, prefill_chunk=5)
    jax_tokens = {f"r{k}": v for k, v in run_all(JaxDecodeScheduler(jm, jp, **kw),
                                                 submits).items()}
    want = {}
    step = jax.jit(jm.decode_step)
    prefill = jax.jit(lambda pp, t: jm.prefill(pp, t, seq_len=24))
    for i, p in enumerate(prompts):
        rid = f"r{i}"
        logits, cache = prefill(jp, jnp.asarray(p)[None])
        for idx, tok in enumerate(jax_tokens[rid]):
            want[(rid, idx)] = np.asarray(logits[0, -1], np.float32)
            logits, cache = step(jp, cache, jnp.asarray([[tok]], jnp.int32))
    for backend in ("gather", "paged_kernel"):
        sched = ForcedScheduler(tm, jax_tokens, attn_backend=backend, device="cpu", **kw)
        got = {f"r{k}": v for k, v in run_all(sched, submits, audit=True).items()}
        for rid, toks in jax_tokens.items():
            np.testing.assert_array_equal(got[rid], toks)      # the forcing held
        assert sched.logits.keys() == want.keys()
        for key, w in want.items():
            assert_logits_agree(sched.logits[key], w, tm.cfg.vocab)


def test_run_serving_end_to_end_on_cpu():
    fe = run_serving(ARCH, 6, max_new=4, prompt_len=10, sessions=2, batch_size=3,
                     attn_backend="paged_kernel", prefill_chunk=4, quiet=True, device="cpu")
    assert sum(len(v) for v in fe.completions.values()) == 6
    for ids in fe.completions.values():
        assert ids == sorted(ids, key=lambda r: int(r[1:]))
    st = fe.serving_stats()
    assert st["attn_backend"] == "paged_kernel" and st["completed"] == 6
    assert st["kv_bytes_per_token"] == 1 * 2 * 1 * 16 * 2   # 'a' layers x (K,V) x Hkv x D x bf16
    fe.scheduler.audit()


def test_full_size_config_is_recurrentgemma_2b():
    cfg = configs.get(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
            cfg.the_head_dim()) == (26, 2560, 10, 1, 7680, 256)
    pat = layer_pattern(cfg)
    assert pat.count("r") == 18 and pat.count("a") == 8 and pat.endswith("rr")
    assert cfg.hybrid.local_window == 2048 and cfg.tie_embeddings
    assert cfg.param_count() == jconfigs.get(ARCH).param_count()
    assert abs(cfg.param_count() - 2.688e9) < 1e6
