"""``DecodeScheduler(kv_mode='ring')`` in the port against solo ``generate``
and against the JAX ring scheduler.

Configs are the ``reduced()`` ones of the dense (``minicpm-2b``,
``qwen3-14b``), hybrid (``recurrentgemma-2b``, local window 8) and SSM
(``mamba2-1.3b``) families.  Port-internal contracts are exact: the ring
scheduler gives solo ``generate``'s greedy tokens, also for a request
admitted into a slot that sat EMPTY through decode steps (its ring row took
the masked step's writes, and the admission overwrote the whole row).

Against the JAX package, on the same weights (``model.init`` through
``params_from_jax``): teacher-forced on the JAX ring scheduler's token
stream, the port's logits agree with the JAX model's on that stream within
the family's tolerance of ``test_torch_model`` / ``test_torch_hybrid_
serving``: 2.5% of the logit scale for dense models, 5% for the hybrid and
the SSM (bf16 accumulation order differs between the frameworks), with
argmax equal wherever the JAX top-2 margin exceeds twice that.  A
from-scratch prefill of 4096 tokens runs every attention layer through
``flash_attention`` and matches the JAX ``prefill`` logits at the same
tolerances.  Errors and KV sizes follow the JAX scheduler's.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_hybrid_serving as hybrid_tests
import test_torch_mamba_serving as mamba_tests
from repro.serve.scheduler import DecodeScheduler as JaxDecodeScheduler
from repro_torch import configs
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch.serve import run_serving
from repro_torch.models import build_model, kvcache
from repro_torch.models import layers as tl
from repro_torch.serve.engine import generate
from repro_torch.serve.scheduler import DecodeScheduler
from test_torch_model import REL_TOL as DENSE_TOL
from test_torch_model import jax_and_port as dense_jax_and_port
from test_torch_scheduler import ForcedScheduler, run_all, staggered

torch.set_num_threads(2)

ARCHS = ["minicpm-2b", "qwen3-14b", "recurrentgemma-2b", "mamba2-1.3b"]
MAX_SEQ = 24


@functools.lru_cache(maxsize=None)
def pair(arch):
    """(jax model, jax params, port model, logit tolerance) on one set of
    weights, shared by the tests, which do not modify them."""
    if arch == "recurrentgemma-2b":
        return (*hybrid_tests.jax_and_port(), hybrid_tests.REL_TOL)
    if arch == "mamba2-1.3b":
        return (*mamba_tests.jax_and_port(), hybrid_tests.REL_TOL)
    return (*dense_jax_and_port(arch), DENSE_TOL)


def assert_logits_agree(got, want, vocab, rel):
    got = np.asarray(got, np.float32)[..., :vocab]
    want = np.asarray(want, np.float32)[..., :vocab]
    tol = rel * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    top2 = np.sort(want, axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > 2 * tol
    np.testing.assert_array_equal(got.argmax(-1)[decisive], want.argmax(-1)[decisive])


class RingForced(ForcedScheduler):
    """Teacher-forced ring scheduler: admission samples the first token from
    the prefill's logits, as a final prefill chunk does in paged mode."""

    def _admit(self, slot, req, need):
        self._chunk_slot = slot
        try:
            super()._admit(slot, req, need)
        finally:
            self._chunk_slot = None


@pytest.mark.parametrize("arch", ARCHS)
def test_ring_scheduler_equals_solo_with_a_reused_slot(arch):
    """Two slots, three sessions: r0 finishes first, its slot sits EMPTY
    (taking the masked steps' writes) until r2 arrives and reuses it; every
    request decodes token for token as it does alone."""
    cfg = configs.get(arch).reduced()
    model = build_model(cfg, device="cpu", seed=0)
    rng = np.random.default_rng(3)
    lens, news = (6, 11, 13), (3, 9, 4)        # 13 > the hybrid's window of 8
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in lens]
    submits = {0: [("a", "r0", prompts[0], news[0]), ("b", "r1", prompts[1], news[1])],
               5: [("c", "r2", prompts[2], news[2])]}
    sched = DecodeScheduler(model, n_slots=2, max_seq=MAX_SEQ, kv_mode="ring", device="cpu")
    assert "page_table" not in sched.cache and sched.n_pages == 0
    has_ring = "k" in sched.cache
    left, got, step = None, {}, 0
    while sched.busy() or step <= 5:
        if step == 5 and has_ring:
            # the row r0 left behind took the EMPTY slot's masked writes
            assert sched.slots[0].empty
            assert not torch.equal(left, sched.cache["positions"][:, 0])
        for args in submits.get(step, ()):
            sched.submit(*args)
        if step == 5:
            assert sched.slots[0].req.request_id == "r2"          # the reused slot
        for fin in sched.step():
            got[fin.request_id] = fin
            if fin.request_id == "r0" and has_ring:
                left = sched.cache["positions"][:, 0].clone()
        sched.audit()                                             # a no-op for rings
        step += 1
        assert step < 100
    assert sorted(got) == ["r0", "r1", "r2"]
    assert got["r2"].admitted_step > got["r0"].finished_step + 1
    for i, p in enumerate(prompts):
        solo = generate(model, torch.from_numpy(p)[None], news[i], seq_len=MAX_SEQ)[0]
        np.testing.assert_array_equal(got[f"r{i}"].tokens, solo.numpy(), err_msg=f"r{i}")
    st = sched.stats()
    assert st["kv_mode"] == "ring" and st["admitted"] == 3 and st["prefill_chunks"] == 0
    assert st["prefill_tokens"] == sum(lens)


@pytest.mark.parametrize("arch", ARCHS)
def test_ring_scheduler_matches_jax_ring_scheduler_teacher_forced(arch):
    jm, jp, tm, rel = pair(arch)
    prompts, submits = staggered(tm.cfg, 11, lengths=(7, 12, 17), max_new=5)
    kw = dict(n_slots=2, max_seq=MAX_SEQ, kv_mode="ring")
    jax_tokens = {f"r{k}": v for k, v in run_all(JaxDecodeScheduler(jm, jp, **kw),
                                                 submits).items()}
    want = {}
    step = jax.jit(jm.decode_step)
    prefill = jax.jit(lambda pp, t: jm.prefill(pp, t, seq_len=MAX_SEQ))
    for i, p in enumerate(prompts):
        rid = f"r{i}"
        logits, cache = prefill(jp, jnp.asarray(p)[None])
        for idx, tok in enumerate(jax_tokens[rid]):
            want[(rid, idx)] = np.asarray(logits[0, -1], np.float32)
            logits, cache = step(jp, cache, jnp.asarray([[tok]], jnp.int32))
    sched = RingForced(tm, jax_tokens, device="cpu", **kw)
    got = {f"r{k}": v for k, v in run_all(sched, submits, audit=True).items()}
    for rid, toks in jax_tokens.items():
        np.testing.assert_array_equal(got[rid], toks)      # the forcing held
    assert sched.logits.keys() == want.keys()
    for key, w in want.items():
        assert_logits_agree(sched.logits[key], w, tm.cfg.vocab, rel)


@pytest.mark.parametrize("arch", ["qwen3-14b", "recurrentgemma-2b"])
def test_long_prefill_runs_flash_and_matches_jax(arch, monkeypatch):
    """A 4096-token from-scratch prefill: every attention layer attends its
    fresh k/v through ``flash_attention`` (the hybrid's windowed layers too:
    4096 > the window of 8), and the logits match the JAX ``prefill``."""
    jm, jp, tm, rel = pair(arch)
    calls = []

    def spy(*args, **kw):
        calls.append((tuple(args[0].shape), kw.get("window")))
        return flash_attention(*args, **kw)

    monkeypatch.setattr(tl, "flash_attention", spy)
    P, seq = 4096, 4100
    prompt = np.random.default_rng(2).integers(0, tm.cfg.vocab, size=(1, P)).astype(np.int32)
    got, cache = tm.prefill(torch.from_numpy(prompt), seq_len=seq)
    want, _ = jax.jit(lambda pp, t: jm.prefill(pp, t, seq_len=seq))(jp, jnp.asarray(prompt))
    window = tm.cfg.hybrid.local_window if tm.cfg.hybrid else tm.cfg.sliding_window
    assert calls == [((1, P, tm.cfg.n_heads, tm.cfg.the_head_dim()), window)] * tm.n_kv_layers
    assert int(cache["length"]) == P
    assert_logits_agree(got.float().numpy(), want, tm.cfg.vocab, rel)


def test_errors_and_kv_sizes_match_the_jax_scheduler():
    jm, jp, tm, _ = pair("qwen3-14b")
    for make in (lambda **k: JaxDecodeScheduler(jm, jp, **k),
                 lambda **k: DecodeScheduler(tm, device="cpu", **k)):
        with pytest.raises(ValueError, match="it needs kv_mode='paged'"):
            make(kv_mode="ring", attn_backend="paged_kernel")
    msgs = []
    for sched in (JaxDecodeScheduler(jm, jp, n_slots=2, max_seq=10, kv_mode="ring"),
                  DecodeScheduler(tm, n_slots=2, max_seq=10, kv_mode="ring", device="cpu")):
        with pytest.raises(ValueError, match="leaves no decode room") as e:
            sched.submit("a", "r0", np.arange(10, dtype=np.int32), 4)
        msgs.append(str(e.value))
        sched.submit("a", "r1", np.arange(7, dtype=np.int32), 9)   # clamped to 10 - 7
        assert sched.pending == [] and sched.slots[0].req.max_new == 3
    assert msgs[0] == msgs[1]
    for arch in ARCHS:
        jm, jp, tm, _ = pair(arch)
        kw = dict(n_slots=3, max_seq=20, kv_mode="ring")
        want = JaxDecodeScheduler(jm, jp, **kw).kv_memory_stats()
        got = DecodeScheduler(tm, device="cpu", **kw).kv_memory_stats()
        assert got == want, arch


@pytest.mark.parametrize("arch", ["qwen3-14b", "recurrentgemma-2b", "mamba2-1.3b"])
def test_run_serving_ring_end_to_end_on_cpu(arch):
    fe = run_serving(arch, 6, max_new=4, prompt_len=10, sessions=3, batch_size=2,
                     kv_mode="ring", quiet=True, device="cpu")
    assert sum(len(v) for v in fe.completions.values()) == 6
    for ids in fe.completions.values():
        assert ids == sorted(ids, key=lambda r: int(r[1:]))
    st = fe.serving_stats()
    assert st["kv_mode"] == "ring" and st["completed"] == 6 and st["prefill_chunks"] == 0
    cfg = configs.get(arch).reduced()
    per_token = 0 if arch == "mamba2-1.3b" else 2 * cfg.n_kv_heads * cfg.the_head_dim() * 2
    n_kv = fe.scheduler.model.n_kv_layers
    assert st["kv_bytes_per_token"] == n_kv * per_token
    ring = fe.scheduler.model.cache_len(14)
    assert st["kv_pool_bytes"] == st["kv_high_water_bytes"] == n_kv * per_token * 2 * ring


def test_ring_slot_surgery():
    """Ring rows: a slot view narrows every per-slot leaf, clearing empties
    the ring row (positions -1), insertion copies a B=1 cache's whole row,
    and masking restores lengths and recurrent rows but leaves the rings as
    the step wrote them."""
    cfg = configs.get("recurrentgemma-2b").reduced()
    model = build_model(cfg, device="cpu", seed=1)
    cache = kvcache.batched_cache(model, 3, 16)
    assert cache["length"].shape == (3,) and cache["k"].shape[1] == 3
    toks = torch.from_numpy(np.arange(5, dtype=np.int32))[None]
    _, one = model.prefill(toks, seq_len=16)
    kvcache.cache_insert_slot(cache, one, 1)
    for key in ("k", "v", "positions", "h", "conv"):
        assert torch.equal(cache[key][:, 1], one[key][:, 0]), key
        assert not cache[key][:, 0].any() if key != "positions" else \
            (cache[key][:, 0] == -1).all()
    view = kvcache.cache_slot_view(cache, 1)
    assert all(view[k].shape[1] == 1 for k in ("k", "v", "positions", "h", "conv"))
    assert int(view["length"][0]) == 5
    old = {k: v.clone() for k, v in cache.items()}
    _, new = model.decode_step(cache, torch.tensor([[1], [2], [3]], dtype=torch.int32))
    keep = torch.tensor([False, True, False])
    out = kvcache.mask_slot_rows(new, old, keep)
    assert out["length"].tolist() == [0, 6, 0]
    for key in ("h", "conv"):
        assert torch.equal(out[key][:, 0], old[key][:, 0])
        assert torch.equal(out[key][:, 1], new[key][:, 1])
    assert out["k"] is cache["k"] and (cache["positions"][:, 0] >= 0).any()  # written in place
    kvcache.cache_clear_slot(cache, 1)
    assert (cache["positions"][:, 1] == -1).all() and not cache["k"][:, 1].any()
    assert not cache["h"][:, 1].any() and int(cache["length"][1]) == 0
