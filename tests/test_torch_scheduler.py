"""The port's continuous-batching scheduler over the paged pool.

Port-internal contracts (exact): the paged-kernel backend, the gather
backend and solo ``generate`` give the same greedy tokens; S=1 decode
writes bitwise the pool bytes chunked prefill writes; per-session FIFO,
slot reuse and the allocator audit hold at every step; a crashed
invocation redelivers without duplicate completions.

Against the JAX ``DecodeScheduler`` (same weights, same workload): the
port's scheduler is teacher-forced on the JAX token stream and its logits
must agree with the JAX model's on that stream within 2.5% of the logit
scale (bf16 accumulation order differs between the frameworks; see
``test_torch_model``), with argmax equal to the JAX token wherever the JAX
top-2 margin exceeds twice that tolerance.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.scheduler import DecodeScheduler as JaxDecodeScheduler
from repro_torch import configs
from repro_torch.core import FaultPlan, SimCloud
from repro_torch.launch.serve import (build_frontend, run_serving, spawn_workload,
                                      validate_pool_sizing)
from repro_torch.models import build_model, kvcache
from repro_torch.serve import sampling
from repro_torch.serve.engine import generate
from repro_torch.serve.scheduler import DecodeScheduler
from test_torch_model import REL_TOL, jax_and_port

torch.set_num_threads(2)


def tiny(arch="minicpm-2b", seed=0):
    cfg = configs.get(arch).reduced()
    return cfg, build_model(cfg, device="cpu", seed=seed)


def run_all(sched, submits, audit=False):
    """Drive a scheduler: ``submits`` maps step -> [(session, rid, prompt,
    max_new)]; returns {rid number: tokens}."""
    got, step = {}, 0
    while sched.busy() or any(k >= step for k in submits):
        for args in submits.get(step, ()):
            sched.submit(*args)
        for fin in sched.step():
            got[int(fin.request_id[1:])] = fin.tokens
        if audit:
            sched.audit()
        step += 1
        assert step < 500, "scheduler failed to drain"
    return got


def staggered(cfg, seed, lengths=(6, 12, 20), max_new=4):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in lengths]
    submits = {0: [("a", "r0", prompts[0], max_new)], 2: [("b", "r1", prompts[1], max_new)],
               3: [("c", "r2", prompts[2], max_new)]}
    return prompts, submits


@pytest.mark.parametrize("arch,seed", [("minicpm-2b", 0), ("qwen3-14b", 0),
                                       ("moonshot-v1-16b-a3b", 0)])
def test_paged_kernel_equals_gather_equals_solo(arch, seed):
    """Prompts spanning 1..3 pages of 8, admitted at different steps and
    prefilled in chunks of 5: the paged-kernel scheduler, the gather
    scheduler and an eviction-free solo decode agree token for token."""
    cfg, model = tiny(arch)
    prompts, submits = staggered(cfg, seed)
    max_seq, N = 24, 4
    solo = {i: generate(model, torch.from_numpy(p)[None], N, seq_len=max_seq)[0].numpy()
            for i, p in enumerate(prompts)}
    kw = dict(n_slots=3, max_seq=max_seq, page_size=8, prefill_chunk=5, device="cpu")
    gather = run_all(DecodeScheduler(model, **kw), submits, audit=True)
    fused_sched = DecodeScheduler(model, attn_backend="paged_kernel", **kw)
    fused = run_all(fused_sched, submits, audit=True)
    assert fused_sched.stats()["attn_backend"] == "paged_kernel"
    assert model.cfg.attn_backend == "gather"     # the rebind did not leak
    assert sorted(gather) == sorted(fused) == [0, 1, 2]
    for i in range(3):
        np.testing.assert_array_equal(fused[i], gather[i], err_msg=f"r{i} kernel != gather")
        np.testing.assert_array_equal(fused[i], solo[i], err_msg=f"r{i} kernel != solo")


def test_decode_pool_bytes_equal_chunked_prefill():
    """The KV a request's batched S=1 decode steps wrote into the pool is
    bitwise what one chunked prefill of the same consumed tokens writes."""
    _decode_pool_bytes_case("minicpm-2b")


def test_decode_pool_bytes_equal_chunked_prefill_moe():
    """The same for the MoE arch: drop-free routing computes each token's
    experts (and the router) the same in a decode step as in a chunk."""
    _decode_pool_bytes_case("moonshot-v1-16b-a3b")


def _decode_pool_bytes_case(arch):
    cfg, model = tiny(arch)
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
    assert consumed == P + N - 2                  # prompt + decode-written tokens
    history = np.concatenate([prompt, sched.out_buf[0, :consumed - P].numpy()])
    row = sched._page_rows[0].copy()

    ref = kvcache.paged_cache(model, 1, page_size=ps, n_pages=8, max_pages=8)
    ref["page_table"][0] = torch.arange(8, dtype=torch.int32)
    for lo in range(0, consumed, 6):              # a chunking unlike the scheduler's
        _, ref = model.decode_step(ref, torch.from_numpy(history[None, lo:lo + 6]))
    for key in ("kp", "vp"):
        got = sched.cache[key][:, row[row >= 0]].flatten(1, 2)[:, :consumed]
        want = ref[key][:, :8].flatten(1, 2)[:, :consumed]
        assert torch.equal(got, want), key


def test_fifo_slot_reuse_and_audit_every_step():
    cfg, model = tiny("qwen3-14b")
    rng = np.random.default_rng(7)
    sched = DecodeScheduler(model, n_slots=2, max_seq=20, page_size=4, prefill_chunk=6,
                            device="cpu")
    submits = {0: [], 3: []}
    for i in range(7):
        submits[0 if i < 5 else 3].append(
            (f"s{i % 3}", f"r{i}", rng.integers(0, cfg.vocab, size=5 + i).astype(np.int32), 3))
    order = []
    step = 0
    while sched.busy() or step <= 3:
        for args in submits.get(step, ()):
            sched.submit(*args)
        order += [(f.session, int(f.request_id[1:])) for f in sched.step()]
        sched.audit()
        step += 1
    assert sorted(n for _, n in order) == list(range(7))
    for s in ("s0", "s1", "s2"):
        nums = [n for sess, n in order if sess == s]
        assert nums == sorted(nums), f"FIFO violated in {s}"
    assert sched.admitted == 7 > sched.n_slots          # slots were reused
    assert sched.allocator.free_count == sched.n_pages and sched._reserved == 0
    assert (sched.cache["page_table"] == -1).all()


def _drive(fe, cloud, cfg, n):
    spawn_workload(cloud, fe, vocab=cfg.vocab, n_requests=n, sessions=4, prompt_len=8,
                   max_new=3)
    cloud.run()


def test_crash_redelivers_batch_without_duplicating_completions():
    """A crash mid-invocation (after some completions) redelivers the batch;
    completions are deduped by request id and replay gives the same tokens."""
    cfg, model = tiny()
    kw = dict(mode="continuous", batch_size=4, max_new=3, prompt_len=8, device="cpu")
    clean_cloud = SimCloud(seed=0)
    clean = build_frontend(clean_cloud, cfg, model, **kw)
    _drive(clean, clean_cloud, cfg, 8)
    cloud = SimCloud(seed=0, faults=FaultPlan(crashes={("serve", "post-complete"): 0}))
    fe = build_frontend(cloud, cfg, model, **kw)
    _drive(fe, cloud, cfg, 8)
    assert fe.runtime.stats["serve"].crashes == 1
    assert fe.dispatch.redeliveries >= 1
    done = [r for ids in fe.completions.values() for r in ids]
    assert sorted(done, key=lambda r: int(r[1:])) == [f"r{i}" for i in range(8)]
    assert len(done) == len(set(done)), "duplicated completions after redelivery"
    for sess, ids in fe.completions.items():
        nums = [int(r[1:]) for r in ids]
        assert nums == sorted(nums), f"FIFO violated in {sess} after redelivery"
        for rid, toks in zip(ids, fe.results[sess], strict=True):
            i = clean.completions[sess].index(rid)
            np.testing.assert_array_equal(toks, clean.results[sess][i])


class ForcedScheduler(DecodeScheduler):
    """Teacher-forced scheduler: every sampled token is replaced by the
    given stream, and the logits it was sampled from are recorded."""

    def __init__(self, model, forced, **kw):
        super().__init__(model, **kw)
        self.forced, self.logits, self._chunk_slot = forced, {}, None

    def _run_chunk(self, slot):
        self._chunk_slot = slot
        try:
            super()._run_chunk(slot)
        finally:
            self._chunk_slot = None

    def _sample(self, logits):
        if self._chunk_slot is not None:
            rows = [(0, self._chunk_slot, 0)]
        else:
            rows = [(s.index, s, s.n_out) for s in self.slots if s.decoding]
        out = torch.zeros(logits.shape[0], dtype=torch.int32)
        for r, slot, idx in rows:
            rid = slot.req.request_id
            self.logits[(rid, idx)] = logits[r].float().numpy().copy()
            out[r] = int(self.forced[rid][idx])
        return out


@pytest.mark.parametrize("arch", ["minicpm-2b", "qwen3-14b", "moonshot-v1-16b-a3b"])
def test_scheduler_matches_jax_scheduler_teacher_forced(arch):
    jm, jp, tm = jax_and_port(arch)
    prompts, submits = staggered(tm.cfg, 11, lengths=(7, 12, 17), max_new=5)
    kw = dict(n_slots=3, max_seq=24, page_size=8, prefill_chunk=5)
    jsched = JaxDecodeScheduler(jm, jp, **kw)
    jax_tokens = {f"r{k}": v for k, v in run_all(jsched, submits).items()}

    # the JAX model's logits on its own stream (prefill, then S=1 steps)
    want = {}
    step = jax.jit(jm.decode_step)
    for i, p in enumerate(prompts):
        rid = f"r{i}"
        logits, cache = jax.jit(lambda pp, t: jm.prefill(pp, t, seq_len=24))(
            jp, jnp.asarray(p)[None])
        for idx, tok in enumerate(jax_tokens[rid]):
            want[(rid, idx)] = np.asarray(logits[0, -1], np.float32)
            logits, cache = step(jp, cache, jnp.asarray([[tok]], jnp.int32))

    for backend in ("gather", "paged_kernel"):
        sched = ForcedScheduler(tm, jax_tokens, attn_backend=backend, device="cpu", **kw)
        got = {f"r{k}": v for k, v in run_all(sched, submits, audit=True).items()}
        assert got.keys() == jax_tokens.keys()
        for rid, toks in jax_tokens.items():
            np.testing.assert_array_equal(got[rid], toks)      # the forcing held
        assert sched.logits.keys() == want.keys()
        for key, w in want.items():
            g, w = sched.logits[key][:tm.cfg.vocab], w[:tm.cfg.vocab]
            tol = REL_TOL * float(np.abs(w).max())
            np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=f"{backend} {key}")
            top2 = np.sort(w)[-2:]
            if top2[1] - top2[0] > 2 * tol:
                assert g.argmax() == jax_tokens[key[0]][key[1]], f"{backend} {key}"


def test_unported_options_raise():
    cfg, model = tiny()
    with pytest.raises(NotImplementedError, match="not ported"):
        DecodeScheduler(model, device="cpu", mesh=object())
    # offload, prefix sharing, parking, speculation and the fleet's index
    # journal are ported: accepted on the pool (speculation is on only with
    # a draft model and spec_k >= 1; the journal only with index sharing)
    for kw in (dict(offload=True), dict(prefix_sharing=True), dict(park_sessions=True),
               dict(draft_model=model, spec_k=2), dict(spec_k=2), dict(draft_model=model),
               dict(index_journal=True)):
        DecodeScheduler(model, device="cpu", **kw)
    sched = DecodeScheduler(model, device="cpu", prefix_sharing=True, index_journal=True)
    assert sched.index_journal and sched.adopt_index_journal() == 0
    with pytest.raises(ValueError, match="attn_backend"):
        DecodeScheduler(model, device="cpu", attn_backend="flash")
    with pytest.raises(ValueError, match="model is on"):
        DecodeScheduler(model, device="meta")
    with pytest.raises(ValueError, match="kv-pages"):
        validate_pool_sizing(batch_size=4, prompt_len=16, max_new=8, page_size=4,
                             kv_pages=8)


def test_run_serving_end_to_end_on_cpu():
    fe = run_serving("qwen3-14b", 6, max_new=4, prompt_len=10, sessions=2, batch_size=3,
                     attn_backend="paged_kernel", prefill_chunk=4, quiet=True, device="cpu")
    assert sum(len(v) for v in fe.completions.values()) == 6
    for ids in fe.completions.values():
        assert ids == sorted(ids, key=lambda r: int(r[1:]))
    st = fe.serving_stats()
    assert st["attn_backend"] == "paged_kernel" and st["completed"] == 6
    assert st["kv_bytes_per_token"] == 4 * 2 * 2 * 16 * 2     # L x (K,V) x Hkv x D x bf16
    fe.scheduler.audit()


def test_topk_restricts_support_to_exactly_k():
    """Ties with the k-th logit must not widen the candidate set."""
    logits = torch.tensor([[3.0, 2.0, 2.0, 2.0, -1.0]])
    gen = torch.Generator().manual_seed(0)
    seen = {int(sampling.temperature_sample(gen, logits, 1.0, top_k=2)[0])
            for _ in range(64)}
    assert seen == {0, 1}


def test_topk_ge_vocab_disabled_and_topk_one():
    logits = torch.tensor([[0.1, 5.0, -2.0, 1.0]])
    gen = torch.Generator().manual_seed(0)
    assert 0 <= int(sampling.temperature_sample(gen, logits, 1.0, top_k=17)[0]) < 4
    assert 0 <= int(sampling.temperature_sample(gen, logits, 1.0, top_k=-1)[0]) < 4
    for _ in range(8):
        assert int(sampling.temperature_sample(gen, logits, 1.0, top_k=1)[0]) == 1
    assert int(sampling.temperature_sample(gen, logits, 1e-4, top_k=0)[0]) == 1
    assert sampling.greedy(logits).dtype == torch.int32


def test_temperature_sampling_replays_after_reset():
    """Sampling draws come from the scheduler's seeded generator, so a reset
    replays the same tokens."""
    cfg, model = tiny()
    prompt = np.arange(9, dtype=np.int32)
    sched = DecodeScheduler(model, n_slots=2, max_seq=16, page_size=4, temperature=1.0,
                            top_k=20, seed=3, device="cpu")
    first = run_all(sched, {0: [("a", "r0", prompt, 5)]})
    sched.reset()
    again = run_all(sched, {0: [("a", "r0", prompt, 5)]})
    np.testing.assert_array_equal(first[0], again[0])
    assert dataclasses.asdict(sched.slots[0])["state"].value == "empty"
