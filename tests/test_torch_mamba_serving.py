"""``Mamba2LM`` and its serving path in the port against the JAX package.

Weights come from the JAX package's ``Mamba2LM.init(key)`` and reach the
port through ``params_from_jax`` as numpy arrays.  The config is
``mamba2-1.3b``'s ``reduced()`` (4 layers, d_model 64, 8 SSD heads of 16,
d_state 16, chunk 8).

Logit tolerance: 5% of the largest logit magnitude (slice 2's).  The two
frameworks accumulate the bf16 projections in different orders and round
the SiLU and gate products at other places, and those bf16 steps add up
over the layers; the fp32 SSD itself agrees to 1e-5
(``test_torch_ssd``).  Argmax must agree wherever the JAX top-2 margin
exceeds twice the tolerance.

The port makes no bitwise claim between S=1 decode and chunked prefill for
this family, and neither does the JAX package: the chunked SSD
reassociates the sums.  Step-by-step decode is held to the full forward to
the same 5%, and greedy tokens to the port's own solo ``generate``.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model as jax_build_model
from repro.serve.scheduler import DecodeScheduler as JaxDecodeScheduler
from repro_torch import configs
from repro_torch.kernels.ssd_scan import ssd_scan_kernel
from repro_torch.launch.serve import run_serving
from repro_torch.models import build_model, kvcache
from repro_torch.models.mamba2 import FP32_PARAMS
from repro_torch.serve.engine import generate
from repro_torch.serve.scheduler import DecodeScheduler
from repro_torch.weights import params_from_jax, params_to_numpy
from test_torch_hybrid_serving import assert_logits_agree
from test_torch_scheduler import ForcedScheduler, run_all, staggered

torch.set_num_threads(2)

ARCH = "mamba2-1.3b"


@functools.lru_cache(maxsize=None)
def jax_and_port(seed=0):
    """(jax model, jax params, port model) on the same weights; shared by
    the tests, which do not modify them."""
    jm = jax_build_model(jconfigs.get(ARCH).reduced())
    jp = jm.init(jax.random.key(seed))
    cfg = configs.get(ARCH).reduced()
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu"))
    return jm, jp, tm


def tiny(seed=0):
    cfg = configs.get(ARCH).reduced()
    return cfg, build_model(cfg, device="cpu", seed=seed)


def tokens(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, size=shape).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_logits_match_jax(seed):
    """20 tokens: three SSD chunks of 8, the last one ragged."""
    jm, jp, tm = jax_and_port(seed)
    toks = tokens(seed, 2, 20)
    want = jax.jit(jm.apply)(jp, {"tokens": jnp.asarray(toks)})
    got = tm.apply(torch.from_numpy(toks))
    assert got.shape == (2, 20, tm.cfg.padded_vocab) and got.dtype == torch.bfloat16
    assert_logits_agree(got.float(), want, tm.cfg.vocab)


def test_prefill_and_decode_match_jax():
    """Prefill 11 tokens, then 4 S=1 steps: logits at every step and the
    carried SSD state against the JAX model's (which decodes through
    ``ssd_decode_step``; the port through the scan's one-token case)."""
    jm, jp, tm = jax_and_port()
    toks = tokens(3, 2, 15)
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, t))(jp, jnp.asarray(toks[:, :11]))
    tl, tc = tm.prefill(torch.from_numpy(toks[:, :11]))
    assert_logits_agree(tl.float(), jl, tm.cfg.vocab)
    assert tc["ssm"].shape == (4, 2, 8, 16, 16) and tc["ssm"].dtype == torch.float32
    assert tc["conv"].shape == (4, 2, 3, 128 + 2 * 16) and int(tc["length"]) == 11
    step = jax.jit(jm.decode_step)
    for t in range(11, 15):
        jl, jc = step(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        tl, tc = tm.decode_step(tc, torch.from_numpy(toks[:, t:t + 1]))
        assert_logits_agree(tl.float(), jl, tm.cfg.vocab)
    js = np.asarray(jc["ssm"])
    np.testing.assert_allclose(tc["ssm"].numpy(), js, atol=5e-2 * np.abs(js).max(), rtol=0)
    assert int(tc["length"]) == int(jc["length"]) == 15


def test_stepwise_decode_matches_full_forward():
    """Prefill 6 tokens, then 10 S=1 steps: each step's logits against the
    full forward's at that position (5% of the logit scale; no bitwise
    claim, the chunked SSD reassociates)."""
    _, tm = tiny(seed=2)
    toks = torch.from_numpy(tokens(4, 2, 16))
    full = tm.apply(toks).float()
    logits, cache = tm.prefill(toks[:, :6])
    got = [logits.float()]
    for t in range(6, 16):
        logits, cache = tm.decode_step(cache, toks[:, t:t + 1])
        got.append(logits.float())
    got = torch.cat(got, 1)[..., :tm.cfg.vocab]
    want = full[..., :tm.cfg.vocab]
    tol = 5e-2 * want.abs().max().item()
    torch.testing.assert_close(got, want, atol=tol, rtol=0)


def test_chunked_admission_equals_solo_generate_with_no_pages():
    """A 12-token prompt in chunks of 5 (5 + 5 + 2) threads the conv tail
    and the SSD state across chunks and gives solo ``generate``'s tokens;
    the allocator holds no pages (the JAX ``test_paged_parity_ssm_chunked``)."""
    cfg, model = tiny()
    P, N = 12, 5
    prompt = np.random.default_rng(5).integers(0, cfg.vocab, size=P).astype(np.int32)
    ref = generate(model, torch.from_numpy(prompt)[None], N, seq_len=P + N)[0].numpy()
    sched = DecodeScheduler(model, n_slots=2, max_seq=P + N, page_size=4, prefill_chunk=5,
                            device="cpu")
    before = ssd_scan_kernel.launches
    got = run_all(sched, {0: [("s", "r0", prompt, N)]}, audit=True)
    assert ssd_scan_kernel.launches == before              # CPU: plain version only
    np.testing.assert_array_equal(got[0], ref)
    assert sched.allocator.n_pages == 0 and sched.n_pages == 0
    assert sched.stats()["prefill_chunks"] == 3
    assert "kp" not in sched.cache and "vp" not in sched.cache
    st = sched.kv_memory_stats()
    assert st["kv_bytes_per_token"] == st["kv_pool_bytes"] == st["kv_pages_high_water"] == 0


def test_reused_slot_and_staggered_admissions_equal_solo():
    """Three requests admitted at different steps over 2 slots, prefilled in
    chunks of 5, so the third takes a slot another request used: each
    equals its solo ``generate`` token for token (a stale SSD or conv row in
    the reused slot would not), with ``audit()`` every step."""
    cfg, model = tiny()
    prompts, submits = staggered(cfg, 3, lengths=(6, 12, 20), max_new=5)
    max_seq, N = 28, 5
    solo = {i: generate(model, torch.from_numpy(p)[None], N, seq_len=max_seq)[0].numpy()
            for i, p in enumerate(prompts)}
    sched = DecodeScheduler(model, n_slots=2, max_seq=max_seq, page_size=4, prefill_chunk=5,
                            device="cpu")
    got = run_all(sched, submits, audit=True)
    assert sched.admitted == 3 > sched.n_slots and sorted(got) == [0, 1, 2]
    for i in range(3):
        np.testing.assert_array_equal(got[i], solo[i], err_msg=f"r{i} != solo")


def test_scheduler_matches_jax_scheduler_teacher_forced():
    """The port's scheduler, teacher-forced on the JAX scheduler's token
    stream, gives logits that agree with the JAX model's on that stream."""
    jm, jp, tm = jax_and_port()
    prompts, submits = staggered(tm.cfg, 11, lengths=(7, 12, 17), max_new=5)
    kw = dict(n_slots=3, max_seq=24, page_size=8, prefill_chunk=5)
    jax_sched = JaxDecodeScheduler(jm, jp, **kw)
    jax_tokens = {f"r{k}": v for k, v in run_all(jax_sched, submits).items()}
    assert jax_sched.allocator.n_pages == 0
    want = {}
    step = jax.jit(jm.decode_step)
    prefill = jax.jit(lambda pp, t: jm.prefill(pp, t, seq_len=24))
    for i, p in enumerate(prompts):
        rid = f"r{i}"
        logits, cache = prefill(jp, jnp.asarray(p)[None])
        for idx, tok in enumerate(jax_tokens[rid]):
            want[(rid, idx)] = np.asarray(logits[0, -1], np.float32)
            logits, cache = step(jp, cache, jnp.asarray([[tok]], jnp.int32))
    sched = ForcedScheduler(tm, jax_tokens, device="cpu", **kw)
    got = {f"r{k}": v for k, v in run_all(sched, submits, audit=True).items()}
    for rid, toks in jax_tokens.items():
        np.testing.assert_array_equal(got[rid], toks)      # the forcing held
    assert sched.logits.keys() == want.keys()
    for key, w in want.items():
        assert_logits_agree(sched.logits[key], w, tm.cfg.vocab)


def test_paged_kernel_backend_raises_and_max_new_clamps_to_max_seq():
    """No attention layers, so no paged-kernel backend (the JAX scheduler
    raises too); the budget is bounded by the output ring alone (the JAX
    ``test_serving_scheduler`` clamp case)."""
    _, model = tiny()
    with pytest.raises(ValueError, match="SSM decode has no KV pool"):
        DecodeScheduler(model, attn_backend="paged_kernel", device="cpu")
    sched = DecodeScheduler(model, n_slots=2, max_seq=12, device="cpu")
    sched.submit("s0", "r0", np.zeros(8, np.int32), max_new=999)
    assert sched.slots[0].req.max_new == 12
    sched.submit("s1", "r1", np.zeros(20, np.int32), max_new=3)   # longer than max_seq
    assert sched.pending == [] and sched.slots[1].req.max_new == 3


def test_slot_surgery_masks_clears_and_writes_back_ssm_rows():
    cfg, model = tiny()
    cache = kvcache.paged_cache(model, 3, page_size=4, n_pages=6, max_pages=2)
    assert set(cache) == {"page_table", "length", "ssm", "conv"}
    assert cache["ssm"].shape == (4, 3, 8, 16, 16) and cache["ssm"].dtype == torch.float32
    assert cache["conv"].shape == (4, 3, 3, 160) and cache["conv"].dtype == torch.bfloat16
    assert kvcache.kv_bytes_per_token(cache) == 0
    new = dict(cache, ssm=torch.ones_like(cache["ssm"]), conv=torch.ones_like(cache["conv"]),
               length=cache["length"] + 1)
    out = kvcache.mask_slot_rows(new, cache, torch.tensor([True, False, True]))
    assert out["ssm"][:, 1].eq(0).all() and out["ssm"][:, [0, 2]].eq(1).all()
    assert out["conv"][:, 1].eq(0).all() and out["length"].tolist() == [1, 0, 1]
    one = kvcache.cache_slot_view(out, 2)
    assert set(one) == {"page_table", "length", "ssm", "conv"}
    assert one["ssm"].shape == (4, 1, 8, 16, 16)
    one = dict(one, ssm=one["ssm"] + 1, conv=one["conv"] + 1, length=one["length"] + 3)
    kvcache.cache_insert_slot(out, one, 2)
    assert out["ssm"][:, 2].eq(2).all() and out["conv"][:, 2].eq(2).all()
    assert out["length"].tolist() == [1, 0, 4]
    kvcache.cache_clear_slot(out, 0)
    assert out["ssm"][:, 0].eq(0).all() and out["conv"][:, 0].eq(0).all()
    assert out["ssm"][:, 2].eq(2).all()


def test_weights_round_trip_keeps_ssd_parameters_fp32():
    """JAX tree -> port -> numpy gives the bf16-rounded tree with the fp32
    leaves (A_log, dt_bias, D, both norm scales) exact, and port -> numpy ->
    port is exact."""
    _, jp, tm = jax_and_port()
    tree = jax.tree_util.tree_map(np.asarray, jp)
    back = params_to_numpy(tm.state_dict(), tm.cfg)
    flat_t = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_t) == len(flat_b) == 8 + 1 + 2 + 1   # ssm, norm, embed+head, final
    fp32 = {f"['layers']['{g}']['{n}']" for g, n in FP32_PARAMS}
    for path, a in flat_t:
        name = jax.tree_util.keystr(path)
        expect = a if name in fp32 else \
            np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(flat_b[path], expect, err_msg=name)
    sd = params_from_jax(back, tm.cfg, "cpu")
    for k, v in tm.state_dict().items():
        assert torch.equal(sd[k], v) and sd[k].dtype == v.dtype, k
    for g, n in FP32_PARAMS:
        assert sd[f"layers.3.{g}.{n}"].dtype == torch.float32, (g, n)
    for n in ("in_proj", "conv_w", "conv_b", "out_proj"):
        assert sd[f"layers.3.ssm.{n}"].dtype == torch.bfloat16, n
    assert sd["embedding.head"].dtype == torch.bfloat16


def test_run_serving_end_to_end_on_cpu():
    fe = run_serving(ARCH, 6, max_new=4, prompt_len=10, sessions=2, batch_size=3,
                     prefill_chunk=4, quiet=True, device="cpu")
    assert sum(len(v) for v in fe.completions.values()) == 6
    for ids in fe.completions.values():
        assert ids == sorted(ids, key=lambda r: int(r[1:]))
    st = fe.serving_stats()
    assert st["completed"] == 6 and st["kv_pages"] == 0 and st["kv_bytes_per_token"] == 0
    fe.scheduler.audit()


def test_full_size_config_is_mamba2_1p3b():
    cfg = configs.get(ARCH)
    s = cfg.ssm
    assert (cfg.n_layers, cfg.d_model, s.d_inner(cfg.d_model), s.n_heads(cfg.d_model),
            s.head_dim, s.d_state, s.d_conv, s.chunk) == (48, 2048, 4096, 64, 64, 128, 4, 256)
    assert (cfg.vocab, cfg.padded_vocab, cfg.tie_embeddings) == (50280, 50432, False)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jconfigs.get(ARCH))
    assert cfg.param_count() == jconfigs.get(ARCH).param_count() == 1_446_402_048
    tm = build_model(cfg.reduced(), device="cpu")
    assert tm.n_kv_layers == 0 and tm.cache_len(100) == 0
