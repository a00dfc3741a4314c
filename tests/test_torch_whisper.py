"""``EncDecLM`` (whisper) in the port against the JAX ``EncDecLM`` on the
same weights.

Weights come from the JAX package's ``model.init(jax.random.key(0))``
through ``params_from_jax``; frames and tokens from a numpy seed.  Logits
are held to ``REL_TOL`` (2.5%) of the largest logit, with argmax equal
wherever the JAX top-2 margin exceeds twice that
(``test_torch_model.assert_logits_agree``).  The family has no per-slot
decode path, so serving takes the whole-batch flavour, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.serve import run_serving as jax_run_serving
from repro.serve.engine import generate as jax_generate
from repro_torch import configs
from repro_torch.core import SimCloud
from repro_torch.launch.serve import build_frontend, run_serving, spawn_workload
from repro_torch.models import build_model
from repro_torch.serve.engine import generate
from repro_torch.serve.scheduler import DecodeScheduler
from repro_torch.weights import params_from_jax, params_to_numpy
from test_torch_model import REL_TOL, assert_logits_agree, jax_and_port

torch.set_num_threads(2)

ARCH = "whisper-base"


@pytest.fixture(scope="module")
def models():
    return jax_and_port(ARCH)


def _inputs(seed, cfg, B=2, S=12, F=None):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    frames = rng.standard_normal((B, F or cfg.encdec.n_frames, cfg.d_model)).astype(np.float32)
    return toks, frames


def test_encode_matches_jax(models):
    jm, jp, tm = models
    _, frames = _inputs(0, tm.cfg)
    want = np.asarray(jm.encode(jp, jnp.asarray(frames)).astype(jnp.float32))
    got = tm.encode(torch.from_numpy(frames))
    assert got.shape == frames.shape and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=REL_TOL * np.abs(want).max(),
                               rtol=0)


def test_apply_logits_match_jax(models):
    jm, jp, tm = models
    toks, frames = _inputs(1, tm.cfg)
    want = jm.apply(jp, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)})
    got = tm.apply(torch.from_numpy(toks), torch.from_numpy(frames))
    assert got.shape == (2, 12, tm.cfg.padded_vocab) and got.dtype == torch.bfloat16
    assert_logits_agree(got.float(), want, tm.cfg.vocab)


def _teacher_forced(jm, jp, tm, toks, frames, seq_len, steps, seed):
    """Prefill both models, then feed both ``steps`` tokens drawn from a
    seed; every step's logits must agree.  Returns the port's cache."""
    jl, jc = jax.jit(lambda p, t, f: jm.prefill(p, t, f, seq_len=seq_len))(
        jp, jnp.asarray(toks), jnp.asarray(frames))
    tl, tc = tm.prefill(torch.from_numpy(toks), torch.from_numpy(frames), seq_len=seq_len)
    assert_logits_agree(tl.float(), jl, tm.cfg.vocab)
    jstep = jax.jit(jm.decode_step)
    feed = np.random.default_rng(seed).integers(0, tm.cfg.vocab,
                                                size=(steps, toks.shape[0], 1)).astype(np.int32)
    for tok in feed:
        jl, jc = jstep(jp, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tc, torch.from_numpy(tok))
        assert_logits_agree(tl.float(), jl, tm.cfg.vocab)
    return tc


def test_prefill_and_decode_match_jax_teacher_forced(models):
    """``prefill(tokens, frames, seq_len=)`` then 8 decode steps on a ring
    that never wraps; the cross-attention k/v sit in the cache."""
    jm, jp, tm = models
    toks, frames = _inputs(2, tm.cfg, S=9)
    tc = _teacher_forced(jm, jp, tm, toks, frames, seq_len=17, steps=8, seed=3)
    cfg = tm.cfg
    assert int(tc["length"]) == 17
    assert tc["xk"].shape == (cfg.n_layers, 2, cfg.encdec.n_frames, cfg.n_kv_heads,
                              cfg.the_head_dim())
    assert tc["k"].shape[2] == 17


def test_ring_wrap_prompt_longer_than_ring(models):
    """S larger than the ring: the prefill attends its fresh k/v and keeps
    the trailing window, and decode runs on the wrapped ring."""
    jm, jp, tm = models
    toks, frames = _inputs(4, tm.cfg, S=12)
    tc = _teacher_forced(jm, jp, tm, toks, frames, seq_len=8, steps=4, seed=5)
    assert tc["k"].shape[2] == 8
    assert sorted(tc["positions"][0, 0].tolist()) == list(range(8, 16))


def test_prefill_without_frames_encodes_zero_frames(models):
    _, _, tm = models
    toks, _ = _inputs(6, tm.cfg)
    zeros = torch.zeros(2, tm.cfg.encdec.n_frames, tm.cfg.d_model)
    la, ca = tm.prefill(torch.from_numpy(toks), seq_len=16)
    lb, cb = tm.prefill(torch.from_numpy(toks), zeros, seq_len=16)
    assert torch.equal(la, lb)
    assert ca.keys() == cb.keys() and all(torch.equal(ca[k], cb[k]) for k in ca)


def test_generate_with_frames_matches_jax(models):
    """Greedy ``generate`` with frames: the port teacher-forced on the JAX
    stream agrees step by step, and its own stream is the JAX stream up
    to the first near-tie JAX sees."""
    jm, jp, tm = models
    toks, frames = _inputs(7, tm.cfg, S=5)
    n, seq_len = 10, 15
    want = np.asarray(jax_generate(jm, jp, jnp.asarray(toks), n, jnp.asarray(frames),
                                   seq_len=seq_len))
    got = generate(tm, torch.from_numpy(toks), n, torch.from_numpy(frames),
                   seq_len=seq_len).numpy()
    assert got.shape == want.shape == (2, n)
    ctx = np.concatenate([toks, want[:, :-1]], axis=1)
    jl = jm.apply(jp, {"tokens": jnp.asarray(ctx), "frames": jnp.asarray(frames)})
    tl = tm.apply(torch.from_numpy(ctx), torch.from_numpy(frames))
    tol = assert_logits_agree(tl[:, toks.shape[1] - 1:].float(), jl[:, toks.shape[1] - 1:],
                              tm.cfg.vocab)
    top2 = np.sort(np.asarray(jl, np.float32)[:, toks.shape[1] - 1:, :tm.cfg.vocab], -1)[..., -2:]
    for b in range(2):
        tied = np.flatnonzero(top2[b, :, 1] - top2[b, :, 0] <= 2 * tol)
        upto = tied[0] if tied.size else n
        np.testing.assert_array_equal(got[b, :upto], want[b, :upto])


def test_weights_round_trip(models):
    jm, jp, tm = models
    tree = jax.tree_util.tree_map(np.asarray, jp)
    back = params_to_numpy(tm.state_dict(), tm.cfg)
    flat_t = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_t) == len(flat_b)
    for path, a in flat_t:
        expect = np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(flat_b[path], expect, err_msg=jax.tree_util.keystr(path))
    sd = params_from_jax(back, tm.cfg, "cpu")
    for k, v in tm.state_dict().items():
        assert torch.equal(sd[k], v) and sd[k].dtype == torch.bfloat16, k
    assert back["enc_layers"]["attn"]["wq"].shape[0] == tm.cfg.encdec.n_encoder_layers
    assert "xattn" in back["layers"] and "enc_norm" in back


def test_scheduler_refuses_the_family(models):
    with pytest.raises(ValueError, match="no per-slot decode path"):
        DecodeScheduler(models[2], n_slots=2, max_seq=16, device="cpu")


def test_whole_batch_fallback_on_cpu():
    fe = run_serving(ARCH, n_requests=6, max_new=3, sessions=2, batch_size=3, quiet=True,
                     device="cpu")
    assert fe.scheduler is None and fe.mode == "shared"
    assert sum(len(v) for v in fe.completions.values()) == 6
    for ids in fe.completions.values():
        assert ids == sorted(ids, key=lambda r: int(r[1:]))


def test_sampling_flags_rejected_on_greedy_fallback():
    with pytest.raises(ValueError, match="continuous scheduler"):
        run_serving(ARCH, n_requests=2, max_new=3, sessions=1, temperature=0.8, quiet=True,
                    device="cpu")
    with pytest.raises(ValueError, match="continuous scheduler"):
        run_serving(ARCH, n_requests=2, max_new=3, sessions=1, top_k=5, quiet=True,
                    device="cpu")


def served_tokens(front) -> dict:
    return {rid: np.asarray(t) for sess, ids in front.completions.items()
            for rid, t in zip(ids, front.results[sess], strict=True)}


def assert_served_agree(jm, jp, tm, got, want, prompts, n_frames=None):
    """Every request's served stream equals the JAX stream up to the first
    token where the JAX model, teacher-forced on its own stream (B = 1,
    zero frames as the whole-batch path gives), has a near-tie; the port's
    logits on that stream agree with JAX's."""
    assert got.keys() == want.keys()
    for rid, w in want.items():
        ctx = np.concatenate([prompts[rid], w[:-1]]).astype(np.int32)[None]
        extra = {}
        if n_frames is not None:
            extra = {"frames": np.zeros((1, n_frames, tm.cfg.d_model), np.float32)}
        jl = jm.apply(jp, {"tokens": jnp.asarray(ctx), **{k: jnp.asarray(v)
                                                          for k, v in extra.items()}})
        tl = tm.apply(torch.from_numpy(ctx), *(torch.from_numpy(v) for v in extra.values()))
        P = len(prompts[rid])
        tol = assert_logits_agree(tl[:, P - 1:].float(), jl[:, P - 1:], tm.cfg.vocab)
        top2 = np.sort(np.asarray(jl, np.float32)[0, P - 1:, :tm.cfg.vocab], -1)[:, -2:]
        tied = np.flatnonzero(top2[:, 1] - top2[:, 0] <= 2 * tol)
        upto = tied[0] if tied.size else len(w)
        np.testing.assert_array_equal(got[rid][:upto], w[:upto], err_msg=rid)


def test_served_tokens_agree_with_jax_run_serving(models):
    """The port's whole-batch frontend on the JAX weights serves what the
    JAX ``run_serving`` serves, request for request."""
    jm, jp, tm = models
    kw = dict(n_requests=6, sessions=2, prompt_len=6, max_new=5)
    jfe = jax_run_serving(ARCH, max_new=kw["max_new"], n_requests=kw["n_requests"],
                          sessions=kw["sessions"], prompt_len=kw["prompt_len"], batch_size=3,
                          quiet=True)
    cloud = SimCloud(seed=0)
    fe = build_frontend(cloud, tm.cfg, tm, mode="continuous", batch_size=3,
                        max_new=kw["max_new"], prompt_len=kw["prompt_len"], device="cpu")
    spawn_workload(cloud, fe, vocab=tm.cfg.vocab, **kw)
    cloud.run()
    assert fe.mode == "shared" and fe.completions == jfe.completions
    rng = np.random.default_rng(0)
    prompts = {f"r{i}": rng.integers(0, tm.cfg.vocab, size=kw["prompt_len"]).astype(np.int32)
               for i in range(kw["n_requests"])}
    assert_served_agree(jm, jp, tm, served_tokens(fe), served_tokens(jfe), prompts,
                        n_frames=tm.cfg.encdec.n_frames)


def test_full_size_config_is_whisper_base():
    cfg = configs.get(ARCH)
    assert (cfg.n_layers, cfg.encdec.n_encoder_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.d_ff, cfg.vocab) == (6, 6, 512, 8, 8, 2048, 51865)
    assert cfg.encdec.n_frames == 1500 and cfg.tie_embeddings and cfg.norm == "layernorm"
    assert cfg.param_count() == 70_595_072
    small = dataclasses.replace(cfg.reduced(), n_layers=1)
    assert build_model(small, device="cpu").cfg.family == "audio"
