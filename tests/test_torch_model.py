"""``DenseLM`` in the port against the JAX ``DenseLM`` on the same weights.

Weights come from the JAX package's ``model.init(key)`` and reach the port
through ``params_from_jax`` as numpy arrays.  Logit tolerance: 2.5% of the
largest logit magnitude.  Both frameworks run the same bf16 recipe, but
their matmuls accumulate in different orders, so activations differ by a
bf16 step here and there and that compounds over the layers (measured
about 1.2% on reduced qwen3-14b).  Argmax must agree wherever the JAX top-2
margin exceeds twice that tolerance.
"""

from __future__ import annotations

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model as jax_build_model
from repro.models import kvcache as jkv
from repro.serve.engine import make_chunk_step as jax_make_chunk_step
from repro_torch import configs
from repro_torch.models import ArchConfig, build_model, kvcache
from repro_torch.serve.engine import make_chunk_step
from repro_torch.weights import params_from_jax, params_to_numpy

torch.set_num_threads(2)

REL_TOL = 2.5e-2


def jax_and_port(arch, **over):
    """(jax model, jax params, port model) on the same weights."""
    jcfg = dataclasses.replace(jconfigs.get(arch).reduced(), **over)
    tcfg = dataclasses.replace(configs.get(arch).reduced(), **over)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.key(0))
    tm = build_model(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu"))
    return jm, jp, tm


def assert_logits_agree(got, want, vocab):
    """Within REL_TOL of the logit scale; argmax equal where JAX is decisive."""
    got = np.asarray(got, np.float32)[..., :vocab]
    want = np.asarray(want, np.float32)[..., :vocab]
    tol = REL_TOL * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    top2 = np.sort(want, axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > 2 * tol
    np.testing.assert_array_equal(got.argmax(-1)[decisive], want.argmax(-1)[decisive])
    return tol


@pytest.mark.parametrize("arch", ["minicpm-2b", "qwen3-14b", "qwen1.5-110b",
                                  "starcoder2-3b"])
def test_apply_logits_match_jax(arch):
    jm, jp, tm = jax_and_port(arch)
    toks = np.random.default_rng(0).integers(0, tm.cfg.vocab, size=(2, 12)).astype(np.int32)
    want = jm.apply(jp, {"tokens": jnp.asarray(toks)})
    got = tm.apply(torch.from_numpy(toks))
    assert got.shape == (2, 12, tm.cfg.padded_vocab) and got.dtype == torch.bfloat16
    assert_logits_agree(got.float(), want, tm.cfg.vocab)


def _jax_paged(jm, B, page_size, n_pages, max_pages, rows):
    cache = jkv.paged_cache(jm, B, page_size=page_size, n_pages=n_pages,
                            max_pages=max_pages)
    for b, row in enumerate(rows):
        cache = jkv.set_page_row(cache, b, row)
    return cache


def _port_paged(tm, B, page_size, n_pages, max_pages, rows):
    cache = kvcache.paged_cache(tm, B, page_size=page_size, n_pages=n_pages,
                                max_pages=max_pages)
    for b, row in enumerate(rows):
        kvcache.set_page_row(cache, b, row)
    return cache


@pytest.mark.parametrize("arch", ["minicpm-2b", "qwen3-14b"])
def test_paged_decode_step_matches_jax(arch):
    """Two slots on scrambled page tables, prompts prefilled in chunks, then
    one batched S=1 decode step: the port's gather and paged-kernel
    backends against the JAX gather path."""
    jm, jp, tm = jax_and_port(arch)
    ps, n_pages, mp = 4, 12, 5
    rows = [np.asarray([7, 2, 9, 4, 0], np.int32), np.asarray([3, 11, 5, -1, -1], np.int32)]
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, tm.cfg.vocab, size=n).astype(np.int32) for n in (13, 9)]
    jc = _jax_paged(jm, 2, ps, n_pages, mp, rows)
    tc = _port_paged(tm, 2, ps, n_pages, mp, rows)
    jchunk, tchunk = jax.jit(jax_make_chunk_step(jm)), make_chunk_step(tm)
    for b, p in enumerate(prompts):
        for lo in range(0, len(p), 5):
            piece = p[lo:lo + 5][None]
            _, jc = jchunk(jp, jc, jnp.asarray(piece), b)
            _, tc = tchunk(tc, torch.from_numpy(piece), b)
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


def test_generate_matches_jax_teacher_forced():
    """Ring-cache prefill + S=1 decode, fed the JAX greedy stream: per-step
    logits agree with the JAX model's on the same stream."""
    jm, jp, tm = jax_and_port("qwen3-14b")
    prompt = np.random.default_rng(2).integers(0, tm.cfg.vocab, size=(2, 9)).astype(np.int32)
    seq_len, steps = 16, 6
    jprefill = jax.jit(lambda p, t: jm.prefill(p, t, seq_len=seq_len))
    jstep = jax.jit(jm.decode_step)
    jl, jc = jprefill(jp, jnp.asarray(prompt))
    tl, tc = tm.prefill(torch.from_numpy(prompt), seq_len=seq_len)
    for _ in range(steps):
        assert_logits_agree(tl[:, -1].float(), jl[:, -1], tm.cfg.vocab)
        tok = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
        jl, jc = jstep(jp, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tc, torch.from_numpy(tok))
    assert int(tc["length"]) == 9 + steps


def _one_slot(tm, n_pages, ps):
    cache = kvcache.paged_cache(tm, 1, page_size=ps, n_pages=n_pages, max_pages=n_pages)
    cache["page_table"][0] = torch.arange(n_pages, dtype=torch.int32)
    return cache


@pytest.mark.parametrize("arch,window", [("minicpm-2b", None), ("minicpm-2b", 8),
                                         ("qwen3-14b", None), ("moonshot-v1-16b-a3b", None)])
def test_decode_is_bitwise_chunked_prefill(arch, window):
    """Within the port, S=1 decode is the chunk path at S=1: the same token
    stream fed as one chunk, mixed chunks or single steps leaves bitwise
    identical pool bytes and per-position logits (the JAX package's plain
    minicpm-2b case of this property fails on its own tree, so it is held
    port-internally only)."""
    cfg = configs.get(arch).reduced()
    if window:
        cfg = dataclasses.replace(cfg, sliding_window=window)
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
    for logits, cache in results[1:]:
        assert torch.equal(logits, logits0)
        assert torch.equal(cache["kp"][:, :4], cache0["kp"][:, :4])
        assert torch.equal(cache["vp"][:, :4], cache0["vp"][:, :4])


def test_weights_round_trip():
    """JAX tree -> port -> numpy gives the bf16-rounded tree (fp32 for the
    qk-norm scales), and port -> numpy -> port is exact."""
    jm, jp, tm = jax_and_port("qwen3-14b")
    tree = jax.tree_util.tree_map(np.asarray, jp)
    back = params_to_numpy(tm.state_dict(), tm.cfg)
    flat_t = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_t) == len(flat_b)
    for path, a in flat_t:
        b = flat_b[path]
        name = jax.tree_util.keystr(path)
        expect = a if ("q_norm" in name or "k_norm" in name) else \
            np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(b, expect, err_msg=name)
    sd = params_from_jax(back, tm.cfg, "cpu")
    for k, v in tm.state_dict().items():
        assert torch.equal(sd[k], v) and sd[k].dtype == v.dtype, k
    assert sd["layers.0.attn.q_norm"].dtype == torch.float32
    assert sd["layers.0.attn.wq"].dtype == torch.bfloat16


def test_unported_families_and_archs_raise():
    """Every architecture of the JAX package resolves in the port, as an
    equal dataclass at full size and reduced; only an unknown family or
    arch raises."""
    assert sorted(configs.list_archs()) == sorted(jconfigs.list_archs())
    assert len(configs.list_archs()) == 10
    for arch in configs.list_archs():
        tcfg, jcfg = configs.get(arch), jconfigs.get(arch)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert dataclasses.asdict(tcfg.reduced()) == dataclasses.asdict(jcfg.reduced())
        assert tcfg.padded_vocab == jcfg.padded_vocab
    cfg = ArchConfig(name="m", family="speech", n_layers=1, d_model=8, n_heads=2,
                     n_kv_heads=2, d_ff=8, vocab=16)
    with pytest.raises(ValueError, match="unknown family"):
        build_model(cfg, device="cpu")
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get("whisper-large")


def _norm_and_bias_count(model) -> int:
    """Parameters ``param_count`` leaves out: norm scales and biases (qk-norm
    too), MLP and qkv biases, the vocabulary's padding rows, and a VLM's
    projector."""
    cfg = model.cfg
    left = 0
    for name, p in model.named_parameters():
        leaf = name.split(".")[-1]
        if leaf in ("scale", "bias", "b_up", "b_down", "bq", "bk", "bv", "q_norm", "k_norm") or \
                name.startswith("patch_proj."):
            left += p.numel()
    n_tables = 1 if cfg.tie_embeddings else 2
    return left + n_tables * (cfg.padded_vocab - cfg.vocab) * cfg.d_model


@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-2b", "minicpm-2b", "qwen3-14b",
                                  "starcoder2-3b"])
def test_param_count_matches_jax_and_the_built_model(arch):
    """``param_count`` equals the JAX package's for every full config, and a
    built model (whisper-base at full size, the others reduced) holds the
    count plus the norms, biases and padding it leaves out."""
    for name in configs.list_archs():
        assert configs.get(name).param_count() == jconfigs.get(name).param_count(), name
    cfg = configs.get(arch)
    if arch != "whisper-base":
        cfg = cfg.reduced()
    model = build_model(cfg, device="cpu")
    built = sum(p.numel() for p in model.parameters())
    assert built == cfg.param_count() + _norm_and_bias_count(model)


def test_full_size_config_is_minicpm_2b():
    cfg = configs.get("minicpm-2b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff) == \
        (40, 2304, 36, 36, 5760)
    assert cfg.padded_vocab == 122880 and cfg.tie_embeddings
    assert abs(cfg.param_count() - 2.7245e9) < 1e6
    # 40 layers x (K + V) x 36 heads x 64 x 2 bytes = 360 KiB of KV per token
    assert 40 * 2 * 36 * 64 * 2 == 360 * 1024


def test_entry_points_default_to_cuda():
    """No silent CPU fallback: the default device is ``cuda``, which fails
    where there is no card."""
    cfg = configs.get("minicpm-2b").reduced()
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            build_model(cfg)
