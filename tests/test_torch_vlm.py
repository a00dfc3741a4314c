"""``VisionLM`` (internvl2) in the port against the JAX ``VisionLM`` on the
same weights.

Weights come from the JAX package's ``model.init(jax.random.key(0))``
through ``params_from_jax``; patch embeddings and tokens from a numpy seed.
Logits are held to ``REL_TOL`` (2.5%) of the largest logit, with argmax
equal wherever the JAX top-2 margin exceeds twice that.  Text-only prefill
is ``DenseLM.prefill``: an aligned prefill of 4096 tokens or more goes to
the flash kernel's entry point, which on the CPU runs its plain streaming
version.  The card case (the flash kernel at internvl2-2b's GQA group,
G = 2 at D = 128) carries the ``gpu`` marker and skips here; on the card,
which has no JAX, it runs alone with ``pytest -m gpu``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels.flash_attention import flash_attention_kernel, flash_attention_plain
from repro_torch.kernels.flash_attention.ref import bf16_rounding_bound
from repro_torch.models import build_model, layers
from repro_torch.models.transformer import DenseLM

try:    # the card's machine has no JAX: there only the gpu-marked test runs
    import jax
    import jax.numpy as jnp

    from repro.serve.engine import generate as jax_generate
    from repro_torch.core import SimCloud
    from repro_torch.launch.serve import build_frontend, run_serving, spawn_workload
    from repro_torch.serve.engine import generate
    from repro_torch.serve.scheduler import DecodeScheduler
    from repro_torch.weights import params_from_jax, params_to_numpy
    from test_torch_model import assert_logits_agree, jax_and_port
    from test_torch_whisper import assert_served_agree, served_tokens
except ModuleNotFoundError:
    jax = None

needs_jax = pytest.mark.skipif(jax is None, reason="the JAX reference is not installed")

torch.set_num_threads(2)

ARCH = "internvl2-2b"


@pytest.fixture(scope="module")
def models():
    return jax_and_port(ARCH)


def _inputs(seed, cfg, B=2, S=12, P=None):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    patches = rng.standard_normal((B, P or cfg.vlm.n_patches,
                                   cfg.vlm.patch_dim)).astype(np.float32)
    return toks, patches


@needs_jax
@pytest.mark.parametrize("with_patches", [True, False])
def test_apply_logits_match_jax(models, with_patches):
    """Logits over the text positions only, with and without the image
    prefix."""
    jm, jp, tm = models
    toks, patches = _inputs(0, tm.cfg)
    batch = {"tokens": jnp.asarray(toks)}
    extra = ()
    if with_patches:
        batch["patch_embeds"] = jnp.asarray(patches)
        extra = (torch.from_numpy(patches),)
    want = jm.apply(jp, batch)
    got = tm.apply(torch.from_numpy(toks), *extra)
    assert got.shape == (2, 12, tm.cfg.padded_vocab) and got.dtype == torch.bfloat16
    assert_logits_agree(got.float(), want, tm.cfg.vocab)


@needs_jax
def test_text_prefill_is_the_dense_backbone_bitwise(models):
    _, _, tm = models
    dense = DenseLM(tm.cfg, device="cpu")
    sd = {k: v for k, v in tm.state_dict().items() if not k.startswith("patch_proj.")}
    dense.load_state_dict(sd)
    toks, _ = _inputs(1, tm.cfg)
    la, ca = tm.prefill(torch.from_numpy(toks), seq_len=20)
    lb, cb = dense.prefill(torch.from_numpy(toks), seq_len=20)
    assert torch.equal(la, lb)
    assert ca.keys() == cb.keys() and all(torch.equal(ca[k], cb[k]) for k in ca)
    assert torch.equal(tm.apply(torch.from_numpy(toks)), dense.apply(torch.from_numpy(toks)))


@needs_jax
def test_prefill_with_patches_and_decode_match_jax_teacher_forced(models):
    """The ring holds the image prefix plus ``seq_len`` text positions;
    then 8 decode steps of tokens drawn from a seed."""
    jm, jp, tm = models
    toks, patches = _inputs(2, tm.cfg, S=9)
    seq_len = 17
    jl, jc = jax.jit(lambda p, t, e: jm.prefill(p, t, e, seq_len=seq_len))(
        jp, jnp.asarray(toks), jnp.asarray(patches))
    tl, tc = tm.prefill(torch.from_numpy(toks), torch.from_numpy(patches), seq_len=seq_len)
    n_p = tm.cfg.vlm.n_patches
    assert tl.shape == (2, 9, tm.cfg.padded_vocab)
    assert tc["k"].shape[2] == n_p + seq_len and int(tc["length"]) == n_p + 9
    assert_logits_agree(tl.float(), jl, tm.cfg.vocab)
    jstep = jax.jit(jm.decode_step)
    feed = np.random.default_rng(3).integers(0, tm.cfg.vocab, size=(8, 2, 1)).astype(np.int32)
    for tok in feed:
        jl, jc = jstep(jp, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tc, torch.from_numpy(tok))
        assert_logits_agree(tl.float(), jl, tm.cfg.vocab)
    assert int(tc["length"]) == n_p + seq_len


@needs_jax
def test_generate_with_patches_matches_jax(models):
    jm, jp, tm = models
    toks, patches = _inputs(4, tm.cfg, S=5)
    n, seq_len = 10, 15
    want = np.asarray(jax_generate(jm, jp, jnp.asarray(toks), n, jnp.asarray(patches),
                                   seq_len=seq_len))
    got = generate(tm, torch.from_numpy(toks), n, torch.from_numpy(patches),
                   seq_len=seq_len).numpy()
    assert got.shape == want.shape == (2, n)
    ctx = np.concatenate([toks, want[:, :-1]], axis=1)
    jl = jm.apply(jp, {"tokens": jnp.asarray(ctx), "patch_embeds": jnp.asarray(patches)})
    tl = tm.apply(torch.from_numpy(ctx), torch.from_numpy(patches))
    P = toks.shape[1]
    tol = assert_logits_agree(tl[:, P - 1:].float(), jl[:, P - 1:], tm.cfg.vocab)
    top2 = np.sort(np.asarray(jl, np.float32)[:, P - 1:, :tm.cfg.vocab], -1)[..., -2:]
    for b in range(2):
        tied = np.flatnonzero(top2[b, :, 1] - top2[b, :, 0] <= 2 * tol)
        upto = tied[0] if tied.size else n
        np.testing.assert_array_equal(got[b, :upto], want[b, :upto])


@needs_jax
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
    assert set(back["patch_proj"]) == {"norm", "w", "w2"}
    assert set(back["patch_proj"]["norm"]) == {"scale", "bias"}


@needs_jax
def test_scheduler_refuses_the_family(models):
    with pytest.raises(ValueError, match="no per-slot decode path"):
        DecodeScheduler(models[2], n_slots=2, max_seq=16, device="cpu")


@needs_jax
def test_whole_batch_fallback_on_cpu():
    fe = run_serving(ARCH, n_requests=6, max_new=3, sessions=2, batch_size=3, quiet=True,
                     device="cpu")
    assert fe.scheduler is None and fe.mode == "shared"
    assert sum(len(v) for v in fe.completions.values()) == 6
    for ids in fe.completions.values():
        assert ids == sorted(ids, key=lambda r: int(r[1:]))
    with pytest.raises(ValueError, match="continuous scheduler"):
        run_serving(ARCH, n_requests=2, max_new=3, sessions=1, temperature=0.8, quiet=True,
                    device="cpu")


@needs_jax
def test_served_tokens_agree_with_jax_run_serving(models):
    """Text-only whole-batch serving on the JAX weights serves what the JAX
    ``run_serving`` serves (no patches on the serving path, as there)."""
    from repro.launch.serve import run_serving as jax_run_serving

    jm, jp, tm = models
    kw = dict(n_requests=6, sessions=2, prompt_len=6, max_new=5)
    jfe = jax_run_serving(ARCH, batch_size=3, quiet=True, max_new=kw["max_new"],
                          n_requests=kw["n_requests"], sessions=kw["sessions"],
                          prompt_len=kw["prompt_len"])
    cloud = SimCloud(seed=0)
    fe = build_frontend(cloud, tm.cfg, tm, mode="continuous", batch_size=3,
                        max_new=kw["max_new"], prompt_len=kw["prompt_len"], device="cpu")
    spawn_workload(cloud, fe, vocab=tm.cfg.vocab, **kw)
    cloud.run()
    assert fe.mode == "shared" and fe.completions == jfe.completions
    rng = np.random.default_rng(0)
    prompts = {f"r{i}": rng.integers(0, tm.cfg.vocab, size=kw["prompt_len"]).astype(np.int32)
               for i in range(kw["n_requests"])}
    assert_served_agree(jm, jp, tm, served_tokens(fe), served_tokens(jfe), prompts)


@needs_jax
def test_aligned_prefill_of_4096_tokens_takes_the_flash_entry_and_matches_jax(monkeypatch):
    """Text-only prefill at the flash threshold: on the CPU the flash entry
    point runs its plain streaming version (no launch is counted) and the
    logits agree with the JAX model's, which streams the same softmax in
    XLA.  One layer keeps it inside seconds."""
    jm, jp, tm = jax_and_port(ARCH, n_layers=1)
    S = layers.STREAM_KV_THRESHOLD
    assert layers.takes_flash(S, True) and not layers.takes_flash(S - 1, True)
    toks = np.random.default_rng(5).integers(0, tm.cfg.vocab, size=(1, S)).astype(np.int32)
    calls = []
    real = layers.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(layers, "flash_attention", spy)
    n0 = flash_attention_kernel.launches
    tl, _ = tm.prefill(torch.from_numpy(toks), seq_len=S + 4)
    assert calls == [(1, S, tm.cfg.n_heads, tm.cfg.the_head_dim())]
    assert flash_attention_kernel.launches == n0
    jl, _ = jax.jit(lambda p, t: jm.prefill(p, t, seq_len=S + 4))(jp, jnp.asarray(toks))
    assert_logits_agree(tl.float(), jl, tm.cfg.vocab)


def test_full_size_config_is_internvl2_2b():
    cfg = configs.get(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.the_head_dim(),
            cfg.d_ff, cfg.vocab) == (24, 2048, 16, 8, 128, 8192, 92553)
    assert (cfg.vlm.n_patches, cfg.vlm.patch_dim) == (256, 1024)
    assert cfg.param_count() == 1_889_046_528
    small = dataclasses.replace(cfg.reduced(), n_layers=1)
    assert build_model(small, device="cpu").cfg.family == "vlm"


@pytest.mark.gpu
def test_cuda_flash_at_internvl2_group():
    """The flash kernel at internvl2-2b's heads (16 over 8 kv heads of 128,
    G = 2), bf16 on the tensor-core route, against the bf16 plain version at
    3e-2 and the fp32 plain version within the bound of its roundings."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    cfg = configs.get(ARCH)
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.the_head_dim()
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(1, 1100, h, D, generator=gen, device="cuda").to(torch.bfloat16)
               for h in (H, Hkv, Hkv))
    n0 = flash_attention_kernel.launches_by_route["tensor_core"]
    got = flash_attention_kernel(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches_by_route["tensor_core"] == n0 + 1
    torch.testing.assert_close(got.float(), flash_attention_plain(q, k, v).float(),
                               atol=3e-2, rtol=3e-2)
    want32, bound = bf16_rounding_bound(q, k, v)
    assert ((got.float() - want32).abs() <= bound).all()
