"""AdamW and the schedules in the port against the JAX package's
``train/optim.py``: the schedules at a sweep of steps (1e-7 relative), and
``adamw_update`` on a random tree of 1-D and 2-D leaves, with the clip
engaged and not (1e-6 relative), and on a model's leaves with the train
step's decay mask against the reference's update of its stacked tree."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.models import build_model
from repro_torch.train.optim import (AdamWConfig, adamw_init, adamw_update, cosine_schedule,
                                     global_norm, lr_at_step, wsd_schedule)
from repro_torch.train.step import decay_mask, trainable
from repro_torch.weights import params_to_numpy

try:    # the card's machine has no JAX
    import jax.numpy as jnp

    from repro.train import optim as joptim
except ModuleNotFoundError:
    jnp = None

STEPS = [0, 1, 3, 9, 10, 11, 50, 89, 90, 91, 95, 99, 100, 101, 150]
CFGS = [
    dict(lr=1.0, schedule="wsd", warmup_steps=10, total_steps=100, stable_frac=0.8,
         min_ratio=0.1),
    dict(lr=3e-4, schedule="wsd", warmup_steps=1, total_steps=6, stable_frac=0.9,
         min_ratio=0.1),
    dict(lr=3e-3, schedule="cosine", warmup_steps=10, total_steps=100),
    dict(lr=2e-3, schedule="constant", warmup_steps=5, total_steps=100),
]


@pytest.mark.parametrize("kw", CFGS, ids=lambda kw: f"{kw['schedule']}-{kw['total_steps']}")
def test_schedules_match_jax(kw):
    tc, jc = AdamWConfig(**kw), joptim.AdamWConfig(**kw)
    for s in STEPS:
        want = float(joptim.lr_at_step(jnp.asarray(float(s)), jc))
        got = float(lr_at_step(torch.tensor(float(s)), tc))
        assert got == pytest.approx(want, rel=1e-7, abs=1e-12), s
        if kw["schedule"] == "wsd":
            assert float(wsd_schedule(s, tc)) == pytest.approx(
                float(joptim.wsd_schedule(jnp.asarray(float(s)), jc)), rel=1e-7, abs=1e-12)
        if kw["schedule"] == "cosine":
            assert float(cosine_schedule(s, tc)) == pytest.approx(
                float(joptim.cosine_schedule(jnp.asarray(float(s)), jc)), rel=1e-7, abs=1e-12)


def tree(rng, scale):
    shapes = {"w": (6, 5), "b": (5,), "e": (3, 4, 2), "s": (7,)}
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0], ids=["clip-idle", "clip-engaged"])
def test_adamw_update_matches_jax(grad_scale):
    rng = np.random.default_rng(0)
    p0 = tree(rng, 1.0)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=20, weight_decay=0.1, grad_clip=1.0)
    tc, jc = AdamWConfig(**kw), joptim.AdamWConfig(**kw)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = adamw_init(tp)
    decay = {k: v.ndim >= 2 for k, v in p0.items()}    # the reference's rule on this tree
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = joptim.adamw_init(jp)
    for _ in range(4):
        g = tree(rng, grad_scale)
        gn_want = float(joptim.global_norm({k: jnp.asarray(v) for k, v in g.items()}))
        assert float(global_norm({k: torch.from_numpy(v) for k, v in g.items()})) == \
            pytest.approx(gn_want, rel=1e-6)
        ts, tm = adamw_update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp, tc,
                              decay)
        jp, js, jm = joptim.adamw_update({k: jnp.asarray(v) for k, v in g.items()}, js, jp, jc)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(ts["mu"][k].numpy(), np.asarray(js["mu"][k]),
                                       rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(ts["nu"][k].numpy(), np.asarray(js["nu"][k]),
                                       rtol=1e-6, atol=1e-12)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == int(js["step"]) == 4
    # weight decay where the mask says: a zero gradient moves a matrix, not a vector
    zs = adamw_init(tp)
    before = {k: v.clone() for k, v in tp.items()}
    adamw_update({k: torch.zeros_like(v) for k, v in tp.items()}, zs, tp, tc, decay)
    assert torch.equal(tp["b"], before["b"]) and torch.equal(tp["s"], before["s"])
    assert not torch.equal(tp["w"], before["w"]) and not torch.equal(tp["e"], before["e"])


@pytest.mark.parametrize("arch", ["starcoder2-3b", "recurrentgemma-2b", "whisper-base"])
def test_decay_mask_is_the_references(arch):
    """The reference stacks per-layer leaves on a layer axis, so its ndim >=
    2 rule decays a layer's norm scales and biases too (but not those of a
    hybrid's unstacked tail, nor the final norm): the port's update with the
    train step's mask is the reference's update of the stacked tree."""
    import jax

    cfg = configs.get(arch).reduced()
    model = build_model(cfg, device="cpu", train=True)
    params = trainable(model)
    decay = decay_mask(model)
    assert any(decay[k] and p.ndim == 1 for k, p in params.items())
    assert not decay["final_norm.scale"]
    g = torch.Generator().manual_seed(0)
    grads = {k: torch.randn(p.shape, generator=g) * 1e-3 for k, p in params.items()}
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1)
    jp = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(
        {k: p.detach() for k, p in params.items()}, cfg))
    jg = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(grads, cfg))
    jp, _, _ = joptim.adamw_update(jg, joptim.adamw_init(jp), jp, joptim.AdamWConfig(**kw))
    with torch.no_grad():
        adamw_update(grads, adamw_init(params), params, AdamWConfig(**kw), decay)
    got = params_to_numpy({k: p.detach() for k, p in params.items()}, cfg)
    for (path, w), (_, t) in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                                 jax.tree_util.tree_flatten_with_path(got)[0], strict=True):
        np.testing.assert_allclose(t, np.asarray(w), rtol=1e-6, atol=1e-7,
                                   err_msg=jax.tree_util.keystr(path))
