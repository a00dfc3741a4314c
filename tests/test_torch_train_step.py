"""The port's train step against the JAX package's ``make_train_step``.

Each family's reduced config starts both frameworks from the reference's
``model.init(key)`` (fp32 masters through ``weights.params_from_jax(...,
master=True)``) and trains 5 steps on the same synthetic batches (each
framework's own pipeline, bitwise equal: ``test_torch_train_data.py``).

Tolerances, measured on this CPU at these sizes and stated here:

* The gradient of the first batch, at identical weights, leaf by leaf:
  ``|g_port - g_jax| <= GRAD_REL |g_jax| + GRAD_FLOOR |g_jax|_global``.
  Both run the same bf16 recipe, but their matmuls accumulate in another
  order; the floor covers leaves whose exact gradient is zero (a k bias,
  under softmax's shift invariance), where only rounding noise is left.
  MoE takes ``GRAD_REL_MOE``: its router reads bf16 activations that differ
  by a rounding step, so a near-tied token can take another expert (and
  push a pair past capacity), which moves every leaf's gradient by about
  4% at these sizes (4 sequences of 32 tokens, 4 experts).
* The 5 losses within ``LOSS_REL`` relative (MoE: ``LOSS_REL_MOE``, a
  near-tied route can flip after the weights drift by a rounding step),
  the first grad norm within ``GNORM_REL``, the later ones within
  ``GNORM_REL_LATER``.
* The parameters after 5 steps: ``|p_port - p_jax| <= PARAM_REL |p_jax -
  p_0|`` over the whole model.  Not leaf by leaf: Adam's first steps move
  every element by about ``lr`` whatever its gradient's size, so an element
  whose gradient is near zero moves a full step either way when its sign
  differs between the frameworks, and one such element of a 64-entry norm
  scale is 25% of that leaf's update; from there the two trajectories part
  (the hybrid's norm scales and RG-LRU gates end up 15-25% of their update
  apart, though their gradients at equal weights agree within 5%).  So
  each leaf is held where the step is decided by the gradient, not by the
  trajectory:
* every leaf's gradient, at each of the 5 steps, at the JAX run's weights
  of that step (loaded into a second port model), within ``GRAD_LEAF_REL``
  of that leaf's own norm, with no floor (measured at most 5.5%, a MoE
  router, and 5.1% elsewhere);
* the first step's update leaf by leaf, on the elements whose first
  gradient is at least ``UPDATE_MASK`` of the leaf's largest (there
  Adam's first step is ``-lr sign(g)``, and the signs agree): within
  ``UPDATE_REL`` of the JAX update on those elements.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.models import build_model
from repro_torch.models.config import ArchConfig, ShapeSpec
from repro_torch.train import AdamWConfig, make_train_step
from repro_torch.train.step import (TrainStepConfig, compress_decompress, cross_entropy,
                                    init_train_state, make_eval_step, make_loss_fn, trainable)
from repro_torch.weights import jax_leaf_groups, params_from_jax, params_to_numpy

try:    # the card's machine has no JAX
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.data import DataConfig as JDataConfig
    from repro.data import SyntheticPipeline as JPipeline
    from repro.models import build_model as jax_build_model
    from repro.models.config import ShapeSpec as JShapeSpec
    from repro.train import AdamWConfig as JAdamWConfig
    from repro.train.step import TrainStepConfig as JTrainStepConfig
    from repro.train.step import _compress_decompress as jax_compress
    from repro.train.step import cross_entropy as jax_cross_entropy
    from repro.train.step import init_train_state as jax_init_train_state
    from repro.train.step import make_loss_fn as jax_make_loss_fn
    from repro.train.step import make_train_step as jax_make_train_step
except ModuleNotFoundError:
    jax = None

torch.set_num_threads(2)

STEPS, SEQ, BATCH, LR = 5, 32, 4, 3e-3
GRAD_REL, GRAD_REL_MOE, GRAD_FLOOR = 3e-2, 8e-2, 2e-3
LOSS_REL, LOSS_REL_MOE = 2e-3, 1.5e-2
GNORM_REL, GNORM_REL_LATER = 1e-2, 6e-2
PARAM_REL = 0.25
GRAD_LEAF_REL, UPDATE_MASK, UPDATE_REL = 8e-2, 5e-2, 5e-2

FAMILIES = ["starcoder2-3b", "minicpm-2b", "recurrentgemma-2b", "mamba2-1.3b",
            "moonshot-v1-16b-a3b", "whisper-base", "internvl2-2b"]


def flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def setup(arch, **over):
    jcfg = dataclasses.replace(jconfigs.get(arch).reduced(), **over)
    tcfg = dataclasses.replace(configs.get(arch).reduced(), **over)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.key(0))
    tm = build_model(tcfg, device="cpu", train=True)
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu",
                                       master=True))
    shape = (SEQ, BATCH)
    jpipe = JPipeline(jcfg, JShapeSpec("t", *shape, "train"), JDataConfig(seed=0))
    tpipe = SyntheticPipeline(tcfg, ShapeSpec("t", *shape, "train"), DataConfig(seed=0),
                              device="cpu")
    return jcfg, tcfg, jm, jp, tm, jpipe, tpipe


def port_grads(tm, tcfg, batch):
    """The port's gradient of one batch in the JAX tree layout."""
    loss, _ = make_loss_fn(tm, TrainStepConfig())(batch)
    loss.backward()
    grads = {k: p.grad.clone() for k, p in tm.named_parameters()}
    for p in tm.parameters():
        p.grad = None
    return flat(params_to_numpy(grads, tcfg))


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_steps_match_jax(arch):
    jcfg, tcfg, jm, jp, tm, jpipe, tpipe = setup(arch)
    p0 = flat(jp)
    # the first batch's gradient at identical weights, leaf by leaf
    jg = flat(jax.grad(lambda p, b: jax_make_loss_fn(jm, JTrainStepConfig())(p, b)[0])(
        jp, jpipe.host_batch(0)))
    tg = port_grads(tm, tcfg, tpipe.host_batch(0))
    assert tg.keys() == jg.keys()
    gnorm = np.sqrt(sum(np.sum(g ** 2) for g in jg.values()))
    grad_rel = GRAD_REL_MOE if tcfg.family == "moe" else GRAD_REL
    for k in jg:
        err = np.linalg.norm(tg[k] - jg[k])
        assert err <= grad_rel * np.linalg.norm(jg[k]) + GRAD_FLOOR * gnorm, \
            (k, err, np.linalg.norm(jg[k]), gnorm)
    # 5 steps of the JAX make_train_step and the port's
    sched = "wsd" if arch.startswith("minicpm") else "cosine"
    kw = dict(lr=LR, total_steps=STEPS, warmup_steps=1, schedule=sched)
    jstep = jax.jit(jax_make_train_step(jm, JAdamWConfig(**kw)))
    jgrad = jax.jit(jax.grad(lambda p, b: jax_make_loss_fn(jm, JTrainStepConfig())(p, b)[0]))
    jstate = jax_init_train_state(jm, jp)
    params = trainable(tm)
    tstate = init_train_state(params)
    tstep = make_train_step(tm, AdamWConfig(**kw))
    probe = build_model(tcfg, device="cpu", train=True)
    loss_rel = LOSS_REL_MOE if tcfg.family == "moe" else LOSS_REL
    for i in range(STEPS):
        # each leaf's gradient at the JAX run's weights of this step
        gj = flat(jgrad(jp, jpipe.host_batch(i)))
        probe.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                              "cpu", master=True))
        gt = port_grads(probe, tcfg, tpipe.host_batch(i))
        for k in gj:
            err = np.linalg.norm(gt[k] - gj[k])
            assert err <= GRAD_LEAF_REL * np.linalg.norm(gj[k]), (i, k, err,
                                                                  np.linalg.norm(gj[k]))
        jp, jstate, jm_ = jstep(jp, jstate, jpipe.host_batch(i))
        params, tstate, tm_ = tstep(params, tstate, tpipe.host_batch(i))
        if i == 0:      # the first update, leaf by leaf, where the gradient decides it
            pj1, pt1 = flat(jp), flat(params_to_numpy(tm.state_dict(), tcfg))
            for k in pj1:
                keep = np.abs(jg[k]) >= UPDATE_MASK * np.abs(jg[k]).max()
                want = (pj1[k] - p0[k])[keep]
                err = np.linalg.norm((pt1[k] - p0[k])[keep] - want)
                assert keep.any() and err <= UPDATE_REL * np.linalg.norm(want), (k, err)
        assert tm_["params_without_grad"] == 0
        assert float(tm_["loss"]) == pytest.approx(float(jm_["loss"]), rel=loss_rel), i
        assert float(tm_["grad_norm"]) == pytest.approx(
            float(jm_["grad_norm"]), rel=GNORM_REL if i == 0 else GNORM_REL_LATER), i
        assert float(tm_["lr"]) == pytest.approx(float(jm_["lr"]), rel=1e-6), i
    assert int(tstate["step"]) == int(jstate["step"]) == STEPS
    pj, pt = flat(jp), flat(params_to_numpy(tm.state_dict(), tcfg))
    moved = np.sqrt(sum(np.sum((pj[k] - p0[k]) ** 2) for k in pj))
    apart = np.sqrt(sum(np.sum((pt[k] - pj[k]) ** 2) for k in pj))
    assert moved > 0 and apart <= PARAM_REL * moved, (apart, moved)


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_cross_entropy_matches_jax(z_loss):
    rng = np.random.default_rng(0)
    lg = rng.standard_normal((2, 8, 32)).astype(np.float32) * 3
    labels = rng.integers(0, 32, (2, 8)).astype(np.int32)
    want = float(jax_cross_entropy(jnp.asarray(lg), jnp.asarray(labels), z_loss))
    got = float(cross_entropy(torch.from_numpy(lg), torch.from_numpy(labels), z_loss))
    assert got == pytest.approx(want, rel=1e-6)
    got_bf16 = float(cross_entropy(torch.from_numpy(lg).bfloat16(), torch.from_numpy(labels),
                                   z_loss))
    want_bf16 = float(jax_cross_entropy(jnp.asarray(lg, jnp.bfloat16), jnp.asarray(labels),
                                        z_loss))
    assert got_bf16 == pytest.approx(want_bf16, rel=1e-6)


TINY = ArchConfig(name="tiny", family="dense", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                  d_ff=64, vocab=64, head_dim=8, remat="none")


def tiny_setup(step_cfg=TrainStepConfig(), cfg=TINY, seed=0):
    model = build_model(cfg, device="cpu", seed=seed, train=True)
    params = trainable(model)
    state = init_train_state(params, step_cfg)
    step = make_train_step(model, AdamWConfig(lr=1e-2, total_steps=100, warmup_steps=5),
                           step_cfg)
    pipe = SyntheticPipeline(cfg, ShapeSpec("t", 16, 8, "train"), DataConfig(seed=0),
                             device="cpu")
    return model, params, state, step, pipe


def test_grad_accumulation_equivalence():
    """accum_steps=2 over the same global batch gives the accum_steps=1
    gradient and loss (the reference's ``tests/test_train_and_data.py``
    check).  The gradients are held, not the updated weights: Adam's first
    step moves every element by about lr whatever its gradient, so an
    element whose gradient is near zero can move either way under a
    rounding step.  Each gradient leaves a bf16 matmul rounded to bf16, so
    the two differ by about one bf16 step of the leaf's scale (2^-8 = 3.9e-3
    measured up to 4.6e-3); the bound is 1e-2 of the largest entry."""
    outs = {}
    for accum in (1, 2):
        model, params, state, step, pipe = tiny_setup(TrainStepConfig(accum_steps=accum))
        grads, m = step.compute_grads(params, pipe.host_batch(0))
        outs[accum] = (grads, float(m["loss"]))
        params, state, m2 = step(params, state, pipe.host_batch(0))
        assert float(m2["loss"]) == float(m["loss"])
    for name, g1 in outs[1][0].items():
        g2 = outs[2][0][name]
        assert (g1 - g2).abs().max().item() <= 1e-2 * g1.abs().max().item(), name
    assert outs[1][1] == pytest.approx(outs[2][1], rel=1e-2)


def test_compression_error_feedback():
    """int8 compression perturbs single steps, but error feedback keeps the
    trajectory close to the uncompressed one (the reference's bounds); the
    residual lives in the state."""
    trajs = {}
    for comp in (False, True):
        model, params, state, step, pipe = tiny_setup(TrainStepConfig(compress_grads=comp))
        assert ("compress_residual" in state) == comp
        losses = []
        for i in range(25):
            params, state, m = step(params, state, pipe.host_batch(i))
            losses.append(float(m["loss"]))
        trajs[comp] = losses
    assert trajs[True][-1] < trajs[True][0] - 0.2
    assert abs(trajs[True][-1] - trajs[False][-1]) < 0.25


@pytest.mark.parametrize("arch,over", [("minicpm-2b", {}),
                                       ("recurrentgemma-2b", {"n_layers": 8})])
def test_compression_scale_is_the_reference_leafs(arch, over):
    """int8 compression takes one scale for each JAX leaf, as the
    reference's ``_compress_decompress`` over its stacked tree: the port's
    g_hat and residual (per port leaf) at the JAX init weights' gradient and
    a random residual are the reference's on every stacked leaf, bitwise
    (the hybrid at 8 layers: two super-blocks of 3 and an unstacked tail of
    2).  One scale per port leaf would quantise each layer on its own."""
    jcfg, tcfg, jm, jp, tm, jpipe, tpipe = setup(arch, **over)
    jg = jax.tree_util.tree_map(np.asarray, jax.grad(
        lambda p, b: jax_make_loss_fn(jm, JTrainStepConfig())(p, b)[0])(jp, jpipe.host_batch(0)))
    rng = np.random.default_rng(0)
    jres = jax.tree_util.tree_map(
        lambda g: (rng.standard_normal(g.shape) * 0.05 * np.abs(g).max()).astype(np.float32), jg)
    pairs = jax.tree_util.tree_map(lambda g, r: jax_compress(jnp.asarray(g), jnp.asarray(r)),
                                   jg, jres)
    is_pair = lambda x: isinstance(x, tuple)     # noqa: E731
    want_g = flat(jax.tree_util.tree_map(lambda pr: pr[0], pairs, is_leaf=is_pair))
    want_r = flat(jax.tree_util.tree_map(lambda pr: pr[1], pairs, is_leaf=is_pair))
    grads = params_from_jax(jg, tcfg, "cpu", master=True)
    res = params_from_jax(jres, tcfg, "cpu", master=True)
    groups = jax_leaf_groups(grads, tcfg)
    assert sorted(n for g in groups for n in g) == sorted(grads)
    assert len(groups) == len(want_g) and max(map(len, groups)) > 1
    g_hat, new_res = compress_decompress(grads, res, groups)
    got_g, got_r = flat(params_to_numpy(g_hat, tcfg)), flat(params_to_numpy(new_res, tcfg))
    assert got_g.keys() == want_g.keys()
    for k in want_g:
        assert np.array_equal(got_g[k], want_g[k]), k
        assert np.array_equal(got_r[k], want_r[k]), k


def test_loss_decreases_to_above_the_chain_floor():
    model, params, state, step, pipe = tiny_setup()
    losses = []
    for i in range(30):
        params, state, m = step(params, state, pipe.host_batch(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.2
    assert losses[-1] > pipe.optimal_loss() - 0.05
    ev = make_eval_step(model)(params, pipe.host_batch(0))
    assert set(ev) == {"loss", "aux_loss"} and float(ev["aux_loss"]) == 0.0


@pytest.mark.parametrize("arch", ["minicpm-2b", "recurrentgemma-2b", "mamba2-1.3b",
                                  "moonshot-v1-16b-a3b", "whisper-base", "internvl2-2b"])
def test_every_parameter_receives_a_gradient(arch):
    cfg = configs.get(arch).reduced()
    model = build_model(cfg, device="cpu", train=True)
    assert all(p.dtype == torch.float32 and p.requires_grad for p in model.parameters())
    pipe = SyntheticPipeline(cfg, ShapeSpec("t", 16, 2, "train"), DataConfig(seed=1),
                             device="cpu")
    loss, _ = make_loss_fn(model, TrainStepConfig())(pipe.host_batch(0))
    loss.backward()
    missing = [k for k, p in model.named_parameters()
               if p.grad is None or not torch.isfinite(p.grad).all()]
    assert missing == []


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_is_the_same_step(policy):
    """Rematerialization changes what is saved, not the result: CPU
    recompute is deterministic, so the step is bitwise the un-remat one."""
    outs = []
    for remat in ("none", policy):
        cfg = dataclasses.replace(TINY, remat=remat)
        model, params, state, step, pipe = tiny_setup(cfg=cfg)
        params, state, m = step(params, state, pipe.host_batch(0))
        outs.append((float(m["loss"]), float(m["grad_norm"]),
                     [p.detach().clone() for p in params.values()]))
    assert outs[0][:2] == outs[1][:2]
    assert all(torch.equal(a, b) for a, b in zip(outs[0][2], outs[1][2], strict=True))


def test_serving_build_is_unchanged():
    """A model built for serving keeps bf16 storage and no grad; the same
    seed built for training holds the fp32 values that storage rounds."""
    cfg = configs.get("minicpm-2b").reduced()
    serve = build_model(cfg, device="cpu", seed=3)
    train = build_model(cfg, device="cpu", seed=3, train=True)
    for (k, s), (k2, t) in zip(serve.state_dict().items(), train.state_dict().items(),
                               strict=True):
        assert k == k2 and t.dtype == torch.float32
        assert torch.equal(s, t.to(s.dtype))
    assert not any(p.requires_grad for p in serve.parameters())
    assert serve.embedding["embed"].dtype == torch.bfloat16
