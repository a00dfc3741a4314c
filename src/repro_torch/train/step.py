"""Train and eval steps, with the JAX package's semantics
(``src/repro/train/step.py``).

``make_train_step(model, optim_cfg, step_cfg)`` returns
``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``;
``params`` is the model's name -> parameter mapping (:func:`trainable`),
updated in place, so the returned one is the same object.  The levers of
the reference, all config-selectable:

* microbatching (``accum_steps``): the batch is split along its first
  axis, each microbatch's gradient accumulates into the parameters'
  ``.grad`` (fp32, as the reference's scan sums into fp32 zeros), and the
  sum is divided by the count;
* int8 error-feedback gradient compression (``compress_grads``): each
  gradient plus its residual is quantised to int8 and back, one max-abs
  scale for each leaf of the reference's tree (the port leaves of one
  stacked JAX leaf share it, ``weights.jax_leaf_groups``), and the
  quantisation error is carried per port leaf in the optimiser state;
* rematerialization: the model config's ``remat`` (``layers.remat``).

Weight decay falls on the leaves the reference decays: ndim >= 2 in its
tree, which stacks every per-layer leaf on a layer axis
(``weights.jax_stacked``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Tuple

import torch

from ..weights import jax_leaf_groups, jax_stacked
from .optim import AdamWConfig, adamw_init, adamw_update


@dataclass(frozen=True)
class TrainStepConfig:
    accum_steps: int = 1
    compress_grads: bool = False
    z_loss: float = 0.0              # logit-norm regularizer (stability)


def trainable(model) -> Dict[str, torch.nn.Parameter]:
    """The model's parameters by state-dict name (a model built with
    ``train=True`` has every one an fp32 master that requires grad)."""
    return dict(model.named_parameters())


def decay_mask(model) -> Dict[str, bool]:
    """name -> whether weight decay falls on the leaf: the reference decays
    leaves of ndim >= 2 in its tree, where per-layer leaves carry a layer
    axis (:func:`weights.jax_stacked`)."""
    return {name: p.ndim + jax_stacked(name, model.cfg) >= 2
            for name, p in trainable(model).items()}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 0.0) -> torch.Tensor:
    """Mean next-token CE in fp32: logits (B, S, V) any float dtype, labels
    (B, S) integers; ``z_loss`` adds ``z_loss * mean(lse^2)``."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    gold = lg.gather(-1, labels.long()[..., None])[..., 0]
    loss = (lse - gold).mean()
    if z_loss:
        loss = loss + z_loss * lse.square().mean()
    return loss


def compress_decompress(grads: Mapping[str, torch.Tensor],
                        residuals: Mapping[str, torch.Tensor], groups: List[List[str]]
                        ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """int8 quantisation with error feedback: ``(g_hat, new residual)`` by
    port leaf.  Each group of ``groups`` (the port leaves of one JAX leaf,
    :func:`weights.jax_leaf_groups`) shares one scale, the max |g + r| over
    the group / 127, as the reference takes one over its stacked leaf."""
    g_hat, new_res = {}, {}
    for names in groups:
        gf = {n: grads[n].float() + residuals[n] for n in names}
        amax = torch.stack([g.abs().max() for g in gf.values()]).max()
        scale = amax / 127.0 + 1e-12
        for n, g in gf.items():
            q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
            g_hat[n] = q.float() * scale
            new_res[n] = g - g_hat[n]
    return g_hat, new_res


def make_loss_fn(model, step_cfg: TrainStepConfig) -> Callable:
    """``loss_fn(batch) -> (loss, {"loss", "aux_loss"})``: CE (with
    ``z_loss``) plus the family's auxiliary loss."""
    def loss_fn(batch):
        logits, aux = model.loss_aux(batch)
        loss = cross_entropy(logits, batch["labels"], step_cfg.z_loss) + aux
        return loss, {"loss": loss.detach(), "aux_loss": aux.detach()}

    return loss_fn


def _split(batch: Mapping[str, torch.Tensor], n: int):
    """(B, ...) leaves -> n microbatches of B / n rows, in order."""
    parts = {k: torch.chunk(v, n, dim=0) for k, v in batch.items()}
    return [{k: parts[k][i] for k in batch} for i in range(n)]


def make_train_step(model, optim_cfg: AdamWConfig,
                    step_cfg: TrainStepConfig = TrainStepConfig()) -> Callable:
    loss_fn = make_loss_fn(model, step_cfg)
    decay = decay_mask(model)
    groups = jax_leaf_groups(trainable(model), model.cfg)

    def compute_grads(params, batch):
        n = max(step_cfg.accum_steps, 1)
        for p in params.values():
            p.grad = None
        micro = [batch] if n == 1 else _split(batch, n)
        msum = None
        for mb in micro:
            loss, metrics = loss_fn(mb)
            loss.backward()
            msum = metrics if msum is None else {k: msum[k] + metrics[k] for k in metrics}
        grads, missing = {}, 0
        for name, p in params.items():
            if p.grad is None:          # no path from the loss (a zero gradient)
                missing += 1
            g = p.grad if p.grad is not None else torch.zeros_like(p, dtype=torch.float32)
            grads[name] = g / n if n > 1 else g
            p.grad = None
        metrics = {k: m / n for k, m in msum.items()}
        metrics["params_without_grad"] = missing
        return grads, metrics

    def train_step(params, opt_state, batch):
        grads, metrics = compute_grads(params, batch)
        new_res = None
        if step_cfg.compress_grads:
            grads, new_res = compress_decompress(grads, opt_state["compress_residual"], groups)
        inner = {k: opt_state[k] for k in ("mu", "nu", "step")}
        new_state, opt_metrics = adamw_update(grads, inner, params, optim_cfg, decay)
        del grads
        metrics = dict(metrics, **opt_metrics)
        if new_res is not None:
            new_state["compress_residual"] = new_res
        return params, new_state, metrics

    train_step.compute_grads = compute_grads      # (params, batch) -> (grads, metrics)
    return train_step


def init_train_state(params: Mapping[str, torch.Tensor],
                     step_cfg: TrainStepConfig = TrainStepConfig()) -> Dict:
    """AdamW's zero state, and the zero compression residual when
    ``compress_grads``."""
    state = adamw_init(params)
    if step_cfg.compress_grads:
        state["compress_residual"] = {k: torch.zeros_like(p, dtype=torch.float32)
                                      for k, p in params.items()}
    return state


def make_eval_step(model, step_cfg: TrainStepConfig = TrainStepConfig()) -> Callable:
    loss_fn = make_loss_fn(model, step_cfg)

    @torch.no_grad()
    def eval_step(params, batch):
        return loss_fn(batch)[1]

    return eval_step
