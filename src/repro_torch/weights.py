"""Weight bridge between the JAX package's parameter tree and the port.

The JAX trees are nested dicts.  A dense model (``DenseLM.init``) stacks
every per-layer leaf on a leading ``(L, ...)`` axis::

    {"embedding": {"embed", ["head"]},
     "layers": {"attn_norm": {...}, "attn": {"wq", ...}, "mlp_norm": {...},
                "mlp": {...}},            # every leaf (L, ...)
     "final_norm": {"scale", ["bias"]}}

An SSM (``Mamba2LM.init``) stacks its layers the same way, with the groups
``norm`` and ``ssm`` (``in_proj``, ``conv_w``, ``conv_b``, ``A_log``,
``dt_bias``, ``D``, ``norm``, ``out_proj``) and an untied ``head``.

A hybrid model (``RecurrentLM.init``) stacks ``pattern`` super-blocks and
keeps the non-divisible tail unstacked::

    {"embedding": {...}, "final_norm": {...},
     "blocks": {"l0": {"norm", "mlp_norm", "mlp", "rec" | "attn"}, ...},
                                          # every leaf (n_sb, ...)
     "tail": {"t0": {...}, ...}}          # layer n_sb * len(pattern) + j

:func:`params_from_jax` takes such a tree **as nested dicts of numpy arrays**
(the caller converts; this module never imports JAX) and returns a state
dict for :class:`repro_torch.models.transformer.DenseLM`,
:class:`repro_torch.models.rglru.RecurrentLM` or
:class:`repro_torch.models.mamba2.Mamba2LM`, one entry per layer.  Leaves
are stored in the port's dtypes: bf16 for everything the JAX package casts
to bf16 at use (identical values), fp32 for what it computes with in fp32
(qk-norm scales, the RG-LRU gates, the SSD's decay, step, skip and norm
parameters).  :func:`params_to_numpy` is the inverse
(fp32 numpy, restacked), so a test can round-trip.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .models.layers import COMPUTE_DTYPE
from .models.mamba2 import FP32_PARAMS
from .models.rglru import FP32_LEAVES


def _dtype(cfg, group: str, name: str) -> torch.dtype:
    if cfg.family == "ssm":
        fp32 = (group, name) in FP32_PARAMS
    else:
        fp32 = name in FP32_LEAVES
    return torch.float32 if fp32 else COMPUTE_DTYPE


def _tensor(a, cfg, group: str, name: str, device) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t.to(device=device, dtype=_dtype(cfg, group, name))


def _hybrid_layout(cfg):
    """(super-block count, pattern length): layer ``sb * n + j`` is
    ``blocks.l{j}[sb]``, layer ``n_sb * n + j`` is ``tail.t{j}``."""
    n = len(cfg.hybrid.pattern)
    return cfg.n_layers // n, n


def _flat_layers(tree: Mapping, cfg):
    """Yield ``(layer, group, name, array)`` for every per-layer leaf."""
    if cfg.family == "hybrid":
        n_sb, n = _hybrid_layout(cfg)
        for j, layer in tree["blocks"].items():
            for group, leaves in layer.items():
                for name, a in leaves.items():
                    a = np.asarray(a)
                    if a.shape[0] != n_sb:
                        raise ValueError(f"blocks.{j}.{group}.{name}: leading dim "
                                         f"{a.shape[0]} != super-blocks {n_sb}")
                    for sb in range(n_sb):
                        yield sb * n + int(j[1:]), group, name, a[sb]
        for j, layer in tree.get("tail", {}).items():
            for group, leaves in layer.items():
                for name, a in leaves.items():
                    yield n_sb * n + int(j[1:]), group, name, a
        return
    for group, leaves in tree["layers"].items():
        for name, a in leaves.items():
            a = np.asarray(a)
            if a.shape[0] != cfg.n_layers:
                raise ValueError(f"layers.{group}.{name}: leading dim {a.shape[0]} "
                                 f"!= n_layers {cfg.n_layers}")
            for i in range(cfg.n_layers):
                yield i, group, name, a[i]


def params_from_jax(tree: Mapping, cfg, device="cuda") -> Dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) -> the port's state dict."""
    sd: Dict[str, torch.Tensor] = {}
    for group in ("embedding", "final_norm"):
        for name, a in tree[group].items():
            sd[f"{group}.{name}"] = _tensor(a, cfg, group, name, device)
    for i, group, name, a in _flat_layers(tree, cfg):
        sd[f"layers.{i}.{group}.{name}"] = _tensor(a, cfg, group, name, device)
    return sd


def params_to_numpy(state: Mapping[str, torch.Tensor], cfg) -> Dict:
    """The port's state dict -> the JAX tree layout, fp32 numpy leaves."""
    def arr(t):
        return t.detach().float().cpu().numpy()

    tree: Dict = {"embedding": {}, "final_norm": {}}
    per_layer: Dict = {}
    for key, t in state.items():
        parts = key.split(".")
        if parts[0] == "layers":
            _, i, group, name = parts
            per_layer.setdefault((group, name), {})[int(i)] = arr(t)
        else:
            tree[parts[0]][parts[1]] = arr(t)
    if cfg.family != "hybrid":
        tree["layers"] = {}
        for (group, name), rows in per_layer.items():
            tree["layers"].setdefault(group, {})[name] = \
                np.stack([rows[i] for i in range(cfg.n_layers)])
        return tree
    n_sb, n = _hybrid_layout(cfg)
    tree["blocks"] = {}
    for (group, name), rows in per_layer.items():
        for j in range(n):
            if j in rows:       # the group exists for this pattern position
                tree["blocks"].setdefault(f"l{j}", {}).setdefault(group, {})[name] = \
                    np.stack([rows[sb * n + j] for sb in range(n_sb)])
        for i in range(n_sb * n, cfg.n_layers):
            if i in rows:
                tree.setdefault("tail", {}).setdefault(f"t{i - n_sb * n}", {}) \
                    .setdefault(group, {})[name] = rows[i]
    return tree
