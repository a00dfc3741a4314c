"""Weight bridge between the JAX package's parameter tree and the port.

The JAX trees are nested dicts.  A dense model (``DenseLM.init``) stacks
every per-layer leaf on a leading ``(L, ...)`` axis::

    {"embedding": {"embed", ["head"]},
     "layers": {"attn_norm": {...}, "attn": {"wq", ...}, "mlp_norm": {...},
                "mlp": {...}},            # every leaf (L, ...)
     "final_norm": {"scale", ["bias"]}}

An MoE model (``MoELM.init``) stacks its layers the same way; its ``moe``
group nests one level deeper: ``moe.router.w`` (L, D, E),
``moe.experts.{w_gate, w_up, w_down}`` (L, E, ...) and, for moonshot,
``moe.shared.{w_gate, w_up, w_down}``.

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
:class:`repro_torch.models.moe.MoELM`,
:class:`repro_torch.models.rglru.RecurrentLM` or
:class:`repro_torch.models.mamba2.Mamba2LM`, one entry per layer.  Leaves
are stored in the port's dtypes: bf16 for everything the JAX package casts
to bf16 at use (identical values), fp32 for what it computes with in fp32
(qk-norm scales, the MoE router, the RG-LRU gates, the SSD's decay, step,
skip and norm parameters).  :func:`params_to_numpy` is the inverse
(fp32 numpy, restacked), so a test can round-trip.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from .models.layers import COMPUTE_DTYPE
from .models.mamba2 import FP32_PARAMS
from .models.moe import FP32_PATHS as MOE_FP32_PATHS
from .models.rglru import FP32_LEAVES


def _dtype(cfg, path: Tuple[str, ...]) -> torch.dtype:
    """Storage dtype of the per-layer leaf at ``path`` (group, ..., name)."""
    if cfg.family == "ssm":
        fp32 = path[-2:] in FP32_PARAMS
    elif cfg.family == "moe" and tuple(path) in MOE_FP32_PATHS:
        fp32 = True
    else:
        fp32 = path[-1] in FP32_LEAVES
    return torch.float32 if fp32 else COMPUTE_DTYPE


def _tensor(a, cfg, path: Tuple[str, ...], device) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t.to(device=device, dtype=_dtype(cfg, path))


def _hybrid_layout(cfg):
    """(super-block count, pattern length): layer ``sb * n + j`` is
    ``blocks.l{j}[sb]``, layer ``n_sb * n + j`` is ``tail.t{j}``."""
    n = len(cfg.hybrid.pattern)
    return cfg.n_layers // n, n


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()):
    """Yield ``(path, array)`` for every leaf of a nested dict."""
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _set(tree: Dict, path: Tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _flat_layers(tree: Mapping, cfg):
    """Yield ``(layer, path, array)`` for every per-layer leaf; ``path`` is
    the leaf's key path inside its layer (``("attn", "wq")``, or three deep
    for an MoE layer's ``("moe", "experts", "w_up")``)."""
    if cfg.family == "hybrid":
        n_sb, n = _hybrid_layout(cfg)
        for j, layer in tree["blocks"].items():
            for path, a in _leaves(layer):
                a = np.asarray(a)
                if a.shape[0] != n_sb:
                    raise ValueError(f"blocks.{j}.{'.'.join(path)}: leading dim "
                                     f"{a.shape[0]} != super-blocks {n_sb}")
                for sb in range(n_sb):
                    yield sb * n + int(j[1:]), path, a[sb]
        for j, layer in tree.get("tail", {}).items():
            for path, a in _leaves(layer):
                yield n_sb * n + int(j[1:]), path, a
        return
    for path, a in _leaves(tree["layers"]):
        a = np.asarray(a)
        if a.shape[0] != cfg.n_layers:
            raise ValueError(f"layers.{'.'.join(path)}: leading dim {a.shape[0]} "
                             f"!= n_layers {cfg.n_layers}")
        for i in range(cfg.n_layers):
            yield i, path, a[i]


def params_from_jax(tree: Mapping, cfg, device="cuda") -> Dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) -> the port's state dict."""
    sd: Dict[str, torch.Tensor] = {}
    for group in ("embedding", "final_norm"):
        for name, a in tree[group].items():
            sd[f"{group}.{name}"] = _tensor(a, cfg, (group, name), device)
    for i, path, a in _flat_layers(tree, cfg):
        sd[f"layers.{i}.{'.'.join(path)}"] = _tensor(a, cfg, path, device)
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
            per_layer.setdefault(tuple(parts[2:]), {})[int(parts[1])] = arr(t)
        else:
            tree[parts[0]][parts[1]] = arr(t)
    if cfg.family != "hybrid":
        tree["layers"] = {}
        for path, rows in per_layer.items():
            _set(tree["layers"], path, np.stack([rows[i] for i in range(cfg.n_layers)]))
        return tree
    n_sb, n = _hybrid_layout(cfg)
    tree["blocks"] = {}
    for path, rows in per_layer.items():
        for j in range(n):
            if j in rows:       # the group exists for this pattern position
                _set(tree["blocks"], (f"l{j}",) + path,
                     np.stack([rows[sb * n + j] for sb in range(n_sb)]))
        for i in range(n_sb * n, cfg.n_layers):
            if i in rows:
                _set(tree, ("tail", f"t{i - n_sb * n}") + path, rows[i])
    return tree
