"""Weight bridge between the JAX package's parameter tree and the port.

The JAX trees are nested dicts.  A dense model (``DenseLM.init``) stacks
every per-layer leaf on a leading ``(L, ...)`` axis::

    {"embedding": {"embed", ["head"]},
     "layers": {"attn_norm": {...}, "attn": {"wq", ...}, "mlp_norm": {...},
                "mlp": {...}},            # every leaf (L, ...)
     "final_norm": {"scale", ["bias"]}}

A hybrid model (``RecurrentLM.init``) stacks ``pattern`` super-blocks and
keeps the non-divisible tail unstacked::

    {"embedding": {...}, "final_norm": {...},
     "blocks": {"l0": {"norm", "mlp_norm", "mlp", "rec" | "attn"}, ...},
                                          # every leaf (n_sb, ...)
     "tail": {"t0": {...}, ...}}          # layer n_sb * len(pattern) + j

:func:`params_from_jax` takes such a tree **as nested dicts of numpy arrays**
(the caller converts; this module never imports JAX) and returns a state
dict for :class:`repro_torch.models.transformer.DenseLM` or
:class:`repro_torch.models.rglru.RecurrentLM`, one entry per layer.  Leaves
are stored in the port's dtypes: bf16 for everything the JAX package casts
to bf16 at use (identical values), fp32 for what it computes with in fp32
(qk-norm scales, the RG-LRU gates).  :func:`params_to_numpy` is the inverse
(fp32 numpy, restacked), so a test can round-trip.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .models.layers import COMPUTE_DTYPE
from .models.rglru import FP32_LEAVES

_GROUPS = ("attn_norm", "attn", "mlp_norm", "mlp")


def _dtype(name: str) -> torch.dtype:
    return torch.float32 if name in FP32_LEAVES else COMPUTE_DTYPE


def _tensor(a, name: str, device) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t.to(device=device, dtype=_dtype(name))


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
    for group in _GROUPS:
        for name, a in tree["layers"][group].items():
            a = np.asarray(a)
            if a.shape[0] != cfg.n_layers:
                raise ValueError(f"layers.{group}.{name}: leading dim {a.shape[0]} "
                                 f"!= n_layers {cfg.n_layers}")
            for i in range(cfg.n_layers):
                yield i, group, name, a[i]


def params_from_jax(tree: Mapping, cfg, device="cuda") -> Dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) -> the port's state dict."""
    sd: Dict[str, torch.Tensor] = {}
    for name, a in tree["embedding"].items():
        sd[f"embedding.{name}"] = _tensor(a, name, device)
    for name, a in tree["final_norm"].items():
        sd[f"final_norm.{name}"] = _tensor(a, name, device)
    for i, group, name, a in _flat_layers(tree, cfg):
        sd[f"layers.{i}.{group}.{name}"] = _tensor(a, name, device)
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
        tree["layers"] = {g: {} for g in _GROUPS}
        for (group, name), rows in per_layer.items():
            tree["layers"][group][name] = np.stack([rows[i] for i in range(cfg.n_layers)])
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
