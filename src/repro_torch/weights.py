"""Weight bridge between the JAX package's parameter tree and the port.

The JAX tree (``DenseLM.init``) is nested dicts with per-layer leaves
stacked on a leading ``(L, ...)`` axis::

    {"embedding": {"embed", ["head"]},
     "layers": {"attn_norm": {...}, "attn": {"wq", ...}, "mlp_norm": {...},
                "mlp": {...}},            # every leaf (L, ...)
     "final_norm": {"scale", ["bias"]}}

:func:`params_from_jax` takes that tree **as nested dicts of numpy arrays**
(the caller converts; this module never imports JAX) and returns a state
dict for :class:`repro_torch.models.transformer.DenseLM` with the stacked
leaves split per layer.  Leaves are stored in the port's dtypes: bf16 for
everything the JAX package casts to bf16 at use (identical values), fp32 for
the qk-norm scales it computes with in fp32.  :func:`params_to_numpy` is the
inverse (fp32 numpy, stacked), so a test can round-trip.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .models.layers import COMPUTE_DTYPE

FP32_LEAVES = frozenset({"q_norm", "k_norm"})
_GROUPS = ("attn_norm", "attn", "mlp_norm", "mlp")


def _dtype(name: str) -> torch.dtype:
    return torch.float32 if name in FP32_LEAVES else COMPUTE_DTYPE


def _tensor(a, name: str, device) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t.to(device=device, dtype=_dtype(name))


def params_from_jax(tree: Mapping, cfg, device="cuda") -> Dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) -> the port's state dict."""
    sd: Dict[str, torch.Tensor] = {}
    for name, a in tree["embedding"].items():
        sd[f"embedding.{name}"] = _tensor(a, name, device)
    for name, a in tree["final_norm"].items():
        sd[f"final_norm.{name}"] = _tensor(a, name, device)
    for group in _GROUPS:
        for name, a in tree["layers"][group].items():
            a = np.asarray(a)
            if a.shape[0] != cfg.n_layers:
                raise ValueError(f"layers.{group}.{name}: leading dim {a.shape[0]} "
                                 f"!= n_layers {cfg.n_layers}")
            for i in range(cfg.n_layers):
                sd[f"layers.{i}.{group}.{name}"] = _tensor(a[i], name, device)
    return sd


def params_to_numpy(state: Mapping[str, torch.Tensor], cfg) -> Dict:
    """The port's state dict -> the JAX tree layout, fp32 numpy leaves."""
    def arr(t):
        return t.detach().float().cpu().numpy()

    tree: Dict = {"embedding": {}, "final_norm": {},
                  "layers": {g: {} for g in _GROUPS}}
    per_layer: Dict = {}
    for key, t in state.items():
        parts = key.split(".")
        if parts[0] == "layers":
            _, i, group, name = parts
            per_layer.setdefault((group, name), {})[int(i)] = arr(t)
        else:
            tree[parts[0]][parts[1]] = arr(t)
    for (group, name), rows in per_layer.items():
        tree["layers"][group][name] = np.stack([rows[i] for i in range(cfg.n_layers)])
    return tree
