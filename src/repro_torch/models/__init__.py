"""Data-plane model zoo: the dense, MoE, hybrid, SSM, enc-dec (audio) and
VLM families.

``build_model(cfg, device=..., seed=...)`` dispatches on ``cfg.family`` and
returns an ``nn.Module`` with the interface::

    apply(tokens, *extra) -> logits                 # full-sequence forward
    loss_aux(batch) -> (logits, aux loss)           # the training forward
    init_cache(B, seq_len) -> cache
    decode_step(cache, tokens) -> (logits, cache)
    prefill(tokens, *extra, seq_len=) -> (logits, cache)

``extra`` is the frame embeddings of an enc-dec model (required by
``apply``; zero frames when ``prefill`` gets none) and the patch embeddings
of a VLM (optional); the other families take none.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import layers
from .config import ArchConfig


def build_model(cfg: ArchConfig, *, device="cuda", seed: Optional[int] = 0,
                train: bool = False, mesh=None):
    """The model for ``cfg`` on ``device``, weights drawn from a
    ``torch.Generator`` on that device seeded with ``seed``.  ``train``:
    every parameter an fp32 master that requires grad (the JAX package's
    ``PARAM_DTYPE``); otherwise each is stored in the dtype its uses cast
    it to (bf16 but for the leaves computed in fp32), with no grad.
    ``mesh`` (a live ``DeviceMesh``, serving only): this rank's model, which
    for the MoE family holds only the rank's experts
    (:class:`~repro_torch.dist.sharding.ExpertShard`), each leaf bitwise
    that slice of the ``mesh=None`` model's; every other weight whole."""
    if cfg.family == "dense":
        from .transformer import DenseLM as model_cls
    elif cfg.family == "moe":
        from .moe import MoELM as model_cls
    elif cfg.family == "hybrid":
        from .rglru import RecurrentLM as model_cls
    elif cfg.family == "ssm":
        from .mamba2 import Mamba2LM as model_cls
    elif cfg.family == "audio":
        from .whisper import EncDecLM as model_cls
    elif cfg.family == "vlm":
        from .vlm import VisionLM as model_cls
    else:
        raise ValueError(f"unknown family {cfg.family}")
    kw = {}
    if mesh is not None:
        if train:
            raise NotImplementedError("training under a mesh (the reference has no sharded "
                                      "training) is not ported, ROADMAP 1.8c")
        if cfg.family == "moe":
            from ..dist.sharding import ExpertShard

            kw["expert_shard"] = ExpertShard.for_mesh(mesh, cfg.moe.n_experts)
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    with layers.master_weights(train):
        return model_cls(cfg, device=device, generator=gen, **kw)


__all__ = ["ArchConfig", "build_model"]
