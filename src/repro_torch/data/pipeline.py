"""Deterministic synthetic-token pipeline (the JAX package's
``data/pipeline.py``, its numpy generation copied so that every batch is
bitwise the reference's).

Every batch is a pure function of ``(seed, step)``: a resumed job
regenerates the identical stream from the checkpointed step, and any host
layout slices the same global batch.  The tokens are an order-2 Markov
chain over the first ``markov_states`` ids, so the cross-entropy has a
learnable signal and a known floor (:meth:`SyntheticPipeline.optimal_loss`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from ..models.config import ArchConfig, ShapeSpec


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    markov_states: int = 64        # structure size of the synthetic chain
    host_index: int = 0
    host_count: int = 1


class SyntheticPipeline:
    def __init__(self, cfg: ArchConfig, shape: ShapeSpec, data_cfg: DataConfig = DataConfig(),
                 device="cuda"):
        self.cfg = cfg
        self.shape = shape
        self.data = data_cfg
        self.device = torch.device(device)
        m = min(data_cfg.markov_states, cfg.vocab)
        rng = np.random.default_rng(data_cfg.seed)
        # sparse-ish transition matrix with a few high-probability successors
        logits = rng.normal(size=(m, m)).astype(np.float32) * 2.0
        self._trans = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        self._m = m

    def global_batch(self, step: int) -> Dict[str, np.ndarray]:
        """The whole batch of ``step`` as numpy arrays: ``tokens`` and
        ``labels`` (B, S) int32, and ``frames`` or ``patch_embeds`` fp32."""
        B, S = self.shape.global_batch, self.shape.seq_len
        rng = np.random.default_rng((self.data.seed, step))
        states = rng.integers(0, self._m, size=B)
        seq = np.empty((B, S + 1), np.int32)
        seq[:, 0] = states
        # vectorized chain sampling via inverse-CDF
        cdf = np.cumsum(self._trans, axis=-1)
        u = rng.random(size=(B, S))
        for t in range(S):
            seq[:, t + 1] = (u[:, t, None] < cdf[seq[:, t]]).argmax(-1)
        batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
        batch.update(self._frontend_stub(rng, B))
        return batch

    def host_batch(self, step: int) -> Dict[str, torch.Tensor]:
        """This host's rows of ``global_batch(step)`` as tensors on the
        pipeline's device."""
        g = self.global_batch(step)
        B = self.shape.global_batch
        lo = B * self.data.host_index // self.data.host_count
        hi = B * (self.data.host_index + 1) // self.data.host_count
        return {k: torch.from_numpy(np.ascontiguousarray(v[lo:hi])).to(self.device)
                for k, v in g.items()}

    def _frontend_stub(self, rng, B: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        if cfg.family == "audio":
            F = cfg.encdec.n_frames
            d = cfg.encdec.frame_dim or cfg.d_model
            return {"frames": rng.normal(size=(B, F, d)).astype(np.float32)}
        if cfg.family == "vlm":
            Np = cfg.vlm.n_patches
            d = cfg.vlm.patch_dim or cfg.d_model
            return {"patch_embeds": rng.normal(size=(B, Np, d)).astype(np.float32)}
        return {}

    def optimal_loss(self) -> float:
        """Conditional entropy of the chain (nats): the floor for CE."""
        p = self._trans
        stationary = np.linalg.matrix_power(p, 512)[0]
        h = -(p * np.log(p + 1e-12)).sum(-1)
        return float((stationary * h).sum())


def make_batch_specs(cfg: ArchConfig, shape: ShapeSpec
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """``{name: (shape, dtype)}`` of one training batch."""
    B, S = shape.global_batch, shape.seq_len
    specs = {"tokens": ((B, S), torch.int32), "labels": ((B, S), torch.int32)}
    if cfg.family == "audio":
        d = cfg.encdec.frame_dim or cfg.d_model
        specs["frames"] = ((B, cfg.encdec.n_frames, d), torch.float32)
    if cfg.family == "vlm":
        d = cfg.vlm.patch_dim or cfg.d_model
        specs["patch_embeds"] = ((B, cfg.vlm.n_patches, d), torch.float32)
    return specs
