"""Model-facing entry point of flash attention.

The JAX package's ``ops.py`` transposes to (B*H, S, D), repeats each kv head
over its query group and pads S and T to the TPU kernel's blocks.  The CUDA
kernel reads the model's layout, indexes each query head's kv head and
masks its own ragged edges, so here the entry point only brings k and v to
q's dtype and all three to contiguous, 16-byte aligned memory (the
tensor-core route copies rows by 16 bytes; a contiguous view that starts
off that boundary is copied).
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernel import flash_attention_kernel


def _dense(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    t = t.to(dtype).contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """q (B, S, H, D); k, v (B, T, Hkv, D) -> (B, S, H, D) in q's dtype; query
    row i and key j at positions i and j (a sequence attending itself from
    position 0), fp32 softmax state."""
    return flash_attention_kernel(_dense(q, q.dtype), _dense(k, q.dtype), _dense(v, q.dtype),
                                  causal=causal, window=window)
