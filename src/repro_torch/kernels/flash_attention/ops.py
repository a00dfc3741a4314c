"""Model-facing entry point of flash attention.

The JAX package's ``ops.py`` transposes to (B*H, S, D), repeats each kv head
over its query group and pads S and T to the TPU kernel's blocks.  The CUDA
kernel reads the model's layout, indexes each query head's kv head and
masks its own ragged edges, so here the entry point only brings k and v to
q's dtype and all three to contiguous, 16-byte aligned memory (the
tensor-core route copies rows by 16 bytes; a contiguous view that starts
off that boundary is copied).

Where autograd needs it (grad mode on and an input that requires grad),
the call goes through :class:`FlashAttention`, a ``torch.autograd.Function``
whose forward also keeps the row log-sum-exp and whose backward is the
kernel's (``flash_attention_backward_kernel``).  Every other call (serving)
launches the forward alone, as before.
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernel import flash_attention_backward_kernel, flash_attention_kernel


def _dense(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    t = t.to(dtype).contiguous()
    return t.clone() if t.data_ptr() % 16 else t


class FlashAttention(torch.autograd.Function):
    """Causal (optionally windowed) self-attention with the kernel's
    backward: saves q, k, v, o and lse; returns dq, dk, dv in the inputs'
    dtype.  Under ``torch.utils.checkpoint`` the recompute's forward saves
    its own lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        o, lse = flash_attention_kernel(q, k, v, causal=causal, window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        grads = flash_attention_backward_kernel(q, k, v, o, lse, _dense(do, q.dtype),
                                                causal=ctx.causal, window=ctx.window)
        return (*grads, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """q (B, S, H, D); k, v (B, T, Hkv, D) -> (B, S, H, D) in q's dtype; query
    row i and key j at positions i and j (a sequence attending itself from
    position 0), fp32 softmax state.  Differentiable (through
    :class:`FlashAttention`) for an aligned causal self-attention."""
    q, k, v = _dense(q, q.dtype), _dense(k, q.dtype), _dense(v, q.dtype)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window)
    return flash_attention_kernel(q, k, v, causal=causal, window=window)
