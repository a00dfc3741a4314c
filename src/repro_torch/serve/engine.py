"""Serving steps: prefill + single-token decode against a KV cache."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models import kvcache


def make_decode_step(model) -> Callable:
    def serve_step(cache, tokens):
        logits, new_cache = model.decode_step(cache, tokens)
        next_token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_token, logits, new_cache

    return serve_step


def make_chunk_step(model) -> Callable:
    """Prefill one prompt chunk for a *single slot* of a batched paged cache.

    The chunk runs as a B=1 forward against the shared page pool: per-slot
    leaves (length, page-table row, recurrent rows) are taken at ``slot``,
    the pool is passed whole (the slot exclusively owns the pages its row
    maps, so its writes cannot race the other slots), and the advanced
    length and new recurrent rows are written back in place.  ``slot`` is an
    int or a 0-d int64 device tensor; with a tensor no host value picks the
    rows, so one CUDA graph per chunk length covers every slot (the
    reference's traced ``slot``), and the result is bitwise the int slot's.
    """

    def chunk_step(cache, tokens, slot):
        one = kvcache.cache_slot_view(cache, slot)
        logits, one_new = model.decode_step(one, tokens)
        kvcache.cache_insert_slot(cache, one_new, slot)
        return logits, cache

    return chunk_step


def make_prefill(model, seq_len: Optional[int] = None) -> Callable:
    """``seq_len`` sizes the cache for the *total* sequence (prompt + decode
    budget): without it the prompt-sized ring evicts the oldest prompt
    tokens once decode wraps it."""

    def prefill(tokens):
        logits, cache = model.prefill(tokens, seq_len=seq_len)
        next_token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_token, cache

    return prefill


def generate(model, prompt: torch.Tensor, max_new: int, *,
             seq_len: Optional[int] = None) -> torch.Tensor:
    """Greedy autoregressive generation; ``seq_len >= prompt + max_new``
    gives an eviction-free decode (the scheduler's parity reference)."""
    prefill = make_prefill(model, seq_len)
    step = make_decode_step(model)
    tok, cache = prefill(prompt)
    out = [tok]
    for _ in range(max_new - 1):
        tok, _, cache = step(cache, tok[:, None])
        out.append(tok)
    return torch.stack(out, dim=1)
