"""Serving steps: prefill, single-token decode and prefill chunks against a
KV cache, the staging steps of offload, and the three steps of
draft-and-verify speculative decoding (the draft's S=1 step, its batched
catch-up and the target's verify chunk).  Every step writes into the
caches and buffers it is given, so a CUDA graph can replay it.

The chunk, offload and speculation factories take ``policy``, a
:class:`repro_torch.dist.sharding.ShardingPolicy` installed around every
call of the step (the reference's ``_policy_scope``), so the cache's split
pool, rings and SSD state are read and written per shard (the scheduler's
``mesh=`` mode; its decode step installs the policy itself).  None installs
nothing, and an outer policy stays in force."""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from ..models import kvcache


def _policy_scope(policy):
    """Context installing ``policy``; ambient pass-through when the caller
    has none (None must not *clear* an outer policy here)."""
    if policy is None:
        return contextlib.nullcontext()
    from ..dist import sharding

    return sharding.activation_sharding(policy)


def make_decode_step(model) -> Callable:
    def serve_step(cache, tokens):
        logits, new_cache = model.decode_step(cache, tokens)
        next_token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_token, logits, new_cache

    return serve_step


def make_chunk_step(model, *, policy=None) -> Callable:
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
        with _policy_scope(policy):
            one = kvcache.cache_slot_view(cache, slot)
            logits, one_new = model.decode_step(one, tokens)
            kvcache.cache_insert_slot(cache, one_new, slot)
        return logits, cache

    return chunk_step


def make_draft_step(model, *, policy=None) -> Callable:
    """Batched S=1 greedy step of the *draft* model of a speculative
    decoder: one proposed token per masked-in slot against the draft's own
    per-slot ring cache, written in place.  Inactive rows keep their state
    and their token: the decode step's masking contract.

    ``draft_step(cache, last_tokens, active, out)`` writes each row's new
    token into ``out`` (``last_tokens`` where inactive; ``out`` may be
    ``last_tokens`` itself) and returns the logits."""

    def draft_step(cache, last_tokens, active, out) -> torch.Tensor:
        with _policy_scope(policy):
            logits, new_cache = model.decode_step(cache, last_tokens[:, None])
            kvcache.mask_slot_rows(new_cache, cache, active)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        out.copy_(torch.where(active, tok, last_tokens))
        return logits

    return draft_step


def make_draft_catchup_step(model, *, policy=None) -> Callable:
    """Batched draft catch-up on the canonical token stream: every
    masked-in slot replays the canonical tokens its draft ring has not
    consumed, in one call per verify round.

    ``tokens`` (B, W) is back-padded to the round's widest pending span and
    ``counts`` (B,) holds each row's real span (>= 1 for active rows).  The
    whole padded chunk runs through ``decode_step``; then each active row's
    length advances by its own count, so the pad positions land past the
    canonical length.  Pad-position K/V is never read: the ring path writes
    a chunk's K/V before it attends, so a later call overwrites a pad lane
    before any query's causal mask admits it, provided the ring is deep
    enough that a pad write never wraps onto a live lane (the scheduler
    sizes the draft ring for the padded worst case).

    ``catchup(cache, tokens, counts, active, out)`` writes row
    ``counts - 1`` of the greedy argmax (the last real position's token)
    into ``out`` and returns the logits."""

    def catchup(cache, tokens, counts, active, out) -> torch.Tensor:
        with _policy_scope(policy):
            logits, new_cache = model.decode_step(cache, tokens)
            # decode_step advanced every row by the padded width W; the
            # canonical advance is each row's own pending count
            new_cache["length"] = cache["length"] + counts
            kvcache.mask_slot_rows(new_cache, cache, active)
        y = torch.argmax(logits, dim=-1).to(torch.int32)              # (B, W)
        idx = (counts - 1).clamp(min=0).long()[:, None]
        out.copy_(y.gather(1, idx)[:, 0])
        return logits

    return catchup


def make_spec_verify_step(model, *, max_seq: int, policy=None) -> Callable:
    """One draft-and-verify round's target half: score ``k + 1`` tokens per
    slot in one chunked decode step against the paged pool and accept the
    longest prefix of drafts that matches the target's own greedy argmax.

    ``verify_tokens[:, 0]`` is each slot's newest canonical token and
    ``verify_tokens[:, 1:]`` the draft's proposals.  Position ``j``'s
    argmax ``y[:, j]`` is what the target samples after consuming
    ``verify_tokens[:, :j+1]``, so draft ``j+1`` is accepted iff it equals
    ``y[:, j]``; ``a = min(cumprod(match).sum(), k_eff)`` (``k_eff`` keeps a
    slot inside its ``max_new`` budget) accepted drafts emit ``a + 1``
    tokens, ``y[:, :a+1]``: the drafts and the target's own bonus or
    correction token.  Every emitted token is the target's argmax over a
    canonical prefix, so the stream is the one S=1 decode gives wherever
    the chunk computes what S=1 steps compute.

    ``verify(cache, verify_tokens, active, k_eff, out_buf, out_pos,
    last_tokens)`` writes in place: the cache (K/V of all ``S`` positions,
    lengths, recurrent rows, inactive rows kept by ``mask_slot_rows``), the
    emitted tokens into the output ring at ``out_pos % max_seq`` (other
    columns keep their values), ``out_pos`` advanced by ``a + 1``,
    ``last_tokens = y[b, a]``, and each active length rewound by
    ``S - 1 - a`` to the canonical ``old + a + 1``: the rejected positions'
    K/V sits past it, invalid to every read until a later write covers it.
    Recurrent rows advance through all ``S`` tokens and are not rewound
    here: a hybrid caller snapshots them before the step and replays the
    accepted span on a partial accept.  Returns ``(y, a, logits)``.

    Under a ``policy`` the call scores this rank's slot rows against its
    part of the pool; ``out_buf``, ``out_pos`` and ``last_tokens`` may then
    be None, and the caller emits the tokens of every slot with
    :func:`spec_emit` once ``y`` and ``a`` are shared."""

    def verify(cache, verify_tokens, active, k_eff, out_buf, out_pos, last_tokens):
        B, S = verify_tokens.shape
        with _policy_scope(policy):
            logits, new_cache = model.decode_step(cache, verify_tokens)
            kvcache.mask_slot_rows(new_cache, cache, active)
        y = torch.argmax(logits, dim=-1).to(torch.int32)              # (B, S)
        match = (verify_tokens[:, 1:] == y[:, :-1]).to(torch.int32)
        a = torch.minimum(torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32), k_eff)
        if out_buf is not None:
            spec_emit(y, a, active, out_buf, out_pos, last_tokens, max_seq=max_seq)
        cache["length"].sub_(torch.where(active, S - 1 - a, 0))
        return y, a, logits

    return verify


def spec_emit(y, a, active, out_buf, out_pos, last_tokens, *, max_seq: int) -> None:
    """A verify round's emission, in place: each active row's ``y[:, :a+1]``
    into the output ring at ``out_pos % max_seq`` (other columns keep their
    values), ``out_pos`` advanced by ``a + 1`` and ``last_tokens = y[b, a]``."""
    S = y.shape[1]
    j = torch.arange(S, dtype=torch.int32, device=y.device)
    cols = ((out_pos[:, None] + j) % max_seq).long()
    emit = active[:, None] & (j <= a[:, None])
    out_buf.scatter_(1, cols, torch.where(emit, y, out_buf.gather(1, cols)))
    last = y.gather(1, a.long()[:, None])[:, 0]
    last_tokens.copy_(torch.where(active, last, last_tokens))
    out_pos.add_(torch.where(active, a + 1, 0))


def make_offload_steps(*, policy=None) -> tuple:
    """The staging steps of storage-backed preemption and parked-session
    offload, ``(extract, inject)``.

    ``extract(cache, page_ids)`` gathers pool pages (in the page table's
    logical order) and copies them to host memory: the blob the scheduler
    puts in the object store is a dict of CPU tensors, so an offload frees
    device memory.  ``inject(cache, page_ids, blob)`` writes a blob (or a
    chunk of one) back onto freshly allocated pages, in place.  Both are
    plain calls (the reference jits them).

    With a ``policy`` (the scheduler's ``mesh=`` mode) both run under it,
    on this rank's part of the pool, as the reference's ``shard_map``
    variant does: the page axis is never split, so a page's take and
    scatter are local to each lane or head shard; the blob holds this
    rank's lanes or heads of each page (the layout
    :func:`~repro_torch.dist.sharding.offload_stage_shardings` gives the
    staging buffer), no collective runs, and an inject of a blob whose
    page shape is not the local pool's raises.
    """

    def extract(cache, page_ids):
        with _policy_scope(policy):
            return kvcache.to_host(kvcache.gather_pages(cache, page_ids))

    def inject(cache, page_ids, blob) -> None:
        with _policy_scope(policy):
            for key, src in blob.items():
                if policy is not None and src.shape[2:] != cache[key].shape[2:]:
                    raise ValueError(f"{key} blob of page shape {tuple(src.shape[2:])} is not "
                                     f"this rank's shard {tuple(cache[key].shape[2:])}")
            kvcache.scatter_pages(cache, page_ids, blob)

    return extract, inject


def make_prefill(model, seq_len: Optional[int] = None) -> Callable:
    """``seq_len`` sizes the cache for the *total* sequence (prompt + decode
    budget): without it the prompt-sized ring evicts the oldest prompt
    tokens once decode wraps it.  ``prefill(tokens, *extra)`` passes
    ``extra`` (an enc-dec model's frames, a VLM's patch embeddings) to the
    model's prefill."""

    def prefill(tokens, *extra):
        logits, cache = model.prefill(tokens, *extra, seq_len=seq_len)
        next_token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_token, cache

    return prefill


def generate(model, prompt: torch.Tensor, max_new: int, *extra,
             seq_len: Optional[int] = None) -> torch.Tensor:
    """Greedy autoregressive generation; ``seq_len >= prompt + max_new``
    gives an eviction-free decode (the scheduler's parity reference).
    ``extra`` goes to the prefill (frames, patch embeddings)."""
    prefill = make_prefill(model, seq_len)
    step = make_decode_step(model)
    tok, cache = prefill(prompt, *extra)
    out = [tok]
    for _ in range(max_new - 1):
        tok, _, cache = step(cache, tok[:, None])
        out.append(tok)
    return torch.stack(out, dim=1)
