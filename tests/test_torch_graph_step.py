"""The scheduler's graphed steps (``serve/graphs.py``).

On the card the batched decode step and the full-size prefill chunk are
captured once as CUDA graphs and replayed; that needs a step that is
fixed-shape and mask-only, a chunk step whose slot is a device tensor, and
state whose storage never moves.  On the CPU the same steps run eagerly,
and these tests hold each of those properties there, exactly:

* the mask-only ``_step_impl`` is bitwise the step it replaced, which
  gathered the active rows (``active_idx``) for the output-ring write and
  merged the recurrent rows into new tensors;
* the chunk step with a 0-d tensor slot is bitwise the int-slot step;
* every cache leaf, ``last_tokens``, ``out_buf`` and ``out_pos`` keeps its
  storage across steps, chunks and ``reset()``.

The ``gpu`` tests hold a replay bitwise against the eager step on the card
(greedy and temperature/top-k), the kernel counters' advance on replay,
and a capture that syncs to the host raising.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels.moe_experts import (moe_combine_kernel, moe_experts_kernel,
                                             moe_route_kernel)
from repro_torch.kernels.paged_attention import paged_attention_kernel
from repro_torch.kernels.rglru_scan import rglru_scan_kernel
from repro_torch.kernels.ssd_scan import ssd_scan_kernel
from repro_torch.models import build_model, kvcache
from repro_torch.models.config import layer_pattern
from repro_torch.serve.scheduler import DecodeScheduler

torch.set_num_threads(2)

# (arch, kv_mode, attn_backend): dense, hybrid, SSM and MoE, paged on both
# backends where there is attention, and rings
CASES = [("minicpm-2b", "paged", "gather"), ("minicpm-2b", "paged", "paged_kernel"),
         ("minicpm-2b", "ring", "gather"), ("recurrentgemma-2b", "paged", "gather"),
         ("recurrentgemma-2b", "paged", "paged_kernel"), ("recurrentgemma-2b", "ring", "gather"),
         ("mamba2-1.3b", "paged", "gather"), ("mamba2-1.3b", "ring", "gather"),
         ("moonshot-v1-16b-a3b", "paged", "gather"),
         ("moonshot-v1-16b-a3b", "paged", "paged_kernel"),
         ("moonshot-v1-16b-a3b", "ring", "gather")]
IDS = [f"{a}-{m}-{b}" for a, m, b in CASES]
SAMPLING = {"greedy": (0.0, 0), "temperature": (0.8, 50)}
N_SLOTS, CHUNK = 4, 5


def mixed_scheduler(arch, kv_mode, backend, sampling="greedy", device="cpu"):
    """A scheduler of 4 slots after 7 steps: in paged mode two slots
    decoding, one mid-admission (chunks of 5) and one empty; in ring mode
    three decoding and one empty."""
    cfg = configs.get(arch).reduced()
    model = build_model(cfg, device=device, seed=0)
    temperature, top_k = SAMPLING[sampling]
    sched = DecodeScheduler(model, n_slots=N_SLOTS, max_seq=32, page_size=4,
                            prefill_chunk=CHUNK, kv_mode=kv_mode, attn_backend=backend,
                            temperature=temperature, top_k=top_k, seed=3, device=device)
    rng = np.random.default_rng(0)
    for i, P in enumerate((7, 11, 18)):
        sched.submit(f"s{i}", f"r{i}", rng.integers(0, cfg.vocab, size=P), 12)
    for _ in range(7):
        sched.step()
    states = [s.state.value for s in sched.slots]
    assert any(s.decoding for s in sched.slots) and not all(s.decoding for s in sched.slots), \
        states
    return cfg, sched


def decoding_mask(sched) -> torch.Tensor:
    return torch.tensor([s.decoding for s in sched.slots], device=sched.device)


def clone_state(sched):
    return ({k: v.clone() for k, v in sched.cache.items()}, sched.last_tokens.clone(),
            sched.out_buf.clone(), sched.out_pos.clone())


def assert_same_state(a, b) -> None:
    cache_a, *rest_a = a
    cache_b, *rest_b = b
    assert cache_a.keys() == cache_b.keys()
    for key in cache_a:
        assert torch.equal(cache_a[key], cache_b[key]), key
    for name, x, y in zip(("last_tokens", "out_buf", "out_pos"), rest_a, rest_b, strict=True):
        assert torch.equal(x, y), name


# -- the step this PR's mask-only step replaced, kept here as its reference ----------


def gathered_mask_slot_rows(new_cache, old_cache, keep):
    out = dict(new_cache)
    out["length"] = torch.where(keep, new_cache["length"], old_cache["length"])
    for key in ("h", "conv", "ssm"):
        if key in new_cache:
            k = keep.reshape((1, -1) + (1,) * (new_cache[key].ndim - 2))
            out[key] = torch.where(k, new_cache[key], old_cache[key])
    return out


def gathered_step(sched, cache, last_tokens, out_buf, out_pos, active, active_idx):
    logits, new_cache = sched.model.decode_step(cache, last_tokens[:, None])
    new_cache = gathered_mask_slot_rows(new_cache, cache, active)
    toks = torch.where(active, sched._sample(logits[:, -1]), last_tokens)
    out_buf[active_idx, out_pos[active_idx] % sched.max_seq] = toks[active_idx]
    return new_cache, toks, out_buf, out_pos + active.to(torch.int32)


@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("arch,kv_mode,backend", CASES, ids=IDS)
def test_mask_only_step_is_bitwise_the_gathered_step(arch, kv_mode, backend, sampling):
    _, sched = mixed_scheduler(arch, kv_mode, backend, sampling)
    active = decoding_mask(sched)
    active_idx = torch.nonzero(active)[:, 0]
    gen0 = sched._gen.get_state()
    masked = clone_state(sched)
    for _ in range(3):
        sched._step_impl(*masked, active)
    sched._gen.set_state(gen0)
    cache, last, out, pos = clone_state(sched)
    for _ in range(3):
        cache, last, out, pos = gathered_step(sched, cache, last, out, pos, active, active_idx)
    assert_same_state(masked, (cache, last, out, pos))
    # the inactive slots' rows did not move, the active ones' did
    before = clone_state(sched)
    assert torch.equal(masked[0]["length"][~active], before[0]["length"][~active])
    assert torch.equal(masked[0]["length"][active], before[0]["length"][active] + 3)
    assert torch.equal(masked[3], before[3] + 3 * active.to(torch.int32))


@pytest.mark.parametrize("slot", [0, N_SLOTS - 1])
@pytest.mark.parametrize("arch", ["minicpm-2b", "recurrentgemma-2b", "mamba2-1.3b",
                                  "moonshot-v1-16b-a3b"])
def test_chunk_step_with_a_tensor_slot_is_bitwise_the_int_slot(arch, slot):
    cfg = configs.get(arch).reduced()
    model = build_model(cfg, device="cpu", seed=0)
    sched = DecodeScheduler(model, n_slots=N_SLOTS, max_seq=32, page_size=4,
                            prefill_chunk=CHUNK, device="cpu")
    cache = sched.cache
    rng = np.random.default_rng(1)
    if "page_table" in cache and model.n_kv_layers:
        for s in range(N_SLOTS):
            kvcache.set_page_row(cache, s, rng.permutation(sched.n_pages)[:sched.max_pages])
    for s in range(N_SLOTS):     # a first chunk in every slot: no state is zero
        first = torch.as_tensor(rng.integers(0, cfg.vocab, size=(1, 3 + s)), dtype=torch.int32)
        sched._chunk(cache, first, s)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, size=(1, CHUNK)), dtype=torch.int32)
    by_int = {k: v.clone() for k, v in cache.items()}
    by_tensor = {k: v.clone() for k, v in cache.items()}
    logits_int, _ = sched._chunk(by_int, tokens, slot)
    logits_tensor, _ = sched._chunk(by_tensor, tokens, torch.tensor(slot))
    assert torch.equal(logits_int, logits_tensor)
    for key in cache:
        assert torch.equal(by_int[key], by_tensor[key]), key
    assert int(by_tensor["length"][slot]) == int(cache["length"][slot]) + CHUNK
    # slot surgery with a tensor slot, as with an int
    kvcache.cache_clear_slot(by_int, slot)
    kvcache.cache_clear_slot(by_tensor, torch.tensor(slot))
    for key in cache:
        assert torch.equal(by_int[key], by_tensor[key]), key


def storage(sched) -> dict:
    ptrs = {f"cache.{k}": v.data_ptr() for k, v in sched.cache.items()}
    ptrs.update(last_tokens=sched.last_tokens.data_ptr(), out_buf=sched.out_buf.data_ptr(),
                out_pos=sched.out_pos.data_ptr())
    return ptrs


@pytest.mark.parametrize("kv_mode", ["paged", "ring"])
@pytest.mark.parametrize("arch", ["minicpm-2b", "recurrentgemma-2b", "mamba2-1.3b",
                                  "moonshot-v1-16b-a3b"])
def test_state_keeps_its_storage_across_steps_chunks_and_reset(arch, kv_mode):
    cfg = configs.get(arch).reduced()
    model = build_model(cfg, device="cpu", seed=0)
    sched = DecodeScheduler(model, n_slots=3, max_seq=32, page_size=4, prefill_chunk=CHUNK,
                            kv_mode=kv_mode, seed=1, device="cpu")
    rng = np.random.default_rng(2)
    ptrs = storage(sched)
    cache = sched.cache
    for round_ in range(2):
        for i, P in enumerate((7, 13, 4, 10)):
            sched.submit(f"s{i % 3}", f"r{round_}{i}", rng.integers(0, cfg.vocab, size=P), 5)
        done = steps = 0
        while sched.busy():
            done += len(sched.step())
            steps += 1
            assert storage(sched) == ptrs and sched.cache is cache, f"step {steps}"
        assert done == 4 and sched.prefill_tokens > 0
        sched.reset()
        assert storage(sched) == ptrs and sched.cache is cache


# -- on the card ------------------------------------------------------------------------


def cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph and the kernels have no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("arch,kv_mode,backend", CASES, ids=IDS)
def test_replay_is_bitwise_the_eager_step(arch, kv_mode, backend, sampling):
    """Decode: 4 replays of the captured step against 4 eager steps from
    the same state and generator state, with inactive slots.  Chunk (paged
    mode): one replay of the 5-token chunk graph at slot 2, from length 0,
    against the eager chunk, and the token drawn from its last logits (past
    the mapped pages every write would go to the scratch page, where
    colliding writes of one launch land in no fixed order)."""
    cuda_or_skip()
    cfg, sched = mixed_scheduler(arch, kv_mode, backend, sampling, device="cuda")
    assert "decode" in sched.graphs
    active = decoding_mask(sched)
    sched._active.copy_(active)
    start, gen0 = clone_state(sched), sched._gen.get_state()
    for _ in range(4):
        sched.graphs.replay("decode")
    replayed = clone_state(sched)
    sched._gen.set_state(gen0)
    for _ in range(4):
        sched._step_impl(*start, active.clone())
    torch.cuda.synchronize()
    assert_same_state(replayed, start)
    if kv_mode != "paged":
        return
    assert "chunk" in sched.graphs
    sched.cache["length"][2] = 0     # the chunk writes into pages slot 2's table maps
    tokens = torch.as_tensor(np.random.default_rng(5).integers(0, cfg.vocab, size=(1, CHUNK)),
                             dtype=torch.int32, device="cuda")
    start, gen0 = clone_state(sched), sched._gen.get_state()
    sched._chunk_tokens.copy_(tokens)
    sched._chunk_at.fill_(2)
    logits_r = sched.graphs.replay("chunk").clone()
    tok_r = sched._sample(logits_r[:, -1])
    replayed = clone_state(sched)
    sched._gen.set_state(gen0)
    logits_e, _ = sched._chunk(start[0], tokens, torch.tensor(2, device="cuda"))
    tok_e = sched._sample(logits_e[:, -1])
    torch.cuda.synchronize()
    assert torch.equal(logits_r, logits_e) and torch.equal(tok_r, tok_e)
    assert_same_state(replayed, start)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["minicpm-2b", "recurrentgemma-2b", "mamba2-1.3b",
                                  "moonshot-v1-16b-a3b"])
def test_kernel_counters_advance_on_replay(arch):
    cuda_or_skip()
    backend = "gather" if arch == "mamba2-1.3b" else "paged_kernel"
    cfg, sched = mixed_scheduler(arch, "paged", backend, device="cuda")
    pattern = layer_pattern(cfg) if cfg.family == "hybrid" else ""
    moe = cfg.family == "moe"
    per_step = {"paged": pattern.count("a") if pattern else
                (cfg.n_layers if backend == "paged_kernel" else 0),
                "rglru": pattern.count("r"),
                "ssd": cfg.n_layers if cfg.family == "ssm" else 0,
                "moe_experts": 2 * cfg.n_layers if moe else 0,
                "moe_route": cfg.n_layers if moe else 0,
                "moe_combine": cfg.n_layers if moe else 0}
    wrappers = (paged_attention_kernel, rglru_scan_kernel, ssd_scan_kernel,
                moe_experts_kernel, moe_route_kernel, moe_combine_kernel)
    before = [w.launches for w in wrappers]
    for _ in range(3):
        sched.graphs.replay("decode")
    torch.cuda.synchronize()
    after = [w.launches for w in wrappers]
    assert [a - b for a, b in zip(after, before)] == [3 * n for n in per_step.values()]
    assert len(sched.graphs.captures) == 2 and sched.graphs.pool_bytes() > 0


class SyncingScheduler(DecodeScheduler):
    """Reads a sampled token on the host: legal eagerly, not in a capture."""

    def _sample(self, logits):
        toks = super()._sample(logits)
        if int(toks[0]) < 0:
            raise AssertionError("unreachable")
        return toks


@pytest.mark.gpu
def test_a_host_sync_in_the_captured_step_raises():
    cuda_or_skip()
    cfg = configs.get("minicpm-2b").reduced()
    sched = SyncingScheduler(build_model(cfg, device="cuda", seed=0), n_slots=2, max_seq=16,
                             page_size=4, prefill_chunk=CHUNK, device="cuda")
    sched.submit("s", "r", np.arange(3) % cfg.vocab, 4)
    with pytest.raises(RuntimeError, match="capturing|capture"):
        # the 3-token prompt's eager chunk and first token, then the first
        # decode step: its warm-up syncs legally, its capture raises
        sched.step()
    assert "decode" not in sched.graphs and sched.graphs.captures == []
