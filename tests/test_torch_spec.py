"""Draft-and-verify speculative decoding in the port.

* The port's draft step, batched draft catch-up and verify step against
  the JAX package's ``make_draft_step`` / ``make_draft_catchup_step`` /
  ``make_spec_verify_step`` on the same weights (``jax_and_port``), from
  the same cache state (the JAX cache's leaves written into the port's
  before each step; the hybrid's recurrent rows, which the two packages
  lay out differently, come from each side's own chunks over the same
  prompts) and the same tokens: logits within ``REL_TOL`` of their scale
  (``test_torch_model``) and the argmax tokens equal wherever JAX's margin
  is decisive; the last tokens and lengths equal; and the verify's
  accepted counts, output ring, positions and rewound lengths equal the
  JAX step's run on the port's own argmax tokens.
* The constructor refuses what the reference refuses, with a
  ``ValueError`` naming the cause.
* A hybrid target under a disagreeing draft: after every partial accept
  the slot's ``h``/``conv`` rows are bitwise those of the run without
  speculation at the same canonical length.
* The widest back-padded catch-up the scheduler can issue never writes a
  live lane of the draft ring.
* A self-draft accepts every proposal its budget allows (on the CPU the
  verify chunk is bitwise the S=1 steps), and ``run_serving`` serves end to
  end with the ``spec_*`` stats.

The ``gpu`` tests need the card: the verify and draft graphs' replays
bitwise their eager steps, and one round's kernel launches counted
exactly for hybrid and MoE targets.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels.moe_experts import (moe_combine_kernel, moe_experts_kernel,
                                             moe_route_kernel)
from repro_torch.kernels.rglru_scan import rglru_scan_kernel
from repro_torch.launch.serve import run_serving
from repro_torch.models import build_model, kvcache
from repro_torch.models.config import layer_pattern
from repro_torch.serve.engine import (generate, make_chunk_step, make_draft_catchup_step,
                                      make_draft_step, make_spec_verify_step)
from repro_torch.serve.scheduler import DecodeScheduler

try:    # the card's machine has no JAX: there only the gpu-marked tests run
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import build_model as jax_build_model
    from repro.models import kvcache as jkv
    from repro.serve import engine as jengine
    from repro_torch.weights import params_from_jax
    from test_torch_model import assert_logits_agree, jax_and_port
except ModuleNotFoundError:
    jax = None

torch.set_num_threads(2)

FAMILIES = {"dense": "minicpm-2b", "moe": "moonshot-v1-16b-a3b",
            "hybrid": "recurrentgemma-2b"}
PS, N_PAGES, MP, MAX_SEQ, K = 4, 16, 6, 16, 3
ROWS = [np.asarray([7, 2, 9, 4, 0, -1], np.int32),
        np.asarray([3, 11, 5, -1, -1, -1], np.int32),
        np.asarray([12, 6, -1, -1, -1, -1], np.int32)]
PROMPTS = (13, 9, 7)


def jax_and_port_routed(family):
    """``jax_and_port`` of the family's arch; a MoE model routes every
    token to all of its experts.  Free-running, a bf16 step of difference
    between the frameworks can flip a near-tied route and move a token's
    logits far past ``REL_TOL`` (``test_torch_moe``'s docstring); with
    top-k equal to the expert count no route can flip, and the steps'
    arithmetic (drop-free routing over the chunk's rows included) is held
    to the tolerance."""
    arch = FAMILIES[family]
    if family != "moe":
        return jax_and_port(arch)

    def all_experts(cfg):
        return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, top_k=cfg.moe.n_experts))

    jcfg, tcfg = all_experts(jconfigs.get(arch).reduced()), all_experts(configs.get(arch).reduced())
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.key(0))
    tm = build_model(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu"))
    return jm, jp, tm


def load_jax_state(tc, jc) -> None:
    """Write a JAX dense/moe cache's leaves into the port's cache in place
    (the pool's pages below the port's scratch page), so the two steps
    start from one state; a hybrid cache keeps the state its own chunks
    left."""
    if "blocks" in jc:
        return
    for key, leaf in jc.items():
        if key == "page_table":
            continue
        src = torch.from_numpy(np.array(jnp.asarray(leaf).astype(
            jnp.float32 if leaf.dtype == jnp.bfloat16 else leaf.dtype)))
        dst = tc[key][:, :src.shape[1]] if key in ("kp", "vp") else tc[key]
        dst.copy_(src.to(dst.dtype))


def need_jax():
    if jax is None:
        pytest.skip("the JAX package is not installed here")


def _prefilled(family):
    """(jax model, params, port model, jax cache, port cache, first tokens):
    three slots on scrambled page tables, each side's chunk step over the
    same prompts in chunks of 5; the first tokens are JAX's argmax of each
    prompt's last logits."""
    jm, jp, tm = jax_and_port_routed(family)
    jc = jkv.paged_cache(jm, 3, page_size=PS, n_pages=N_PAGES, max_pages=MP)
    tc = kvcache.paged_cache(tm, 3, page_size=PS, n_pages=N_PAGES, max_pages=MP)
    for b, row in enumerate(ROWS):
        jc = jkv.set_page_row(jc, b, row)
        kvcache.set_page_row(tc, b, row)
    jchunk, tchunk = jax.jit(jengine.make_chunk_step(jm)), make_chunk_step(tm)
    rng = np.random.default_rng(1)
    first = []
    for b, n in enumerate(PROMPTS):
        p = rng.integers(0, tm.cfg.vocab, size=n).astype(np.int32)
        for lo in range(0, n, 5):
            logits, jc = jchunk(jp, jc, jnp.asarray(p[None, lo:lo + 5]), b)
            tchunk(tc, torch.from_numpy(p[None, lo:lo + 5]), b)
        first.append(int(jnp.argmax(logits[0, -1])))
    return jm, jp, tm, jc, tc, np.asarray(first, np.int32)


class ForcedArgmax:
    """The JAX model with its logits replaced by a one-hot of given tokens:
    the JAX verify step then runs its own acceptance arithmetic (accepted
    counts, output ring, last tokens, length rewind) on those argmax tokens,
    and writes the cache as the real model does."""

    def __init__(self, jm, y):
        self.jm, self.y = jm, jnp.asarray(y)

    def decode_step(self, params, cache, tokens):
        logits, new_cache = self.jm.decode_step(params, cache, tokens)
        return jax.nn.one_hot(self.y, logits.shape[-1], dtype=logits.dtype), new_cache


@pytest.mark.parametrize("family", list(FAMILIES))
def test_verify_step_matches_jax(family):
    """Slot 0's drafts are the target's own greedy continuation, capped at
    k_eff = 2; slot 1's second draft is wrong (a = 1); slot 2 is masked out.
    The output rings start from random tokens, so the columns a round must
    leave alone are checked too.  The logits agree with the JAX verify's
    within ``REL_TOL``, and so the argmax tokens wherever JAX's top-2 margin
    is decisive (twice the tolerance; an argmax is not held where the two
    frameworks' bf16 orders can swap it).  Everything the step derives from
    its argmax tokens is held exactly to the JAX step run on the port's own
    tokens (:class:`ForcedArgmax`)."""
    need_jax()
    jm, jp, tm, jc, tc, first = _prefilled(family)
    jstep = jax.jit(jengine.make_decode_step(jm))
    tok, cont, c = jnp.asarray(first), [], jc
    for _ in range(K):
        tok, _, c = jstep(jp, c, tok[:, None])
        cont.append(np.asarray(tok))
    drafts = np.stack(cont, axis=1)
    drafts[1, 1] = (drafts[1, 1] + 1) % tm.cfg.vocab
    vt = np.concatenate([first[:, None], drafts], axis=1).astype(np.int32)
    active = np.asarray([True, True, False])
    k_eff = np.asarray([2, 3, 3], np.int32)
    rng = np.random.default_rng(2)
    out_buf = rng.integers(0, tm.cfg.vocab, size=(3, MAX_SEQ)).astype(np.int32)
    out_pos = np.asarray([5, 9, 3], np.int32)
    last = np.asarray([first[0], first[1], 77], np.int32)

    want_logits, _ = jax.jit(jm.decode_step)(jp, jc, jnp.asarray(vt))
    load_jax_state(tc, jc)
    t_buf, t_pos, t_last = (torch.from_numpy(x.copy()) for x in (out_buf, out_pos, last))
    y, a, logits = make_spec_verify_step(tm, max_seq=MAX_SEQ)(
        tc, torch.from_numpy(vt), torch.from_numpy(active), torch.from_numpy(k_eff),
        t_buf, t_pos, t_last)
    assert_logits_agree(logits.float(), want_logits, tm.cfg.vocab)
    jverify = jax.jit(jengine.make_spec_verify_step(ForcedArgmax(jm, y.numpy()),
                                                    max_seq=MAX_SEQ))
    jc2, jy, ja, jbuf, jpos, jlast = jverify(
        jp, jc, jnp.asarray(vt), jnp.asarray(active), jnp.asarray(k_eff),
        jnp.asarray(out_buf), jnp.asarray(out_pos), jnp.asarray(last))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    assert a.tolist()[:2] == [2, 1]
    np.testing.assert_array_equal(t_last.numpy(), np.asarray(jlast))
    np.testing.assert_array_equal(t_pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(t_buf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(tc["length"].numpy(), np.asarray(jc2["length"]))
    assert tc["length"].tolist() == [13 + 3, 9 + 2, 7]


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_draft_catchup_and_draft_step_match_jax(family):
    """Ring caches of three rows: a back-padded catch-up (counts 9, 4 and a
    masked row), a second one over the pad lanes (counts 2, 3), then two
    draft steps; last tokens, lengths and the real positions' logits
    against the JAX steps."""
    need_jax()
    jm, jp, tm = jax_and_port_routed(family)
    T = 24
    jc, tc = jkv.batched_cache(jm, 3, T), kvcache.batched_cache(tm, 3, T)
    jcatch = jax.jit(jengine.make_draft_catchup_step(jm))
    jlogits = jax.jit(jm.decode_step)
    tcatch = make_draft_catchup_step(tm)
    active = np.asarray([True, True, False])
    rng = np.random.default_rng(3)
    out = torch.zeros(3, dtype=torch.int32)
    for counts in ((9, 4, 1), (2, 3, 1)):
        W = max(counts)
        toks = np.zeros((3, W), np.int32)
        for b, n in enumerate(counts):
            toks[b, :n] = rng.integers(0, tm.cfg.vocab, size=n)
        cnt = np.asarray(counts, np.int32)
        want, _ = jlogits(jp, jc, jnp.asarray(toks))
        load_jax_state(tc, jc)
        jc, jlast = jcatch(jp, jc, jnp.asarray(toks), jnp.asarray(cnt), jnp.asarray(active))
        logits = tcatch(tc, torch.from_numpy(toks), torch.from_numpy(cnt),
                        torch.from_numpy(active), out)
        for b in (0, 1):
            assert_logits_agree(logits[b, :counts[b]].float(), want[b, :counts[b]],
                                tm.cfg.vocab)
        np.testing.assert_array_equal(out.numpy()[:2], np.asarray(jlast)[:2])
        np.testing.assert_array_equal(tc["length"].numpy(), np.asarray(jc["length"]))
    assert tc["length"].tolist() == [11, 7, 0]
    jdraft, tdraft = jax.jit(jengine.make_draft_step(jm)), make_draft_step(tm)
    last = out.clone()
    for _ in range(2):
        want, _ = jlogits(jp, jc, jnp.asarray(last.numpy())[:, None])
        load_jax_state(tc, jc)
        jc, jtok = jdraft(jp, jc, jnp.asarray(last.numpy()), jnp.asarray(active))
        logits = tdraft(tc, last, torch.from_numpy(active), last)
        assert_logits_agree(logits[:2].float(), want[:2], tm.cfg.vocab)
        np.testing.assert_array_equal(last.numpy(), np.asarray(jtok))
        np.testing.assert_array_equal(tc["length"].numpy(), np.asarray(jc["length"]))
    assert tc["length"].tolist() == [13, 9, 0]


def _model(arch, seed=0, device="cpu", **over):
    return build_model(dataclasses.replace(configs.get(arch).reduced(), **over),
                       device=device, seed=seed)


def test_constructor_refuses_what_the_reference_refuses():
    dense, ssm, hybrid = _model("minicpm-2b"), _model("mamba2-1.3b"), _model("recurrentgemma-2b")
    spec = dict(draft_model=dense, spec_k=2, device="cpu")
    cases = [
        (dense, dict(kv_mode="ring"), "kv_mode='paged'"),
        (ssm, {}, "KV-bearing target"),
        (dense, dict(temperature=0.7), "greedy-only"),
        (dense, dict(attn_backend="paged_kernel"), "attn_backend='gather'"),
        (dense, dict(draft_model=hybrid), "draft family must be dense or moe"),
        (dense, dict(draft_model=ssm), "draft family must be dense or moe"),
        (dense, dict(draft_model=_model("minicpm-2b", vocab=128)), "draft vocab 128"),
    ]
    for target, kw, match in cases:
        with pytest.raises(ValueError, match=match):
            DecodeScheduler(target, **{**spec, **kw})
    with pytest.raises(NotImplementedError, match="not ported"):
        DecodeScheduler(dense, **spec, mesh=object())
    # the fleet's index journal is ported: it rides along with speculation
    DecodeScheduler(dense, **spec, prefix_sharing=True, index_journal=True)
    # accepted: dense, moe and hybrid targets; dense and moe drafts
    for target in (dense, _model("moonshot-v1-16b-a3b"), hybrid):
        for draft in (dense, _model("moonshot-v1-16b-a3b", seed=7)):
            sched = DecodeScheduler(target, **{**spec, "draft_model": draft})
            assert sched._spec and sched.draft_cache["k"].shape[2] == \
                2 * sched.max_pages * sched.page_size + 2 + 2


def _serve(sched, prompts, max_new, record=None):
    """Submit each prompt as its own session and step to the end; returns
    the tokens by request, and calls ``record(sched)`` after every step."""
    for i, p in enumerate(prompts):
        sched.submit(f"s{i}", f"r{i}", p, max_new)
    out = {}
    while sched.busy():
        for fin in sched.step():
            out[fin.request_id] = fin.tokens
        sched.audit()
        if record is not None:
            record(sched)
    return out


def test_hybrid_rows_after_partial_accepts_are_bitwise_the_plain_run():
    """recurrentgemma-2b (reduced) under a minicpm-2b draft rejects nearly
    every proposal; after each round, every decoding slot's ``h`` and
    ``conv`` rows are bitwise the rows of the run without speculation at
    the same canonical length, and the tokens are the same."""
    target, draft = _model("recurrentgemma-2b"), _model("minicpm-2b")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, size=n).astype(np.int32) for n in (11, 6)]
    kw = dict(n_slots=2, max_seq=40, page_size=PS, prefill_chunk=5, device="cpu")

    def recorder(table):
        def record(sched):
            for st in sched.slots:
                if st.decoding:
                    rows = tuple(sched.cache[key][:, st.index].clone() for key in ("h", "conv"))
                    table.setdefault((st.req.request_id, st.len), []).append(rows)
        return record

    plain, spec = {}, {}
    want = _serve(DecodeScheduler(target, **kw), prompts, 20, recorder(plain))
    sched = DecodeScheduler(target, draft_model=draft, spec_k=K, **kw)
    got = _serve(sched, prompts, 20, recorder(spec))
    assert got.keys() == want.keys()
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    st = sched.spec_stats()
    assert st["spec_rollbacks"] > 0 and st["spec_accepted"] < st["spec_proposed"]
    assert spec.keys() <= plain.keys() and len(spec) >= 8
    for key, seen in spec.items():
        ref = plain[key][0]
        for rows in seen:
            for r, w in zip(rows, ref, strict=True):
                assert torch.equal(r, w), key


def test_widest_padded_catchup_never_writes_a_live_draft_lane():
    """Slot 0's draft row sits at the deepest canonical length a verify
    span reaches (span + k); slot 1's pending span is the longest an
    admission gives (max_seq + 1 with its first token).  The catch-up pads
    slot 0 to slot 1's width: its writes land past its live lanes and
    never wrap onto them, in the ring the scheduler sized."""
    draft = _model("minicpm-2b")
    sched = DecodeScheduler(_model("minicpm-2b", seed=1), n_slots=2, max_seq=22, page_size=PS,
                            draft_model=draft, spec_k=K, device="cpu")
    span = sched.max_pages * sched.page_size
    L, W = span + K, sched.max_seq + 1
    dc = sched.draft_cache
    T = dc["k"].shape[2]
    assert T == 2 * span + K + 2 and L + W - 1 < T
    rng = np.random.default_rng(5)
    catch = make_draft_catchup_step(draft)
    out = torch.zeros(2, dtype=torch.int32)
    fill = rng.integers(0, 256, size=(2, L)).astype(np.int32)
    catch(dc, torch.from_numpy(fill), torch.tensor([L, 1], dtype=torch.int32),
          torch.tensor([True, False]), out)
    assert dc["length"].tolist() == [L, 0]
    live = {key: dc[key][:, 0, :L].clone() for key in ("k", "v", "positions")}
    toks = np.zeros((2, W), np.int32)
    toks[0, 0] = 7
    toks[1] = rng.integers(0, 256, size=W)
    catch(dc, torch.from_numpy(toks), torch.tensor([1, W], dtype=torch.int32),
          torch.tensor([True, True]), out)
    assert dc["length"].tolist() == [L + 1, W]
    for key, before in live.items():
        assert torch.equal(dc[key][:, 0, :L], before), key
    # the pad lanes hold positions past the canonical length: masked until
    # a later write covers them
    assert (dc["positions"][:, 0, L + 1:L + W] > L).all()


@pytest.mark.parametrize("arch", ["minicpm-2b", "moonshot-v1-16b-a3b"])
def test_self_draft_accepts_every_proposal_its_budget_allows(arch):
    """On the CPU the verify chunk is bitwise the S=1 steps, so a
    self-draft accepts every proposal: 12 tokens after the first in 3
    rounds of k + 1 = 4, and the stream is solo ``generate``'s."""
    model = _model(arch)
    sched = DecodeScheduler(model, n_slots=2, max_seq=32, page_size=PS, prefill_chunk=5,
                            draft_model=model, spec_k=K, device="cpu")
    prompt = np.random.default_rng(6).integers(0, 256, size=9).astype(np.int32)
    got = _serve(sched, [prompt], 13)["r0"]
    want = generate(model, torch.from_numpy(prompt)[None], 13, seq_len=32)[0].numpy()
    np.testing.assert_array_equal(got, want)
    st = sched.spec_stats()
    assert (st["spec_rounds"], st["spec_proposed"], st["spec_accepted"],
            st["spec_emitted"]) == (3, 9, 9, 12)
    assert st["spec_acceptance_rate"] == 1.0 and st["spec_rollbacks"] == 0


def test_run_serving_with_speculation_end_to_end_on_cpu():
    fe = run_serving("minicpm-2b", 6, max_new=7, prompt_len=10, sessions=3, batch_size=2,
                     prefill_chunk=4, page_size=4, spec_draft="minicpm-2b", spec_k=2,
                     quiet=True, device="cpu")
    assert sum(len(v) for v in fe.completions.values()) == 6
    for ids in fe.completions.values():
        assert ids == sorted(ids, key=lambda r: int(r[1:]))
    st = fe.serving_stats()
    assert st["spec_k"] == 2 and st["spec_rounds"] > 0 and st["completed"] == 6
    assert st["spec_emitted"] == st["decode_tokens"] == 6 * 6
    for key in ("spec_proposed", "spec_accepted", "spec_acceptance_rate",
                "spec_steps_per_token", "spec_rollbacks"):
        assert key in st
    fe.scheduler.audit()
    fe = run_serving("recurrentgemma-2b", 2, max_new=5, prompt_len=8, sessions=2,
                     batch_size=2, spec_draft="minicpm-2b", quiet=True, device="cpu")
    assert fe.serving_stats()["spec_k"] == 3


# -- on the card --------------------------------------------------------------------


def cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph and the kernels have no CPU mode")


CARD_CASES = [("minicpm-2b", "minicpm-2b", 0), ("recurrentgemma-2b", "minicpm-2b", 0),
              ("moonshot-v1-16b-a3b", "moonshot-v1-16b-a3b", 0)]


def card_scheduler(arch, draft_arch, draft_seed):
    """A speculative scheduler on the card after a few rounds: 3 slots, two
    decoding and one mid-admission, both graphs captured."""
    model = _model(arch, device="cuda")
    draft = (model if (draft_arch, draft_seed) == (arch, 0) else
             _model(draft_arch, seed=draft_seed, device="cuda"))
    sched = DecodeScheduler(model, n_slots=3, max_seq=48, page_size=PS, prefill_chunk=5,
                            draft_model=draft, spec_k=K, device="cuda")
    rng = np.random.default_rng(7)
    for i, P in enumerate((7, 9, 23)):
        sched.submit(f"s{i}", f"r{i}", rng.integers(0, 256, size=P), 30)
    for _ in range(6):
        sched.step()
    assert "verify" in sched.graphs and "draft" in sched.graphs
    assert [s.decoding for s in sched.slots] == [True, True, False]
    return sched


def spec_state(sched) -> dict:
    out = {f"cache.{k}": v for k, v in sched.cache.items()}
    out.update({f"draft.{k}": v for k, v in sched.draft_cache.items()})
    out.update({f"rows.{k}": v for k, v in sched._spec_rows.items()})
    out.update(last_tokens=sched.last_tokens, out_buf=sched.out_buf, out_pos=sched.out_pos,
               vtok=sched._vtok, dtok=sched._dtok)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("arch,draft_arch,draft_seed", CARD_CASES)
def test_spec_graph_replays_are_bitwise_their_eager_steps(arch, draft_arch, draft_seed):
    """From one state, the draft graph's replay and the eager draft step,
    then the verify graph's replay and the eager verify step, leave every
    cache, draft-ring, row-snapshot and token leaf bitwise the same (the
    scratch page aside: colliding writes of one launch land there in no
    fixed order, and nothing reads it)."""
    cuda_or_skip()
    sched = card_scheduler(arch, draft_arch, draft_seed)
    sched._active.copy_(torch.tensor([s.decoding for s in sched.slots], device="cuda"))
    sched._k_eff.fill_(K)
    for key, eager in (("draft", sched._draft_step_impl), ("verify", sched._verify_impl)):
        state = spec_state(sched)
        start = {k: v.clone() for k, v in state.items()}
        got = sched.graphs.replay(key)
        got = None if got is None else [t.clone() for t in got]
        replayed = {k: v.clone() for k, v in state.items()}
        for k, v in state.items():
            v.copy_(start[k])
        want = eager()
        torch.cuda.synchronize()
        if got is not None:
            assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True)), key
        for k, v in state.items():
            a, b = replayed[k], v
            if k in ("cache.kp", "cache.vp"):
                a, b = a[:, :-1], b[:, :-1]
            assert torch.equal(a, b), (key, k)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,draft_arch,draft_seed", CARD_CASES[1:])
def test_spec_round_launch_counts_are_exact(arch, draft_arch, draft_seed):
    """One round with no prefill in its tick: RG-LRU launches = RG-LRU
    layers x (one verify + the round's rollback replays) for the hybrid
    target; moe_experts = 2 x layers x (one catch-up + k-1 draft steps +
    one verify) and the route and combine kernels one each per layer and
    call for the MoE self-draft."""
    cuda_or_skip()
    sched = card_scheduler(arch, draft_arch, draft_seed)
    while any(s.state.value == "admitting" for s in sched.slots):
        sched.step()
    wrappers = (rglru_scan_kernel, moe_experts_kernel, moe_route_kernel, moe_combine_kernel)
    before = [w.launches for w in wrappers]
    rb0, pf0 = sched.spec_rollbacks, sched.prefill_chunks
    sched.step()
    torch.cuda.synchronize()
    delta = [w.launches - b for w, b in zip(wrappers, before)]
    assert sched.prefill_chunks == pf0
    cfg = sched.model.cfg
    if cfg.family == "hybrid":
        n_rec = layer_pattern(cfg).count("r")
        assert delta == [n_rec * (1 + sched.spec_rollbacks - rb0), 0, 0, 0]
    else:
        calls = 1 + (K - 1) + 1
        assert delta == [0, 2 * cfg.n_layers * calls, cfg.n_layers * calls,
                         cfg.n_layers * calls]
