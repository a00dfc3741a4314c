"""The speculative tier of the port's scheduler differential harness.

The JAX package's ``TIER1_SPEC_SEEDS`` rows (target, (draft arch, draft
seed, k), soup seed) over the port's event soup of
``test_torch_sched_differential`` — multi-turn parking, cross-session
shared prefixes, forced preemptions, TTL expiry — with draft-and-verify
speculative decoding on.  Every completed request must equal the port's
own *non-speculative* solo ``generate`` token for token, and ``audit()``
runs after every step.  A draft of seed 0 and the target's arch is the
target's own module (a self-draft: the accept path); any other draft
disagrees and rejects nearly every proposal (the length rewind, and for
the hybrid target the recurrent-row rollback and replay, every round).

The tier lives in its own file so that ``--dist loadfile`` gives it a
worker of its own.
"""

from __future__ import annotations

import pytest

from test_torch_sched_differential import _arch, run_and_dump

TIER1_SPEC_SEEDS = (
    [("minicpm-2b", ("minicpm-2b", 0, 3), s) for s in range(8)]
    + [("minicpm-2b", ("minicpm-2b", 7, 2), s) for s in range(4)]
    + [("moonshot-v1-16b-a3b", ("moonshot-v1-16b-a3b", 0, 3), s) for s in range(4)]
    + [("moonshot-v1-16b-a3b", ("minicpm-2b", 7, 2), s) for s in range(2)]
    + [("recurrentgemma-2b", ("minicpm-2b", 0, 3), s) for s in range(7)])


@pytest.mark.parametrize(
    "arch,spec,seed", TIER1_SPEC_SEEDS,
    ids=[f"{a}-draft_{sp[0]}_{sp[1]}_k{sp[2]}-{s}" for a, sp, s in TIER1_SPEC_SEEDS])
def test_sched_differential_spec(arch, spec, seed):
    """The event soup with speculation on, token for token the
    non-speculative solo reference, audited every step."""
    run_and_dump(arch, seed, spec=spec)


def test_spec_soup_exercises_accepts_rejects_and_rollbacks():
    """Across the matrix the self-drafts accept proposals (each capped by
    its request's remaining budget, which the soup's 2-4 new tokens keep
    small), the other drafts reject some, the hybrid target rejects every
    one and rolls its rows back (no other target does), and the soup's own
    mechanisms (forced preemption and restore, park hits, index hits) run
    under speculation too.  (The reduced models tie their embeddings, so
    two of them drawn from different seeds still agree on many tokens.)"""
    totals = {}
    for arch, spec, seed in TIER1_SPEC_SEEDS:
        sched = _arch(arch, spec)[1]
        before = sched.stats()
        run_and_dump(arch, seed, spec=spec)
        after = sched.stats()
        kind = ("self" if (spec[0], spec[1]) == (arch, 0) else
                "hybrid" if arch == "recurrentgemma-2b" else "other")
        row = totals.setdefault(kind, {})
        for key in ("spec_proposed", "spec_accepted", "spec_rollbacks", "preemptions",
                    "restores", "park_hits", "index_hits"):
            row[key] = row.get(key, 0) + after[key] - before[key]
    me, other, hybrid = totals["self"], totals["other"], totals["hybrid"]

    assert me["spec_accepted"] > 0, totals
    assert other["spec_accepted"] < other["spec_proposed"], totals
    assert hybrid["spec_accepted"] == 0 < hybrid["spec_proposed"], totals
    assert me["spec_rollbacks"] == other["spec_rollbacks"] == 0, totals
    assert hybrid["spec_rollbacks"] > 0, totals
    for key in ("preemptions", "park_hits", "index_hits"):
        assert sum(row[key] for row in totals.values()) > 0, totals
    assert sum(row["restores"] for row in totals.values()) == sum(
        row["preemptions"] for row in totals.values())
