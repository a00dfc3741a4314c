"""The serving frontend's fleet flavour, in the port, on the CPU.

``launch.serve.build_frontend(fleet_size=3)`` puts a ``FleetController``
of three worker schedulers behind the shared dispatch queue.  A burst of
requests over several sessions must be served whole, in per-session FIFO
order; a crash of the serving invocation aborts the controller (every
live worker fail-stops, its work is requeued) and the queue's redelivery
still completes each request exactly once; every worker spawn is billed
as one worker invocation; and ``serving_stats()`` carries the JAX
package's keys — with its values, since the fleet's decisions depend on
prompt lengths and timing, not on token values, and the two packages'
simulated clouds draw the same latencies.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import FaultPlan as JaxFaultPlan
from repro.core import SimCloud as JaxSimCloud
from repro.launch.serve import build_frontend as jax_build_frontend
from repro.launch.serve import spawn_workload as jax_spawn_workload
from repro.models import build_model as jax_build_model
from repro_torch import configs
from repro_torch.core import FaultPlan, SimCloud
from repro_torch.launch.serve import build_frontend, spawn_workload
from repro_torch.models import build_model
from repro_torch.serve.engine import generate

torch.set_num_threads(2)

ARCH = "minicpm-2b"
KW = dict(mode="continuous", batch_size=2, prompt_len=12, max_new=4, page_size=4,
          prefill_chunk=4, prefix_sharing=True, fleet_size=3, scale_to_zero=True)
WORK = dict(n_requests=12, sessions=4, prompt_len=12, max_new=4)
_MODEL = {}


def _model():
    if not _MODEL:
        cfg = configs.get(ARCH).reduced()
        _MODEL["m"] = (cfg, build_model(cfg, device="cpu", seed=0))
    return _MODEL["m"]


def _serve(faults=None):
    cfg, model = _model()
    cloud = SimCloud(seed=0, faults=faults)
    fe = build_frontend(cloud, cfg, model, device="cpu", **KW)
    spawn_workload(cloud, fe, vocab=cfg.vocab, **WORK)
    cloud.run()
    return fe


def _expected_ids():
    out = {}
    for i in range(WORK["n_requests"]):
        out.setdefault(f"s{i % WORK['sessions']}", []).append(f"r{i}")
    return out


def _prompts():
    """The workload's prompts, as ``spawn_workload`` draws them."""
    cfg, _ = _model()
    rng = np.random.default_rng(0)
    return {f"r{i}": rng.integers(0, cfg.vocab, size=WORK["prompt_len"]).astype(np.int32)
            for i in range(WORK["n_requests"])}


def test_fleet_front_serves_all_in_fifo_order_with_solo_tokens():
    fe = _serve()
    assert fe.completions == _expected_ids()       # all served, FIFO per session
    assert fe.dropped_requests() == 0
    s = fe.serving_stats()
    assert s["mode"] == "fleet" and s["workers_live"] == 0     # scaled to zero
    assert s["spawns"] >= 2 and s["cold_starts_from_zero"] >= 1
    _, model = _model()
    prompts = _prompts()
    for sess, ids in fe.completions.items():
        for rid, toks in zip(ids, fe.results[sess], strict=True):
            want = generate(model, torch.from_numpy(prompts[rid])[None], WORK["max_new"],
                            seq_len=WORK["prompt_len"] + WORK["max_new"])[0].numpy()
            np.testing.assert_array_equal(np.asarray(toks), want, err_msg=rid)


def test_one_billed_worker_invocation_per_spawn():
    fe = _serve()
    s = fe.serving_stats()
    wst = fe.runtime.stats["serve:worker"]
    assert s["worker_invocations"] == s["spawns"] == wst.invocations == wst.cold_starts
    assert s["worker_cost_usd"] > 0 and s["offload_storage_ops"] > 0


def test_exactly_once_after_controller_abort_and_redelivery():
    """The serving invocation crashes after its second batch of
    completions: the controller aborts (live workers fail-stop, in-flight
    work is requeued), the dispatch queue redelivers, and every request
    completes exactly once, in per-session order."""
    fe = _serve(FaultPlan(crashes={("serve", "post-complete"): 1}))
    assert fe.runtime.stats["serve"].crashes == 1
    assert fe.completions == _expected_ids()
    assert all(len(ids) == len(set(ids)) for ids in fe.completions.values())
    s = fe.serving_stats()
    assert s["crashes"] >= 1 and s["dropped"] == 0


@pytest.mark.parametrize("crash", [False, True], ids=["clean", "abort"])
def test_serving_stats_equal_the_reference(crash):
    """Same keys as the JAX frontend's fleet flavour, and the same values
    (the decisions and the simulated latencies do not depend on the
    weights)."""
    fe = _serve(FaultPlan(crashes={("serve", "post-complete"): 1}) if crash else None)
    jcfg = jconfigs.get(ARCH).reduced()
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.key(0))
    faults = JaxFaultPlan(crashes={("serve", "post-complete"): 1}) if crash else None
    jcloud = JaxSimCloud(seed=0, faults=faults)
    jfe = jax_build_frontend(jcloud, jcfg, jm, jp, **KW)
    jax_spawn_workload(jcloud, jfe, vocab=jcfg.vocab, **WORK)
    jcloud.run()
    ps, js = fe.serving_stats(), jfe.serving_stats()
    assert sorted(ps) == sorted(js)
    assert ps == pytest.approx(js, rel=1e-12)
    assert fe.cloud.now == jcloud.now
    assert fe.completions == jfe.completions
