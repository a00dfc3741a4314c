"""The port's checkpoint store, its FaaSKeeper-coordinated manifests and
straggler detection (mirroring ``tests/test_coord_and_checkpoint.py``, on
the port's own FaaSKeeper core), and the training driver end to end:
train, crash, restart with ``resume``; on the CPU the resumed losses are
bitwise an uninterrupted run's.  The training driver refuses, before any step, a
family whose forward on the card reaches a kernel with no backward."""

from __future__ import annotations

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.checkpoint.store import host_copy, save_tree
from repro_torch.coord import CoordinatedManifest, StragglerDetector
from repro_torch.core import FaaSKeeperService, SimCloud
from repro_torch.launch.train import optim_config, run_training


def make_service(seed: int = 0):
    cloud = SimCloud(seed=seed)
    return cloud, FaaSKeeperService(cloud)


def state_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"layers.0.attn.wq": torch.randn(4, 6, generator=g),
                       "embedding.embed": torch.randn(5, 3, generator=g).bfloat16()},
            "opt": {"mu": {"layers.0.attn.wq": torch.randn(4, 6, generator=g)},
                    "step": torch.tensor(7, dtype=torch.int32)}}


def same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    store = CheckpointStore(str(tmp_path))
    tree = state_tree()
    store.save(3, tree)
    template = state_tree(seed=1)
    restored, step = store.restore(template)
    assert step == 3 and same(restored, tree)
    with open(os.path.join(store.step_dir(3), "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    assert {e["path"] for e in leaves} == {"params/layers.0.attn.wq",
                                           "params/embedding.embed",
                                           "opt/mu/layers.0.attn.wq", "opt/step"}
    # a leaf whose bytes changed on disk is refused
    victim = os.path.join(store.step_dir(3), "params__layers.0.attn.wq.npy")

    np.save(victim, np.zeros((4, 6), np.float32))
    with pytest.raises(IOError, match="digest"):
        store.restore(template)


def test_checkpoint_manifest_atomicity(tmp_path):
    """A crash after the bulk write but before the manifest commit leaves the
    previous checkpoint authoritative."""
    cloud, svc = make_service()
    manifest = CoordinatedManifest(svc)
    store = CheckpointStore(str(tmp_path), committer=manifest.commit,
                            latest_resolver=manifest.latest)
    store.save(1, {"w": torch.arange(8.0)})
    assert manifest.latest() == 1
    save_tree(host_copy({"w": torch.arange(8.0) * 99}), store.step_dir(2))   # never committed
    restored, step = store.restore({"w": torch.zeros(8)})
    assert step == 1 and torch.equal(restored["w"], torch.arange(8.0))


def test_checkpoint_async_and_history(tmp_path):
    cloud, svc = make_service()
    manifest = CoordinatedManifest(svc)
    store = CheckpointStore(str(tmp_path), committer=manifest.commit,
                            latest_resolver=manifest.latest, keep=2)
    for s in (10, 20, 30):
        store.save_async(s, {"w": torch.full((4,), float(s))})
    store.wait()
    assert manifest.latest() == 30
    assert manifest.history() == ["step_00000010", "step_00000020", "step_00000030"]
    assert manifest.manifest_for(20)["step"] == 20
    restored, step = store.restore({"w": torch.zeros(4)}, step=20)
    assert float(restored["w"][0]) == 20.0
    assert not os.path.exists(store.step_dir(10))        # older than the 2 kept


def test_async_saves_commit_in_call_order(tmp_path, monkeypatch):
    """The first save's write is delayed before it starts: the later saves
    must still commit after it, so ``latest()`` is the last step saved and
    no committed step is pruned as dangling."""
    import time

    cloud, svc = make_service()
    manifest = CoordinatedManifest(svc)
    store = CheckpointStore(str(tmp_path), committer=manifest.commit,
                            latest_resolver=manifest.latest, keep=3)
    save_host = CheckpointStore._save_host

    def slow_first(self, step, host_tree):
        if step == 10:
            time.sleep(0.3)
        return save_host(self, step, host_tree)

    monkeypatch.setattr(CheckpointStore, "_save_host", slow_first)
    for s in (10, 20, 30):
        store.save_async(s, {"w": torch.full((4,), float(s))})
    store.wait()
    assert manifest.latest() == 30
    assert manifest.history() == ["step_00000010", "step_00000020", "step_00000030"]
    for s in (20, 30):
        restored, step = store.restore({"w": torch.zeros(4)}, step=s)
        assert step == s and float(restored["w"][0]) == float(s)


def test_straggler_detection():
    cloud, svc = make_service()
    det = StragglerDetector(svc, lag_threshold=2)
    for w, s in [("a", 10), ("b", 9), ("c", 3)]:
        det.report(w, s)
    rep = det.scan()
    assert rep.lagging == ["c"] and rep.median_step == 9.0
    det.report("c", 10)
    assert det.scan().lagging == []


KW = dict(smoke=True, seq_len=32, global_batch=4, device="cpu")


@pytest.mark.parametrize("accum", [1, 2])
def test_crash_and_resume_is_bitwise_an_uninterrupted_run(tmp_path, accum):
    """launch.train end to end: run, crash at step 9 (async saves joined
    first), restart with resume from the committed step 8; the resumed
    losses are bitwise those of one uninterrupted run."""
    full = run_training("starcoder2-3b", steps=12, accum_steps=accum, **KW)
    assert len(full["losses"]) == 12 and full["params_without_grad"] == 0
    out1 = run_training("starcoder2-3b", steps=12, ckpt_dir=str(tmp_path), ckpt_every=4,
                        simulate_failure=9, accum_steps=accum, **KW)
    assert out1["crashed_at"] == 9 and out1["losses"] == full["losses"][:9]
    out2 = run_training("starcoder2-3b", steps=12, ckpt_dir=str(tmp_path), resume=True,
                        accum_steps=accum, **KW)
    assert out2["start_step"] == 8 and len(out2["losses"]) == 4
    assert out2["losses"] == full["losses"][8:]
    assert out2["grad_norms"] == full["grad_norms"][8:]


def test_control_plane_is_driven_from_one_thread_at_a_time(tmp_path, monkeypatch):
    """A checkpoint every step: each save's commit and garbage pass (on the
    save thread) overlap the next steps' straggler reports.  The event loop
    is entered by one thread at a time (each entry held a little, to widen
    the window), and every save commits in order."""
    import threading
    import time

    inside, worst, guard = [0], [0], threading.Lock()
    run = SimCloud.run

    def watched(self, *a, **kw):
        with guard:
            inside[0] += 1
            worst[0] = max(worst[0], inside[0])
        try:
            time.sleep(0.03)
            return run(self, *a, **kw)
        finally:
            with guard:
                inside[0] -= 1

    monkeypatch.setattr(SimCloud, "run", watched)
    out = run_training("starcoder2-3b", steps=8, ckpt_dir=str(tmp_path), ckpt_every=1, **KW)
    assert len(out["losses"]) == 8 and worst[0] == 1
    cloud, svc = make_service()
    with open(os.path.join(tmp_path, "control_plane.pkl"), "rb") as f:
        svc.load_storage(f.read())
    manifest = CoordinatedManifest(svc, job="train-starcoder2-3b")
    assert manifest.latest() == 8
    assert manifest.history() == [f"step_{s:08d}" for s in range(1, 9)]


def test_run_training_reports_its_coordination_cost(monkeypatch):
    """``coord_cost_usd`` is the run's own service's ``cost_summary()`` total
    (its metered queue, storage, DynamoDB and function charges)."""
    import repro_torch.launch.train as train

    made = []
    build = train.build_control_plane

    def recorded():
        made.append(build())
        return made[-1]

    monkeypatch.setattr(train, "build_control_plane", recorded)
    out = run_training("starcoder2-3b", steps=2, **KW)
    (_, svc), = made
    assert out["coord_cost_usd"] == svc.cost_summary()["total_usd"]
    assert out["coord_cost_usd"] > 0


@pytest.mark.parametrize("steps", [6, 50, 200])
@pytest.mark.parametrize("arch", ["minicpm-2b", "starcoder2-3b"])
def test_optim_config_matches_the_reference_run_training(arch, steps, monkeypatch):
    """The port's AdamW config equals the one the JAX package's
    ``run_training`` builds (captured where it reaches ``make_train_step``):
    WSD for minicpm, cosine otherwise, a tenth of the run as warmup."""
    import repro.launch.train as reference

    class Captured(Exception):
        pass

    seen = []

    def capture(model, optim, step_cfg=None):
        seen.append(optim)
        raise Captured

    monkeypatch.setattr(reference, "make_train_step", capture)
    with pytest.raises(Captured):
        reference.run_training(arch, steps=steps, seq_len=8, global_batch=2, lr=3e-4,
                               log_every=100)
    got = optim_config(arch, steps, 3e-4)
    assert dataclasses.asdict(got) == dataclasses.asdict(seen[0])
    assert got.schedule == ("wsd" if arch.startswith("minicpm") else "cosine")


def test_only_moe_lacks_a_backward_and_mamba2_trains():
    """No family lacks its backward kernels any more (the MoE family's came
    last): ``NO_BACKWARD`` and the card's refusal are gone, and moonshot
    takes steps (its CPU path through
    ``MoEFFN`` and the plain backwards) with every parameter given a
    gradient, as mamba2 does through ``SSDScan``."""
    import repro_torch.launch.train as train_mod

    assert not hasattr(train_mod, "NO_BACKWARD")
    for arch in ("moonshot-v1-16b-a3b", "mamba2-1.3b"):
        out = run_training(arch, steps=2, device="cpu", smoke=True, seq_len=16,
                           global_batch=2, log_every=100)
        assert len(out["losses"]) == 2 and all(math.isfinite(x) for x in out["losses"])
        assert out["params_without_grad"] == 0
