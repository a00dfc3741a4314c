"""End-to-end training driver with FaaSKeeper coordination (the JAX
package's ``launch/train.py``).

Trains a config for real while exercising the control plane: ephemeral-
znode membership, transactional checkpoint manifests, progress reporting,
straggler scanning and crash/restart recovery.  The control plane's event
loop (``SimCloud``) is single-threaded: the async checkpoint thread's
commit and garbage pass and the step loop's progress reports take one lock,
so they never drive it at once.  The model is built for
training (fp32 masters, ``build_model(train=True)``) from ``--seed`` on
``--device`` (``cuda`` unless asked otherwise).  On the card every
attention of 4096 tokens or more runs in the flash kernel, every RG-LRU
recurrence in the scan kernel, every SSD recurrence (mamba2, the ``ssm``
family) in the SSD scan kernel and every MoE layer (the ``moe`` family) in
the route, grouped expert and combine kernels, forward and backward: every
family trains on the card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b --steps 50 \\
      --smoke --ckpt-dir /tmp/ckpt [--resume] [--simulate-failure 20] [--device cpu] \\
      [--accum-steps 4]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import threading
import time
from typing import Optional

import torch

from .. import configs
from ..checkpoint import CheckpointStore
from ..coord import CoordinatedManifest, MembershipService, StragglerDetector
from ..core import FaaSKeeperService, SimCloud
from ..data import DataConfig, SyntheticPipeline
from ..models import build_model
from ..models.config import ShapeSpec
from ..train import AdamWConfig, make_train_step
from ..train.step import TrainStepConfig, init_train_state, trainable

def build_control_plane():
    cloud = SimCloud(seed=0)
    service = FaaSKeeperService(cloud)
    return cloud, service


def optim_config(arch: str, steps: int, lr: float, schedule: Optional[str] = None
                 ) -> AdamWConfig:
    """``run_training``'s AdamW, as the JAX package's ``run_training``
    builds it: minicpm takes WSD, the others cosine, every schedule a tenth
    of the run as warmup and the config's defaults for the rest (WSD's
    stable share and floor; ``configs/minicpm_2b.py::WSD`` is the preset,
    which neither reads)."""
    schedule = schedule or ("wsd" if arch.startswith("minicpm") else "cosine")
    return AdamWConfig(lr=lr, total_steps=steps, warmup_steps=max(1, steps // 10),
                       schedule=schedule)


def run_training(arch: str, steps: int = 50, *, smoke: bool = True,
                 ckpt_dir: Optional[str] = None, resume: bool = False,
                 ckpt_every: int = 20, simulate_failure: Optional[int] = None,
                 seq_len: int = 64, global_batch: int = 8,
                 lr: float = 3e-3, log_every: int = 10,
                 schedule: Optional[str] = None, device: str = "cuda",
                 accum_steps: int = 1, seed: int = 0, n_layers: Optional[int] = None):
    """Train ``arch`` (its ``.reduced()`` config with ``smoke``; ``n_layers``
    cuts the depth) for ``steps`` steps of ``global_batch`` sequences of
    ``seq_len`` tokens in ``accum_steps`` microbatches.  Returns the
    per-step losses, grad norms, learning rates and wall seconds."""
    cfg = configs.get(arch)
    if smoke:
        cfg = cfg.reduced()
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    dev = torch.device(device)
    model = build_model(cfg, device=dev, seed=seed, train=True)
    shape = ShapeSpec("driver", seq_len, global_batch, "train")
    pipe = SyntheticPipeline(cfg, shape, DataConfig(seed=0), device=dev)

    # -- control plane ---------------------------------------------------------
    cloud, service = build_control_plane()
    cp_state = os.path.join(ckpt_dir, "control_plane.pkl") if ckpt_dir else None
    if resume and cp_state and os.path.exists(cp_state):
        # fresh functions attach to the durable storage of the previous run
        with open(cp_state, "rb") as f:
            service.load_storage(f.read())
    membership = MembershipService(service)
    worker = membership.join("worker-0", {"devices": 1, "device": str(dev)})
    stragglers = StragglerDetector(service)
    manifest = CoordinatedManifest(service, job=f"train-{arch}")
    # every control-plane call after this point holds the lock: the save
    # thread's commit and manifest reads overlap the step loop's reports
    control = threading.Lock()

    def persist_control_plane(step: int, m) -> None:
        with control:
            manifest.commit(step, m)
            if cp_state:
                tmp = cp_state + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(service.snapshot_storage())
                os.replace(tmp, cp_state)

    def latest_committed():
        with control:
            return manifest.latest()

    store = None
    if ckpt_dir:
        store = CheckpointStore(ckpt_dir, committer=persist_control_plane,
                                latest_resolver=latest_committed)

    # -- data plane ---------------------------------------------------------------
    optim = optim_config(arch, steps, lr, schedule)
    step_cfg = TrainStepConfig(accum_steps=accum_steps)
    params = trainable(model)
    state = init_train_state(params, step_cfg)
    start_step = 0
    if resume and store is not None:
        try:
            restored, start_step = store.restore({"params": params, "opt": state})
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(restored["params"][name])
            state = restored["opt"]
            print(f"[coord] resumed from committed checkpoint step {start_step} "
                  f"(txid-ordered manifest via FaaSKeeper; every leaf's bytes checked "
                  f"against its saved digest)")
        except FileNotFoundError:
            print("[coord] no committed checkpoint; starting fresh")
    train_step = make_train_step(model, optim, step_cfg)

    losses, grad_norms, lrs, step_s, missing = [], [], [], [], 0
    t0 = time.time()
    for step in range(start_step, steps):
        if simulate_failure is not None and step == simulate_failure and not resume:
            if store is not None:
                # drain in-flight async saves before injecting the fault: their
                # device->host copy already happened at save_async time, so a
                # checkpoint started >= 1 step ago counts as durably committed,
                # and the background committer must not race the eviction below
                store.wait()
            print(f"[fault] simulating worker crash at step {step} "
                  f"(restart with --resume to recover)")
            with control:
                membership.fail(worker)
                service.start_heartbeat(period=5.0, max_runs=3)
                cloud.run()
                members = membership.members()
            print(f"[coord] members after eviction: {members}")
            return {"crashed_at": step, "losses": losses, "grad_norms": grad_norms,
                    "start_step": start_step}
        ts = time.perf_counter()
        batch = pipe.host_batch(step)
        params, state, metrics = train_step(params, state, batch)
        loss = float(metrics["loss"])           # waits for the step
        step_s.append(time.perf_counter() - ts)
        losses.append(loss)
        grad_norms.append(float(metrics["grad_norm"]))
        lrs.append(float(metrics["lr"]))
        missing = max(missing, metrics["params_without_grad"])
        with control:
            stragglers.report("worker-0", step)
        if (step + 1) % log_every == 0:
            print(f"step {step+1:5d}  loss {loss:.4f}  lr {lrs[-1]:.2e} "
                  f" gnorm {grad_norms[-1]:.3f}  {step_s[-1] * 1e3:.1f} ms")
        if store is not None and (step + 1) % ckpt_every == 0:
            store.save_async(step + 1, {"params": params, "opt": state})
    if store is not None:
        store.wait()
    with control:
        rep = stragglers.scan()
    dt = time.time() - t0
    if losses:
        print(f"done: {len(losses)} steps in {dt:.1f}s; "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
              f"(chain floor {pipe.optimal_loss():.3f}); stragglers: {rep.lagging}")
    with control:
        membership.leave(worker)
        coord_cost = service.cost_summary()["total_usd"]
    return {"losses": losses, "final_loss": losses[-1] if losses else None,
            "grad_norms": grad_norms, "lrs": lrs, "step_s": step_s,
            "start_step": start_step, "params_without_grad": missing,
            "n_params": sum(p.numel() for p in params.values()),
            "optimal_loss": pipe.optimal_loss(), "coord_cost_usd": coord_cost}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.list_archs())
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="the full config (one card holds minicpm-2b, recurrentgemma-2b and "
                         "mamba2-1.3b)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--simulate-failure", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--accum-steps", type=int, default=1,
                    help="microbatches a step (a full-size global batch fits one card only "
                         "in microbatches)")
    args = ap.parse_args()
    run_training(args.arch, args.steps, smoke=args.smoke, ckpt_dir=args.ckpt_dir,
                 resume=args.resume, ckpt_every=args.ckpt_every,
                 simulate_failure=args.simulate_failure, seq_len=args.seq_len,
                 global_batch=args.global_batch, lr=args.lr, device=args.device,
                 accum_steps=args.accum_steps)


if __name__ == "__main__":
    main()
