"""Time one ``all_reduce`` of the sharded decode's merge on gloo ranks that
share one card, the way ``DecodeScheduler(mesh=)`` runs them.

    python3 scripts/collective_latency.py [--device cuda|cpu]

Spawns (1, 2) and (2, 2) meshes (``launch/sharded_smoke.spawn_ranks``) and
times, on rank 0, a SUM over the ``model`` group of 288, 18,720 and
147,456 floats (a decode step's softmax maxima, minicpm-2b's lane merge
of 8 slots, and a larger buffer), with the tensor on the card, on the
host, copied to the host and back, and through pinned memory: 5 warm-up
calls, then the mean of 50, synchronized.  Prints one line per mesh.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

SIZES = (288, 18720, 147456)
CALLS = 50


def rank(mesh, device: str) -> dict:
    import torch
    import torch.distributed as dist

    group = mesh.get_group("model")
    kinds = ("cuda", "cpu", "staged", "pinned") if device == "cuda" else ("cpu",)
    out = {}
    for n in SIZES:
        for kind in kinds:
            t = torch.ones(n, device="cpu" if kind == "cpu" else device)
            host = torch.empty(n, pin_memory=True) if kind == "pinned" else None

            def one():
                if kind in ("cuda", "cpu"):
                    dist.all_reduce(t, group=group)
                elif kind == "staged":
                    c = t.cpu()
                    dist.all_reduce(c, group=group)
                    t.copy_(c)
                else:
                    host.copy_(t)
                    dist.all_reduce(host, group=group)
                    t.copy_(host, non_blocking=True)

            def sync():
                if device == "cuda":
                    torch.cuda.synchronize()

            for _ in range(5):
                one()
            sync()
            t0 = time.perf_counter()
            for _ in range(CALLS):
                one()
            sync()
            out[f"{kind}/{n}"] = (time.perf_counter() - t0) / CALLS * 1e3
    return out


def main() -> None:
    from repro_torch.launch.sharded_smoke import spawn_ranks

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    for dp, mp in ((1, 2), (2, 2)):
        res = spawn_ranks(rank, (args.device,), dp=dp, mp=mp, device=args.device,
                          timeout_s=300)
        print(f"mesh {dp}x{mp}, ms an all_reduce (rank 0): "
              + ", ".join(f"{k} {v:.4f}" for k, v in res[0].items()), flush=True)


if __name__ == "__main__":
    main()
