"""Probe the MoE routing kernels on the card (``moe_route`` and
``moe_route_backward``): against another build of their sources, split by
phase, and as source variants, each timed in turns.

  python3 scripts/route_probe.py compare --against DIR
      DIR holds another revision's moe_experts.cu, moe_backward.cu and
      hopper.cuh (``git show REV:src/repro_torch/kernels/csrc/NAME >
      DIR/NAME``).  Every Route output on chip_smoke's ROUTE_CASES, with
      top-k and forced experts, and the route backward's dx on four layer
      states, bitwise the other build's; dw within ROUTE_BWD_DW_TOL of the
      plain version; device ms of both builds in turns (A B B A) at
      moonshot's T = 8, 256, 4096, 8192 and the route backward at 8192.
  python3 scripts/route_probe.py split [--src DIR]
      The package's sources (or DIR's) built again with a stop after each
      phase of the routing launch, timed in turns: the product, the slice
      sums, the routing, the rank, the rest of the launch, and the sort
      launch (the earlier one-launch kernel: product, slice sums, routing
      with the rank, the sort).  With the package's sources also the route
      backward's dx and dw launches alone.
  python3 scripts/route_probe.py variant --sub OLD=>NEW [--sub ...]
      moe_experts.cu with each OLD text replaced by NEW (each must occur
      once) against the package's, outputs bitwise and device ms in turns.

Builds use the package's nvcc flags (``kernels/build.py``) into
``build/route_probe/``; each library is loaded with ctypes in place of the
package's (``kernel._lib``, ``kernel._blib``).  Device ms are
``chip_smoke.queued_device_ms``: launches queued behind a device sleep,
no profiler.  Needs the card; prints one line per result.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

OUT = ROOT / "build" / "route_probe"
NAMES = ("moe_experts", "moe_backward")
MOONSHOT = (2048, 64, 6)                     # D, E, k
TIMED = (8, 256, 4096, 8192)
# stops after each phase of the routing launch: (anchor, text, after)
# for the package's sources and for the earlier one-launch kernel
STOPS = {
    "tiled": [
        ("    } else {\n        if (!last_to_arrive(p.counters + tile, s.groups, &flag)) return;",
         "#if STOP == 1\n        return;\n#endif\n", False),
        ("        if (!last_to_arrive(p.counters + tile, s.groups, &flag)) return;\n",
         "#if STOP == 1\n        return;\n#endif\n", False),
        ("    // B tokens of a warp at once: 4 where", "#if STOP == 2\n    return;\n#endif\n",
         False),
        ("    // each pair's rank within its expert in the tile, in pair order: warp w\n",
         "#if STOP == 3\n    return;\n#endif\n", False),
        ("    if (s.n_tiles == 1) {       // one tile", "#if STOP == 4\n    return;\n#endif\n",
         False),
        ("    if (e != cudaSuccess || p.s.n_tiles == 1) return e;\n",
         "#if STOP != 0\n    return e;\n#endif\n", True),
    ],
    "lane": [
        ("    } else {\n        if (!last_to_arrive(p.counters + tile, s.groups, &flag)) return;",
         "#if STOP == 1\n        return;\n#endif\n", False),
        ("        if (!last_to_arrive(p.counters + tile, s.groups, &flag)) return;\n",
         "#if STOP == 1\n        return;\n#endif\n", False),
        ("    for (int r = warp; r < n_valid; r += kRouteThreads / 32)\n        route_token(",
         "#if STOP == 2\n    return;\n#endif\n", False),
        ("    if (!last_to_arrive(p.counters + kRouteCounters - 1, s.n_tiles, &flag)) return;",
         "#if STOP == 3\n    return;\n#endif\n", False),
    ],
}
PHASES = {"tiled": ("product", "slice sums", "routing", "rank", "rest of the launch",
                    "sort launch"),
          "lane": ("product", "slice sums", "routing and rank", "sort")}
# the route backward: the dx launch alone (STOP 1), the dw launch alone (STOP 2)
BWD_STOPS = [
    ("    moe_route_backward_dx_kernel<CI><<<", "#if STOP != 2\n", False),
    ("<<<p.s.n_tok_tiles, kThreads, p.s.dx_smem, stream>>>(p);\n", "#endif\n", True),
    ("    err = cudaFuncSetAttribute(moe_route_backward_dw_kernel,",
     "#if STOP == 1\n    return cudaGetLastError();\n#endif\n", False),
]


def patched(src: str, stops) -> str:
    for anchor, text, after in stops:
        if src.count(anchor) != 1:
            raise SystemExit(f"anchor not found once: {anchor!r}")
        src = src.replace(anchor, anchor + text if after else text + anchor)
    return src


def compile_all(jobs):
    """jobs: {tag: (source path, include dir, extra flags)} -> {tag: library path}."""
    from repro_torch.kernels import build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, (src, inc, flags) in jobs.items():
        lib = OUT / f"{tag}.so"
        procs[tag] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, *flags, "-I", str(inc), "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for tag, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {tag}:\n{log[-4000:]}")
        out[tag] = lib
    return out


class Libraries:
    """Points the wrappers at a pair of libraries (None: the package's)."""

    def __init__(self):
        from repro_torch.kernels import build
        import repro_torch.kernels.moe_experts.kernel as mk

        self.build, self.mk = build, mk
        self.orig = build.load
        self.cache = {}

    def use(self, fwd=None, bwd=None):
        libs = {}
        for name, path in zip(NAMES, (fwd, bwd)):
            if path is None:
                libs[name] = self.orig(name)
            else:
                libs[name] = self.cache.setdefault(str(path), ctypes.CDLL(str(path)))
        self.build.load = lambda name: libs[name]
        self.mk._lib = None
        self.mk._blib = None
        self.mk._library()
        self.mk._backward_library()
        self.build.load = self.orig


def timed(cs, libs, setups, fn, iters):
    """Device ms of fn under each library setup, in turns (A B B A ...)."""
    order = list(setups) + list(setups)[::-1]
    res = {tag: [] for tag in setups}
    for tag in order:
        libs.use(**setups[tag])
        res[tag].append(cs.queued_device_ms(lambda i: fn(), iters))
    libs.use()
    return res


def route_inputs(T, D, E, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(T, D, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn(D, E, generator=gen, device="cuda") * D ** -0.5
    return x, w


def route_backward_state(cs, T, seed):
    import torch

    from repro_torch import configs
    from repro_torch.models.moe import capacity

    cfg = configs.get(cs.MOE)
    m = cfg.moe
    gen = torch.Generator(device="cuda").manual_seed(seed)
    st = cs.moe_bwd_inputs(gen, T, m.n_experts, m.top_k, cfg.d_model, m.d_expert, True,
                           cfg.mlp, capacity(T, m), special=False)
    return cs.moe_bwd_calls(st, cfg.mlp)["moe_route_backward"][0]


def compare(args, cs):
    import torch

    from repro_torch.kernels.moe_experts import ref

    other = Path(args.against)
    libs_paths = compile_all({f"other_{n}": (other / f"{n}.cu", other, []) for n in NAMES})
    other_setup = {"fwd": libs_paths["other_moe_experts"], "bwd": libs_paths["other_moe_backward"]}
    libs = Libraries()
    fails = 0
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for T, D, E, k, kind in cs.ROUTE_CASES:
        x = torch.randn(T, D, generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.zeros(D, E, device="cuda") if kind == "tied" else
             torch.randn(D, E, generator=gen, device="cuda") * D ** -0.5)
        forced = torch.randint(0, E, (T, k), generator=gen, device="cuda", dtype=torch.int32)
        outs = {}
        for tag, setup in (("package", {}), ("other", other_setup)):
            libs.use(**setup)
            outs[tag] = (libs.mk.moe_route_kernel(x, w, k),
                         libs.mk.moe_route_kernel(x, w, k, forced=forced))
        torch.cuda.synchronize()
        for j, label in enumerate(("top-k", "forced")):
            same = {n: torch.equal(a, b) for n, a, b in
                    zip(ref.Route._fields, outs["package"][j], outs["other"][j])}
            fails += not all(same.values())
            print(f"COMPARE route T={T} D={D} E={E} k={k} {kind} {label}: bitwise {same}",
                  flush=True)
    libs.use()
    for T, E, k, D, F in ((37, 8, 2, 64, 48), (512, 64, 6, 2048, 64), (4095, 40, 5, 1536, 96),
                          (cs.T38, 64, 6, 2048, 64)):
        st = cs.moe_bwd_inputs(gen, T, E, k, D, F, False, "swiglu", None, special=False)
        r = st["r"]
        dwt = torch.randn(T, k, generator=gen, device="cuda")
        res = {}
        for tag, setup in (("package", {}), ("other", other_setup)):
            libs.use(**setup)
            res[tag] = libs.mk.moe_route_backward_kernel(st["x"], st["w"], r.gates, r.weights,
                                                         r.idx, dwt, st["dgates"])
        libs.use()
        with cs.fp32_reductions():
            want = ref.moe_route_backward_plain(st["x"], st["w"], r.gates, r.weights, r.idx,
                                                dwt, st["dgates"])
        torch.cuda.synchronize()
        dx_same = torch.equal(res["package"][0], res["other"][0])
        dw_err = cs.rel_max(res["package"][1], want[1])
        fails += not (dx_same and dw_err <= cs.ROUTE_BWD_DW_TOL)
        other_err = cs.rel_max(res["other"][1], want[1])
        print(f"COMPARE route backward T={T} E={E} k={k} D={D}: dx bitwise {dx_same}; dw err / "
              f"largest |want| {dw_err:.3g} (other build {other_err:.3g})", flush=True)
        del st
    D, E, k = MOONSHOT
    setups = {"other": other_setup, "package": {}}
    for T in TIMED:
        x, w = route_inputs(T, D, E, args.seed + T)
        res = timed(cs, libs, setups, lambda: libs.mk.moe_route_kernel(x, w, k),
                    40 if T <= 256 else 20)
        print(f"TIME moe_route T={T}: other {res['other']}, package {res['package']} ms",
              flush=True)
    kern = route_backward_state(cs, cs.T38, args.seed)
    res = timed(cs, libs, setups, kern, 5)
    print(f"TIME moe_route_backward T={cs.T38}: other {res['other']}, package {res['package']} ms",
          flush=True)
    return fails


def split(args, cs):
    src_dir = Path(args.src) if args.src else ROOT / "src/repro_torch/kernels/csrc"
    fwd = (src_dir / "moe_experts.cu").read_text()
    family = "tiled" if "route_tokens" in fwd else "lane"
    stage = OUT / f"split_{family}"
    stage.mkdir(parents=True, exist_ok=True)
    for hdr in src_dir.glob("*.cuh"):
        shutil.copy(hdr, stage / hdr.name)
    (stage / "moe_experts.cu").write_text(patched(fwd, STOPS[family]))
    n = len(PHASES[family])
    jobs = {f"f{v}": (stage / "moe_experts.cu", stage, [f"-DSTOP={v}"]) for v in range(n)}
    if family == "tiled":
        bwd = (src_dir / "moe_backward.cu").read_text()
        (stage / "moe_backward.cu").write_text(patched(bwd, BWD_STOPS))
        jobs.update({f"b{v}": (stage / "moe_backward.cu", stage, [f"-DSTOP={v}"])
                     for v in range(3)})
    paths = compile_all(jobs)
    libs = Libraries()
    D, E, k = MOONSHOT
    for T in TIMED:
        x, w = route_inputs(T, D, E, args.seed + T)
        setups = {v: {"fwd": paths[f"f{v}"]} for v in range(n)}
        res = timed(cs, libs, setups, lambda: libs.mk.moe_route_kernel(x, w, k),
                    40 if T <= 256 else 20)
        mean = {v: sum(r) / len(r) for v, r in res.items()}
        stops = [mean[v] for v in range(1, n)] + [mean[0]]
        parts = [stops[0]] + [b - a for a, b in zip(stops, stops[1:])]
        print(f"SPLIT {family} T={T}: " + ", ".join(f"{name} {ms:.5f}" for name, ms in
                                                   zip(PHASES[family], parts)) +
              f"; whole {mean[0]:.5f} ms; every run {res}", flush=True)
    if family == "tiled":
        kern = route_backward_state(cs, cs.T38, args.seed)
        setups = {v: {"bwd": paths[f"b{v}"]} for v in range(3)}
        res = timed(cs, libs, setups, kern, 5)
        print(f"SPLIT route backward T={cs.T38}: both {res[0]}, dx launch alone {res[1]}, dw "
              f"launch alone {res[2]} ms", flush=True)
    return 0


def variant(args, cs):
    import torch

    csrc = ROOT / "src/repro_torch/kernels/csrc"
    name = "moe_experts.cu"
    src = (csrc / name).read_text()
    for sub in args.sub:
        old, new = sub.split("=>", 1)
        old, new = old.encode().decode("unicode_escape"), new.encode().decode("unicode_escape")
        if src.count(old) != 1:
            raise SystemExit(f"not found once in {name}: {old!r}")
        src = src.replace(old, new)
    stage = OUT / "variant"
    stage.mkdir(parents=True, exist_ok=True)
    for hdr in csrc.glob("*.cuh"):
        shutil.copy(hdr, stage / hdr.name)
    (stage / name).write_text(src)
    path = compile_all({"variant": (stage / name, stage, [])})["variant"]
    setups = {"package": {}, "variant": {"fwd": path}}
    libs = Libraries()
    D, E, k = MOONSHOT
    for T in TIMED:
        x, w = route_inputs(T, D, E, args.seed + T)
        outs = {}
        for tag, setup in setups.items():
            libs.use(**setup)
            outs[tag] = libs.mk.moe_route_kernel(x, w, k)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(outs["package"], outs["variant"]))
        res = timed(cs, libs, setups, lambda: libs.mk.moe_route_kernel(x, w, k),
                    40 if T <= 256 else 20)
        print(f"VARIANT T={T}: package {res['package']}, variant {res['variant']} ms; Route "
              f"bitwise {same}", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("compare")
    c.add_argument("--against", required=True)
    s = sub.add_parser("split")
    s.add_argument("--src", default=None)
    v = sub.add_parser("variant")
    v.add_argument("--sub", action="append", required=True)
    for p in (c, s, v):
        p.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("route_probe: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi_line(), torch.__version__, torch.version.cuda, flush=True)
    from repro_torch.kernels import build

    build.build(list(NAMES))
    fails = {"compare": compare, "split": split, "variant": variant}[args.cmd](args, cs)
    print(f"route_probe {args.cmd}: {fails} failed checks", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
