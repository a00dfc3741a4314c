"""CUDA graphs over the scheduler's steps: the port's counterpart of the
reference's ``jax.jit`` around its decode and chunk steps.

:class:`StepGraphs` holds one scheduler's graphs, one per step key, all
allocating from one memory pool.  The first call of a key runs the step
once eagerly on a side stream (the warm-up: it is that call's real work,
and it builds the kernels' libraries, sets their attributes, loads their
modules and allocates the paged kernel's split scratch for that stream),
then captures it with ``torch.cuda.graph`` on the same stream.  Every later
call replays the graph.  A replay runs the captured kernels in the captured
order, so it is bitwise the eager step; the step's inputs and outputs are
tensors whose storage never moves (the scheduler's cache, token buffers and
static inputs), and an output the step returns is the graph's own tensor,
overwritten by the next replay.  A capture that fails raises; nothing runs
the step eagerly in its place.

The scheduler's ``torch.Generator`` is registered with every graph, so the
draws of a replayed temperature/top-k step are the ones the eager step
would take from the generator's state at that replay.

Launch counts: a capture records kernels and launches none, so the launches
the kernel wrappers counted while it ran are taken back, kept with the
graph, and added to the wrappers' counters at each replay.  ``captures``
lists each capture's key and seconds; :meth:`pool_bytes` is the memory the
pool holds.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Hashable, List, Tuple

import torch


def _wrappers() -> tuple:
    from ..kernels.flash_attention.kernel import flash_attention_kernel
    from ..kernels.moe_experts.kernel import moe_experts_kernel, moe_router_kernel
    from ..kernels.paged_attention.kernel import paged_attention_kernel
    from ..kernels.rglru_scan.kernel import rglru_scan_kernel
    from ..kernels.ssd_scan.kernel import ssd_scan_kernel

    return (paged_attention_kernel, flash_attention_kernel, rglru_scan_kernel, ssd_scan_kernel,
            moe_experts_kernel, moe_router_kernel)


def _launch_counts() -> Dict[tuple, int]:
    """Every kernel wrapper's counters: ``(wrapper, "launches", None)`` and
    ``(wrapper, "launches_by_<what>", key)`` for each per-route entry."""
    out = {}
    for w in _wrappers():
        for name, val in vars(w).items():
            if name == "launches":
                out[(w, name, None)] = val
            elif name.startswith("launches_by_"):
                out.update({(w, name, key): n for key, n in val.items()})
    return out


def _add(delta: Dict[tuple, int], sign: int = 1) -> None:
    for (w, name, key), n in delta.items():
        if key is None:
            setattr(w, name, getattr(w, name) + sign * n)
        else:
            getattr(w, name)[key] += sign * n


class StepGraphs:
    """One scheduler's CUDA graphs, keyed by step, sharing one memory pool."""

    def __init__(self, device, generator: torch.Generator):
        self.device = torch.device(device)
        self.generator = generator
        self.stream = torch.cuda.Stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()
        self._graphs: Dict[Hashable, Tuple[torch.cuda.CUDAGraph, object, Dict]] = {}
        self.captures: List[Tuple[Hashable, float]] = []

    def __contains__(self, key: Hashable) -> bool:
        return key in self._graphs

    def run(self, key: Hashable, fn: Callable[[], object]):
        """``fn()``'s result: the replay of ``key``'s graph, or on the first
        call the warm-up's result, after which ``fn`` is captured."""
        if key in self._graphs:
            return self.replay(key)
        return self._capture(key, fn)

    def replay(self, key: Hashable):
        graph, out, delta = self._graphs[key]
        graph.replay()
        _add(delta)
        return out

    def _capture(self, key: Hashable, fn: Callable[[], object]):
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            result = fn()
        main.wait_stream(self.stream)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        before = _launch_counts()
        # A CUDAGraph that the cycle collector frees while this capture runs
        # (an earlier scheduler's) would destroy its graph mid-capture, which
        # invalidates the capture: collect now, and not again until it ends.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                out = fn()
        finally:
            if collecting:
                gc.enable()
            torch.cuda.set_stream(main)     # also when a failed capture skipped it
            after = _launch_counts()
            delta = {k: n - before.get(k, 0) for k, n in after.items()
                     if n != before.get(k, 0)}
            _add(delta, -1)
        self._graphs[key] = (graph, out, delta)
        self.captures.append((key, time.perf_counter() - t0))
        return result

    def pool_bytes(self) -> int:
        """Device memory the graphs' pool holds (its allocator segments)."""
        pool = tuple(self.pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)
