"""Function runtime: free / event / scheduled functions (paper §2.2).

* **Free functions** — invoked via API request (RPC semantics); used by the
  distributor to fan out watch notifications.
* **Event functions** — bound to a queue trigger (see ``queues.py``); used by
  the writer and distributor.
* **Scheduled functions** — cron semantics; used by the heartbeat.

The runtime models cold/warm starts and GB-second billing (the §6 cost model
charges function time at AWS Lambda rates).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Generator, List, Optional

from .simcloud import SimCloud, SimulatedCrash, Sleep

LAMBDA_GBS_PRICE = 1.66667e-5  # USD per GB-second (AWS Lambda, us-east-1)
LAMBDA_INVOKE_PRICE = 2.0e-7  # USD per invocation


@dataclass
class FunctionStats:
    invocations: int = 0
    cold_starts: int = 0
    crashes: int = 0
    billed_seconds: float = 0.0
    runtimes: List[float] = field(default_factory=list)


class FunctionContext:
    """Passed to every function body: crash points + metering."""

    def __init__(self, runtime: "FunctionRuntime", name: str):
        self.runtime = runtime
        self.cloud = runtime.cloud
        self.name = name
        self.start_time = runtime.cloud.now

    def crash_point(self, label: str) -> None:
        if self.cloud.faults.should_crash(self.name, label):
            self.runtime.stats[self.name].crashes += 1
            raise SimulatedCrash(f"{self.name}@{label}")


class FunctionRuntime:
    def __init__(self, cloud: SimCloud, memory_mb: int = 2048, warm_window: float = 600.0):
        self.cloud = cloud
        self.memory_mb = memory_mb
        self.warm_window = warm_window
        self.stats: Dict[str, FunctionStats] = {}
        self._last_end: Dict[str, float] = {}

    def _stats(self, name: str) -> FunctionStats:
        return self.stats.setdefault(name, FunctionStats())

    def wrap(
        self,
        name: str,
        body: Callable[..., Generator],
        memory_mb: Optional[int] = None,
    ) -> Callable[..., Generator]:
        """Wrap a function body with start latency, billing, crash accounting."""
        mem = memory_mb or self.memory_mb

        def invoke(*args: Any, **kwargs: Any) -> Generator:
            st = self._stats(name)
            st.invocations += 1
            last = self._last_end.get(name)
            cold = last is None or (self.cloud.now - last) > self.warm_window
            if cold:
                st.cold_starts += 1
                yield Sleep(self.cloud.sample("cold_start"))
            yield Sleep(self.cloud.sample("fn_overhead"))
            ctx = FunctionContext(self, name)
            t0 = self.cloud.now
            try:
                result = yield from body(ctx, *args, **kwargs)
            finally:
                dt = self.cloud.now - t0
                st.billed_seconds += dt * (mem / 1024.0)
                st.runtimes.append(dt)
                self._last_end[name] = self.cloud.now
            return result

        return invoke

    def invoke_free(self, fn: Callable[..., Generator], *args: Any, **kwargs: Any):
        """Fire a free function asynchronously (RPC-style); returns the Task."""
        delay = self.cloud.sample("direct_invoke")
        return self.cloud.spawn(fn(*args, **kwargs), name="free-fn", delay=delay)

    def schedule_every(
        self,
        period: float,
        fn: Callable[..., Generator],
        stop_when: Optional[Callable[[], bool]] = None,
        jitter: float = 0.0,
        max_runs: Optional[int] = None,
    ) -> None:
        """Cron semantics: invoke ``fn`` every ``period`` virtual seconds."""
        runs = {"n": 0}

        def tick() -> None:
            if stop_when is not None and stop_when():
                return
            if max_runs is not None and runs["n"] >= max_runs:
                return
            runs["n"] += 1
            self.cloud.spawn(fn(), name="scheduled-fn")
            j = float(self.cloud.rng.uniform(-jitter, jitter)) if jitter else 0.0
            self.cloud.schedule(period + j, tick)

        self.cloud.schedule(period, tick)

    def cost_usd(self) -> float:
        total = 0.0
        for st in self.stats.values():
            total += st.billed_seconds * LAMBDA_GBS_PRICE
            total += st.invocations * LAMBDA_INVOKE_PRICE
        return total
