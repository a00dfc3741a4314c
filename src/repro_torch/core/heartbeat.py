"""Scheduled heartbeat function (paper §4.5, Fig. 11).

ZooKeeper's per-session TCP heartbeats become one *scheduled* function that
(1) scans the session table, (2) pings every live client in parallel, and
(3) enqueues a deregistration request for each non-responder — the writer
then deletes the session's ephemeral nodes through the normal write path, so
ephemeral deletion is ordered/watched like any other transaction.

The function is parameterized by the heartbeat frequency H_fr; its cost is
the DynamoDB scan plus GB-seconds of function time (reproduced in
``benchmarks/bench_heartbeat.py``).
"""

from __future__ import annotations

from typing import Generator, List

from .simcloud import Sleep, Task, Wait


class HeartbeatCore:
    def __init__(self, service):
        self.service = service
        self.kv = service.kv
        self.cloud = service.cloud
        self.evictions = 0

    def body(self, ctx) -> Generator:
        sessions = yield from self.kv.scan("sessions")
        ctx.crash_point("after_scan")
        live = [sid for sid, item in sessions.items()
                if item.get("alive") and sid != "system"]

        # ping all clients in parallel
        pings: List[Task] = []
        for sid in live:
            pings.append(self.cloud.spawn(self._ping(sid), name=f"ping:{sid}"))
        yield Wait(tuple(pings))
        ctx.crash_point("after_pings")

        for sid, task in zip(live, pings, strict=True):
            if task.result is False:
                self.evictions += 1
                yield from self.service.enqueue_deregistration(sid)
        return len(live)

    def _ping(self, sid: str) -> Generator:
        yield Sleep(self.cloud.sample("tcp_rtt"))
        client = self.service.clients.get(sid)
        if client is None or client.failed:
            # wait out the response timeout
            yield Sleep(self.service.heartbeat_timeout)
            return False
        yield Sleep(self.cloud.sample("tcp_rtt"))
        return True
