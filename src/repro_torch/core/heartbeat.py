"""Heartbeat protocol + liveness (paper §IV.c.ii, implemented faithfully).

Copied from ``repro/core/heartbeat.py`` (pure Python).

  * workers heartbeat every ``interval_s`` (default 3 s, the paper's value);
  * a worker silent for ``dead_after_s`` (default 600 s = the paper's 10
    minutes) is pronounced dead; its grains are scheduled for re-replication
    and its tasks re-queued (core/replication.py / launch/elastic.py);
  * the coordinator NEVER calls workers — instructions piggyback on
    heartbeat *replies* (the paper lists them: replicate / remove replicas /
    re-register / shut down / send urgent report);
  * heartbeats carry capacity telemetry (grains/s, disk, active transfers)
    that feeds CapacityEstimator — the paper notes heartbeats "play an
    important role in the name-node's … load-balancing decisions";
  * the handler is O(1) per beat so a single coordinator sustains the
    paper's "thousands of heartbeats per second" (benchmarks/bench_heartbeat).
"""

from __future__ import annotations

import enum
import heapq
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.core.capacity import CapacityEstimator


class Command(enum.Enum):
    NONE = "none"
    REPLICATE = "replicate"  # copy listed grains to listed targets
    DROP_REPLICAS = "drop_replicas"
    RE_REGISTER = "re_register"
    SHUTDOWN = "shutdown"
    URGENT_REPORT = "urgent_block_report"


@dataclass
class Heartbeat:
    worker: str
    time: float
    grains_done: float = 0.0
    elapsed_s: float = 0.0
    capacity_used: float = 0.0  # paper: total/used disk capacity …
    capacity_total: float = 1.0
    active_transfers: int = 0  # … and # of in-flight data transfers


@dataclass
class Reply:
    commands: list[tuple[Command, dict]] = field(default_factory=list)


@dataclass
class WorkerState:
    last_seen: float
    registered_at: float
    beats: int = 0
    dead: bool = False


class HeartbeatMonitor:
    """Coordinator-side liveness + piggyback command queue."""

    def __init__(
        self,
        interval_s: float = 3.0,
        dead_after_s: float = 600.0,
        capacity: Optional[CapacityEstimator] = None,
        on_dead: Optional[Callable[[str, float], None]] = None,
    ):
        self.interval_s = interval_s
        self.dead_after_s = dead_after_s
        self.capacity = capacity or CapacityEstimator()
        self.on_dead = on_dead
        self.workers: dict[str, WorkerState] = {}
        self._outbox: dict[str, list[tuple[Command, dict]]] = {}
        # min-heap of (last_seen + dead_after, worker) for O(log n) sweeps
        self._expiry: list[tuple[float, str]] = []

    # -- worker side -----------------------------------------------------
    def register(self, worker: str, t: float, nameplate: float = 1.0) -> None:
        self.workers[worker] = WorkerState(last_seen=t, registered_at=t)
        self.capacity.register(worker, nameplate)
        heapq.heappush(self._expiry, (t + self.dead_after_s, worker))

    def beat(self, hb: Heartbeat) -> Reply:
        st = self.workers.get(hb.worker)
        if st is None or st.dead:
            # paper: unknown/expired nodes are told to re-register
            return Reply([(Command.RE_REGISTER, {})])
        st.last_seen = hb.time
        st.beats += 1
        heapq.heappush(self._expiry, (hb.time + self.dead_after_s, hb.worker))
        if hb.elapsed_s > 0:
            self.capacity.update(hb.worker, hb.grains_done, hb.elapsed_s)
        cmds = self._outbox.pop(hb.worker, [])
        return Reply(cmds)

    # -- coordinator side --------------------------------------------------
    def enqueue(self, worker: str, cmd: Command, **kwargs) -> None:
        self._outbox.setdefault(worker, []).append((cmd, kwargs))

    def sweep(self, now: float) -> list[str]:
        """Pronounce dead everything silent ≥ dead_after_s. O(expired)."""
        newly_dead = []
        while self._expiry and self._expiry[0][0] <= now:
            _, w = heapq.heappop(self._expiry)
            st = self.workers.get(w)
            if st is None or st.dead:
                continue
            if now - st.last_seen >= self.dead_after_s:
                st.dead = True
                newly_dead.append(w)
                self.capacity.drop(w)
                if self.on_dead:
                    self.on_dead(w, now)
        return newly_dead

    def revive(self, worker: str, t: float, nameplate: float = 1.0) -> None:
        """Re-admit a worker whose post-pronouncement heartbeat was answered
        with RE_REGISTER (the paper's re-register command): fresh liveness
        state and a fresh capacity nameplate — its measured history died
        with the pronouncement."""
        self.register(worker, t, nameplate)

    def pronounce(self, worker: str, now: float = 0.0) -> None:
        """Directly pronounce a worker dead (its heartbeats stopped and the
        timeout elapsed) — the failure-injection entry point."""
        st = self.workers.get(worker)
        if st is None or st.dead:
            return
        st.dead = True
        self.capacity.drop(worker)
        if self.on_dead:
            self.on_dead(worker, now)

    def alive(self, now: Optional[float] = None) -> list[str]:
        return [w for w, st in self.workers.items() if not st.dead]

    def is_alive(self, worker: str) -> bool:
        st = self.workers.get(worker)
        return st is not None and not st.dead
