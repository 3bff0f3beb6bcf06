"""Elastic scaling: pod death → shrink, recover, resume.

Port of ``repro/launch/elastic.py`` (pure Python). Wires the paper's
failure chain end to end:
  heartbeat timeout (§IV.c.ii) → pronounce dead → re-replicate that pod's
  grains from surviving replicas (§IV.c.i) → drop the pod from the capacity
  schedule (§IV.b.ii re-proportioning) → restore training state from the
  last redundant checkpoint → resume.

Two feeds drive the controller:

* **live monitor callbacks** — ``HeartbeatMonitor.on_dead`` fires when a
  worker's silence crosses the timeout (the training-loop path of
  ``launch/train.py``);
* **simulator churn traces** — :meth:`ElasticController.apply_churn`
  replays a ``WorkloadResult.churn`` list (core/simulator.py) so pod
  shrink/re-grow decisions are exercised against *contended multi-job
  queues*, not a lone job: the simulator pronounces deaths from
  heartbeat-derived timeouts mid-workload, and this controller mirrors
  them into the coordinator's capacity schedule (re-proportioned on the
  next step) and the replica manager's cost accounting.

Across machines the "rebuild the mesh" step would re-run the process
group's init with the survivor set; here the coordinator's logical pods
shrink instead, and the control flow is the same.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Iterable, Optional

from repro_torch.core.heartbeat import HeartbeatMonitor
from repro_torch.core.replication import ReplicaManager
from repro_torch.core.topology import Location

if TYPE_CHECKING:  # torch-heavy imports, type-only: the simulator-side churn
    from repro_torch.checkpoint import CheckpointManager  # path needs no torch
    from repro_torch.core.coordinator import HetCoordinator


@dataclass
class ElasticEvent:
    time: float
    kind: str  # pod_dead | re_replicated | restored | resumed | pod_re_registered
    detail: dict = field(default_factory=dict)


class ElasticController:
    """Coordinator-side response to liveness churn.

    ``coordinator`` is optional: a simulator-driven controller can run with
    just a :class:`HeartbeatMonitor` (liveness + replica accounting) — the
    training-side shrink/restore steps are skipped when absent.
    """

    def __init__(
        self,
        coordinator: Optional["HetCoordinator"] = None,
        replicas: Optional[ReplicaManager] = None,
        checkpoints: Optional["CheckpointManager"] = None,
        pod_locations: Optional[dict[str, Location]] = None,
        monitor: Optional[HeartbeatMonitor] = None,
    ):
        self.coord = coordinator
        self.replicas = replicas
        self.ckpt = checkpoints
        self.pod_locations = pod_locations or {}
        self.events: list[ElasticEvent] = []
        self.monitor = monitor or (coordinator.monitor if coordinator else None)
        if self.monitor is not None:
            self.monitor.on_dead = self._on_dead
        self._template = None
        self._restore_requested = False

    def set_restore_template(self, template) -> None:
        self._template = template

    # ------------------------------------------------------------------
    def _on_dead(self, worker: str, t: float) -> None:
        self.events.append(ElasticEvent(t, "pod_dead", {"pod": worker}))
        if self.coord is not None:
            self.coord.fail_pod(worker)
        if self.replicas is not None:
            loc = self.pod_locations.get(worker)
            if loc is not None:
                self.replicas.fail_worker(loc)
                cost = self.replicas.recover()
                self.events.append(
                    ElasticEvent(
                        t,
                        "re_replicated",
                        {
                            "grains": len(cost.events),
                            "bytes": cost.bytes_written,
                            "transfer_s": cost.transfer_s,
                        },
                    )
                )
        self._restore_requested = True

    # ------------------------------------------------------------------
    def apply_churn(
        self,
        churn: Iterable[Any],
        pod_names: Optional[dict[int, str]] = None,
    ) -> list[Any]:
        """Replay a simulator churn trace against the training side.

        Handles the pod-level transitions of ``WorkloadResult.churn``:
        ``pod_dead`` pronounces the named pod on the monitor (which fires
        ``_on_dead`` → coordinator shrink + re-replication), ``pod_alive``
        re-registers it (re-grow: the next schedule re-proportions over the
        restored capacity). Worker-level events pass through untouched —
        the simulator already acted on them. Returns the applied events.
        """
        names = pod_names or {}
        applied = []
        for ev in churn:
            if ev.kind == "pod_dead":
                name = names.get(ev.detail["pod"], f"pod{ev.detail['pod']}")
                if self.monitor is not None:
                    self.monitor.pronounce(name, ev.time)
                applied.append(ev)
            elif ev.kind == "pod_alive":
                name = names.get(ev.detail["pod"], f"pod{ev.detail['pod']}")
                if self.coord is not None:
                    self.coord.revive_pod(name, ev.time)
                elif self.monitor is not None:
                    self.monitor.revive(name, ev.time)
                self.events.append(
                    ElasticEvent(ev.time, "pod_re_registered", {"pod": name})
                )
                applied.append(ev)
        return applied

    # ------------------------------------------------------------------
    def maybe_restore(self, params, opt_state):
        """After a death, roll back to the last checkpoint (if any). An
        async save still in flight is waited for first, so the restore
        takes the last checkpoint asked for; the reference lists only the
        saves its writer thread has finished, so it may take an older one
        or none (ROADMAP C9). The restored state becomes the template of
        the next restore, so the controller holds no pre-restore tensor
        (at full width, 20.7 GB of params and moments on the card)."""
        if not self._restore_requested or self.ckpt is None or self._template is None:
            return params, opt_state, False
        self.ckpt.wait()
        steps = self.ckpt.steps()
        if not steps:
            self._restore_requested = False
            return params, opt_state, False
        state, info = self.ckpt.restore(steps[-1], self._template)
        self.events.append(
            ElasticEvent(0.0, "restored", {"step": steps[-1], **info})
        )
        self._restore_requested = False
        self._template = state
        return state["params"], state["opt_state"], True

    @property
    def alive_pod_names(self) -> list[str]:
        if self.coord is None:
            return [] if self.monitor is None else self.monitor.alive()
        return [p.name for p in self.coord.alive_pods()]
