"""Heterogeneity-aware training coordinator (jobtracker analogue).

Port of ``repro/core/coordinator.py``. Drives the het-DP global step end
to end:

  1. read measured pod capacities (heartbeat telemetry → CapacityEstimator);
  2. compute the capacity-proportional accumulation schedule
     (placement.het_accumulation_schedule);
  3. each pod runs its k_i grad microbatches;
  4. cross-pod combine: sample-weighted mean, optionally int8+error-feedback
     compressed (optim/compression.py), the scarce-link analogue of the
     paper's cross-rack 8 Gb pipe;
  5. apply the optimizer update;
  6. heartbeats tick; a dead pod triggers the elastic shrink upstream
     (launch/elastic.py); this module just surfaces the event.

Pods are *logical*: their grad steps run one after another on one device,
while wall-clock heterogeneity is tracked in virtual time from the pods'
speed factors; the scheduling layer (what the paper is about) is the same
either way.

Memory: the reference keeps one fp32 accumulator per pod and then their
weighted sum. Here each pod sums its microbatch gradients in place into
its first microbatch's gradients, and, uncompressed, the pod's mean is
scaled by its weight and added into the combined sum as soon as the pod
finishes: the same left-to-right order as ``_weighted_combine``, so the
same bits, with one fp32 copy of the gradients beside the pod's own
instead of one per pod.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from repro_torch import spans
from repro_torch.core.capacity import CapacityEstimator
from repro_torch.core.heartbeat import Heartbeat, HeartbeatMonitor
from repro_torch.core.placement import HetSchedule, het_accumulation_schedule
from repro_torch.models.common import tree_map
from repro_torch.optim.compression import CompressedAllReduce


@dataclass
class PodRuntime:
    name: str
    speed: float  # virtual relative speed (1.0 = nominal)
    alive: bool = True
    compressor: Optional[CompressedAllReduce] = None


@dataclass
class StepReport:
    schedule: HetSchedule
    virtual_step_s: float  # makespan across pods (slowest pod)
    homo_virtual_s: float  # what a uniform schedule would have cost
    tokens: int
    metrics: dict[str, float] = field(default_factory=dict)


def _weighted_combine(grad_list, weights):
    """Σ w_i g_i in fp32, summed left to right (new tensors)."""
    out = None
    for g, w in zip(grad_list, weights):
        scaled = tree_map(lambda x, w=w: x.to(torch.float32) * w, g)
        out = scaled if out is None else tree_map(torch.add, out, scaled)
    return out


def _fold_in(combined, pod_mean, w):
    """``combined + w · pod_mean`` as ``_weighted_combine`` forms it, in
    the storage of ``pod_mean`` (scaled in place) and ``combined``."""
    scaled = tree_map(lambda x: x.mul_(w), pod_mean)
    return scaled if combined is None else tree_map(torch.Tensor.add_, combined, scaled)


class HetCoordinator:
    def __init__(
        self,
        grad_fn: Callable,  # (params, batch) -> (grads, metrics)
        update_fn: Callable,  # (params, opt_state, grads) -> (params, opt_state, metrics)
        pods: list[PodRuntime],
        total_microbatches: int,
        grain_tokens: int,
        compress: bool = False,
        het_schedule: bool = True,
        monitor: Optional[HeartbeatMonitor] = None,
    ):
        self.grad_fn = grad_fn
        self.update_fn = update_fn
        self.pods = {p.name: p for p in pods}
        self.total_microbatches = total_microbatches
        self.grain_tokens = grain_tokens
        self.compress = compress
        self.het_schedule = het_schedule
        self.capacity = CapacityEstimator()
        self.monitor = monitor or HeartbeatMonitor(capacity=self.capacity)
        self._vtime = 0.0
        for p in pods:
            self.capacity.register(p.name, p.speed)
            self.monitor.register(p.name, 0.0, p.speed)
            if compress:
                p.compressor = CompressedAllReduce()

    # ------------------------------------------------------------------
    def alive_pods(self) -> list[PodRuntime]:
        return [p for p in self.pods.values() if p.alive and self.monitor.is_alive(p.name)]

    def schedule(self) -> HetSchedule:
        pods = self.alive_pods()
        caps = self.capacity.capacities([p.name for p in pods])
        if not self.het_schedule:
            caps = [1.0] * len(pods)  # stock-Hadoop homogeneity assumption
        return het_accumulation_schedule(caps, self.total_microbatches)

    # ------------------------------------------------------------------
    def step(self, params, opt_state, batch_iter) -> tuple[Any, Any, StepReport]:
        """One global step: pod-local accumulation + weighted combine."""
        pods = self.alive_pods()
        sched = self.schedule()
        combined, payloads, pod_metrics, pod_times = None, [], [], []

        # spans: train.grad carries the microbatch's index in the step, and
        # train.combine the pod's index among the step's pods
        mb = 0
        for p_i, (pod, k, w) in enumerate(zip(pods, sched.microbatches, sched.weights)):
            acc = None
            for _ in range(k):
                span = spans.begin("train.grad", mb) if spans.on else -1
                grads, metrics = self.grad_fn(params, next(batch_iter))
                if span >= 0:
                    span = spans.then(span, "train.accumulate", device=True)
                if acc is None:
                    acc = tree_map(lambda g: g.to(torch.float32), grads)
                else:
                    acc = tree_map(torch.Tensor.add_, acc, grads)
                del grads  # else they live on beside the next microbatch's
                mb += 1
                if span >= 0:
                    spans.end(span)
            span = spans.begin("train.accumulate", device=True) if spans.on else -1
            acc = tree_map(lambda g: g.div_(k), acc)
            if span >= 0:
                spans.end(span)
            # virtual pod wall time: k grains at the pod's (true) speed
            vt = k / max(pod.speed, 1e-9)
            pod_times.append(vt)
            self.monitor.beat(Heartbeat(pod.name, self._vtime + vt, grains_done=k, elapsed_s=vt))
            span = spans.begin("train.combine", p_i, device=True) if spans.on else -1
            if self.compress:
                payloads.append(pod.compressor.encode(acc))
            else:
                combined = _fold_in(combined, acc, w)
            if span >= 0:
                spans.end(span)
            del acc  # else it lives on beside the next pod's
            pod_metrics.append(metrics)

        if self.compress:
            span = spans.begin("train.combine", device=True) if spans.on else -1
            combined = CompressedAllReduce.combine(payloads, list(sched.weights))
            if span >= 0:
                spans.end(span)

        span = spans.begin("train.update") if spans.on else -1
        params, opt_state, opt_metrics = self.update_fn(params, opt_state, combined)
        if span >= 0:
            spans.end(span)

        # bookkeeping: virtual makespan het vs homo
        step_s = max(pod_times) if pod_times else 0.0
        self._vtime += step_s
        homo = het_accumulation_schedule([1.0] * len(pods), self.total_microbatches)
        homo_s = max(k / max(p.speed, 1e-9) for p, k in zip(pods, homo.microbatches)) if pods else 0.0
        self.monitor.sweep(self._vtime)

        # one host sync per step: the metrics come back as Python floats
        metrics = {k: float(v) for k, v in {**pod_metrics[-1], **opt_metrics}.items()}
        report = StepReport(
            schedule=sched,
            virtual_step_s=step_s,
            homo_virtual_s=homo_s,
            tokens=sched.total * self.grain_tokens,
            metrics=metrics,
        )
        return params, opt_state, report

    # ------------------------------------------------------------------
    def fail_pod(self, name: str) -> None:
        self.pods[name].alive = False

    def revive_pod(self, name: str, t: float = 0.0) -> None:
        """Re-admit a pod that re-registered after being pronounced dead
        (elastic re-grow): fresh liveness + nameplate capacity, so the next
        ``schedule()`` re-proportions microbatches over the restored fleet."""
        p = self.pods[name]
        p.alive = True
        self.capacity.register(p.name, p.speed)
        self.monitor.revive(p.name, t, nameplate=p.speed)

    def set_speed(self, name: str, speed: float) -> None:
        """Simulate thermal throttling / contention mid-run."""
        self.pods[name].speed = speed
