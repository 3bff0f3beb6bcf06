"""GPipe-style pipeline parallelism over the ``pod`` mesh axis.

Port of ``repro/parallel/pipeline.py``. Stage-partitioning the layer stack
across pods hands only (microbatch × hidden) activations between stages,
instead of re-gathering parameter shards: the right choice when the
cross-pod link is too slow for FSDP gathers (the Hadoop paper's scarce
cross-rack bandwidth, §IV.a Table 1).

Schedule: GPipe fill-drain with M microbatches over P stages. Each rank of
the ``stage_axis`` group runs ``M + P − 1`` ticks; at tick t, stage s runs
microbatch ``t − s`` when ``0 ≤ t − s < M``. Bubble fraction =
(P−1)/(M+P−1). Stage 0 reads fresh microbatches; after each tick every
stage hands its activations down the ring (``batch_isend_irecv`` to the
next stage's global rank); the last stage's outputs reach every rank of
the group by a broadcast (the JAX package all-gathers and selects, which
computes the same). ``fn(stage_params, x)`` is any function of one stage.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.models.common import tree_map


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    return (num_stages - 1) / (num_microbatches + num_stages - 1)


def pipeline_apply(
    fn: Callable,  # (stage_params, x) -> x, one stage's computation
    stage_params,  # tree of tensors with a leading stage axis (P, ...)
    x: torch.Tensor,  # (M, B, ...) microbatched input, the same on every rank
    mesh,
    stage_axis: str = "pod",
) -> torch.Tensor:
    """Run x through all pipeline stages; returns (M, B, ...) outputs on
    every rank. Each rank keeps its own stage's slice of ``stage_params``;
    output microbatch m carries the result of every stage in order."""
    dim = tuple(mesh.mesh_dim_names).index(stage_axis)
    num_stages = mesh.size(dim)
    stage = mesh.get_local_rank(dim)
    group = mesh.get_group(dim)
    m = x.shape[0]
    assert m >= 1
    params = tree_map(lambda a: a[stage], stage_params)
    nxt = dist.get_global_rank(group, (stage + 1) % num_stages)
    prv = dist.get_global_rank(group, (stage - 1) % num_stages)

    buf = torch.zeros_like(x[0])
    out = torch.zeros_like(x)
    for t in range(m + num_stages - 1):
        mb = t - stage
        if 0 <= mb < m:
            y = fn(params, x[mb] if stage == 0 else buf)
        else:
            y = buf
        done = t - (num_stages - 1)
        if stage == num_stages - 1 and 0 <= done < m:
            out[done] = y
        if num_stages > 1:
            # hand activations downstream (ring; stage 0 ignores what wraps)
            recv = torch.empty_like(y)
            ops = [dist.P2POp(dist.isend, y.contiguous(), nxt, group), dist.P2POp(dist.irecv, recv, prv, group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            buf = recv
    if num_stages > 1:
        dist.broadcast(out, src=dist.get_global_rank(group, num_stages - 1), group=group)
    return out
