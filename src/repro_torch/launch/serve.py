"""Batched serving loop: prefill + decode with continuous batching.

Port of ``repro/launch/serve.py``. A request queue feeds a fixed-width
decode batch; finished sequences free their slot and the next request is
admitted with its own prefill.

**Admission** goes through the same ``ADMISSION`` registry as the JAX
package (``core/admission.py``, copied): a request is a tiny job whose
work is its token budget, judged against a ``ClusterView`` built from the
*measured* decode throughput.

**Decode is token-level continuous batching** (``mode="arena"``, the
default): the replica owns one fixed-capacity KV arena —
``models.model.init_cache`` ``batch`` slots wide — plus a free-slot
allocator. ``decode_step`` takes a per-slot position vector and an
active-slot mask, so every occupied slot advances in one call per step
whatever the length mix. A request joins by copying its prefilled cache
into a free slot (an in-place ``index_copy_`` on the slot axis) and leaves
by marking the slot free at a token boundary. Greedy sampling (argmax) is
part of the decode call, so the host reads back ``batch`` token ids per
step, not logits.

**On the card the arena's decode step is one CUDA graph.** Warm-up builds
the loop's arena, runs one eager step on a side stream and captures the
step (``decode_step`` and the argmax) over static token and mask buffers;
each tick then copies the tokens and the mask in from pinned host buffers
and replays the graph, so no Python runs between the step's kernels. The
arena is kept for the loop's life: a session's slots overwrite what the
last one left. Any other arena (a copy, a sharded DTensor cache), a loop
built with ``warmup=False``, the CPU, and the cohort and serial modes run
the step eagerly, one Python call per step. The prefill stays eager.

``mode="cohort"`` (position groups) and ``mode="serial"`` (one slot per
call, the single-request reference) remain for the comparisons the tests
and claim 14 make.

**Mixture-of-experts stacks** (moonshot, mixtral) serve exactly in the
arena too. At decode (S = 1) every row is its own dispatch group, with a
capacity of one slot per expert and ``k`` distinct experts per token, so
nothing is dropped and a parked slot takes no router capacity from an
active one: its token and cache change no active row's logits
(``tests/test_torch_moe.py`` checks this in the port and in the JAX
package). A prompt's prefill routes alone, in groups of
``moe_group_size`` tokens at the eval capacity factor, so its drops depend
on it alone. The JAX package's note that parked slots consume router
capacity holds only for a prefill that batches several prompts into one
group, which neither serve runs. A prompt longer than the group must be a
multiple of it, as in the JAX package.

**Latent attention** (``moonlight-16b-a3b``, MLA): the arena holds each
slot's latent and RoPE key (``c_kv``, ``k_pe``; 576 values a token and
layer, 31,104 B a token in bf16 over its 27 layers) in place of ``k`` and
``v``; admitting, slot writes and the captured step carry them as they
carry any cache tensor, so the absorbed decode replays inside the graph.
Its dropless experts route every row alone, so a parked slot changes no
active row's experts either. ``stats()`` reports the prefills' routed
(token, slot) pairs and the sum over prefills and layers of the most that
one expert took (``moe_pairs``, ``moe_max_expert_pairs``), counted on the
device and read only there.

On the card the kernel path is the default (``main()`` selects
``attention_impl="pallas"``, K2, for prefill and
``decode_attention_impl="kernel"``, K1, for decode; the mLSTM and Mamba-2
prefills always run K3); the plain versions run only for tensors on the
CPU. The loop serves tokens only, as the JAX package's does: a frontend
arch (llava, musicgen) is served on its token stream, and a caller that
has prefix features calls ``models.model.prefill`` with them. ``ServeLoop(..., device="cuda")`` raises when
no card is present: it never carries on on the CPU.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b-smoke \
      --requests 16 --batch 4 --prompt-len 32 --gen 16 --mode arena
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b-smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b-smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-1.5-large-398b-smoke --device cpu
"""

from __future__ import annotations

import argparse
import heapq
import math
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional, Union

import numpy as np
import torch

from repro_torch import spans
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.core.admission import (
    ADMIT,
    DEFER,
    AdmissionPolicy,
    ClusterView,
    JobRequest,
    get_policy,
    trailing_class_p99,
)
from repro_torch.data.dataset import SyntheticCorpus
from repro_torch.kernels import ops
from repro_torch.models import model as M


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    submitted: float = 0.0  # admit time (slot granted; prefill starts)
    first_token: float = -1.0
    finished: float = -1.0
    tokens: list[int] = field(default_factory=list)
    # arrival is stamped at *enqueue*, so TTFT and latency include queueing
    # and deferral
    arrived: float = -1.0
    slo_class: int = 0
    deadline_s: float = math.inf
    rejected: bool = False
    # multi-turn session identity: turns of one conversation share a
    # session_id; the arena parks the session's KV slot between turns so a
    # follow-up admitted here skips re-prefill. session_end marks the last
    # turn — its completion frees the slot instead of parking it.
    session_id: int = -1
    session_end: bool = False

    @property
    def queue_wait(self) -> float:
        return self.submitted - self.arrived

    def clone_for_hedge(self) -> "Request":
        """A second attempt of this request, for hedged dispatch: same
        ``rid`` and admission identity, fresh token list and timing fields
        (each replica session mutates the ``Request`` it holds)."""
        return Request(
            rid=self.rid,
            prompt=self.prompt,
            max_new=self.max_new,
            arrived=self.arrived,
            slo_class=self.slo_class,
            deadline_s=self.deadline_s,
            session_id=self.session_id,
            session_end=self.session_end,
        )


class _Group:
    """Cohort-mode slots whose caches share a position, stacked along the
    batch axis (dim 1 of every per-layer cache tensor, dim 0 of ``pos``)."""

    __slots__ = ("pos", "rids", "cache", "last")

    def __init__(self, pos: int, rids: list[int], cache, last: list[int]):
        self.pos, self.rids, self.cache, self.last = pos, rids, cache, last


def _map_cache(fn, *caches):
    """Apply ``fn(*tensors, dim)`` to every tensor of the caches, which
    share a structure (``models/model.py::init_cache``): ``dim`` is the
    batch axis, 0 for ``pos`` and 1 for every per-layer stack."""

    def walk(nodes, dim):
        if isinstance(nodes[0], dict):
            return {k: walk([n[k] for n in nodes], 0 if k == "pos" and dim is None else 1)
                    for k in nodes[0]}
        return fn(*nodes, dim)

    return walk(list(caches), None)


def _cat(a, b):
    return _map_cache(lambda x, y, dim: torch.cat([x, y], dim=dim), a, b)


def _take(cache, idx: list[int]):
    sel = torch.tensor(idx, device=cache["pos"].device)
    return _map_cache(lambda x, dim: x.index_select(dim, sel), cache)


def _slot_write(arena, one, slot: int) -> None:
    """Copy a freshly prefilled single-request cache into arena slot
    ``slot``, in place."""
    idx = torch.tensor([slot], device=arena["pos"].device)
    _map_cache(lambda a, o, dim: a.index_copy_(dim, idx, o), arena, one)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@contextmanager
def _side_stream(device: torch.device):
    """Run the block on a fresh stream of ``device``, ordered after the
    current stream's work and before what follows it; on the CPU, as is."""
    if device.type != "cuda":
        yield
        return
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        yield
    cur.wait_stream(side)


def _capture(fn, device: torch.device):
    """``fn()`` recorded as one CUDA graph, which runs nothing until it is
    replayed, and ``fn``'s output, which every replay overwrites; ``None``
    off the card, where there is no graph to record."""
    if device.type != "cuda":
        return None
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


class _StepGraph:
    """The arena decode step as one CUDA graph over static device buffers:
    ``toks`` (B, 1) int64 and ``act`` (B,) bool in, ``out`` (B,) int64 the
    greedy tokens. ``launches`` holds the ``ops.LAUNCHES`` counts that the
    capture recorded: a capture runs no kernel, so they are taken back out
    of the counts, and each replay adds them."""

    def __init__(self, arena, graph, out, toks, act, launches: dict):
        self.arena, self.graph, self.out = arena, graph, out
        self.toks, self.act, self.launches = toks, act, launches

    @classmethod
    def capture(cls, arena, step, toks, act, device) -> Optional["_StepGraph"]:
        """``step(arena, toks, act)`` captured; ``None`` off the card."""
        before = dict(ops.LAUNCHES)
        got = _capture(lambda: step(arena, toks, act), device)
        launches = {k: ops.LAUNCHES[k] - n for k, n in before.items()}
        for k, n in launches.items():
            ops.LAUNCHES[k] -= n
        return None if got is None else cls(arena, *got, toks, act, launches)

    def holds(self, arena) -> bool:
        """Whether ``arena`` is the captured one, tensor for tensor."""
        return all(a is b for a, b in zip(_leaves(arena), _leaves(self.arena)))

    def replay(self, toks: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
        self.toks.copy_(toks, non_blocking=True)
        self.act.copy_(act, non_blocking=True)
        self.graph.replay()
        for k, n in self.launches.items():
            ops.LAUNCHES[k] += n
        return self.out


class ServeLoop:
    """Single-replica continuous batching behind a shared admission policy.

    Session API: :meth:`start` opens a session, :meth:`tick` advances it by
    one scheduling/decode cycle, :meth:`stats` closes it; :meth:`enqueue` /
    :meth:`cancel` are the fleet hooks. ``run_requests`` is a
    start/tick/stats wrapper.
    """

    def __init__(
        self,
        cfg,
        run,
        params,
        batch: int,
        max_len: int,
        admission: Union[str, AdmissionPolicy, None] = "admit_all",
        batched: bool = True,
        warmup: bool = True,
        mode: Optional[str] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.cfg, self.run, self.params = cfg, run, params
        self.batch = batch
        self.max_len = max_len
        self.admission = admission
        # mode: "arena" (token-level continuous batching, default) |
        # "cohort" (position groups) | "serial" (per-slot calls).
        # `batched=False` is exactly "serial".
        if mode is None:
            mode = "arena" if batched else "serial"
        if mode not in ("arena", "cohort", "serial"):
            raise ValueError(f"unknown serve mode {mode!r}")
        self.mode = mode
        self.batched = mode != "serial"
        self.warmup = warmup
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServeLoop(device='cuda'): no CUDA device is available; "
                               "pass device='cpu' to run the plain path on the CPU")
        # the arena (built by warm-up, or by the first admit without one) is
        # kept for the loop's life; on the card warm-up captures its step
        self._arena = None
        self._graph: Optional[_StepGraph] = None
        self._graph_replays = 0
        pin = self.device.type == "cuda"
        self._host_toks = torch.zeros((batch, 1), dtype=torch.long, pin_memory=pin)
        self._host_act = torch.zeros((batch,), dtype=torch.bool, pin_memory=pin)

    def prefill(self, toks: torch.Tensor):
        self._prefills += 1
        if self._moe_load is None and self.cfg.moe_dropless:
            self._moe_load = torch.zeros(2, dtype=torch.long, device=self.device)
        return M.prefill(self.cfg, self.run, self.params, toks, self.max_len, moe_load=self._moe_load)

    def decode(self, cache, toks: torch.Tensor):
        return M.decode_step(self.cfg, self.run, self.params, cache, toks)

    def _decode_arena(self, arena, toks: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
        """Decode step + greedy argmax in one call: the host reads back
        ``batch`` token ids, not a (B, 1, vocab) logits tensor. ``toks``
        (B, 1) and ``act`` (B,) may lie on the host or the device. The
        captured arena replays its graph (the result is the graph's output,
        which the next replay overwrites); any other arena steps eagerly."""
        g = self._graph
        if g is not None and g.holds(arena):
            self._graph_replays += 1
            return g.replay(toks, act)
        return self._decode_eager(arena, toks.to(self.device), act.to(self.device))

    def _decode_eager(self, arena, toks: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
        logits, _ = M.decode_step(self.cfg, self.run, self.params, arena, toks, active=act)
        return torch.argmax(logits[:, -1, :], dim=-1)

    def _tokens(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    def _warm(self, prompt_len: int) -> None:
        """Run prefill (B=1) and decode at every width the mode uses once,
        *before* the measured window opens. On the card that builds and
        loads the CUDA kernels and initialises cuBLAS; a first-hit build
        inside the serve loop would stall decoding mid-run and land in the
        capacity EMA that capacity-gated policies act on.

        In arena mode it builds the loop's arena and steps it once, on a
        side stream, as a capture wants its first call (lazy handles and
        workspaces made outside the capture); on the card it then captures
        the step. A later warm-up replays the captured step."""
        tok = torch.zeros((1, prompt_len), dtype=torch.long, device=self.device)
        _, cache = M.prefill(self.cfg, self.run, self.params, tok, self.max_len)
        if self.mode == "arena":
            if self._arena is None:
                self._arena = M.init_cache(self.cfg, self.batch, self.max_len, self.device)
            _slot_write(self._arena, cache, 0)
            toks = torch.zeros((self.batch, 1), dtype=torch.long, device=self.device)
            act = torch.zeros((self.batch,), dtype=torch.bool, device=self.device)
            act[0] = True
            if self._graph is not None:
                self._decode_arena(self._arena, toks, act)
                return
            with _side_stream(self.device):
                self._decode_eager(self._arena, toks, act)
            self._graph = _StepGraph.capture(self._arena, self._decode_eager, toks, act, self.device)
            return
        widths = range(1, self.batch + 1) if self.batched else (1,)
        c = cache
        for b in widths:
            if b > 1:
                c = _cat(c, cache)
            self.decode(c, torch.zeros((b, 1), dtype=torch.long, device=self.device))

    def warm(self, prompt_len: int) -> None:
        """Public warm-up hook for shared-clock callers: a fleet warms every
        replica *before* opening the shared measurement clock."""
        if self.warmup:
            self._warm(prompt_len)

    # -- session lifecycle ----------------------------------------------

    def start(
        self,
        requests: list[Request],
        prompt_len: Optional[int] = None,
        t0: Optional[float] = None,
    ) -> None:
        """Open a serving session over ``requests`` (may be empty when a
        fleet front-end will :meth:`enqueue` routed requests later —
        ``prompt_len`` then sizes the warm-up). ``t0`` is a shared
        ``perf_counter`` origin; a shared-clock caller owns the warm-up
        (:meth:`warm` before opening the clock); standalone sessions warm
        here and open their own origin afterwards."""
        self._policy = get_policy(self.admission)  # fresh state per run
        warm_len = prompt_len or (
            int(requests[0].prompt.shape[0]) if requests else 0
        )
        if self.warmup and warm_len and t0 is None:
            self._warm(warm_len)
        self._t0 = time.perf_counter() if t0 is None else t0
        self._requests: list[Request] = list(requests)
        for r in self._requests:
            if r.arrived < 0:
                r.arrived = self.now()  # enqueue stamp (0.0 upfront)
        self._by_id = {r.rid: r for r in self._requests}
        self._pending = deque(self._requests)  # not yet offered to policy
        self._ready: deque[Request] = deque()  # admitted, awaiting a slot
        self._rejected: list[Request] = []
        self._groups: list[_Group] = []
        # arena state: rid per slot (None = free), last emitted token per
        # slot, ascending free-slot heap (lowest slot wins — deterministic);
        # the arena itself outlives the session, its slots all free again
        self._slot_rid: list[Optional[int]] = [None] * self.batch
        self._slot_last = np.zeros(self.batch, np.int64)
        self._free_slots = list(range(self.batch))
        self._graph_replays = 0
        # session residency: a finished turn whose session is still live
        # *parks* its slot (cache bytes stay) instead of freeing it —
        # session_id → slot, insertion-ordered so the first entry is the
        # least-recently-parked and is the LRU eviction victim under slot
        # pressure. Parked slots are in neither _free_slots nor _slot_rid.
        self._session_slot: dict[int, int] = {}
        self._prefill_skipped = 0
        self._sessions_evicted = 0
        self._occ_sum = 0  # Σ active slots over decode calls
        self._done_hist: dict[int, list[float]] = {}  # sojourns per class
        self._decode_tokens = 0
        self._decode_calls = 0
        self._prefills = 0
        # a dropless MoE's routed (token, slot) pairs and the most one expert
        # took, summed over the session's prefills and layers on the device
        # (made by the first prefill that routes so)
        self._moe_load = None
        self._cancelled = 0
        self._offered = 0
        # measured decode throughput (tokens/s), EMA over per-step rates
        # timed around the decode calls only
        self._tok_rate = 0.0
        self._peak_rate = 0.0
        self._pump()
        self._fill_slots()

    def now(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def tok_rate(self) -> float:
        """Measured decode throughput EMA — the capacity this replica
        reports to a fleet router."""
        return self._tok_rate

    @property
    def peak_rate(self) -> float:
        """Fastest EMA observed this session: the fleet's stand-in for a
        nameplate rate."""
        return self._peak_rate

    def _active_count(self) -> int:
        if self.mode == "arena":
            # parked session slots hold cache bytes but decode nothing
            return sum(1 for rid in self._slot_rid if rid is not None)
        return sum(len(g.rids) for g in self._groups)

    def resident_sessions(self) -> frozenset:
        """Sessions whose KV cache is parked in this replica's arena."""
        return frozenset(self._session_slot)

    def _decoding_rids(self) -> list[int]:
        """Rids currently holding a decode slot, slot/decode order."""
        if self.mode == "arena":
            return [rid for rid in self._slot_rid if rid is not None]
        return [rid for g in self._groups for rid in g.rids]

    def outstanding_rids(self) -> list[int]:
        """Requests decoding or admitted-and-waiting, decode order first."""
        return self._decoding_rids() + [r.rid for r in self._ready]

    def queued_rids(self) -> list[int]:
        """Admitted-but-not-yet-decoding requests, queue order."""
        return [r.rid for r in self._ready]

    def backlog_tokens(self) -> float:
        """Remaining token budget across decoding + ready requests."""
        live = [self._by_id[rid] for rid in self._decoding_rids()]
        return float(
            sum(r.max_new - len(r.tokens) for r in live)
            + sum(r.max_new for r in self._ready)
        )

    @property
    def idle(self) -> bool:
        return self._active_count() == 0 and not self._ready

    # -- fleet hooks -----------------------------------------------------

    def enqueue(self, r: Request) -> None:
        """Route an already-admitted request onto this replica."""
        if r.arrived < 0:
            r.arrived = self.now()
        if r.rid not in self._by_id:
            self._requests.append(r)
        self._by_id[r.rid] = r
        self._ready.append(r)

    def cancel(self, rid: int) -> bool:
        """Pull a request out of this replica. Returns False when the
        request is not outstanding here. The request leaves this session's
        books entirely, and its session's parked slot (if any) is evicted."""
        found = False
        for r in list(self._ready):
            if r.rid == rid:
                self._ready.remove(r)
                found = True
                break
        if not found and self.mode == "arena":
            # mid-decode cancel: free the slot — the next join overwrites
            # its cache bytes
            for s, orid in enumerate(self._slot_rid):
                if orid == rid:
                    self._release_slot(s)
                    found = True
                    break
        if not found:
            for g in self._groups:
                if rid in g.rids:
                    keep = [i for i, x in enumerate(g.rids) if x != rid]
                    if not keep:
                        self._groups.remove(g)
                    else:
                        g.cache = _take(g.cache, keep)
                        g.rids = [g.rids[i] for i in keep]
                        g.last = [g.last[i] for i in keep]
                    found = True
                    break
        if found:
            req = self._by_id.get(rid)
            # the request now lives on another replica: its session's
            # parked slot from a previous turn must not pin a slot here
            sid = getattr(req, "session_id", -1) if req is not None else -1
            if sid is not None and sid >= 0:
                parked = self._session_slot.pop(sid, None)
                if parked is not None:
                    self._release_slot(parked)
            self._requests = [x for x in self._requests if x.rid != rid]
            self._by_id.pop(rid, None)
            self._cancelled += 1
        return found

    # -- admission protocol (same registry as run_workload) --------------

    def _view(self, t: float) -> ClusterView:
        # before the first measurement, capacity is *unbounded*: an offer
        # is a permanent decision, and the door must never shed work on a
        # guess — _pump() bounds how many requests are judged optimistically
        cap = self._tok_rate if self._tok_rate > 0 else float("inf")
        return ClusterView(
            time=t,
            live_capacity=cap,
            total_capacity=cap,
            free_slots=self.batch - self._active_count(),
            queue_depth=self._active_count() + len(self._ready),
            backlog_work=self.backlog_tokens(),
            deferred_depth=self._policy.n_deferred if self._policy else 0,
            deferred_work=self._policy.deferred_work if self._policy else 0.0,
            class_p99=trailing_class_p99(self._done_hist),
        )

    @staticmethod
    def as_job_request(r: Request) -> JobRequest:
        return JobRequest(
            job_id=r.rid,
            arrive_t=r.arrived,
            n_tasks=1,
            total_work=float(r.max_new),
            slo_class=r.slo_class,
            deadline_s=r.deadline_s,
            session_id=r.session_id,
        )

    def _resolve(self, r: Request, decision: str) -> None:
        if decision == ADMIT:
            self._ready.append(r)
        else:
            r.rejected = True
            self._rejected.append(r)

    def _pump(self, force: bool = False) -> None:
        """Offer new arrivals, then drain whatever the policy releases.
        Until the first decode step has measured capacity, at most one
        batch of requests is offered; ``force`` lifts that bound for the
        endgame drain."""
        span = spans.begin("serve.pump") if spans.on else -1
        if self._policy is None:
            while self._pending:
                self._ready.append(self._pending.popleft())
        else:
            while self._pending:
                if self._tok_rate <= 0 and not force and self._offered >= self.batch:
                    break
                r = self._pending.popleft()
                self._offered += 1
                decision = self._policy.offer(self.as_job_request(r), self._view(self.now()))
                if decision != DEFER:
                    self._resolve(r, decision)
            for req, decision in self._policy.poll(self._view(self.now())):
                self._resolve(self._by_id[req.job_id], decision)
        if span >= 0:
            spans.end(span)

    def _on_done(self, r: Request) -> None:
        sojourn = r.finished - r.arrived
        self._done_hist.setdefault(r.slo_class, []).append(sojourn)
        if self._policy is not None:
            self._policy.on_job_done(self.now(), self.as_job_request(r), sojourn)

    # -- decode mechanics -------------------------------------------------

    def _release_slot(self, s: int) -> None:
        self._slot_rid[s] = None
        heapq.heappush(self._free_slots, s)

    def _admit(self, r: Request) -> None:
        r.submitted = self.now()
        if self.mode == "arena" and r.session_id >= 0 and r.session_id in self._session_slot:
            # cache hit: the session's slot is parked here from its previous
            # turn — reclaim it and keep decoding from the resident cache,
            # skipping the re-prefill. The slot's last token is still in
            # _slot_last.
            s = self._session_slot.pop(r.session_id)
            self._slot_rid[s] = r.rid
            self._prefill_skipped += 1
            return
        span = spans.begin("serve.prefill", device=True) if spans.on else -1
        logits, cache = self.prefill(self._tokens(r.prompt[None]))
        if span >= 0:
            span = spans.then(span, "serve.first_token")
        tok = int(torch.argmax(logits[0, -1]))
        if span >= 0:
            spans.end(span)
        r.tokens.append(tok)
        r.first_token = self.now()
        if self.mode == "arena":
            if self._arena is None:
                self._arena = M.init_cache(self.cfg, self.batch, self.max_len, self.device)
            if not self._free_slots and self._session_slot:
                # slot pressure: evict the least-recently-parked session —
                # a live decode always outranks a speculative future turn
                old_sid = next(iter(self._session_slot))
                self._release_slot(self._session_slot.pop(old_sid))
                self._sessions_evicted += 1
            s = heapq.heappop(self._free_slots)
            self._slot_rid[s] = r.rid
            self._slot_last[s] = tok
            span = spans.begin("serve.slot_write") if spans.on else -1
            _slot_write(self._arena, cache, s)
            if span >= 0:
                spans.end(span)
            return
        pos = int(r.prompt.shape[0])
        if self.mode == "cohort":
            for g in self._groups:
                if g.pos == pos and len(g.rids) < self.batch:
                    g.cache = _cat(g.cache, cache)
                    g.rids.append(r.rid)
                    g.last.append(tok)
                    return
        self._groups.append(_Group(pos, [r.rid], cache, [tok]))

    def _fill_slots(self) -> None:
        while self._ready and self._active_count() < self.batch:
            r = self._ready.popleft()
            span = spans.begin("serve.admit", r.rid) if spans.on else -1
            self._admit(r)
            if span >= 0:
                spans.end(span)

    def _merge_groups(self) -> None:
        """Coalesce groups whose positions have come to coincide."""
        by_pos: dict[int, _Group] = {}
        for g in list(self._groups):
            head = by_pos.get(g.pos)
            if head is None or len(head.rids) + len(g.rids) > self.batch:
                by_pos[g.pos] = g
                continue
            head.cache = _cat(head.cache, g.cache)
            head.rids += g.rids
            head.last += g.last
            self._groups.remove(g)

    def _step_arena(self) -> None:
        """One decode step for the whole arena: a single call advances
        every occupied slot, whatever mix of positions they sit at."""
        span = spans.begin("serve.decode.issue") if spans.on else -1
        act = np.array([rid is not None for rid in self._slot_rid])
        self._host_toks.numpy()[:, 0] = self._slot_last
        self._host_act.numpy()[:] = act
        new = self._decode_arena(self._arena, self._host_toks, self._host_act)
        if span >= 0:
            span = spans.then(span, "serve.decode.readback")
        new = new.cpu().numpy()
        if span >= 0:
            span = spans.then(span, "serve.decode.book")
        self._decode_calls += 1
        self._occ_sum += int(act.sum())
        t_step = self.now()
        for s, rid in enumerate(list(self._slot_rid)):
            if rid is None:
                continue
            r = self._by_id[rid]
            tok = int(new[s])
            r.tokens.append(tok)
            if r.first_token < 0:
                # cache-hit admits skip prefill, so their first token is the
                # first decode append
                r.first_token = t_step
            self._slot_last[s] = tok
            self._decode_tokens += 1
            if len(r.tokens) >= r.max_new:
                r.finished = t_step
                self._on_done(r)
                if r.session_id >= 0 and not r.session_end:
                    # park: the session has more turns coming
                    self._slot_rid[s] = None
                    old = self._session_slot.pop(r.session_id, None)
                    if old is not None and old != s:
                        self._release_slot(old)
                    self._session_slot[r.session_id] = s
                else:
                    if r.session_id >= 0:
                        self._session_slot.pop(r.session_id, None)
                    self._release_slot(s)
        if span >= 0:
            spans.end(span)

    def _step_groups(self) -> None:
        if self.mode == "cohort" and len(self._groups) > 1:
            self._merge_groups()
        for g in list(self._groups):
            logits, g.cache = self.decode(g.cache, self._tokens(np.asarray(g.last)[:, None]))
            self._decode_calls += 1
            self._occ_sum += len(g.rids)
            new = torch.argmax(logits[:, -1, :], dim=-1).cpu().numpy()
            t_step = self.now()
            keep: list[int] = []
            for i, rid in enumerate(g.rids):
                r = self._by_id[rid]
                tok = int(new[i])
                r.tokens.append(tok)
                g.last[i] = tok
                self._decode_tokens += 1
                if len(r.tokens) >= r.max_new:
                    r.finished = t_step
                    self._on_done(r)
                else:
                    keep.append(i)
            g.pos += 1
            if len(keep) < len(g.rids):
                if not keep:
                    self._groups.remove(g)
                else:
                    g.cache = _take(g.cache, keep)
                    g.rids = [g.rids[i] for i in keep]
                    g.last = [g.last[i] for i in keep]

    def _step(self) -> None:
        # one pair of clock reads times the step for the rate EMA and, when
        # the recorder is on, stamps the ends of its serve.decode span
        t_in, toks_in = time.time_ns(), self._decode_tokens
        span = spans.begin("serve.decode", t=t_in) if spans.on else -1
        if self.mode == "arena":
            self._step_arena()
        else:
            self._step_groups()
        t_out = time.time_ns()
        if span >= 0:
            spans.end(span, t_out)
        inst = (self._decode_tokens - toks_in) / max((t_out - t_in) / 1e9, 1e-9)
        self._tok_rate = (
            inst if self._tok_rate <= 0 else 0.8 * self._tok_rate + 0.2 * inst
        )
        self._peak_rate = max(self._peak_rate, self._tok_rate)
        if self._policy is not None:
            self._policy.on_capacity(self.now(), self._tok_rate)

    # -- the session stepper ----------------------------------------------

    def tick(self) -> str:
        """Advance one scheduling/decode cycle.

        Returns ``"step"`` (made progress), ``"wait"`` (deferred requests
        exist but the policy released nothing — the caller owns the
        wall-clock and decides whether to sleep), or ``"done"``."""
        if not spans.on:
            return self._tick()
        span = spans.begin("serve.tick")
        status = self._tick()
        spans.end(span)
        return status

    def _tick(self) -> str:
        if self._active_count() == 0:
            if self._ready:
                self._fill_slots()
                return "step"
            if self._policy is not None and self._policy.n_deferred:
                self._pump()
                self._fill_slots()
                return (
                    "step"
                    if (self._active_count() or self._ready)
                    else "wait"
                )
            if self._pending:
                # endgame: nothing running or deferred but requests were
                # never offered (the pre-measurement bound) — drain them
                self._pump(force=True)
                self._fill_slots()
                if self._active_count() or self._ready:
                    return "step"
            return "done"
        self._step()
        self._pump()
        self._fill_slots()
        return "step"

    def stats(self) -> dict:
        wall = time.perf_counter() - self._t0
        done = [r for r in self._requests if r.finished >= 0]
        policy = self._policy
        # read from the device here only: nothing on the serving path waits for it
        moe_pairs, moe_max = self._moe_load.tolist() if self._moe_load is not None else (0, 0)
        return {
            "completed": len(done),
            "rejected": len(self._rejected),
            "deferred_unserved": policy.n_deferred if policy else 0,
            "admission": policy.name if policy else "none",
            "mode": self.mode,
            "wall_s": wall,
            "decode_steps": self._decode_tokens,
            "decode_calls": self._decode_calls,
            # decode calls that replayed the captured step
            "decode_graph_replays": self._graph_replays,
            "prefill_calls": self._prefills,
            # dropless MoE routing over the prefills: (token, slot) pairs, and
            # the sum over prefills and layers of the most one expert took
            "moe_pairs": moe_pairs,
            "moe_max_expert_pairs": moe_max,
            # mean fraction of the batch doing useful work per call
            "slot_occupancy": (
                self._occ_sum / (self._decode_calls * self.batch)
                if self._decode_calls
                else 0.0
            ),
            "cancelled": self._cancelled,
            "prefill_skipped": self._prefill_skipped,
            "sessions_evicted": self._sessions_evicted,
            "tokens_per_s": sum(len(r.tokens) for r in done) / wall if wall else 0.0,
            "mean_ttft_s": float(np.mean([r.first_token - r.arrived for r in done])) if done else -1,
            "mean_latency_s": float(np.mean([r.finished - r.arrived for r in done])) if done else -1,
            "mean_queue_wait_s": float(np.mean([r.queue_wait for r in done])) if done else -1,
        }

    def run_requests(self, requests: list[Request]) -> dict:
        """Standalone session: start → tick to completion → stats."""
        self.start(requests)
        last_progress = time.perf_counter()
        while True:
            status = self.tick()
            if status == "done":
                break
            if status == "wait":
                # nothing running: wall-clock has to pay the token debt
                nxt = self._policy.next_event_t()
                wait = 0.01 if nxt is None else max(0.0, min(nxt - self.now(), 0.25))
                time.sleep(wait)
                if time.perf_counter() - last_progress > 60.0:
                    break  # a policy that never releases: report, don't hang
            else:
                last_progress = time.perf_counter()
        return self.stats()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b-smoke")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--admission", default="admit_all",
                    help="policy name from core.admission.ADMISSION")
    ap.add_argument("--mode", default=None,
                    choices=["arena", "cohort", "serial"],
                    help="decode batching: arena (continuous, default), "
                         "cohort (position groups), serial (per-slot)")
    ap.add_argument("--no-batch", action="store_true",
                    help="alias for --mode serial: per-slot decode, the "
                         "single-request reference path")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    run = RunConfig(remat="none", attention_impl="pallas", decode_attention_impl="kernel")
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = M.init_model(cfg, gen, dtype=getattr(torch, cfg.compute_dtype))

    corpus = SyntheticCorpus(cfg.vocab_size, args.prompt_len, args.seed)
    reqs = [
        Request(i, corpus.grain_tokens(i, 1)[0], args.gen) for i in range(args.requests)
    ]
    loop = ServeLoop(
        cfg, run, params, args.batch, args.prompt_len + args.gen + 1,
        admission=args.admission, batched=not args.no_batch, mode=args.mode,
        device=args.device,
    )
    stats = loop.run_requests(reqs)
    print(
        f"served {stats['completed']}/{args.requests} requests "
        f"(rejected {stats['rejected']}, admission={stats['admission']}, "
        f"mode={stats['mode']}, device={args.device})  "
        f"{stats['tokens_per_s']:.1f} tok/s in {stats['decode_calls']} decode calls "
        f"(occupancy {stats['slot_occupancy']:.2f})  "
        f"ttft={stats['mean_ttft_s']*1e3:.0f}ms  "
        f"latency={stats['mean_latency_s']*1e3:.0f}ms"
    )
    return stats


if __name__ == "__main__":
    main()
