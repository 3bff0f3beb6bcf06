"""Sharded, redundant, async checkpointing (paper §IV.c.i applied to state).

Port of ``repro/checkpoint/checkpoint.py``. Training state (params +
optimizer + step) is flattened and chunked into ``num_shards`` shard
files spread across *storage nodes* (directories that stand in for hosts;
on a real cluster, one per worker filesystem). Redundancy is pluggable,
mirroring the paper's replication-vs-striping trade-off:

  * ``replicate``: every shard written to r distinct nodes. Recovery of a
    lost node reads ONE surviving copy per shard (paper: "replication always
    needs only one copy").
  * ``stripe``: XOR parity groups (k data shards + 1 parity). Space overhead
    (k+1)/k instead of r, but recovering a lost shard reads the k−1 surviving
    siblings + parity (paper: "read two or more of the remaining segments").

Saves can run on a background thread (async) so the training loop only pays
the host-transfer time — the compute/IO overlap trick at the checkpoint
layer. Restore prefers any intact copy and falls back to parity
reconstruction; integrity is guarded by per-shard crc32.

State is a tree of torch tensors (nested dicts, lists, tuples), flattened
in ``models/common.py::tree_leaves`` order: sorted keys, never the device.
Each leaf is written as its raw bytes (numpy has no bf16), snapshotted to
the host when ``save`` is called, so the caller may go on updating the
tensors in place while the write runs. Restore rebuilds each leaf in the
template's dtype and shape, on the template leaf's device. The format
round-trips the port's own trees; it is not the JAX package's on-disk
layout (that one flattens stacked layers).
"""

from __future__ import annotations

import io
import json
import threading
import time
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten


def _host_bytes(x) -> np.ndarray:
    """A leaf's raw bytes as a uint8 array on the host: a copy, whatever
    the leaf's device, so later in-place updates do not reach it."""
    t = torch.as_tensor(x).detach().to("cpu", copy=True).contiguous()
    return t.reshape(-1).view(torch.uint8).numpy()


def _flatten(state) -> tuple[list[np.ndarray], str]:
    treedef = repr(tree_map(lambda _: "*", state))
    return [_host_bytes(x) for x in tree_leaves(state)], treedef


def _shard_bytes(leaves: list[np.ndarray], idxs: list[int]) -> bytes:
    # raw bytes (uint8): the template supplies dtype and shape on restore
    buf = io.BytesIO()
    np.savez(buf, **{f"leaf_{i}": leaves[i] for i in idxs})
    return buf.getvalue()


def _leaf_from_bytes(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if t.numel() != like.numel() * like.element_size():
        raise IOError(f"leaf of {t.numel()} bytes does not fit {like.dtype} {tuple(like.shape)}")
    return t.view(like.dtype).reshape(like.shape).to(like.device)


def _load_shard(data: bytes) -> dict[int, np.ndarray]:
    with np.load(io.BytesIO(data)) as z:
        return {int(k.split("_")[1]): z[k] for k in z.files}


@dataclass
class ShardInfo:
    shard: int
    leaf_idxs: list[int]
    nodes: list[str]  # directories holding a full copy
    crc: int
    nbytes: int
    parity_group: int = -1


class CheckpointManager:
    def __init__(
        self,
        root: str | Path,
        num_nodes: int = 4,
        num_shards: int = 8,
        redundancy: str = "replicate",  # replicate | stripe
        replication: int = 3,
        stripe_k: int = 4,
        async_save: bool = False,
    ):
        self.root = Path(root)
        self.num_nodes = num_nodes
        self.num_shards = num_shards
        self.redundancy = redundancy
        self.replication = min(replication, num_nodes)
        self.stripe_k = stripe_k
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        for n in range(num_nodes):
            (self.root / f"node{n}").mkdir(parents=True, exist_ok=True)

    # ------------------------------------------------------------------
    def _node_dir(self, node: str) -> Path:
        return self.root / node

    def _step_name(self, step: int) -> str:
        return f"step_{step:08d}"

    def save(self, step: int, state) -> dict:
        """Write a checkpoint; returns the manifest. Blocks unless async."""
        leaves, treedef = _flatten(state)
        if self._thread is not None:
            self._thread.join()  # one in-flight save at a time
            self._thread = None
        if self.async_save:
            # snapshot to host (the only sync cost), then write in background
            manifest_holder: dict = {}
            self._thread = threading.Thread(
                target=self._write, args=(step, leaves, treedef, manifest_holder)
            )
            self._thread.start()
            return {"async": True, "step": step}
        holder: dict = {}
        self._write(step, leaves, treedef, holder)
        return holder["manifest"]

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ------------------------------------------------------------------
    def _write(self, step: int, leaves, treedef_repr: str, out: dict) -> None:
        shards: list[ShardInfo] = []
        per_shard = [[] for _ in range(self.num_shards)]
        for i in range(len(leaves)):
            per_shard[i % self.num_shards].append(i)

        blobs: list[bytes] = [
            _shard_bytes(leaves, idxs) for idxs in per_shard
        ]

        sname = self._step_name(step)
        if self.redundancy == "replicate":
            for s, (idxs, blob) in enumerate(zip(per_shard, blobs)):
                nodes = [f"node{(s + r) % self.num_nodes}" for r in range(self.replication)]
                for nd in nodes:
                    d = self._node_dir(nd) / sname
                    d.mkdir(parents=True, exist_ok=True)
                    (d / f"shard_{s}.npz").write_bytes(blob)
                shards.append(ShardInfo(s, idxs, nodes, zlib.crc32(blob), len(blob)))
        else:  # stripe: groups of k shards + XOR parity on a distinct node
            k = self.stripe_k
            for g0 in range(0, self.num_shards, k):
                group = list(range(g0, min(g0 + k, self.num_shards)))
                pad = max(len(blobs[s]) for s in group)
                parity = np.zeros(pad, np.uint8)
                for gi, s in enumerate(group):
                    nd = f"node{(s) % self.num_nodes}"
                    d = self._node_dir(nd) / sname
                    d.mkdir(parents=True, exist_ok=True)
                    (d / f"shard_{s}.npz").write_bytes(blobs[s])
                    arr = np.frombuffer(blobs[s].ljust(pad, b"\0"), np.uint8)
                    parity ^= arr
                    shards.append(
                        ShardInfo(s, per_shard[s], [nd], zlib.crc32(blobs[s]), len(blobs[s]), g0 // k)
                    )
                # parity must not share a node with any group member, or a
                # single node loss kills both a shard and its parity
                member_nodes = {s_ % self.num_nodes for s_ in group}
                cands = [n for n in range(self.num_nodes) if n not in member_nodes]
                pnode = f"node{cands[g0 // k % len(cands)] if cands else (g0 // k) % self.num_nodes}"
                pd = self._node_dir(pnode) / sname
                pd.mkdir(parents=True, exist_ok=True)
                (pd / f"parity_{g0 // k}.bin").write_bytes(parity.tobytes())

        manifest = {
            "step": step,
            "num_shards": self.num_shards,
            "redundancy": self.redundancy,
            "stripe_k": self.stripe_k,
            "treedef": treedef_repr,
            "time": time.time(),
            "shards": [vars(s) for s in shards],
        }
        # manifest itself is replicated on every node (it is tiny metadata —
        # the namespace analogue)
        for n in range(self.num_nodes):
            d = self._node_dir(f"node{n}") / sname
            d.mkdir(parents=True, exist_ok=True)
            (d / "manifest.json").write_text(json.dumps(manifest))
        out["manifest"] = manifest

    # ------------------------------------------------------------------
    def _read_manifest(self, step: int) -> dict:
        sname = self._step_name(step)
        for n in range(self.num_nodes):
            p = self._node_dir(f"node{n}") / sname / "manifest.json"
            if p.exists():
                return json.loads(p.read_text())
        raise FileNotFoundError(f"no manifest for step {step}")

    def restore(self, step: int, template, failed_nodes: Optional[set[str]] = None):
        """Rebuild state; tolerates ``failed_nodes`` (missing directories)."""
        failed = failed_nodes or set()
        man = self._read_manifest(step)
        leaves_t = [torch.as_tensor(x) for x in tree_leaves(template)]
        out = [None] * len(leaves_t)
        recovery_reads = 0

        blobs: dict[int, bytes] = {}
        sname = self._step_name(step)
        for sh in man["shards"]:
            blob = None
            for nd in sh["nodes"]:
                if nd in failed:
                    continue
                p = self._node_dir(nd) / sname / f"shard_{sh['shard']}.npz"
                if p.exists():
                    cand = p.read_bytes()
                    if zlib.crc32(cand) == sh["crc"]:
                        blob = cand
                        recovery_reads += 1
                        break
            blobs[sh["shard"]] = blob

        if man["redundancy"] == "stripe":
            k = man["stripe_k"]
            groups: dict[int, list[dict]] = {}
            for sh in man["shards"]:
                groups.setdefault(sh["parity_group"], []).append(sh)
            for gi, members in groups.items():
                missing = [sh for sh in members if blobs[sh["shard"]] is None]
                if not missing:
                    continue
                if len(missing) > 1:
                    raise IOError(f"stripe group {gi}: {len(missing)} losses > parity 1")
                pad = max(sh["nbytes"] for sh in members)
                parity = None
                for n in range(self.num_nodes):
                    p = self._node_dir(f"node{n}") / sname / f"parity_{gi}.bin"
                    if p.exists() and f"node{n}" not in failed:
                        parity = np.frombuffer(p.read_bytes(), np.uint8)[:pad].copy()
                        break
                if parity is None:
                    raise IOError(f"stripe group {gi}: parity lost too")
                for sh in members:
                    if blobs[sh["shard"]] is not None:
                        arr = np.frombuffer(blobs[sh["shard"]].ljust(pad, b"\0"), np.uint8)
                        parity ^= arr
                        recovery_reads += 1
                lost = missing[0]
                blob = parity.tobytes()[: lost["nbytes"]]
                if zlib.crc32(blob) != lost["crc"]:
                    raise IOError(f"shard {lost['shard']}: parity reconstruction failed crc")
                blobs[lost["shard"]] = blob

        for sh in man["shards"]:
            blob = blobs[sh["shard"]]
            if blob is None:
                raise IOError(f"shard {sh['shard']}: no surviving replica")
            for idx, arr in _load_shard(blob).items():
                out[idx] = _leaf_from_bytes(arr, leaves_t[idx])

        state = tree_unflatten(template, out)
        return state, {"recovery_reads": recovery_reads, "step": man["step"]}

    # ------------------------------------------------------------------
    def steps(self) -> list[int]:
        found = set()
        for n in range(self.num_nodes):
            for d in (self._node_dir(f"node{n}")).glob("step_*"):
                if (d / "manifest.json").exists():
                    found.add(int(d.name.split("_")[1]))
        return sorted(found)


def save_checkpoint(root, step, state, **kw) -> dict:
    return CheckpointManager(root, **kw).save(step, state)


def restore_checkpoint(root, step, template, **kw):
    return CheckpointManager(root, **kw).restore(step, template)


def latest_step(root, **kw) -> Optional[int]:
    steps = CheckpointManager(root, **kw).steps()
    return steps[-1] if steps else None
