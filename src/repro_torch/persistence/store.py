"""The two persistence tiers behind the PCS checkpoint manager (port of
``repro.persistence.store``).

``HostBufferTier``  — the cluster analogue of the switch's Persistent
Buffer: a bounded in-memory store adjacent to the accelerator.  Durability
of an ack is provided by K-replication across failure domains in a real
deployment; here replication is modeled by ``replicas`` metadata so tests
can fail individual replicas.

``DurableStore``    — the PM endpoint analogue: a slow, durable object
store (directory of files, fsync'd), with versioned, atomic writes that
reject stale versions (the paper's PM write-order rule).

Payloads are pickled trees of numpy arrays in the reference's format, so
a store directory written by either package reads in the other.  The
one exception is bf16: numpy has no bfloat16 dtype without
``ml_dtypes``, which the port does not need, so :func:`_serialize`
writes a bf16 tensor as the dict ``{"__dtype__": "bfloat16", "bits":
<its uint16 bits>}`` and :func:`_deserialize` reads that dict (or a
reference-written ``ml_dtypes`` bfloat16 array, where it unpickles) back
as a CPU ``torch.bfloat16`` tensor.  Other tensors are written as numpy
arrays of their dtype, and f32 and integer leaves come back as numpy
arrays, exactly as the reference writes and reads them.
"""
from __future__ import annotations

import io
import os
import pickle
import tempfile
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

DTYPE_TAG = "__dtype__"


def _encode(tree: Any) -> Any:
    """Tensors to numpy (bf16 as its tagged bits), containers walked."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            bits = t.contiguous().view(torch.int16).numpy().view(np.uint16)
            return {DTYPE_TAG: "bfloat16", "bits": bits}
        return t.numpy()
    if isinstance(tree, dict):
        return {k: _encode(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_encode(v) for v in tree)
    return tree


def _bf16(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)
                            ).view(torch.bfloat16)


def _decode(tree: Any) -> Any:
    if isinstance(tree, dict):
        if tree.get(DTYPE_TAG) == "bfloat16" and set(tree) == {DTYPE_TAG,
                                                               "bits"}:
            return _bf16(tree["bits"])
        return {k: _decode(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_decode(v) for v in tree)
    if isinstance(tree, np.ndarray) and tree.dtype.name == "bfloat16":
        return _bf16(tree.view(np.uint16))
    return tree


def _serialize(tree: Any) -> bytes:
    buf = io.BytesIO()
    pickle.dump(_encode(tree), buf, protocol=pickle.HIGHEST_PROTOCOL)
    return buf.getvalue()


def _deserialize(raw: bytes) -> Any:
    return _decode(pickle.loads(raw))


class HostBufferTier:
    """Bounded host-memory buffer holding (shard, version) -> payload."""

    def __init__(self, capacity_bytes: int = 1 << 30, replicas: int = 2):
        self.capacity_bytes = capacity_bytes
        self.replicas = replicas
        self._data: Dict[Tuple[str, int], bytes] = {}
        self._alive: Dict[Tuple[str, int], int] = {}
        self._lock = threading.Lock()

    @property
    def used_bytes(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._data.values())

    def put(self, shard: str, version: int, payload: bytes) -> bool:
        with self._lock:
            used = sum(len(v) for v in self._data.values())
            if used + len(payload) > self.capacity_bytes:
                return False
            self._data[(shard, version)] = payload
            self._alive[(shard, version)] = self.replicas
            return True

    def get(self, shard: str, version: int) -> Optional[bytes]:
        with self._lock:
            if self._alive.get((shard, version), 0) <= 0:
                return None
            return self._data.get((shard, version))

    def newest(self, shard: str) -> Optional[Tuple[int, bytes]]:
        with self._lock:
            versions = [v for (s, v), alive in self._alive.items()
                        if s == shard and alive > 0 and (s, v) in self._data]
            if not versions:
                return None
            v = max(versions)
            return v, self._data[(shard, v)]

    def drop(self, shard: str, version: int) -> None:
        with self._lock:
            self._data.pop((shard, version), None)
            self._alive.pop((shard, version), None)

    def fail_replica(self, shard: str, version: int) -> None:
        """Simulate losing one replica of an entry (node failure)."""
        with self._lock:
            if (shard, version) in self._alive:
                self._alive[(shard, version)] -= 1
                if self._alive[(shard, version)] <= 0:
                    self._data.pop((shard, version), None)

    def entries(self):
        with self._lock:
            return [(s, v) for (s, v), a in self._alive.items() if a > 0]

    def crash_volatile(self) -> None:
        """Power loss of the *volatile* routing state: the buffer itself
        survives (battery/NV analogue) — nothing to do, mirrors PB."""


class DurableStore:
    """Filesystem-backed durable endpoint with versioned atomic writes."""

    def __init__(self, root: str, write_delay_s: float = 0.0):
        self.root = root
        self.write_delay_s = write_delay_s
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()
        self.writes_applied = 0
        self.stale_rejected = 0

    def _path(self, shard: str) -> str:
        return os.path.join(self.root, shard.replace("/", "_") + ".ckpt")

    def version_of(self, shard: str) -> int:
        p = self._path(shard)
        if not os.path.exists(p):
            return -1
        with open(p, "rb") as f:
            return int.from_bytes(f.read(8), "little")

    def write(self, shard: str, version: int, payload: bytes) -> bool:
        """Atomic versioned write; returns False for stale versions."""
        if self.write_delay_s:
            time.sleep(self.write_delay_s)
        with self._lock:
            if self.version_of(shard) > version:
                self.stale_rejected += 1
                return False
            fd, tmp = tempfile.mkstemp(dir=self.root)
            with os.fdopen(fd, "wb") as f:
                f.write(version.to_bytes(8, "little"))
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path(shard))
            self.writes_applied += 1
            return True

    def read(self, shard: str) -> Optional[Tuple[int, bytes]]:
        p = self._path(shard)
        if not os.path.exists(p):
            return None
        with open(p, "rb") as f:
            raw = f.read()
        return int.from_bytes(raw[:8], "little"), raw[8:]

    def shards(self):
        return [f[:-5] for f in os.listdir(self.root) if f.endswith(".ckpt")]
