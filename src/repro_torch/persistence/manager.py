"""PCS checkpoint manager: the paper's PB state machine over train-state
shards (port of ``repro.persistence.manager``; the same states, drainer
thread, crash window, persist-indexed epochs and ``stats`` keys).

Mapping (DESIGN.md §2, Layer B):

    persist (clflush+mfence)  -> checkpoint write of one sharded slice
    PB entry Dirty/Drain/Empty-> ShardState per (shard, version)
    ack at first switch       -> persist() returns once the host buffer
                                 holds the payload (training resumes)
    background drain          -> a drainer thread uploads buffer->store
    write order               -> DurableStore rejects stale versions; the
                                 drain queue is FIFO per shard
    crash consistency         -> a buffer entry is freed only after the
                                 store confirms the write (drain ack)
    Read Forwarding           -> restore() serves from the buffer when the
                                 newest acked version still lives there
    write coalescing          -> a newer buffered version of a shard
                                 supersedes an undrained older one (the
                                 older drain is elided)
    recovery (drain-all)      -> on restart, every surviving buffer entry
                                 is re-drained; stale writes are rejected

Schemes mirror the paper: NOPB (write-through to the store, ack on store
fsync), PB (ack at buffer, drain immediately), PB_RF (ack at buffer,
drain lazily above a threshold -> read forwarding + coalescing).
"""
from __future__ import annotations

import enum
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.params import (DEFAULT_DRAIN_PRESET,
                                     DEFAULT_DRAIN_THRESHOLD, DrainPolicy,
                                     PBPolicy, SCHEME_NAMES, Scheme,
                                     epoch_index, resolve_epoch,
                                     shared_boundaries)
from repro_torch.persistence.store import (DurableStore, HostBufferTier,
                                           _deserialize, _serialize)

# The checkpoint tier speaks the same scheme vocabulary as the timed
# engine and the untimed oracle: names and drain thresholds come from the
# shared policy definitions, so the layers can no longer drift.
PersistScheme = enum.Enum(
    "PersistScheme", {s.name: SCHEME_NAMES[s] for s in Scheme})


class ShardState(enum.Enum):
    DIRTY = "dirty"
    DRAIN = "drain"
    EMPTY = "empty"


class PCSCheckpointManager:
    def __init__(self, buffer: HostBufferTier, store: DurableStore, *,
                 scheme: PersistScheme = PersistScheme.PB_RF,
                 policy: Optional[PBPolicy] = None,
                 drain_threshold: float = DEFAULT_DRAIN_THRESHOLD,
                 drain_preset: float = DEFAULT_DRAIN_PRESET,
                 sync_drain: bool = False):
        self.buffer = buffer
        self.store = store
        self.scheme = scheme
        # The checkpoint tier consumes the same declarative PBPolicy as
        # the engine and the oracle; the legacy float knobs forward into
        # a default policy (same shim as PCSConfig).  The drain fractions
        # apply to buffer *bytes* instead of PBE counts; the tenant-quota
        # / victim fields are inert here until the tier grows a tenant
        # axis (single-host checkpoint streams today).
        if policy is None:
            policy = PBPolicy(drain=DrainPolicy(threshold=drain_threshold,
                                                preset=drain_preset))
        # Epoched host-side policy (first step of carrying quotas into
        # the checkpoint tier): any Schedule on the policy is honoured
        # with its boundaries read as PERSIST INDICES — the tier's
        # logical clock — so a quota/threshold step lands at an exact
        # acked-persist count, mirroring schedule_crash's after_persists
        # determinism despite the asynchronous drainer.
        self._base_policy = policy
        self._epoch_bounds = shared_boundaries(
            policy.drain.threshold, policy.drain.preset,
            policy.drain.latency_target_ns, policy.alloc.tenant_quota)
        self._epoch = -1
        self._set_epoch(0)
        self.sync_drain = sync_drain
        self._states: Dict[Tuple[str, int], ShardState] = {}
        self._lru: Dict[Tuple[str, int], float] = {}
        self._tenant_of: Dict[Tuple[str, int], int] = {}
        self._lock = threading.RLock()
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self.stats = {"persists": 0, "acks": 0, "drains": 0, "coalesces": 0,
                      "restore_forwarded": 0, "restore_from_store": 0,
                      "stalls": 0, "lost_after_crash": 0}
        self._crashed = False
        self._crash_after: Optional[int] = None
        self._drainer = None
        if not sync_drain and scheme != PersistScheme.NOPB:
            self._start_drainer()

    def _set_epoch(self, epoch: int) -> None:
        """Collapse the base policy to its value during ``epoch``
        (``params.resolve_epoch`` — the same resolution rule the engine
        lowering and the oracle use, so the tiers cannot drift)."""
        self._epoch = int(epoch)
        pol = resolve_epoch(self._base_policy, self._epoch)
        self.policy = pol
        self.drain_threshold = pol.drain.threshold
        self.drain_preset = pol.drain.preset
        self._quota = pol.alloc.tenant_quota

    def _start_drainer(self) -> None:
        """Spawn the background drain loop — refusing to double-spawn.

        One *active* drain loop per queue: if the tracked drainer is
        alive and has not been told to stop, this is a no-op.  A
        previous drainer that is alive but already stopping (a slow
        ``DurableStore`` write outliving ``crash()``'s 1 s join) is not
        a conflict: each thread loops on its own private stop event,
        captured at spawn, so the stale thread exits as soon as its
        in-flight write returns and can never consume from the new
        queue — while the fresh thread gets a fresh event.
        """
        if (self._drainer is not None and self._drainer.is_alive()
                and not self._stop.is_set()):
            return
        self._stop = threading.Event()
        # the queue is bound at spawn too: a stale thread keeps polling
        # the *old* (abandoned) queue, never its successor's
        self._drainer = threading.Thread(target=self._drain_loop,
                                         args=(self._stop, self._q),
                                         name="pcs-ckpt-drainer",
                                         daemon=True)
        self._drainer.start()

    # ------------------------------------------------------------- persist
    def persist(self, shard: str, version: int, tree: Any,
                tenant: int = 0) -> None:
        """Make (shard, version) durable.  Returns when the persistent
        domain holds it: store fsync under NOPB, buffer ack under PB/RF.

        ``tenant`` attributes the entry for the per-tenant quota
        drain-down (inert when the policy carries no ``tenant_quota``).
        """
        # crash window (mirrors the engine's crash_at_ns): the power is
        # lost right before persist #(crash_after + 1), so exactly
        # crash_after persists are acked — a deterministic logical crash
        # point despite the asynchronous drainer.  The flag flips under
        # the lock; the drainer join happens outside it (the drainer
        # takes the same lock to finish its in-flight drain).
        fire = False
        with self._lock:
            # persist-indexed epoch advance: this persist executes under
            # epoch_of(#persists so far) — the same <=-gate as the
            # engine's issue-clock selection, on the tier's logical clock
            if self._epoch_bounds:
                ep = epoch_index(self._epoch_bounds,
                                 self.stats["persists"])
                if ep != self._epoch:
                    self._set_epoch(ep)
            if (self._crash_after is not None and not self._crashed
                    and self.stats["persists"] >= self._crash_after):
                self._crashed = fire = True
            if self._crashed:
                # machine is off: the write never reaches the switch
                self.stats["lost_after_crash"] += 1
                if not fire:
                    return
        if fire:
            self.crash()
            return
        payload = _serialize(tree)
        self.stats["persists"] += 1
        if self.scheme == PersistScheme.NOPB:
            self.store.write(shard, version, payload)
            self.stats["acks"] += 1
            return

        with self._lock:
            # write coalescing (PB_RF): an undrained older version of the
            # same shard is superseded — its drain is elided entirely.
            if self.scheme == PersistScheme.PB_RF:
                for (s, v), st in list(self._states.items()):
                    if s == shard and st == ShardState.DIRTY and v < version:
                        self._states[(s, v)] = ShardState.EMPTY
                        self.buffer.drop(s, v)
                        self.stats["coalesces"] += 1

            while not self.buffer.put(shard, version, payload):
                # buffer full: drain LRU dirty entries (stall, V-D1)
                self.stats["stalls"] += 1
                if not self._evict_one_locked():
                    raise RuntimeError(
                        "host buffer exhausted and nothing drainable")
            self._states[(shard, version)] = ShardState.DIRTY
            self._lru[(shard, version)] = time.monotonic()
            self._tenant_of[(shard, version)] = tenant
            self.stats["acks"] += 1

            if self.scheme == PersistScheme.PB:
                self._start_drain_locked(shard, version)
            else:
                self._quota_drain_locked(tenant)
                self._rf_drain_down_locked()
        if self.sync_drain:
            self.drain_all(wait=True)

    # --------------------------------------------------------------- drain
    def _start_drain_locked(self, shard: str, version: int) -> None:
        if self._states.get((shard, version)) != ShardState.DIRTY:
            return
        self._states[(shard, version)] = ShardState.DRAIN
        self.stats["drains"] += 1
        if self.sync_drain or self._drainer is None:
            self._drain_one(shard, version)
        else:
            self._q.put((shard, version))

    def _quota_drain_locked(self, tenant: int) -> None:
        """Per-tenant quota drain-down: while ``tenant`` holds more
        DIRTY entries than its active-epoch quota, start draining its
        LRU dirty entry — the host-side analogue of the engine's
        per-tenant drain scope.  Drain *initiation* is synchronous
        (DIRTY -> DRAIN under the lock), so the drain counts stay
        deterministic even with the asynchronous drainer."""
        if self._quota is None:
            return
        q = int(self._quota[tenant % len(self._quota)])
        while True:
            dirty = sorted(
                [k for k, st in self._states.items()
                 if st == ShardState.DIRTY
                 and self._tenant_of.get(k, 0) == tenant],
                key=lambda k: self._lru.get(k, 0.0))
            if len(dirty) <= q:
                return
            self._start_drain_locked(*dirty[0])

    def _rf_drain_down_locked(self) -> None:
        cap = self.buffer.capacity_bytes
        if self.buffer.used_bytes <= self.drain_threshold * cap:
            return
        dirty = sorted(
            [k for k, st in self._states.items() if st == ShardState.DIRTY],
            key=lambda k: self._lru.get(k, 0.0))
        for key in dirty:
            if self.buffer.used_bytes <= self.drain_preset * cap:
                break
            self._start_drain_locked(*key)

    def _evict_one_locked(self) -> bool:
        dirty = sorted(
            [k for k, st in self._states.items() if st == ShardState.DIRTY],
            key=lambda k: self._lru.get(k, 0.0))
        if not dirty:
            # everything already draining; wait for one to complete
            draining = [k for k, st in self._states.items()
                        if st == ShardState.DRAIN]
            if not draining:
                return False
            key = draining[0]
            self._lock.release()
            try:
                for _ in range(10_000):
                    if self._states.get(key) != ShardState.DRAIN:
                        return True
                    time.sleep(0.001)
            finally:
                self._lock.acquire()
            return True
        self._start_drain_locked(*dirty[0])
        if self.sync_drain or self._drainer is None:
            return True
        # give the drainer a moment (ack-priority analogue)
        self._lock.release()
        try:
            time.sleep(0.002)
        finally:
            self._lock.acquire()
        return True

    def _drain_one(self, shard: str, version: int) -> None:
        payload = self.buffer.get(shard, version)
        if payload is not None:
            self.store.write(shard, version, payload)  # stale -> rejected
        with self._lock:
            # crash consistency: free ONLY after the store ack
            self._states[(shard, version)] = ShardState.EMPTY
            self.buffer.drop(shard, version)

    def _drain_loop(self, stop: threading.Event, q: "queue.Queue") -> None:
        # `stop` and `q` are this thread's private bindings (see
        # _start_drainer): the event stays set once set and the queue
        # reference never changes, so a stale loop can neither wake up
        # again nor consume / task_done on a successor's queue.
        while not stop.is_set():
            try:
                shard, version = q.get(timeout=0.05)
            except queue.Empty:
                continue
            self._drain_one(shard, version)
            q.task_done()

    def drain_all(self, wait: bool = True) -> None:
        with self._lock:
            for (s, v), st in list(self._states.items()):
                if st == ShardState.DIRTY:
                    self._start_drain_locked(s, v)
        if wait and self._drainer is not None:
            self._q.join()

    # -------------------------------------------------------------- restore
    def restore(self, shard: str) -> Optional[Tuple[int, Any]]:
        """Read Forwarding: newest version, from the buffer if it still
        lives there, else from the durable store."""
        hit = self.buffer.newest(shard)
        rec = self.store.read(shard)
        if hit is not None and (rec is None or hit[0] >= rec[0]):
            self.stats["restore_forwarded"] += 1
            return hit[0], _deserialize(hit[1])
        if rec is None:
            return None
        self.stats["restore_from_store"] += 1
        return rec[0], _deserialize(rec[1])

    # ------------------------------------------------------------- recovery
    def schedule_crash(self, after_persists: int) -> None:
        """Arm a deterministic crash window: power is lost right before
        persist number ``after_persists + 1`` reaches the switch, i.e.
        exactly ``after_persists`` persists get acked.  The checkpoint
        analogue of the engine's ``crash_at_ns`` — a crash scheduled at a
        persist index instead of a wall-clock instant."""
        if after_persists < 0:
            raise ValueError("after_persists must be >= 0")
        self._crash_after = after_persists

    def crash(self) -> None:
        """Process crash: queue (volatile routing state) is lost; buffer
        and store survive.  Until :meth:`recover`, further persists are
        dropped (the machine is off)."""
        self._crashed = True
        self._stop.set()
        if self._drainer is not None and self._drainer is not \
                threading.current_thread():
            self._drainer.join(timeout=1.0)
        self._q = queue.Queue()

    def recover(self) -> int:
        """Reboot: treat every surviving buffer entry as Dirty and drain
        all (Section V-D4).  Stale versions are rejected by the store.
        Restarts the drainer, so the manager is usable again afterwards.
        Returns the number of entries re-drained."""
        n = 0
        for shard, version in self.buffer.entries():
            payload = self.buffer.get(shard, version)
            if payload is not None:
                self.store.write(shard, version, payload)
                n += 1
            self.buffer.drop(shard, version)
            self._states[(shard, version)] = ShardState.EMPTY
        self._crashed = False
        self._crash_after = None
        if not self.sync_drain and self.scheme != PersistScheme.NOPB:
            self._start_drainer()
        return n

    def close(self) -> None:
        self.drain_all(wait=True)
        self._stop.set()
        if self._drainer is not None:
            self._drainer.join(timeout=2.0)
