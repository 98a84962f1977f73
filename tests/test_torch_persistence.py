"""The port's PCS checkpoint tier (``repro_torch.persistence``).

Twins of the 13 test functions of ``tests/test_persistence.py`` (the
reference's suite, which does not collect under jax 0.9: ROADMAP Queue
C, F1) against the port's tier, then a differential: one scripted
sequence of persists from three tenants, a scheduled crash, recovery and
restores, with ``sync_drain=True``, through the reference's manager and
the port's in each scheme, under the default policy and under a
persist-indexed quota ``Schedule``.  Both must give equal ``stats``,
equal store counters and equal restored ``(version, payload)`` for every
shard: exactly, since the tier's logic has no float in it.  Also the
payload format: f32 and int leaves pickle as the reference's numpy
arrays, bf16 as tagged uint16 bits.
"""
from __future__ import annotations

import pickle
import threading
import time

import numpy as np
import pytest
import torch

from _torch_ref import reference
from repro_torch.core.params import AllocPolicy, PBPolicy, Schedule
from repro_torch.persistence import (DurableStore, HostBufferTier,
                                     PCSCheckpointManager, PersistScheme,
                                     ShardState)
from repro_torch.persistence.store import _deserialize, _serialize


def mk(tmp_path, scheme, cap_mb=64, sync=True, delay=0.0):
    buf = HostBufferTier(capacity_bytes=cap_mb << 20)
    store = DurableStore(str(tmp_path / "store"), write_delay_s=delay)
    return PCSCheckpointManager(buf, store, scheme=scheme, sync_drain=sync)


# ---------------------------------------- twins of tests/test_persistence.py
@pytest.mark.parametrize("scheme", list(PersistScheme))
def test_persist_restore_roundtrip(tmp_path, scheme):
    mgr = mk(tmp_path, scheme)
    arr = np.arange(100, dtype=np.float32)
    mgr.persist("w", 1, arr)
    got = mgr.restore("w")
    assert got is not None and got[0] == 1
    np.testing.assert_array_equal(got[1], arr)
    mgr.close()


def test_write_order_stale_rejected(tmp_path):
    store = DurableStore(str(tmp_path / "s"))
    assert store.write("x", 5, b"new")
    assert not store.write("x", 3, b"old")     # stale must not overwrite
    assert store.read("x") == (5, b"new")
    assert store.stale_rejected == 1


def test_rf_read_forwarding(tmp_path):
    mgr = mk(tmp_path, PersistScheme.PB_RF, sync=False)
    mgr.persist("w", 1, np.ones(4))
    got = mgr.restore("w")
    assert got[0] == 1
    assert mgr.stats["restore_forwarded"] >= 1
    mgr.close()


def test_rf_write_coalescing(tmp_path):
    mgr = mk(tmp_path, PersistScheme.PB_RF, sync=False)
    for v in range(1, 6):
        mgr.persist("w", v, np.full(4, v))
    assert mgr.stats["coalesces"] >= 3         # undrained olds superseded
    mgr.drain_all()
    assert mgr.store.read("w")[0] == 5
    mgr.close()


def test_pb_drains_every_version(tmp_path):
    mgr = mk(tmp_path, PersistScheme.PB, sync=True)
    for v in range(1, 4):
        mgr.persist("w", v, np.full(4, v))
    assert mgr.stats["coalesces"] == 0
    assert mgr.store.writes_applied == 3
    mgr.close()


def test_crash_recovery_drains_survivors(tmp_path):
    mgr = mk(tmp_path, PersistScheme.PB_RF, sync=False)
    mgr.persist("a", 1, np.ones(8))
    mgr.persist("b", 1, np.zeros(8))
    mgr.crash()                                 # drainer dies, queue lost
    n = mgr.recover()
    assert n >= 0
    for s in ("a", "b"):
        assert mgr.store.read(s) is not None, f"{s} lost after recovery"
    mgr.close()


@pytest.mark.parametrize("scheme",
                         [PersistScheme.PB, PersistScheme.PB_RF])
def test_scheduled_crash_window_is_deterministic(tmp_path, scheme):
    mgr = mk(tmp_path, scheme, sync=False)
    mgr.schedule_crash(3)
    for v in range(1, 7):
        mgr.persist(f"s{v}", v, np.full(8, v))
    assert mgr.stats["acks"] == 3
    assert mgr.stats["lost_after_crash"] == 3
    n = mgr.recover()
    assert n >= 0
    for v in range(1, 4):          # acked before the crash: durable
        rec = mgr.store.read(f"s{v}")
        assert rec is not None and rec[0] == v, f"acked s{v} lost"
    for v in range(4, 7):          # never reached the switch: gone
        assert mgr.store.read(f"s{v}") is None, f"s{v} resurrected"
        assert mgr.buffer.newest(f"s{v}") is None
    mgr.persist("post", 9, np.ones(4))
    mgr.drain_all()
    assert mgr.store.read("post")[0] == 9
    mgr.close()


def test_quota_schedule_steps_at_persist_index(tmp_path):
    buf = HostBufferTier(capacity_bytes=64 << 20)
    store = DurableStore(str(tmp_path / "store"))
    pol = PBPolicy(alloc=AllocPolicy(
        tenant_quota=Schedule((4.0,), ((3,), (1,)))))
    mgr = PCSCheckpointManager(buf, store, scheme=PersistScheme.PB_RF,
                               policy=pol, sync_drain=False)
    for v in range(1, 5):
        mgr.persist(f"s{v}", v, np.full(8, v))
    assert mgr._epoch == 0
    assert mgr.stats["drains"] == 1
    mgr.persist("s5", 5, np.full(8, 5))
    assert mgr._epoch == 1
    assert mgr.stats["drains"] == 4
    dirty = [k for k, st in mgr._states.items()
             if st == ShardState.DIRTY]
    assert dirty == [("s5", 5)]
    mgr.drain_all(wait=True)
    for v in range(1, 6):
        rec = mgr.store.read(f"s{v}")
        assert rec is not None and rec[0] == v
    mgr.close()


def test_scheduled_crash_zero_acks_nothing(tmp_path):
    mgr = mk(tmp_path, PersistScheme.PB_RF, sync=False)
    mgr.schedule_crash(0)
    mgr.persist("w", 1, np.ones(4))
    assert mgr.stats["acks"] == 0
    mgr.recover()
    assert mgr.store.read("w") is None
    mgr.close()


def test_replica_failure_falls_back_to_store(tmp_path):
    mgr = mk(tmp_path, PersistScheme.PB_RF, sync=False)
    mgr.persist("w", 1, np.ones(4))
    mgr.drain_all(wait=True)
    for (s, v) in mgr.buffer.entries():
        for _ in range(mgr.buffer.replicas):
            mgr.buffer.fail_replica(s, v)
    got = mgr.restore("w")
    assert got is not None and got[0] == 1
    assert mgr.stats["restore_from_store"] >= 1
    mgr.close()


def test_capacity_stall_then_drain(tmp_path):
    mgr = mk(tmp_path, PersistScheme.PB_RF, cap_mb=1, sync=False)
    big = np.zeros(200_000, dtype=np.float32)   # 0.8 MB each
    mgr.persist("a", 1, big)
    mgr.persist("b", 1, big)                    # must evict a first
    assert mgr.stats["stalls"] >= 1
    assert mgr.restore("b")[0] == 1
    mgr.close()


def test_one_drainer_per_queue_after_slow_crash_recover(tmp_path):
    mgr = mk(tmp_path, PersistScheme.PB, sync=False, delay=1.5)
    mgr.persist("a", 1, np.ones(8))
    time.sleep(0.3)                 # drainer is now inside the slow write
    old = mgr._drainer
    mgr.crash()                     # join(1.0) times out; old still alive
    assert old.is_alive(), "precondition: the slow write must outlive crash"
    mgr.recover()
    new = mgr._drainer
    assert new is not old and new.is_alive()
    mgr._start_drainer()
    assert mgr._drainer is new, "_start_drainer must not double-spawn"
    old.join(timeout=8.0)
    assert not old.is_alive(), "stopped drainer must exit, not keep looping"
    assert mgr._drainer is new and new.is_alive()
    mgr.persist("b", 2, np.zeros(4))
    mgr.drain_all(wait=True)
    assert mgr.store.read("b")[0] == 2
    assert mgr.store.read("a") is not None, "survivor lost in recovery"
    mgr.close()


def test_concurrent_persists(tmp_path):
    mgr = mk(tmp_path, PersistScheme.PB_RF, sync=False)
    errs = []

    def worker(i):
        try:
            for v in range(1, 6):
                mgr.persist(f"w{i}", v, np.full(16, v))
        except Exception as e:  # pragma: no cover
            errs.append(e)

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    assert not errs
    mgr.drain_all()
    for i in range(4):
        assert mgr.store.read(f"w{i}")[0] == 5
    mgr.close()


# ------------------------------------------------------- payload format
def test_payloads_keep_the_reference_format_and_tag_bf16():
    f32 = np.arange(6, dtype=np.float32).reshape(2, 3)
    tree = {"a": torch.from_numpy(f32), "n": np.int32(7),
            "b": torch.tensor([1.5, -2.25, 3e38], dtype=torch.bfloat16),
            "l": [torch.arange(3, dtype=torch.int32)], "meta": {"step": 4}}
    raw = _serialize(tree)
    plain = pickle.loads(raw)              # what the reference reads
    assert isinstance(plain["a"], np.ndarray) and plain["a"].dtype == np.float32
    assert plain["b"] == {"__dtype__": "bfloat16", "bits": plain["b"]["bits"]}
    assert plain["b"]["bits"].dtype == np.uint16
    back = _deserialize(raw)
    np.testing.assert_array_equal(back["a"], f32)
    assert back["b"].dtype == torch.bfloat16
    assert torch.equal(back["b"], tree["b"])
    np.testing.assert_array_equal(back["l"][0], np.arange(3, dtype=np.int32))
    assert back["meta"] == {"step": 4} and back["n"] == 7
    # the reference's own payloads (numpy trees) read back unchanged
    ref_raw = pickle.dumps({"w": f32}, protocol=pickle.HIGHEST_PROTOCOL)
    assert _serialize({"w": f32}) == ref_raw
    np.testing.assert_array_equal(_deserialize(ref_raw)["w"], f32)


# ------------------------------------------------------------ differential
@pytest.fixture(scope="module")
def ref():
    with reference() as r:
        yield r


def _script(mgr, payload):
    """Persists of 4 shards over 6 versions from 3 tenants, a crash
    window after 14 persists, recovery, more persists and a restore of
    every shard.  With ``sync_drain`` every persist drains the buffer
    before it returns."""
    log = []
    mgr.schedule_crash(14)
    for v in range(1, 7):
        for i, shard in enumerate(("a", "b", "c", "d")):
            if (v + i) % 3 == 0:
                continue
            mgr.persist(shard, v, payload(v, i), tenant=i % 3)
        log.append(dict(mgr.stats))
    log.append(mgr.recover())
    for v in (7, 8):
        mgr.persist("a", v, payload(v, 0))
        mgr.persist("e", v, payload(v, 4), tenant=1)
    for shard in ("a", "b", "c", "d", "e", "none"):
        log.append((shard, mgr.restore(shard)))
    mgr.drain_all()
    log.append(dict(mgr.stats))
    log.append((mgr.store.writes_applied, mgr.store.stale_rejected,
                sorted(mgr.store.shards())))
    return log


def _payload(v, i):
    return np.full(80_000 + 1_000 * i, v * 10 + i, dtype=np.float32)


@pytest.mark.parametrize("quota", [False, True], ids=["default", "quota"])
@pytest.mark.parametrize("scheme", ["nopb", "pb", "pb_rf"])
def test_tier_equals_reference_tier(ref, tmp_path, scheme, quota):
    RP = ref.persistence
    logs = []
    for side, (Buf, Store, Mgr, Scheme, policy) in {
            "ref": (RP.HostBufferTier, RP.DurableStore,
                    RP.PCSCheckpointManager, RP.PersistScheme,
                    ref.params.PBPolicy(alloc=ref.params.AllocPolicy(
                        tenant_quota=ref.params.Schedule(
                            (5.0,), ((2,), (1,))))) if quota else None),
            "port": (HostBufferTier, DurableStore, PCSCheckpointManager,
                     PersistScheme,
                     PBPolicy(alloc=AllocPolicy(tenant_quota=Schedule(
                         (5.0,), ((2,), (1,))))) if quota else None)}.items():
        mgr = Mgr(Buf(capacity_bytes=1 << 20),
                  Store(str(tmp_path / side)), scheme=Scheme(scheme),
                  policy=policy, sync_drain=True)
        logs.append(_script(mgr, _payload))
        mgr.close()
    want, got = logs
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, tuple) and len(w) == 2 and isinstance(w[0], str):
            assert g[0] == w[0]
            if w[1] is None:
                assert g[1] is None, g
                continue
            assert g[1][0] == w[1][0], (g[0], g[1][0], w[1][0])
            np.testing.assert_array_equal(g[1][1], w[1][1])
        else:
            assert g == w
    assert want[-2]["lost_after_crash"] > 0
    assert want[-2]["restore_from_store"] == 5
