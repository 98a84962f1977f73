"""Port parity: state lowering, channels and policy pieces
(``repro_torch.core.engine.state`` / ``channels`` / ``policy``) against
the JAX functions, on random machine states made with numpy.

Equality is exact throughout: every function is integer logic or a
fixed sequence of f64 adds, maxes and products.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_ref import reference
from repro_torch.core import params as P
from repro_torch.core.engine import channels, policy, state

T, B, A = 2, 4, 8


@pytest.fixture(scope="module")
def ref():
    with reference() as r:
        yield r


def _np(x):
    return np.asarray(x)


def _same(got, want):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    assert np.array_equal(g.astype(np.float64), w.astype(np.float64)), \
        (g, w)


def _cfgs(m):
    S = m.Scheme
    return [
        m.PCSConfig(scheme=S.PB_RF),
        m.PCSConfig(scheme=S.PB_RF, n_tenants=2,
                    policy=m.PBPolicy(alloc=m.AllocPolicy(victim="weighted"))),
        m.PCSConfig(scheme=S.PB_RF, n_tenants=2, policy=m.PBPolicy(
            alloc=m.AllocPolicy(tenant_quota=(3, 5)))),
        m.PCSConfig(scheme=S.PB_RF, n_tenants=2,
                    policy=m.PBPolicy(drain=m.DrainPolicy(
                        per_tenant=True, latency_target_ns=300.0))),
        m.PCSConfig(scheme=S.PB, n_pbe=9, pm_banks=B),
        m.PCSConfig(scheme=S.PB_RF, crash_at_ns=5e3,
                    latency=m.LatencyProfile(nvm_write_ns=333.0)),
    ]


def _random_state(rng, P_, n_track=A):
    """A random depth-1 machine state with many tag, LRU and ack-time
    ties (small value ranges), as numpy arrays."""
    return dict(
        clock=rng.uniform(0, 1e4, 8), ptr=rng.integers(0, 9, 8),
        tag=rng.integers(-1, 12, P_), state=rng.integers(0, 3, P_),
        lru=rng.choice([0.0, 10.0, 20.0, 30.0, 40.5], P_),
        dd=rng.choice([0.0, 50.0, 75.0, 100.0, 125.5], P_),
        ver=rng.integers(0, 9, P_), owner=rng.integers(0, T, P_),
        aver=rng.integers(0, 9, max(n_track, 1)),
        pm_ver=rng.integers(0, 9, max(n_track, 1)),
        pm_busy=rng.choice([0.0, 60.0, 90.0, 120.0], B),
        pbc_busy=np.float64(rng.uniform(0, 100)),
        blocked=rng.integers(0, 2, 8).astype(bool),
        bcount=rng.integers(0, 3, T),
        stats=rng.integers(0, 20, (T, state.N_STATS)).astype(np.float64),
        hop_stats=np.zeros((1, state.N_HOP_STATS)))


def _f64(x):
    return torch.tensor(x, dtype=torch.float64)


def _ref_sc(ref, cfg, nt=T):
    import jax.numpy as jnp
    with ref.x64():
        return {k: jnp.asarray(v, jnp.float64)
                for k, v in ref.state.scalars_from_config(cfg, nt).items()}


def test_lat_bin_edges_and_sweep(ref):
    import jax.numpy as jnp
    vals = [np.geomspace(0.25, 4e7, 20000)]
    for k in range(state.N_LAT_BINS - 1):
        e = state.LAT_BIN_EDGES[k]
        exact = 256.0 * 2.0 ** (k / 2)
        for x in (e, exact):
            vals.append(x + np.arange(-3000, 3000) * np.spacing(x))
    v = np.concatenate(vals)
    with ref.x64():
        want = _np(ref.state.lat_bin(jnp.asarray(v)))
    got = state.lat_bin(torch.tensor(v)).numpy()
    assert np.array_equal(got, want)
    assert state.N_STATS == ref.state.N_STATS
    assert np.array_equal(state.lat_hist_edges(), ref.state.lat_hist_edges())


def test_hist_percentiles_match(ref):
    rng = np.random.default_rng(3)
    for _ in range(20):
        h = rng.integers(0, 50, state.N_LAT_BINS).astype(np.float64)
        for q in (0.0, 0.5, 0.95, 0.99, 1.0):
            assert state.lat_hist_percentile(h, q) == \
                ref.state.lat_hist_percentile(h, q)
        assert state.lat_hist_mean(h) == ref.state.lat_hist_mean(h)


def test_channels_match(ref):
    import jax.numpy as jnp
    rng = np.random.default_rng(7)
    with ref.x64():
        for addr in (-5, -1, 0, 3, 17, 2 ** 22 - 1):
            for nb in (1, 3, 4):
                assert int(channels.bank_of(torch.tensor(addr), nb)) == \
                    int(ref.channels.bank_of(jnp.asarray(addr), nb))
        for _ in range(50):
            busy = rng.choice([0.0, 40.0, 90.5], B)
            bank = int(rng.integers(0, B))
            ready, occ = rng.uniform(0, 100), rng.uniform(1, 60)
            tb, jb = torch.tensor(busy), jnp.asarray(busy)
            _same(channels.service_start(tb, bank, _f64(ready)),
                  ref.channels.service_start(jb, bank, ready))
            _same(channels.reserve(tb, bank, _f64(ready), occ),
                  ref.channels.reserve(jb, bank, ready, occ))
            _same(channels.pbc_start(_f64(busy[0]),
                                     _f64(ready), occ),
                  ref.channels.pbc_start(busy[0], ready, occ))
            _same(channels.pbc_hold(_f64(busy[0]),
                                    _f64(ready), occ),
                  ref.channels.pbc_hold(busy[0], ready, occ))
            arr = np.sort(rng.uniform(0, 200, 9))
            act = rng.integers(0, 2, 9).astype(bool)
            s1, b1 = channels.fifo_service(_f64(busy[1]),
                                           _f64(arr),
                                           torch.tensor(act), occ)
            s2, b2 = ref.channels.fifo_service(jnp.asarray(busy[1]),
                                               jnp.asarray(arr),
                                               jnp.asarray(act), occ)
            _same(s1, s2)
            _same(b1, b2)


@pytest.mark.parametrize("P_", [16, 40])
def test_lookups_and_occupancy_on_random_states(ref, P_):
    import jax.numpy as jnp
    rng = np.random.default_rng(11 + P_)
    for _ in range(150):
        s = _random_state(rng, P_)
        st = state.state_from_numpy(**s)
        n_pbe = int(rng.integers(1, P_ + 1))
        act = np.arange(P_) < n_pbe
        addr = int(rng.integers(-1, 12))
        now = float(rng.choice([0.0, 50.0, 80.0, 130.0]))
        with ref.x64():
            jt, js, jd = (jnp.asarray(s["tag"], jnp.int32),
                          jnp.asarray(s["state"], jnp.int8),
                          jnp.asarray(s["dd"]))
            want_free = ref.policy.lazy_free(js, jd, now)
            has_r, idx_r = ref.policy.pb_lookup(jt, js, jnp.asarray(act),
                                                jnp.asarray(addr, jnp.int32))
            md = jnp.asarray(act) & (jt == addr) & (js == state.DIRTY)
            occ_r = ref.policy.tenant_occupancy(
                js, jnp.asarray(act), jnp.asarray(s["owner"], jnp.int8), T)
        ta = torch.tensor(act)
        _same(policy.lazy_free(st.state, st.dd, _f64(now)), want_free)
        has, idx = policy.pb_lookup(st.tag, st.state, ta,
                                    torch.tensor(addr, dtype=torch.int32))
        assert bool(has) == bool(has_r) and int(idx) == int(idx_r)
        hd, idd = policy.coalesce_lookup(st.tag, st.state, ta,
                                         torch.tensor(addr, dtype=torch.int32))
        assert bool(hd) == bool(jnp.any(md))
        assert int(idd) == int(jnp.argmax(md))
        _same(policy.tenant_occupancy(st.state, ta, st.owner, T), occ_r)


@pytest.mark.parametrize("k", range(6))
def test_select_slot_and_drain_policies_on_random_states(ref, k):
    import jax.numpy as jnp
    cfg_r = _cfgs(ref.params)[k]
    cfg_p = _cfgs(P)[k]
    sc_r = _ref_sc(ref, cfg_r)
    sc_p = state.scalars_from_config(cfg_p, T)
    P_ = max(16, cfg_p.n_pbe)
    rng = np.random.default_rng(100 + k)
    for _ in range(60):
        s = _random_state(rng, P_)
        st = state.state_from_numpy(**s)
        act = np.arange(P_) < cfg_p.n_pbe
        ta, ja = torch.tensor(act), jnp.asarray(act)
        tenant = int(rng.integers(0, T))
        tw = float(rng.choice([10.0, 60.0, 95.5]))
        tight = bool(rng.integers(0, 2))
        wslot = int(rng.integers(0, P_))
        bank = int(rng.integers(0, B))
        with ref.x64():
            js = dict(tag=jnp.asarray(s["tag"], jnp.int32),
                      state=jnp.asarray(s["state"], jnp.int8),
                      lru=jnp.asarray(s["lru"]), dd=jnp.asarray(s["dd"]),
                      owner=jnp.asarray(s["owner"], jnp.int8),
                      pm_busy=jnp.asarray(s["pm_busy"]))
            occ_r = ref.policy.tenant_occupancy(js["state"], ja, js["owner"],
                                                T)
            sel_r = ref.policy.select_slot(
                sc_r, js["state"], ja, js["lru"], js["dd"], js["owner"],
                jnp.asarray(tenant, jnp.int32), occ_r)
            imm_r = ref.policy.drain_immediate(
                sc_r, bank, jnp.arange(P_), wslot, tw, js["state"],
                js["dd"], js["pm_busy"])
            rf_r = ref.policy.drain_threshold_preset(
                sc_r, B, ja, tw, js["state"], js["tag"], js["lru"],
                js["dd"], js["pm_busy"], owner=js["owner"],
                tenant=jnp.asarray(tenant, jnp.int32),
                tight=jnp.asarray(tight))
            surv_r = ref.policy.surviving_entries(js["state"], js["dd"], ja,
                                                  sc_r["crash_at"])
            per_bank = rng.integers(0, 4, B).astype(np.float64)
            cost_r = ref.policy.recovery_burst_cost(
                sc_r, jnp.asarray(per_bank), per_bank.sum())
        ten = torch.tensor(tenant)
        occ = policy.tenant_occupancy(st.state, ta, st.owner, T)
        sel = policy.select_slot(sc_p, st.state, ta, st.lru, st.dd,
                                 st.owner, ten, occ)
        for g, w in zip(sel, sel_r):
            assert int(g) == int(w)
        imm = policy.drain_immediate(sc_p, bank, torch.arange(P_),
                                     torch.tensor(wslot), _f64(tw),
                                     st.state, st.dd, st.pm_busy)
        for g, w in zip(imm, imm_r):
            _same(g, w)
        rf = policy.drain_threshold_preset(
            sc_p, B, ta, _f64(tw), st.state, st.tag, st.lru, st.dd,
            st.pm_busy, owner=st.owner, tenant=ten,
            tight=torch.tensor(tight))
        for g, w in zip(rf, rf_r):
            _same(g, w)
        _same(policy.surviving_entries(st.state, st.dd, ta,
                                       sc_p["crash_at"]), surv_r)
        _same(policy.recovery_burst_cost(sc_p, _f64(per_bank),
                                         _f64(per_bank.sum())),
              cost_r)


def _sched_cfgs(m):
    S = m.Scheme
    return _cfgs(m) + [
        m.PCSConfig(scheme=S.NOPB),
        m.PCSConfig(scheme=S.PB, n_switches=3, pbe_per_hop=(16, 8, 4)),
        m.PCSConfig(scheme=S.PB_RF, n_tenants=2, fabric=m.FabricTopology(
            n_leaves=2, leaf_pbe=(8, 8), placement=(1, 0), bp_high=3.0)),
        m.PCSConfig(scheme=S.PB_RF, n_tenants=2, policy=m.PBPolicy(
            drain=m.DrainPolicy(threshold=m.Schedule((4e3,), (0.8, 0.5)),
                                preset=m.Schedule((4e3,), (0.6, 0.25))),
            alloc=m.AllocPolicy(tenant_quota=m.Schedule((4e3,),
                                                        ((3, 5), (6, 2)))))),
    ]


@pytest.mark.parametrize("k", range(len(_sched_cfgs(P))))
def test_scalars_from_config_all_keys_match(ref, k):
    cr, cp = _sched_cfgs(ref.params)[k], _sched_cfgs(P)[k]
    for kw in (dict(), dict(n_tenants_max=3), dict(n_deep_max=2),
               dict(n_tenants_max=2, n_deep_max=2, n_leaves_max=3,
                    n_epochs_max=3)):
        try:
            want = ref.state.scalars_from_config(cr, **kw)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)[:30]):
                state.scalars_from_config(cp, **kw)
            continue
        got = state.scalars_from_config(cp, **kw)
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == torch.float64
            _same(got[key], np.asarray(want[key], np.float64))
