"""PB policy layer: allocation, victim selection, drain policies (torch
port of ``repro.core.engine.policy``).

Scalar policy constants live in ``core.params`` and are re-exported
here.  The tensor functions below operate on the
:class:`~repro_torch.core.engine.state.MachineState` arrays and keep
every arithmetic expression in the reference's form and order, so
results are bit-identical.  The PB lookups (:func:`pb_lookup`,
:func:`coalesce_lookup`) are written through
:func:`~repro_torch.kernels.ref.tat_lookup_ref`, the plain version of
the ported ``tat_lookup`` kernel; the cell-scan kernel runs the same
compositions through the kernel's shared match routine.
"""
from __future__ import annotations

import torch

from repro_torch.core.params import (DEFAULT_DRAIN_PRESET,     # noqa: F401
                                     DEFAULT_DRAIN_THRESHOLD, RF_EMPTY_SLACK,
                                     RF_LOW_WATER_DRAINS, SCHEME_NAMES,
                                     Scheme, preset_count, rf_drain_count,
                                     threshold_count)
from repro_torch.core.engine.state import DIRTY, DRAIN, EMPTY, INF
from repro_torch.kernels.ref import tat_lookup_ref


def lazy_free(state, dd, now):
    """Observe Drain->Empty transitions whose PM ack time has passed."""
    freed = (state == DRAIN) & (dd <= now)
    return torch.where(freed, EMPTY, state)


def _first_match(tag, live, addr):
    """``tat_lookup`` of one request against the masked table: the first
    slot with ``tag == addr`` among ``live`` slots, or -1."""
    idx, _ = tat_lookup_ref(addr.reshape(1).to(torch.int32), tag,
                            live.to(torch.int32))
    return idx[0]


def pb_lookup(tag, state, slot_active, addr):
    """Newest live entry for ``addr`` (a Dirty entry supersedes Drain).

    Returns (has_entry, idx): whether any live entry matches, and the
    index of the newest one — the first Dirty match if there is one,
    else the first live match, else 0 (the reference's ``argmax`` of an
    all-False mask).
    """
    i_dirty = _first_match(tag, slot_active & (state == DIRTY), addr)
    i_live = _first_match(tag, slot_active & (state != EMPTY), addr)
    idx = torch.where(i_dirty >= 0, i_dirty, torch.clamp(i_live, min=0))
    return i_live >= 0, idx


def coalesce_lookup(tag, state, slot_active, addr):
    """The persist path's coalesce target: the first Dirty entry holding
    ``addr`` (index 0 when there is none)."""
    i_dirty = _first_match(tag, slot_active & (state == DIRTY), addr)
    return i_dirty >= 0, torch.clamp(i_dirty, min=0)


def tenant_occupancy(state, slot_active, owner, n_tenants_max: int):
    """Per-tenant live-PBE counts: ``occ[t]`` = non-Empty entries owned
    by tenant ``t`` (the quota / weighted-victim accounting base)."""
    live = (slot_active & (state != EMPTY)).to(torch.float64)
    return torch.zeros((n_tenants_max,), dtype=torch.float64,
                       device=state.device).index_add(
        0, torch.clamp(owner.long(), 0, n_tenants_max - 1), live)


def _argmin_masked(mask, key):
    return torch.argmin(torch.where(mask, key, INF))


def select_slot(sc, state, slot_active, lru, dd, owner, tenant, occ):
    """Allocation / victim selection over the PBE array (AllocPolicy).

    Preference order of the persist handler: an Empty slot (LRU-oldest),
    else the LRU Dirty entry (victim drain), else the Drain entry whose
    PM ack lands earliest (pure wait) — refined by the quota gate and
    the weighted victim choice of the
    :class:`~repro_torch.core.params.AllocPolicy` lowering.  Every
    ``argmin`` breaks ties to the lowest index.
    """
    T = occ.shape[0]
    over_quota = occ[tenant] >= sc["quota"][tenant]
    own = owner == tenant
    empty_mask = slot_active & (state == EMPTY) & ~over_quota
    any_empty = empty_mask.any()
    empty_idx = _argmin_masked(empty_mask, lru)
    dirty_all = slot_active & (state == DIRTY)
    over_share = occ >= sc["share"]                       # (T,) bool
    hot = dirty_all & over_share[torch.clamp(owner.long(), 0, T - 1)]
    use_hot = (sc["victim_weighted"] > 0.0) & hot.any()
    dirty_mask = torch.where(over_quota, dirty_all & own,
                             torch.where(use_hot, hot, dirty_all))
    any_dirty = dirty_mask.any()
    victim_idx = _argmin_masked(dirty_mask, lru)
    drain_all = slot_active & (state == DRAIN)
    drain_mask = torch.where(over_quota, drain_all & own, drain_all)
    earliest_idx = _argmin_masked(drain_mask, dd)
    return any_empty, empty_idx, any_dirty, victim_idx, earliest_idx


def drain_immediate(sc, bank, slot_ids, wslot, t_written,
                    state3, dd3, pm_busy1):
    """PB scheme: drain the just-written entry at once (ack at switch).

    Returns (state4, dd4, pm_busy2, policy_writes).
    """
    pm_start2 = torch.maximum(pm_busy1[bank], t_written + sc["ow_sw1_pm"])
    dd_new = pm_start2 + sc["nvm_write"] + sc["ow_sw1_pm"]
    state4 = torch.where(slot_ids == wslot, DRAIN, state3)
    dd4 = dd3.clone()
    dd4[wslot] = dd_new
    pm_busy2 = pm_busy1.clone()
    pm_busy2[bank] = pm_start2 + sc["nvm_w_occ"]
    return state4, dd4, pm_busy2, torch.ones((), dtype=torch.float64,
                                             device=dd3.device)


def surviving_entries(state, dd, slot_active, crash_at):
    """Mask of PBEs that survive a power loss at ``crash_at``: a Dirty
    entry always survives; a Drain entry iff its PM ack would have
    landed only after the crash."""
    return slot_active & ((state == DIRTY) |
                          ((state == DRAIN) & (dd > crash_at)))


def recovery_burst_cost(sc, per_bank, n):
    """Drain-all burst latency over aggregated per-bank survivor counts
    (drains sharing a bank serialize at its write occupancy; zero when
    nothing survived)."""
    worst = torch.max(per_bank)
    return torch.where(
        n > 0,
        (worst - 1.0) * sc["nvm_w_occ"] + sc["nvm_write"]
        + 2.0 * sc["ow_sw1_pm"],
        0.0)


def drain_threshold_preset(sc, n_banks, slot_active, t_written,
                           state3, tag3, lru3, dd3, pm_busy1, *,
                           owner, tenant, tight=None, defer=None):
    """PB_RF: threshold/preset drain-down over LRU Dirty entries.

    Tensor twin of :func:`rf_drain_count` plus the per-bank burst
    serialization: drains sharing a PM bank are issued back-to-back at
    the bank's write occupancy, overlapping across banks.  A
    tenant-scoped drain (``sc["drain_scope"]``) sees only the issuing
    tenant's Dirty entries and its own counts; ``tight`` (the serving-SLO
    override) drains with threshold 1 / preset 0; ``defer`` (the
    fabric's spine backpressure, or None to skip) defers the whole
    drain-down (``k = 0``) while the spine is congested.  The LRU rank is
    the stable-sort rank, so equal stamps order by slot index.  Returns
    (state4, dd4, pm_busy2, policy_writes).
    """
    B = n_banks
    scoped = sc["drain_scope"] > 0.0
    in_scope = (owner == tenant) | ~scoped
    dirty_mask = (state3 == DIRTY) & slot_active & in_scope
    dirty_cnt = dirty_mask.sum()
    empty_cnt = ((state3 == EMPTY) & slot_active).sum()
    thr = torch.where(scoped, sc["t_threshold"][tenant],
                      sc["threshold_count"])
    pre = torch.where(scoped, sc["t_preset"][tenant], sc["preset_count"])
    if tight is not None:
        thr = torch.where(tight, 1.0, thr)  # lint: mirror(rf-tight-thr)
        pre = torch.where(tight, 0.0, pre)  # lint: mirror(rf-tight-pre)
    do_drain = dirty_cnt >= thr  # lint: mirror(rf-do-drain)
    k_thresh = torch.where(do_drain, dirty_cnt - pre, 0.0)  # lint: mirror(rf-k-thresh)
    k_low = torch.where(empty_cnt <= sc["empty_slack"],  # lint: mirror(rf-k-low)
                        torch.minimum(sc["low_water"],
                                      dirty_cnt.to(torch.float64)),
                        0.0)
    k = torch.maximum(k_thresh, k_low)
    if defer is not None:
        k = torch.where(defer, 0.0, k)
    key = torch.where(dirty_mask, lru3, INF)
    rank = torch.argsort(torch.argsort(key, stable=True),
                         stable=True).to(torch.float64)
    to_drain = (rank < k) & dirty_mask
    banks = torch.remainder(tag3, B).long()
    # rank among drained entries sharing a bank (serializes the burst per
    # PM bank, overlapping across banks)
    same_bank = banks[:, None] == banks[None, :]
    earlier = rank[None, :] < rank[:, None]
    rank_b = (same_bank & earlier & to_drain[None, :]).to(
        torch.float64).sum(1)
    start_i = (torch.maximum(pm_busy1[banks], t_written + sc["ow_sw1_pm"])
               + rank_b * sc["nvm_w_occ"])
    dd_j = start_i + sc["nvm_write"] + sc["ow_sw1_pm"]
    state4 = torch.where(to_drain, DRAIN, state3)
    dd4 = torch.where(to_drain, dd_j, dd3)
    busy_after = torch.where(to_drain, start_i + sc["nvm_w_occ"], 0.0)
    per_bank = torch.where(same_bank & to_drain[None, :],
                           busy_after[None, :], 0.0).max(dim=1).values
    pm_busy2 = torch.maximum(
        pm_busy1, torch.zeros((B,), dtype=torch.float64,
                              device=pm_busy1.device).scatter_reduce(
            0, banks, per_bank, "amax"))
    return state4, dd4, pm_busy2, k
