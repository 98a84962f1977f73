"""Op handlers of the timed engine (torch port).

Each handler maps ``(ctx, MachineState) -> MachineState`` for the op the
selected core issues at time ``ctx.t``.  The step loop picks the
handler by the op kind, and the PM-read and persist handlers pick their
body by the cell's scheme (NoPB / PB / PB_RF) — Python branches where
the reference uses ``lax.switch``.  The reference's vmapped switch runs
every branch and selects one; a branch computes only the selected one,
so the results are identical.

PM write acks are modeled lazily: when a drain is scheduled its ack
arrival time at the switch is computed immediately (PM queueing
included) and stored per entry; any later event observes Drain->Empty
transitions whose ack time has passed (``policy.lazy_free``).  Under a
switch chain (``n_switches >= 2``) a hop-1 drain is acked by hop 2's
persistent cells instead, and the reads pass every deeper switch's PBCS
(``engine.chain``).  Under a fan-out fabric (``engine.fabric``) a
tenant's reads and persists see only its own leaf's hop-1 slot window
and queue at its own leaf's PBC clock (``lpbc``), and the spine's Dirty
occupancy can defer a leaf's drain-down.

Scope: switch chains and fan-out fabrics; under a schedule the step
loop hands every handler the rows of the op's epoch
(``step.resolve_epoch_sc``), and a deep row a lowered threshold left
over its drain count drains on a forward with no packet
(``chain.drain_pending``).  A committed macro-step (``engine.macro``)
stands in for the handlers of its window's ops, with the same results.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from repro_torch.core.engine import chain, channels, fabric, policy
from repro_torch.core.params import spine_defer
from repro_torch.core.engine.state import (DIRTY, DRAIN, INF, H_COALESCES,
                                           H_FWD_CNT, H_FWD_SUM, H_READ_HITS,
                                           MachineState, S_ACKED,
                                           S_COALESCES, S_DRAM_READS,
                                           S_DURABLE, S_LAT_HIST0,
                                           S_PBCQ_SUM, S_PERSIST_CNT,
                                           S_PERSIST_SUM, S_PI_DETOURS,
                                           S_PM_WRITES, S_READ_CNT,
                                           S_READ_HITS, S_READ_SUM,
                                           S_SLO_OVER, S_STALL_TIME,
                                           S_VICTIM_CNT, lat_bin)


class StepCtx(NamedTuple):
    """Per-step context handed to every handler."""

    c: torch.Tensor          # ()  selected core
    t: torch.Tensor          # ()  f64 op issue time
    addr: torch.Tensor       # ()  i32 target cache line
    scheme: int              # the cell's Scheme value
    sc: Dict[str, torch.Tensor]  # latency/policy scalars of the config
    slot_ids: torch.Tensor   # (P,) arange over PBE slots
    slot_active: torch.Tensor  # (P,) live-slot mask (slot_ids < n_pbe)
    tenant: torch.Tensor     # ()  tenant id of the selected core
    tids: torch.Tensor       # (C,) per-core tenant ids
    n_live_t: torch.Tensor   # ()  live cores in this op's tenant (barriers)
    n_banks: int             # PM bank count
    n_track: int = 0         # durability-tracked address count


def _tracked(ctx: StepCtx, addr):
    """Is ``addr`` inside the durability-tracked window [0, n_track)?"""
    return (addr >= 0) & (addr < ctx.n_track)


def _set(x, i, v):
    """Out-of-place ``x.at[i].set(v)``."""
    out = x.clone()
    out[i] = v
    return out


def _add_stats(stats, tenant, cols, vals):
    """``stats.at[tenant, cols].add(vals)`` over distinct columns: one add
    per column, as the reference's fused scatter."""
    out = stats.clone()
    out[tenant, cols] += vals
    return out


def _f64(x):
    return x.to(torch.float64)


def _leaf_window(ctx: StepCtx, st: MachineState):
    """The issuing tenant's hop-1 view: ``(leaf, slot mask, PBC clock)``.

    Under a multi-leaf fabric grid (``NL > 0``) the op enters its
    tenant's own leaf switch — only that leaf's slot window is visible,
    and that leaf's PBC front serves it; otherwise (leaf None) the
    global window and the single ``pbc_busy`` clock.
    """
    if not fabric.has_fabric(st):
        return None, ctx.slot_active, st.pbc_busy
    sc = ctx.sc
    my_leaf = fabric.leaf_of_tenant(sc, ctx.tenant)
    leaf_act = ctx.slot_active & fabric.leaf_mask(
        sc, fabric.slot_leaf(sc, ctx.slot_ids), my_leaf)
    return my_leaf, leaf_act, st.lpbc[my_leaf]


def _pbc_cols(st: MachineState, my_leaf, pbc_new) -> dict:
    """The PBC clock written back where :func:`_leaf_window` read it."""
    if my_leaf is None:
        return dict(pbc_busy=pbc_new)
    return dict(lpbc=_set(st.lpbc, my_leaf.long(), pbc_new))


# ---------------------------------------------------------------- volatile
def handle_compute(ctx: StepCtx, st: MachineState) -> MachineState:
    return st._replace(clock=_set(st.clock, ctx.c, ctx.t))


def handle_dram_read(ctx: StepCtx, st: MachineState) -> MachineState:
    stats = st.stats.clone()
    stats[ctx.tenant, S_DRAM_READS] += 1.0
    return st._replace(clock=_set(st.clock, ctx.c, ctx.t + ctx.sc["dram_ns"]),
                       stats=stats)


def handle_dram_write(ctx: StepCtx, st: MachineState) -> MachineState:
    # posted write: ~free for the core
    return st._replace(clock=_set(st.clock, ctx.c, ctx.t))


# ----------------------------------------------------------------- PM read
def _read_direct(ctx: StepCtx, st: MachineState) -> MachineState:
    # NoPB: the volatile switch forwards every read to PM.
    sc, t = ctx.sc, ctx.t
    ow = sc["ow_cpu_pm"]
    bank = channels.bank_of(ctx.addr, ctx.n_banks)
    pm_start = channels.service_start(st.pm_busy, bank, t + ow)
    resp = pm_start + sc["nvm_read"] + ow
    stats = _add_stats(st.stats, ctx.tenant, [S_READ_SUM, S_READ_CNT],
                       torch.stack([resp - t, torch.ones_like(resp)]))
    return st._replace(
        clock=_set(st.clock, ctx.c, resp),
        pm_busy=channels.reserve(st.pm_busy, bank, pm_start, sc["nvm_r_occ"]),
        stats=stats)


def _read_via_pb(ctx: StepCtx, st: MachineState) -> MachineState:
    # PB/PB_RF: the PBCS classifies the read; a live entry routes it
    # through the PI buffer to the PBC (read forwarding).
    sc, t, addr = ctx.sc, ctx.t, ctx.addr
    ow = sc["ow_cpu_pm"]
    bank = channels.bank_of(addr, ctx.n_banks)
    pm_start_dir = channels.service_start(st.pm_busy, bank, t + ow)
    resp_dir = pm_start_dir + sc["nvm_read"] + ow

    state0 = policy.lazy_free(st.state, st.dd, t)
    my_leaf, leaf_act, pbc_prev = _leaf_window(ctx, st)
    has, idx = policy.pb_lookup(st.tag, state0, leaf_act, addr)
    # PI-buffer path: wait for the PBC (head-of-line blocking)
    arr = t + sc["ow_cpu_sw1"]
    pbc_start = channels.pbc_start(pbc_prev, arr,
                                   sc["pbc_read_ns"] + sc["tag_ns"])
    st_i = state0[idx]
    dd_i = st.dd[idx]
    served = (st_i == DIRTY) | (
        (st_i == DRAIN) & (dd_i > pbc_start + sc["fwd_margin"]))
    resp_pb = pbc_start + sc["data_ns"] + sc["ow_cpu_sw1"]
    # forwarded to PM through the PO buffer after the detour; the
    # packet re-enters the routing pipeline (one extra pipe pass)
    pm_start_fwd = torch.maximum(
        st.pm_busy[bank], pbc_start + sc["switch_pipe"] + sc["ow_sw1_pm"])
    resp_fwd = pm_start_fwd + sc["nvm_read"] + ow

    # Read-forwarding checks below hop 1 (switch chain): when hop 1 has
    # no live entry, the packet travels toward PM passing every deeper
    # switch's PBCS — the shallowest hop holding a visible live entry
    # serves it.  (A *stale* hop-1 Drain entry keeps its forward-to-PM
    # path: the deep refinement is skipped.)
    deep_hit, dlru, hrow = False, st.dlru, 0
    if st.dtag.shape[0] > 0 and float(sc["n_switches"]) >= 2.0 \
            and not bool(has):
        deep_hit, resp_deep, dlru, hrow = chain.deep_read(sc, st, addr, t)

    hit = has & served
    if deep_hit:
        resp, pmb = resp_deep, st.pm_busy[bank]
    else:
        resp = torch.where(has, torch.where(served, resp_pb, resp_fwd),
                           resp_dir)
        pmb = torch.where(
            has, torch.where(served, st.pm_busy[bank],
                             pm_start_fwd + sc["nvm_r_occ"]),
            pm_start_dir + sc["nvm_r_occ"])
    pm_busy2 = _set(st.pm_busy, bank, pmb)
    pbc_busy2 = torch.where(
        has, channels.pbc_hold(pbc_prev, arr, sc["pbc_read_occ"]),
        pbc_prev)
    lru2 = _set(st.lru, idx, torch.where(hit, t, st.lru[idx]))
    hop_stats = st.hop_stats.clone()
    hop_stats[0, H_READ_HITS] += _f64(hit)
    if deep_hit:
        hop_stats[hrow + 1, H_READ_HITS] += 1.0
    stats = _add_stats(
        st.stats, ctx.tenant,
        [S_READ_SUM, S_READ_CNT, S_READ_HITS, S_PI_DETOURS],
        torch.stack([resp - t, torch.ones_like(resp), _f64(hit | deep_hit),
                     _f64(has)]))
    return st._replace(clock=_set(st.clock, ctx.c, resp), state=state0,
                       lru=lru2, dlru=dlru, pm_busy=pm_busy2, stats=stats,
                       hop_stats=hop_stats,
                       **_pbc_cols(st, my_leaf, pbc_busy2))


def handle_pm_read(ctx: StepCtx, st: MachineState) -> MachineState:
    body = _read_direct if ctx.scheme == 0 else _read_via_pb
    return body(ctx, st)


# ----------------------------------------------------------------- persist
def _persist_with_buffer(ctx: StepCtx, st: MachineState) -> MachineState:
    """Shared PB persist core: PBC service, lookup, allocation / victim
    selection, entry write — then the scheme's drain policy (PB_RF
    coalesces and drains by threshold/preset; PB drains at once)."""
    sc, t, addr = ctx.sc, ctx.t, ctx.addr
    is_rf = ctx.scheme == 2          # Scheme.PB_RF
    crash = sc["crash_at"]
    bank = channels.bank_of(addr, ctx.n_banks)
    arr = t + sc["ow_cpu_sw1"]
    # Fabric: lookup/alloc/victim/drain are scoped to the tenant's leaf
    # window and its leaf's PBC front serves the packet (a chain cell in
    # a fabric grid keeps the global window: the n_leaves < 2 bypass)
    my_leaf, leaf_act, pbc_prev = _leaf_window(ctx, st)
    pbc_start = channels.pbc_start(pbc_prev, arr,
                                   sc["pbc_proc_ns"] + sc["tag_ns"])
    state1 = policy.lazy_free(st.state, st.dd, pbc_start)
    has_dirty, idx = policy.coalesce_lookup(st.tag, state1, leaf_act, addr)

    # durability tracking: this persist's per-address version number
    A = st.aver.shape[0]
    tracked = _tracked(ctx, addr)
    a_idx = torch.clamp(addr, 0, A - 1).long()
    v_new = st.aver[a_idx] + 1
    aver2 = st.aver.clone()
    aver2[a_idx] += tracked.to(aver2.dtype)

    is_coalesce = has_dirty & is_rf
    # Allocation is policy-driven (AllocPolicy lowering): per-tenant
    # occupancy feeds the quota gate and the weighted victim selection.
    # (The occupancy counts the whole hop-1 PB, as the reference's does.)
    occ = policy.tenant_occupancy(state1, ctx.slot_active, st.owner,
                                  st.stats.shape[0])
    (any_empty, empty_idx, any_dirty, victim_idx,
     earliest_idx) = policy.select_slot(sc, state1, leaf_act,
                                        st.lru, st.dd, st.owner,
                                        ctx.tenant, occ)

    # victim drain (only used when no Empty entry exists)
    vic_tag = st.tag[victim_idx]
    victim_bank = channels.bank_of(vic_tag, ctx.n_banks)
    victim_pm_start = torch.maximum(st.pm_busy[victim_bank],
                                    pbc_start + sc["ow_sw1_pm"])
    victim_dd = victim_pm_start + sc["nvm_write"] + sc["ow_sw1_pm"]
    needs_victim = (~is_coalesce) & (~any_empty) & any_dirty

    # the victim's in-flight write is durable at PM iff its ack beats the
    # crash (a later ack means the write is lost with the power)
    vic_ok = (needs_victim & (victim_dd <= crash) & (vic_tag >= 0)
              & (vic_tag < ctx.n_track))
    pm_ver1 = st.pm_ver.clone()
    v_idx = torch.clamp(vic_tag, 0, A - 1).long()
    pm_ver1[v_idx] = torch.maximum(
        pm_ver1[v_idx], torch.where(vic_ok, st.ver[victim_idx], 0))
    vic_emit = needs_victim & (pbc_start <= crash)

    # ---- switch chain, victim leg (per-switch persistent buffers) -----
    # With >= 2 switches in the chain, a hop-1 drain is acked by hop 2's
    # persistent cells, not by PM: the victim packet travels the chain
    # FIRST (it leaves the PBC at pbc_start, ahead of the entry write),
    # so the slot frees at its true downstream ack.  A batch with no
    # active packet changes nothing, so it is not sent.
    is_chain = st.dtag.shape[0] > 0 and float(sc["n_switches"]) >= 2.0
    if is_chain:
        dd_v, rows_v, hpbc_v, hstats_v = (st.dd, chain.rows_of(st), st.hpbc,
                                          st.hop_stats)
        pmb_v, pmv_v = st.pm_busy, st.pm_ver
        pmw_v = torch.zeros((), dtype=torch.float64, device=t.device)
        # (a forward with no packet runs only when a deep row would
        # drain: chain.drain_pending)
        if bool(vic_emit) or chain.drain_pending(sc, ctx.scheme, rows_v):
            one_i = torch.tensor([0], dtype=torch.int32, device=t.device)
            vic_batch = chain.Batch(
                active=vic_emit.reshape(1), addr=vic_tag.reshape(1),
                ver=st.ver[victim_idx].reshape(1),
                owner=st.owner[victim_idx].reshape(1),
                emit=pbc_start.reshape(1), ohop=one_i,
                oslot=victim_idx.to(torch.int32).reshape(1))
            (dd_v, rows_v, hpbc_v, hstats_v, pmb_v, pmv_v,
             pmw_v) = chain.forward_chain(
                sc, ctx.scheme, rows_v, hpbc_v, hstats_v, vic_batch, dd_v,
                pmb_v, pmv_v, n_banks=ctx.n_banks, n_track=ctx.n_track)
        vic_wait = torch.where(vic_emit, dd_v[victim_idx], victim_dd)
    else:
        vic_wait = victim_dd

    slot = torch.where(any_empty, empty_idx,
                       torch.where(any_dirty, victim_idx, earliest_idx))
    ta = torch.where(any_empty, pbc_start,
                     torch.where(any_dirty, vic_wait,
                                 torch.maximum(pbc_start,
                                               st.dd[earliest_idx])))
    pm_busy1 = _set(st.pm_busy, victim_bank, torch.where(
        needs_victim, victim_pm_start + sc["nvm_w_occ"],
        st.pm_busy[victim_bank]))
    vslot = ctx.slot_ids == victim_idx
    state2 = torch.where(needs_victim & vslot, DRAIN, state1)
    dd2 = torch.where(needs_victim & vslot, victim_dd, st.dd)

    # write the entry (new allocation or coalesce-in-place)
    wslot = torch.where(is_coalesce, idx, slot)
    t_written = torch.where(is_coalesce, pbc_start, ta) + sc["data_ns"]
    ack = t_written + sc["ow_cpu_sw1"]
    # Serving-SLO drain tightening (DrainPolicy.latency_target_ns): the
    # running over-target fraction *including this persist* decides
    # whether this op's drain-down runs tight.
    lat = ack - t
    over_now = _f64(lat > sc["lat_target"])  # lint: mirror(slo-over)
    cnt1 = st.stats[ctx.tenant, S_PERSIST_CNT] + 1.0  # lint: mirror(slo-cnt)
    over1 = st.stats[ctx.tenant, S_SLO_OVER] + over_now  # lint: mirror(slo-run)
    tight = over1 > sc["lat_tol"] * cnt1  # lint: mirror(slo-tight)
    state3 = torch.where(ctx.slot_ids == wslot, DIRTY, state2)
    tag3 = _set(st.tag, wslot, addr)
    lru3 = _set(st.lru, wslot, t_written)
    dd3 = dd2
    ver3 = _set(st.ver, wslot, v_new)
    # the writer takes ownership (a cross-tenant coalesce included)
    owner3 = _set(st.owner, wslot, ctx.tenant.to(st.owner.dtype))

    # Backpressure-aware drain scheduling (fabric): while the spine PB's
    # Dirty occupancy — measured after this op's victim leg landed — is
    # at/above bp_high, the leaf's threshold/low-water drain-down defers.
    # Non-fabric configs lower bp_high = INF (never defer); victim drains
    # and PB's drain-immediate are exempt.
    defer = None
    if st.dtag.shape[0] > 0 and my_leaf is not None:
        dstate0 = rows_v["dstate"][0] if is_chain else st.dstate[0]
        defer = spine_defer(fabric.spine_live(sc, dstate0, ctx.slot_ids),
                            sc["bp_high"])

    if is_rf:
        state4, dd4, pm_busy2, policy_writes = \
            policy.drain_threshold_preset(
                sc, ctx.n_banks, leaf_act, t_written, state3, tag3,
                lru3, dd3, pm_busy1, owner=owner3, tenant=ctx.tenant,
                tight=tight, defer=defer)
    else:
        state4, dd4, pm_busy2, policy_writes = policy.drain_immediate(
            sc, bank, ctx.slot_ids, wslot, t_written, state3, dd3, pm_busy1)

    # drains the policy just scheduled (Dirty -> Drain) whose PM ack
    # beats the crash make their versions durable at the device
    drained_now = (state4 == DRAIN) & (state3 == DIRTY)
    drain_ok = (drained_now & (dd4 <= crash) & (tag3 >= 0)
                & (tag3 < ctx.n_track))
    pm_ver2 = pm_ver1.scatter_reduce(
        0, torch.clamp(tag3, 0, A - 1).long(),
        torch.where(drain_ok, ver3, 0), "amax")

    # Switch-commit gate: a persist that issued before the crash but
    # whose entry write lands only after it never reached the
    # persistent switch — its PB-table effects are discarded; the
    # victim drain stands if the PBC emitted it before the power loss.
    commit = t_written <= crash
    state5 = torch.where(commit, state4,
                         torch.where(vic_emit & vslot, DRAIN, st.state))
    tag5 = torch.where(commit, tag3, st.tag)
    lru5 = torch.where(commit, lru3, st.lru)
    dd5 = torch.where(commit, dd4,
                      torch.where(vic_emit & vslot, victim_dd, st.dd))
    ver5 = torch.where(commit, ver3, st.ver)
    owner5 = torch.where(commit, owner3, st.owner)
    aver3 = torch.where(commit, aver2, st.aver)
    pm_ver3 = torch.where(commit, pm_ver2, pm_ver1)
    pm_busy3 = torch.where(commit, pm_busy2, pm_busy1)
    pm_writes_inc = (_f64(vic_emit)
                     + torch.where(commit, policy_writes, 0.0))

    # ---- switch chain, policy-drain leg --------------------------------
    # The drains the policy just scheduled travel to hop 2 as one batch
    # (they leave the PBC together at t_written, after the victim leg);
    # under the chain the PM-path dd/pm values computed above are
    # replaced by the cascade's downstream acks and landings.
    chain_cols = {}
    hop_stats = st.hop_stats
    if is_chain:
        P = st.tag.shape[0]
        # the batch leaves the PBC in LRU order of the drained entries
        # (the wire order the oracle's drain-down replays)
        pol_active = drained_now & commit
        dd_c = torch.where(commit, dd4, dd_v)
        rows_c, hpbc_c, hstats_c = rows_v, hpbc_v, hstats_v
        pmb_c, pmv_c = pmb_v, pmv_v
        pmw_c = torch.zeros((), dtype=torch.float64, device=t.device)
        if bool(pol_active.any()) or chain.drain_pending(sc, ctx.scheme,
                                                         rows_c):
            pol_order = torch.argsort(torch.where(pol_active, lru3, INF),
                                      stable=True).to(torch.int32)
            po = pol_order.long()
            pol_batch = chain.Batch(
                active=pol_active[po], addr=tag3[po], ver=ver3[po],
                owner=owner3[po],
                emit=torch.zeros((P,), dtype=torch.float64,
                                 device=t.device) + t_written,
                ohop=torch.zeros((P,), dtype=torch.int32, device=t.device),
                oslot=pol_order)
            (dd_c, rows_c, hpbc_c, hstats_c, pmb_c, pmv_c,
             pmw_c) = chain.forward_chain(
                sc, ctx.scheme, rows_c, hpbc_c, hstats_c, pol_batch, dd_c,
                pmb_c, pmv_c, n_banks=ctx.n_banks, n_track=ctx.n_track)
        dd5, pm_ver3, pm_busy3 = dd_c, pmv_c, pmb_c
        pm_writes_inc = pmw_v + pmw_c
        chain_cols = dict(rows_c, hpbc=hpbc_c)
        hop_stats = hstats_c

    # hop-1 telemetry row (chain row 0; maintained at every depth >= 1)
    hop_stats = hop_stats.clone()
    hop_stats[0, H_FWD_CNT] += _f64(commit)
    hop_stats[0, H_FWD_SUM] += torch.where(commit, t_written - arr, 0.0)
    hop_stats[0, H_COALESCES] += _f64(is_coalesce & commit)

    stall = torch.where(is_coalesce, 0.0, ta - pbc_start)
    # Only a genuine Empty-shortage stall (ta > pbc_start) holds the PI
    # front beyond the pipelined issue interval.
    pbc_free = torch.maximum(
        channels.pbc_hold(pbc_prev, arr, sc["pbc_occ_ns"]),
        torch.where(is_coalesce | (ta <= pbc_start), 0.0, ta))
    # One add per accumulator column (all distinct columns).  A persist
    # committed into the persistent switch is durable regardless of the
    # drain's fate; the core only observes the ack if it lands before
    # the crash.
    hist_col = S_LAT_HIST0 + int(lat_bin(lat))  # lint: mirror(lat-bin)
    cols = [S_VICTIM_CNT, S_PBCQ_SUM, S_PERSIST_SUM, S_PERSIST_CNT,
            S_SLO_OVER, S_COALESCES, S_PM_WRITES, S_STALL_TIME, S_ACKED,
            S_DURABLE, hist_col]
    one = torch.ones_like(ack)
    vals = torch.stack([
        _f64((~is_coalesce) & (~any_empty)),
        torch.clamp(pbc_prev - arr, min=0.0),
        ack - t,
        one,
        over_now,
        _f64(is_coalesce),
        pm_writes_inc,
        stall,
        _f64(ack <= crash),
        _f64(commit),
        one])
    stats = _add_stats(st.stats, ctx.tenant, cols, vals)  # lint: mirror(stats-scatter)
    return st._replace(clock=_set(st.clock, ctx.c, ack), tag=tag5,
                       state=state5, lru=lru5, dd=dd5, ver=ver5,
                       owner=owner5, aver=aver3, pm_ver=pm_ver3,
                       pm_busy=pm_busy3, stats=stats, hop_stats=hop_stats,
                       **_pbc_cols(st, my_leaf, pbc_free), **chain_cols)


def _persist_direct(ctx: StepCtx, st: MachineState) -> MachineState:
    # Volatile switch: the persist round-trips to PM.  Nothing is
    # durable until PM acks — a write whose ack lands after the crash
    # is lost (and the core never saw the ack either).
    sc, t, addr = ctx.sc, ctx.t, ctx.addr
    ow = sc["ow_cpu_pm"]
    crash = sc["crash_at"]
    bank = channels.bank_of(addr, ctx.n_banks)
    pm_start = channels.service_start(st.pm_busy, bank, t + ow)
    ack = pm_start + sc["nvm_write"] + ow
    ok = ack <= crash
    A = st.aver.shape[0]
    tracked = _tracked(ctx, addr)
    a_idx = torch.clamp(addr, 0, A - 1).long()
    v_new = st.aver[a_idx] + 1
    # lint: exempt(stats-columns, S_COALESCES S_READ_HITS S_PI_DETOURS): no PB table on the volatile switch
    # lint: exempt(stats-columns, S_PBCQ_SUM S_STALL_TIME S_VICTIM_CNT): no PBC queue or eviction on the direct PM path
    lat = ack - t
    over_now = _f64(lat > sc["lat_target"])  # lint: mirror(slo-over)
    hist_col = S_LAT_HIST0 + int(lat_bin(lat))  # lint: mirror(lat-bin)
    one = torch.ones_like(ack)
    cols = [S_PERSIST_SUM, S_PERSIST_CNT, S_SLO_OVER, S_PM_WRITES, S_ACKED,
            S_DURABLE, hist_col]
    vals = torch.stack([ack - t, one, over_now, one, _f64(ok), _f64(ok), one])
    stats = _add_stats(st.stats, ctx.tenant, cols, vals)  # lint: mirror(stats-scatter)
    aver = st.aver.clone()
    aver[a_idx] += tracked.to(aver.dtype)
    pm_ver = st.pm_ver.clone()
    pm_ver[a_idx] = torch.maximum(pm_ver[a_idx],
                                  torch.where(tracked & ok, v_new, 0))
    return st._replace(
        clock=_set(st.clock, ctx.c, ack), aver=aver, pm_ver=pm_ver,
        pm_busy=channels.reserve(st.pm_busy, bank, pm_start, sc["nvm_w_occ"]),
        stats=stats)


def handle_persist(ctx: StepCtx, st: MachineState) -> MachineState:
    body = _persist_direct if ctx.scheme == 0 else _persist_with_buffer
    return body(ctx, st)


# ----------------------------------------------------------------- barrier
def handle_barrier(ctx: StepCtx, st: MachineState) -> MachineState:
    # Centralized barrier *per tenant*: only this tenant's cores arrive,
    # and the last of them releases its tenant's waiters at its arrival
    # time.
    same = ctx.tids == ctx.tenant
    last = (st.bcount[ctx.tenant] + 1) >= ctx.n_live_t
    released = _set(torch.where(st.blocked & same, ctx.t, st.clock),
                    ctx.c, ctx.t)
    waiting = _set(st.clock, ctx.c, INF * 0.9)
    return st._replace(clock=torch.where(last, released, waiting))


HANDLERS = [handle_compute, handle_dram_read, handle_dram_write,
            handle_pm_read, handle_persist, handle_barrier]


# ---------------------------------------------------------------- recovery
def recovery_snapshot(st: MachineState, scheme: int, sc, slot_active,
                      n_banks: int, n_track: int):
    """Section V-D4 recovery pass over the crash-time machine state.

    NoPB has no PBEs, so its durable state is exactly ``pm_ver`` and
    recovery is free; PB/PB_RF drain-all the *union* of surviving
    Dirty/Drain entries across every hop of the switch chain — a crash
    freezes each hop independently, and durability per address is the
    newest version held at any surviving hop (or PM).  Returns
    ``(durable_ver (A,) i32, n_recovered f64, recovery_ns f64,
    recovered_per_tenant (T,) f64, recovered_per_hop (D+1,) f64,
    recovered_per_leaf (max(NL,1),) f64)``; the last three attribute
    each surviving entry to its owning tenant, to the hop holding it,
    and — for hop 1 — to the leaf switch holding it (a chain's one hop-1
    switch is leaf 0; the spine's survivors are ``per_hop[1]``).
    """
    crash = sc["crash_at"]
    A = st.pm_ver.shape[0]
    T = st.stats.shape[0]
    D, P = st.dtag.shape
    NL = st.lpbc.shape[0]
    dev = st.stats.device
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    zero_t = torch.zeros((T,), dtype=torch.float64, device=dev)
    zero_l = torch.zeros((max(NL, 1),), dtype=torch.float64, device=dev)
    if scheme == 0:
        return (st.pm_ver, zero, zero, zero_t,
                torch.zeros((D + 1,), dtype=torch.float64, device=dev),
                zero_l)
    surviving = policy.surviving_entries(st.state, st.dd, slot_active, crash)
    in_range = surviving & (st.tag >= 0) & (st.tag < n_track)
    dv = st.pm_ver.scatter_reduce(0, torch.clamp(st.tag, 0, A - 1).long(),
                                  torch.where(in_range, st.ver, 0), "amax")
    surv = _f64(surviving)
    per_t = zero_t.index_add(0, torch.clamp(st.owner.long(), 0, T - 1), surv)
    banks = torch.where(surviving, torch.remainder(st.tag, n_banks), 0)
    per_bank = torch.zeros((n_banks,), dtype=torch.float64,
                           device=dev).index_add(0, banks.long(), surv)
    n = surv.sum()
    per_hop = [n]
    slot_ids = torch.arange(P, device=dev)
    if fabric.has_fabric(st):
        per_leaf = zero_l.index_add(
            0, fabric.slot_leaf(sc, slot_ids).long(), surv)
    else:
        per_leaf = n.reshape(1)
    for j in range(D):
        row_live = float(j) + 2.0 <= float(sc["n_switches"])
        sa = slot_ids < sc["deep_pbe"][j].to(torch.int32)
        # same survival rule per hop: Dirty cells persist; a Drain entry
        # survives iff its downstream ack is lost with the power
        surv_j = (row_live & sa & (st.dwt[j] <= crash)
                  & ((st.dstate[j] == DIRTY)
                     | ((st.dstate[j] == DRAIN) & (st.ddd[j] > crash))))
        in_r = surv_j & (st.dtag[j] >= 0) & (st.dtag[j] < n_track)
        dv = dv.scatter_reduce(0, torch.clamp(st.dtag[j], 0, A - 1).long(),
                               torch.where(in_r, st.dver[j], 0), "amax")
        sj = _f64(surv_j)
        per_t = per_t.index_add(
            0, torch.clamp(st.downer[j].long(), 0, T - 1), sj)
        bj = torch.where(surv_j, torch.remainder(st.dtag[j], n_banks), 0)
        per_bank = per_bank.index_add(0, bj.long(), sj)
        per_hop.append(sj.sum())
    per_hop = torch.stack(per_hop)
    n_total = per_hop.sum()
    cost = policy.recovery_burst_cost(sc, per_bank, n_total)
    return dv, n_total, cost, per_t, per_hop, per_leaf
