"""Macro-stepping: a homogeneous op run as one guarded step (torch port
of ``repro.core.engine.macro``).

The trace-time pre-pass (``core.traces.plan_runs``) marks, per trace
slot, the length of the longest *statically eligible* run starting
there: consecutive PM_READ / PERSIST ops of one core with non-negative
gaps and pairwise-distinct addresses (when a persist is involved).  The
step loop (``engine.step``) hands the selected core's window to
:func:`macro_step`, which replays up to ``MACRO_KMAX`` ops as an exact
mini-interpreter: every arithmetic expression keeps the form and order
of the slot-at-a-time handlers, so a committed macro-step is
bit-identical to the handler path by construction.

Commit-or-abort, as in the reference:

  * while replaying, the mini-interpreter accumulates a guard; any op
    that would leave the straight-line path — a PB lookup hit, a
    coalesce opportunity, a missing Empty slot, a PB_RF drain-down that
    would fire, an op issuing past the crash point — clears it;
  * every other core's next issue time must lie strictly after the
    window's last issue time (so the issue-time ``argmin`` picks this
    core for the whole window), and in a scheduled grid the window must
    end before the next epoch boundary;
  * on failure the candidate state is discarded whole and the step's
    slot-at-a-time result stands; exactly one reason of
    :data:`MACRO_ABORT_REASONS` is counted for the failed live head.

A second, independent path collapses *dead runs*: once a core's next op
issues after the crash point, up to ``MACRO_KMAX`` of its remaining ops
drain at once as no-ops that only advance its cursor and clock (dead
ops touch no shared state, so they commute with every other core's ops
bit for bit).

The reference builds every candidate under ``jnp.where``; here Python
branches compute only what a step selects, and the window's replay runs
only for a live head that passed the static gates (``window``,
``fabric``, ``deep``) — every other candidate is discarded unread.
Masked window slots (``j >= k_live``) are skipped: in the reference they
add exact zeros, select the old values and leave the guard as it is.

Two exact shortcuts skip what cannot change the outcome.  Every op
completes no earlier than it issues (:func:`floor_holds`), so the
window's last issue time is at least its gaps added in order to the
head's issue time (:func:`window_floor`): where that floor already
reaches the next epoch boundary the window aborts on
``epoch_boundary``, and in a grid without a schedule, where another
core's issue time is at or below it, on ``interleave`` — with no
replay.  And with non-negative gaps the window's issue times never
decrease, so the replay stops at the first op that issues at or past
the boundary (a schedule) or another core's issue time (none): the
outcome is then settled the same way.  The cell-scan kernel takes both
(and, in a scheduled grid where another core sits at or below the
floor, replays only the clocks, which alone decide between
``epoch_boundary`` and ``interleave`` then).
"""
from __future__ import annotations

import torch

from repro_torch.core.engine import channels, fabric, policy
from repro_torch.core.engine.state import (DIRTY, EMPTY, H_FWD_CNT,
                                           H_FWD_SUM, INF, S_ACKED,
                                           S_DURABLE, S_LAT_HIST0,
                                           S_PBCQ_SUM, S_PERSIST_CNT,
                                           S_PERSIST_SUM, S_PM_WRITES,
                                           S_READ_CNT, S_READ_SUM,
                                           S_SLO_OVER, lat_bin)
from repro_torch.core.params import Op

# Prioritised abort attribution for live candidate windows: each live op
# at the head of a window that fails to commit counts under exactly the
# *first* failing gate, in this order.  ``window`` = no eligible >= 2-op
# run at the cursor; ``fabric`` = a multi-leaf fabric cell; ``deep`` = a
# >= 2-switch chain cell; ``epoch_boundary`` = the window straddles an
# epoch boundary of a scheduled config; ``interleave`` = another core
# issues inside the window; ``guard`` = the replay's guard cleared.
MACRO_ABORT_REASONS = ("window", "fabric", "deep", "epoch_boundary",
                       "interleave", "guard")
WINDOW, FABRIC, DEEP, EPOCH_BOUNDARY, INTERLEAVE, GUARD = range(6)


def _f64(x):
    return x.to(torch.float64)


def _set(x, i, v):
    out = x.clone()
    out[i] = v
    return out


# The latencies between an op's issue and its completion on the paths a
# window replays: while none is negative, no op completes before it
# issues (an f64 sum of non-negative terms never rounds below its first).
_COMPLETION_KEYS = ("ow_cpu_pm", "nvm_read", "nvm_write", "ow_cpu_sw1",
                    "pbc_proc_ns", "tag_ns", "data_ns")


def floor_holds(sc) -> bool:
    """Does :func:`window_floor` bound this config's windows?  (Every
    latency it leans on is non-negative.)"""
    return all(float(sc[k]) >= 0.0 for k in _COMPLETION_KEYS)


def window_floor(t_issue: float, w_gap, k_live: int) -> float:
    """A lower bound of the window's last issue time: the head's issue
    time plus the later ops' gaps, added in order in f64.  Op j issues
    at its predecessor's completion plus its gap, the completion is no
    earlier than the predecessor's own issue time (:func:`floor_holds`),
    and rounding to nearest is monotone."""
    lb = t_issue
    for j in range(1, k_live):
        lb = lb + float(w_gap[j])
    return lb


def dead_run(st, c, w_gap, k_cap):
    """The dead-run collapse: core ``c``'s clock after ``k_cap`` dead
    ops, each setting it to its issue time (sequential f64 adds of the
    widened gaps, the slot-at-a-time rounding order)."""
    ck = st.clock[c]
    for j in range(k_cap):
        ck = ck + w_gap[j]
    return st._replace(clock=_set(st.clock, c, ck))


def replay(ctx, st, w_ops, w_addr, w_gap, k_live, t_issue, stop=None):
    """The window's exact mini-interpreter (reference ``win_op``) over
    its ``k_live`` ops of core ``ctx.c`` from state ``st``.

    Returns ``(st_live, guard, t_last)``: the candidate state after the
    window (meaningful only where it commits), whether every op stayed
    on the straight-line path, and the window's last issue time.  After
    the guard clears the replay goes on exactly as before — a PB-hit
    read keeps the PM miss timing, a persist with no Empty slot writes
    slot 0, PB's immediate drain still reserves its bank — since
    ``t_last``, and so the attribution, comes from that trajectory.
    With ``stop`` (a float; the caller has shown that the window's
    issue times never decrease) it ends at the first op issuing at or
    past ``stop`` and returns ``(None, guard, t_j)``, a lower bound of
    ``t_last`` that already reaches ``stop``.
    """
    sc = ctx.sc
    crash = sc["crash_at"]
    A = st.aver.shape[0]
    T = st.stats.shape[0]
    is_nopb = ctx.scheme == 0                       # Scheme.NOPB
    is_rf = ctx.scheme == 2                         # Scheme.PB_RF
    pb_like = not is_nopb
    NL = st.lpbc.shape[0]
    if NL > 0:
        my_leaf = fabric.leaf_of_tenant(sc, ctx.tenant)
        pbc_cur = st.lpbc[my_leaf]
    else:
        pbc_cur = st.pbc_busy
    ow = sc["ow_cpu_pm"]
    clk = st.clock[ctx.c]
    state_cur, tag_cur, lru_cur, dd_cur = st.state, st.tag, st.lru, st.dd
    ver_cur, owner_cur, pmb_cur = st.ver, st.owner, st.pm_busy
    pm_ver_cur, aver_cur = st.pm_ver, st.aver
    stats_cur, hop_cur = st.stats, st.hop_stats
    guard = torch.ones((), dtype=torch.bool)
    t_last = t_issue
    tenant = ctx.tenant
    for j in range(k_live):
        is_p = int(w_ops[j]) == int(Op.PERSIST)
        a_j, g_j = w_addr[j], w_gap[j]
        t_j = clk + g_j
        t_last = t_j
        if stop is not None and float(t_j) >= stop:
            return None, bool(guard), t_j
        bank = channels.bank_of(a_j, ctx.n_banks)
        tracked = (a_j >= 0) & (a_j < ctx.n_track)
        a_idx = torch.clamp(a_j, 0, A - 1).long()
        if not is_p:
            # ---- PM read (handler miss path; identical in both schemes)
            pm_start_r = channels.service_start(pmb_cur, bank, t_j + ow)
            resp = pm_start_r + sc["nvm_read"] + ow
            g_op = t_j <= crash
            if pb_like:
                state_rd = policy.lazy_free(state_cur, dd_cur, t_j)
                has_rd = (ctx.slot_active & (tag_cur == a_j)
                          & (state_rd != EMPTY)).any()
                g_op = g_op & ~has_rd
                state_cur = state_rd
            guard = guard & g_op
            pmb_cur = _set(pmb_cur, bank, pm_start_r + sc["nvm_r_occ"])
            clk = resp
            stats_cur = stats_cur.clone()
            stats_cur[tenant, S_READ_SUM] += resp - t_j
            stats_cur[tenant, S_READ_CNT] += 1.0
            continue
        v_new = aver_cur[a_idx] + 1
        if is_nopb:
            # ---- persist, NoPB leg (always exact: no guard)
            pm_start_w = channels.service_start(pmb_cur, bank, t_j + ow)
            ack_n = pm_start_w + sc["nvm_write"] + ow
            ok_n = ack_n <= crash
            pmb_cur = channels.reserve(pmb_cur, bank, pm_start_w,
                                       sc["nvm_w_occ"])
            guard = guard & (t_j <= crash)
            ack, pv_ok = ack_n, ok_n
            pm_writes, acked, durable = 1.0, _f64(ok_n), _f64(ok_n)
        else:
            # ---- persist, buffered leg (fresh-Empty allocation only)
            arr = t_j + sc["ow_cpu_sw1"]
            pbc_start = channels.pbc_start(pbc_cur, arr,
                                           sc["pbc_proc_ns"] + sc["tag_ns"])
            state_p1 = policy.lazy_free(state_cur, dd_cur, pbc_start)
            has_dirty = (ctx.slot_active & (tag_cur == a_j)
                         & (state_p1 == DIRTY)).any()
            # select_slot's Empty leg under the quota gate, verbatim
            occ_t = torch.where(
                ctx.slot_active & (state_p1 != EMPTY)
                & (torch.clamp(owner_cur, 0, T - 1) == tenant),
                1.0, 0.0).sum()
            over_quota = occ_t >= sc["quota"][tenant]
            empty_mask = ctx.slot_active & (state_p1 == EMPTY) & ~over_quota
            any_empty = empty_mask.any()
            wslot = torch.argmin(torch.where(empty_mask, lru_cur, INF))
            t_written = pbc_start + sc["data_ns"]
            ack_p = t_written + sc["ow_cpu_sw1"]
            state_w = torch.where(ctx.slot_ids == wslot, DIRTY, state_p1)
            tag_w = _set(tag_cur, wslot, a_j)
            lru_w = _set(lru_cur, wslot, t_written)
            ver_w = _set(ver_cur, wslot, v_new)
            owner_w = _set(owner_cur, wslot, tenant.to(owner_cur.dtype))
            g_wr = any_empty & (t_written <= crash)
            if is_rf:
                # PB_RF: the threshold/preset drain-down must fire zero
                # drains (drain_threshold_preset's k, same expressions)
                scoped = sc["drain_scope"] > 0.0
                in_scope = torch.where(scoped, owner_w == tenant,
                                       torch.ones_like(owner_w,
                                                       dtype=torch.bool))
                dirty_cnt = ((state_w == DIRTY) & ctx.slot_active
                             & in_scope).sum()
                empty_cnt = ((state_w == EMPTY) & ctx.slot_active).sum()
                thr = torch.where(scoped, sc["t_threshold"][tenant],
                                  sc["threshold_count"])
                pre = torch.where(scoped, sc["t_preset"][tenant],
                                  sc["preset_count"])
                # serving-SLO tightening mirror (the handler's tight, from
                # the stats row including this persist)
                lat_p = ack_p - t_j
                over_p = _f64(lat_p > sc["lat_target"])
                cnt1 = stats_cur[tenant, S_PERSIST_CNT] + 1.0
                over1 = stats_cur[tenant, S_SLO_OVER] + over_p
                tight = over1 > sc["lat_tol"] * cnt1
                thr = torch.where(tight, 1.0, thr)
                pre = torch.where(tight, 0.0, pre)
                do_drain = dirty_cnt >= thr
                k_thresh = torch.where(do_drain, dirty_cnt - pre, 0.0)
                k_low = torch.where(
                    empty_cnt <= sc["empty_slack"],
                    torch.minimum(sc["low_water"], _f64(dirty_cnt)), 0.0)
                rf_zero = torch.maximum(k_thresh, k_low) == 0.0
                g_wr = g_wr & ~has_dirty & rf_zero
                # RF with k == 0 is a no-op drain policy: state, dd and
                # the banks stay as the write left them
                state_cur, pv_ok = state_w, torch.zeros((), dtype=torch.bool)
                pm_writes = 0.0
            else:
                # PB: immediate drain of the written entry (exact policy
                # call)
                state_cur, dd_cur, pmb_cur, _pw = policy.drain_immediate(
                    sc, bank, ctx.slot_ids, wslot, t_written, state_w,
                    dd_cur, pmb_cur)
                pv_ok = dd_cur[wslot] <= crash
                pm_writes = 1.0
            guard = guard & (t_j <= crash) & g_wr
            pbcq_inc = torch.clamp(pbc_cur - arr, min=0.0)
            pbc_cur = torch.clamp(
                channels.pbc_hold(pbc_cur, arr, sc["pbc_occ_ns"]), min=0.0)
            tag_cur, lru_cur, ver_cur, owner_cur = tag_w, lru_w, ver_w, \
                owner_w
            ack = ack_p
            acked, durable = _f64(ack_p <= crash), 1.0
            hop_cur = hop_cur.clone()
            hop_cur[0, H_FWD_CNT] += 1.0
            hop_cur[0, H_FWD_SUM] += t_written - arr
        clk = ack
        aver_cur = aver_cur.clone()
        aver_cur[a_idx] += tracked.to(aver_cur.dtype)
        pm_ver_cur = _set(pm_ver_cur, a_idx, torch.maximum(
            pm_ver_cur[a_idx], torch.where(tracked & pv_ok, v_new, 0)))
        # stats, one add per column as the reference's fused scatter
        lat_j = ack - t_j
        over_j = _f64(lat_j > sc["lat_target"])
        stats_cur = stats_cur.clone()
        if pb_like:
            stats_cur[tenant, S_PBCQ_SUM] += pbcq_inc
        stats_cur[tenant, S_PERSIST_SUM] += lat_j
        stats_cur[tenant, S_PERSIST_CNT] += 1.0
        stats_cur[tenant, S_SLO_OVER] += over_j
        stats_cur[tenant, S_PM_WRITES] += pm_writes
        stats_cur[tenant, S_ACKED] += acked
        stats_cur[tenant, S_DURABLE] += durable
        stats_cur[tenant, S_LAT_HIST0 + int(lat_bin(lat_j))] += 1.0
    pbc_kw = (dict(lpbc=_set(st.lpbc, my_leaf.long(), pbc_cur)) if NL > 0
              else dict(pbc_busy=pbc_cur))
    st_live = st._replace(
        clock=_set(st.clock, ctx.c, clk), state=state_cur, tag=tag_cur,
        lru=lru_cur, dd=dd_cur, ver=ver_cur, owner=owner_cur,
        aver=aver_cur, pm_ver=pm_ver_cur, pm_busy=pmb_cur,
        stats=stats_cur, hop_stats=hop_cur, **pbc_kw)
    return st_live, bool(guard), t_last


def macro_step(ctx, st, ops, addrs, gaps64, lengths, mlen, tsel, live,
               t_issue, i, *, kmax: int, next_epoch_bound=None,
               floor_ok: bool = False):
    """Candidate macro execution of up to ``kmax`` ops of core ``ctx.c``
    at cursor ``i`` (the step is valid: the loop stops before any step
    that selects no core).

    Returns ``(st_macro, k_adv, reason)``: the state after the committed
    macro-step and the trace slots it consumed, or ``(None, 1, ...)``
    when neither a live window nor a dead run committed; ``reason`` is
    the index in :data:`MACRO_ABORT_REASONS` of the failed live head's
    abort, or None (a commit, or no live candidate).

    ``next_epoch_bound`` is the first epoch boundary strictly after the
    head op's issue time in a scheduled grid (``INF`` in the last
    epoch), or ``None`` without a schedule; the window commits only if
    its last issue time precedes it.  Dead runs are exempt: dead ops
    touch no policy state.  ``floor_ok`` (:func:`floor_holds` of the
    config) lets :func:`window_floor` settle an abort without the
    replay.
    """
    sc = ctx.sc
    c = int(ctx.c)
    w_gap = gaps64[c, i:i + kmax]
    if w_gap.shape[0] < kmax:
        raise ValueError("macro_step: the trace axis must carry MACRO_KMAX "
                         "slots past the longest stream (grid pads it)")
    k_cap = min(max(int(lengths[c]) - i, 0), kmax)

    # ---------------- dead-run collapse (post-crash stream drain) ------
    if not live:
        if k_cap >= 2 and bool((w_gap >= 0.0).all()):
            return dead_run(st, c, w_gap, k_cap), k_cap, None
        return None, 1, None

    # ---------------- live window (exact mini-interpreter) -------------
    k_live = min(int(mlen[c, i]), k_cap)
    if k_live < 2:
        return None, 1, WINDOW
    is_nopb = ctx.scheme == 0
    if not is_nopb and float(sc["n_leaves"]) >= 2.0:
        return None, 1, FABRIC
    if not is_nopb and float(sc["n_switches"]) >= 2.0:
        return None, 1, DEEP
    others_min = torch.min(_set(tsel, c, INF))
    # the bound that settles the outcome once the window's issue times
    # reach it: the epoch boundary (a schedule), else the next other core
    stop = float(others_min if next_epoch_bound is None
                 else next_epoch_bound)
    if floor_ok:
        lb = window_floor(float(t_issue), w_gap, k_live)
        if lb >= stop:
            return None, 1, (INTERLEAVE if next_epoch_bound is None
                             else EPOCH_BOUNDARY)
    monotone = floor_ok and bool((w_gap[1:k_live] >= 0.0).all())
    st_live, guard, t_last = replay(ctx, st, ops[c, i:i + kmax],
                                    addrs[c, i:i + kmax], w_gap, k_live,
                                    t_issue, stop if monotone else None)
    if next_epoch_bound is not None and not bool(t_last < next_epoch_bound):
        return None, 1, EPOCH_BOUNDARY
    # no other core may issue inside the window (strict: argmin ties
    # break by index, so equality must abort too)
    if not bool(others_min > t_last):
        return None, 1, INTERLEAVE
    if not guard:
        return None, 1, GUARD
    return st_live, k_live, None
