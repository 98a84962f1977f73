"""Step loop: merge per-core op streams by issue time (eager torch).

One step = one trace op of the core whose next op *issues* earliest
(core clock + compute gap; fence semantics: a core blocks on its
persists and PM reads, so its clock only advances when its op
completes).  Merging on issue time makes the global op order
well-defined under heterogeneous gaps — the property the crash model
rests on.

:func:`scan_cell` is the plain PyTorch version of the cell-scan kernel
(``repro_torch.kernels.cell_scan``): one Python iteration per step with
the same issue-time ``argmin``, crash gate, barrier bookkeeping and
cursor/clock updates as the reference's ``lax.scan`` step
(``repro.core.engine.step``).  The reference pads the scan to a bucket
and lets the padded steps run as no-ops; here the loop stops at the
first step that selects no core, after which every step would be a
no-op — the results are the same.

Epoch schedules (DESIGN §7): in a grid that carries a ``Schedule`` the
lowered ``sc`` holds every :data:`~repro_torch.core.engine.state.
EPOCH_KEYS` row with a leading ``(E,)`` axis and one ``epoch_bounds``
vector; :func:`resolve_epoch_sc` picks each op's rows at its issue time,
so every layer below sees a schedule-free ``sc``.

Macro-stepping (``engine.macro``): with ``macro=True`` each step also
hands the selected core's planned window (``mlen``, from
``core.traces.plan_runs``) to ``macro.macro_step``, which commits up to
``MACRO_KMAX`` ops at once behind its guard, or collapses a dead
post-crash run, and otherwise leaves the slot-at-a-time result standing
— bit-exact either way.  The step then consumes as many trace slots as
the macro-step did.

Crash semantics (Section V-D4): an op whose issue time exceeds
``sc["crash_at"]`` becomes a no-op (the machine is off), and after the
loop a recovery pass (``handlers.recovery_snapshot``) computes the
durable-version vector and the drain-all cost over the surviving
Dirty/Drain PBEs.
"""
from __future__ import annotations

import torch

from repro_torch.core.engine.handlers import (HANDLERS, StepCtx,
                                              recovery_snapshot)
from repro_torch.core.engine.macro import (MACRO_ABORT_REASONS,
                                           floor_holds, macro_step)
from repro_torch.core.engine.state import INF, epoch_rows, init_state
from repro_torch.core.params import MACRO_KMAX, Op


def resolve_epoch_sc(sc, t_issue):
    """The config rows of the epoch active at issue time ``t_issue``, and
    the next epoch boundary.

    Without an ``epoch_bounds`` key (a schedule-free grid) the result is
    ``(sc, None)``.  Otherwise the epoch is ``#{b in epoch_bounds : b <=
    t_issue}`` — a boundary instant belongs to the new epoch, and the
    ``INF`` padding of a shorter or static config never selects — and
    the result is that epoch's rows (``state.epoch_rows``) and the least
    bound strictly after ``t_issue`` (``INF`` in the last epoch), which
    the macro window's epoch gate reads.
    """
    if "epoch_bounds" not in sc:
        return sc, None
    eb = sc["epoch_bounds"]
    sc_op = epoch_rows(sc, int((eb <= t_issue).sum()))
    next_bound = torch.min(torch.where(eb > t_issue, eb, INF))
    return sc_op, next_bound


def tenant_map(lengths, n_tenants, n_tenants_max: int):
    """Per-core tenant ids and per-tenant live-core counts.

    Balanced contiguous partition of the live cores: core ``c`` belongs
    to tenant ``floor(c * T / n_live)``, clipped; padded cores (zero
    length) get a clipped id but never issue ops.
    """
    C = lengths.shape[0]
    live_cores = (lengths > 0).to(torch.int32)
    n_live = live_cores.sum()
    core_ids = torch.arange(C, device=lengths.device)
    t_int = torch.clamp(n_tenants.to(torch.int32), min=1)
    tids = torch.clamp(torch.div(core_ids * t_int,
                                 torch.clamp(n_live, min=1),
                                 rounding_mode="floor"),
                       0, int(torch.clamp(t_int, max=n_tenants_max)) - 1)
    live_per_tenant = torch.zeros((n_tenants_max,), dtype=torch.int32,
                                  device=lengths.device).index_add(
        0, tids, live_cores)
    return tids, live_per_tenant


def scan_cell(ops, addrs, gaps, lengths, scheme: int, sc, *,
              max_pbe: int, pm_banks: int, n_track: int = 0,
              n_tenants_max: int = 1, n_deep_max: int = 0,
              n_leaves_max: int = 1, mlen=None, macro: bool = False):
    """Simulate one (trace, config) cell, one Python iteration per step.

    ``ops``/``addrs`` (C, L) int32, ``gaps`` (C, L) f32 and ``lengths``
    (C,) int32 are the cell's trace; ``sc`` is the config's
    :func:`~repro_torch.core.engine.state.scalars_from_config` dict,
    lowered with the grid's deep-row bound ``n_deep_max`` (the grid's
    largest depth minus one; 0 carries no deep row) and leaf bound
    ``n_leaves_max`` (the grid's most fabric leaves; 1 carries no leaf
    clock and runs no fabric branch); a scheduled grid's epoch rows are
    resolved per step (:func:`resolve_epoch_sc`), and the recovery pass
    reads the full ``sc``, none of whose epoch rows it needs.
    ``macro=True`` runs the macro-steps over the ``(C, L)`` run plan
    ``mlen``; the trace axis must then carry ``MACRO_KMAX`` slots past
    the longest stream (the grid pads it).  Returns ``(runtime, stats,
    durable_ver, n_recovered, recovery_ns, recovered_per_tenant,
    hop_stats, recovered_per_hop, recovered_per_leaf, n_steps,
    macro_ops, macro_aborts)``: the reference's outputs with the number
    of trace slots consumed (``n_steps``, whatever ``macro`` is) before
    its macro telemetry — the slots run as macro-steps and the
    per-reason aborts (:data:`~repro_torch.core.engine.macro.
    MACRO_ABORT_REASONS` order, all zero with ``macro`` off).
    """
    dev = ops.device
    C = ops.shape[0]
    slot_ids = torch.arange(max_pbe, device=dev)
    slot_active = slot_ids < sc["n_pbe"].to(torch.int32)
    tids, live_per_tenant = tenant_map(lengths, sc["n_tenants"],
                                       n_tenants_max)
    core_ids = torch.arange(C, device=dev)
    # per-step invariant: the issue-time merge runs in f64, so widen the
    # stored f32 gaps once instead of on every step
    gaps64 = gaps.to(torch.float64)
    crash_at = sc["crash_at"]
    st = init_state(C, max_pbe, pm_banks, n_track, n_tenants_max,
                    n_deep_max, n_leaves_max, device=dev)
    use_macro = bool(macro) and mlen is not None
    floor_ok = use_macro and floor_holds(sc)
    n_steps = macro_ops = 0
    macro_aborts = [0] * len(MACRO_ABORT_REASONS)
    while True:
        active = st.ptr < lengths
        idx = torch.minimum(st.ptr, torch.clamp(lengths - 1, min=0))
        next_gap = gaps64[core_ids, idx.long()]
        # blocked cores wait at a barrier and cannot be selected; all
        # others compete on the *issue* time of their next op
        tsel = torch.where(active & ~st.blocked, st.clock + next_gap, INF)
        c = torch.argmin(tsel)
        # once no core can be selected every later step is a no-op
        if not bool(active.any() & (tsel[c] < INF * 0.5)):
            break
        i = idx[c]
        t_issue = tsel[c]
        # ops issuing after the power loss never happen (machine is off)
        live = bool(t_issue <= crash_at)
        op = int(ops[c, i]) if live else int(Op.COMPUTE)
        t = t_issue if live else st.clock[c]
        # every layer below sees the rows of the epoch at the issue time
        sc_op, next_bound = resolve_epoch_sc(sc, t_issue)
        tid_c = tids[c]
        ctx = StepCtx(c=c, t=t, addr=addrs[c, i], scheme=scheme, sc=sc_op,
                      slot_ids=slot_ids, slot_active=slot_active,
                      tenant=tid_c, tids=tids,
                      n_live_t=live_per_tenant[tid_c], n_banks=pm_banks,
                      n_track=n_track)
        st2, adv, took = None, 1, False
        if use_macro:
            st2, k_m, reason = macro_step(
                ctx, st, ops, addrs, gaps64, lengths, mlen, tsel, live,
                t_issue, int(i), kmax=MACRO_KMAX,
                next_epoch_bound=next_bound, floor_ok=floor_ok)
            if st2 is not None:
                adv, took = k_m, True
                macro_ops += k_m
            if reason is not None:
                macro_aborts[reason] += 1
        if st2 is None:     # no macro-step committed: the slot's handler
            st2 = HANDLERS[op](ctx, st)
        n_steps += adv

        # barriers synchronize only within a tenant (independent hosts);
        # macro windows hold no barrier, so after a macro-step this is
        # an identity
        blocked, bcount = st.blocked, st.bcount
        if op == int(Op.BARRIER):
            if bool((st.bcount[tid_c] + 1) >= ctx.n_live_t):
                blocked = torch.where(tids == tid_c, False, st.blocked)
                bcount = bcount.clone()
                bcount[tid_c] = 0
            else:
                blocked = blocked.clone()
                blocked[c] = True
                bcount = bcount.clone()
                bcount[tid_c] += 1
        # crashed ops still consume their cursor slot and still advance
        # the core clock to their issue time: gaps are relative, so a
        # frozen clock would let a *later* op's issue time collapse back
        # below the crash point and wrongly execute (a dead-run
        # macro-step advanced the clock itself)
        ptr = st2.ptr.clone()
        ptr[c] += adv
        clock = st2.clock
        if not live and not took:
            clock = clock.clone()
            clock[c] = t_issue
        st = st2._replace(clock=clock, ptr=ptr, blocked=blocked,
                          bcount=bcount)
    # a crashed run ends at the power loss: dead cores advanced their
    # clocks through never-executed ops, so cap at the crash instant
    runtime = torch.max(torch.where(st.clock < INF * 0.5,
                                    torch.minimum(st.clock, crash_at), 0.0))
    (durable_ver, n_recov, recov_ns, recov_t, recov_h,
     recov_l) = recovery_snapshot(st, scheme, sc, slot_active, pm_banks,
                                  n_track)
    return (runtime, st.stats, durable_ver, n_recov, recov_ns, recov_t,
            st.hop_stats, recov_h, recov_l, n_steps, macro_ops,
            macro_aborts)
