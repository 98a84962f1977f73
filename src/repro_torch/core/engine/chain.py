"""Switch-chain forwarding: per-switch persistent buffers (torch port of
``repro.core.engine.chain``).

The pooling topology promotes ``n_switches`` from a latency multiplier
into a simulated chain: hop 1 (the tenant-facing ack point) keeps the
flat PB columns of :class:`~repro_torch.core.engine.state.MachineState`,
and every deeper switch owns one row of the ``(D, P)`` deep-hop columns.
A hop-1 drain travels one inter-switch segment to hop 2's PBC, commits
into hop 2's persistent cells (the ack that frees the hop-1 entry
returns from there), and later propagates further down per the scheme's
drain policy:

  * **PB** (drain-immediate): every hop forwards what it just committed;
  * **PB_RF**: every hop retains Dirty entries and runs its *own*
    threshold/preset drain-down (``params.hop_drain_counts``),
    coalescing arrivals into an existing Dirty entry for the same line.

An arrival that finds a hop full (no coalesce, no Empty slot after
lazy-free) **bypasses** the hop and continues toward PM.  Packets that
run out of switches land at PM with the per-bank burst serialization of
the depth-1 drain path.  A packet whose downstream commit lands after
``crash_at`` dies on the wire: the target hop's table is untouched.

Every expression keeps the reference's f64 form and order.  Where the
reference computes both a hop's placement and its PM landing and
selects one per cell (``row_live``), the eager code takes the selected
branch only; the reference's select leaves every unselected column as
it was, and so does the branch.  Two reductions of the reference are
order-sensitive and are reproduced as its XLA CPU program runs them:

  * ``_scatter_dd``'s scatters write every packet of the batch (the
    unmasked ones write the value they read), and XLA applies a
    scatter's updates in index order, so for each origin slot the
    *last* packet of the batch naming it decides (:func:`_set_last`);
  * the per-hop commit-latency sum (``H_FWD_SUM``) is an f64 sum over
    the batch, added in XLA's order (:func:`xla_sum`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.engine import channels
from repro_torch.core.engine.state import (DIRTY, DRAIN, EMPTY, INF,
                                           H_BYPASS, H_COALESCES, H_FWD_CNT,
                                           H_FWD_SUM)

F = torch.float64


class Batch(NamedTuple):
    """Packets in flight between two adjacent switches (wire order)."""

    active: torch.Tensor  # (Q,) bool
    addr: torch.Tensor    # (Q,) i32
    ver: torch.Tensor     # (Q,) i32
    owner: torch.Tensor   # (Q,) i8
    emit: torch.Tensor    # (Q,) f64  emission time at the previous switch
    ohop: torch.Tensor    # (Q,) i32  origin hop (0 = hop-1 flat columns,
                          #           m > 0 = deep row m-1) for dd writeback
    oslot: torch.Tensor   # (Q,) i32  origin PBE slot


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of a 1-D f64 vector in the order XLA's CPU reduction adds it.

    Up to 32 elements: left to right.  Longer: the middle in chunks of
    32 and the rest (33 to 64 elements) split into a first half (the
    larger) before and a second half after them, each chunk summed left
    to right and the chunk sums added left to right.  Measured against
    ``jnp.sum`` under jax 0.9 on the CPU, for every length the engine
    produces (tests/test_torch_chain.py holds it).
    """
    vals = x.tolist()
    n = len(vals)
    if n <= 32:
        bounds = [0, n]
    else:
        m = max(0, -(-(n - 64) // 32))
        r = n - 32 * m
        first = (r + 1) // 2
        bounds = [0, first] + [first + 32 * (i + 1) for i in range(m)] + [n]
    total = 0.0
    for a, b in zip(bounds[:-1], bounds[1:]):
        part = 0.0
        for v in vals[a:b]:
            part += v
        total += part
    return torch.tensor(total, dtype=F, device=x.device)


def _set_last(col, oslot, vals):
    """``col.at[oslot].set(vals)`` with XLA's duplicate rule: for each
    slot, the last update in index order wins."""
    q = torch.arange(oslot.shape[0], device=oslot.device)
    later = (oslot[None, :] == oslot[:, None]) & (q[None, :] > q[:, None])
    keep = ~later.any(1)
    out = col.clone()
    out[oslot[keep].long()] = vals[keep]
    return out


def _scatter_dd(dd1, ddd, batch: Batch, vals, mask):
    """Write per-packet ack times back to the origin entries' dd.

    Every packet of the batch writes its origin slot of every origin row
    (its ack where it is masked and from that row, else the value it
    read), and the last packet naming a slot decides; the reference's
    ``_last_writer`` (the last masked packet per slot) is implied.
    """
    D = ddd.shape[0]
    oslot = batch.oslot.long()
    dd1 = _set_last(dd1, batch.oslot, torch.where(
        mask & (batch.ohop == 0), vals, dd1[oslot]))
    if D > 0:
        ddd = ddd.clone()
    for m in range(1, D + 1):
        ddd[m - 1] = _set_last(ddd[m - 1], batch.oslot, torch.where(
            mask & (batch.ohop == m), vals, ddd[m - 1, oslot]))
    return dd1, ddd


def _pm_land(sc, pos, batch: Batch, pm_busy, pm_ver, n_banks, n_track):
    """Packets at switch ``pos`` with no deeper switch write through to PM.

    Same per-bank burst serialization as the depth-1 drain path; the ack
    returns up the chain to the origin switch.  Returns
    ``(pm_busy, pm_ver, dd_vals (Q,), n_writes)``.
    """
    crash = sc["crash_at"]
    A = pm_ver.shape[0]
    act = batch.active
    dev = act.device
    # remaining wire: switch pos -> PM through the switches below it
    rem = torch.clamp(sc["n_switches"] - float(pos), min=0.0)
    path_down = sc["link_ns"] + rem * sc["hop_ns"]
    arr = batch.emit + path_down
    bank = torch.remainder(batch.addr, n_banks).long()
    same_bank = bank[None, :] == bank[:, None]
    q = torch.arange(act.shape[0], device=dev)
    earlier = q[None, :] < q[:, None]
    rank_b = (same_bank & earlier & act[None, :]).to(F).sum(1)
    start = torch.maximum(pm_busy[bank], arr) + rank_b * sc["nvm_w_occ"]
    # ack back at the origin switch o: PM -> switch n -> ... -> switch o
    o = batch.ohop + 1
    path_up = sc["link_ns"] + torch.clamp(
        sc["n_switches"] - o.to(F), min=0.0) * sc["hop_ns"]
    dd_vals = start + sc["nvm_write"] + path_up
    busy_after = torch.where(same_bank & act[None, :],
                             (start + sc["nvm_w_occ"])[None, :],
                             torch.zeros((), dtype=F, device=dev)).amax(1)
    pm_busy2 = torch.maximum(pm_busy, torch.zeros_like(pm_busy).scatter_reduce(
        0, bank, torch.where(act, busy_after, 0.0), "amax"))
    ok = act & (dd_vals <= crash) & (batch.addr >= 0) \
        & (batch.addr < n_track)
    pm_ver2 = pm_ver.scatter_reduce(
        0, torch.clamp(batch.addr, 0, A - 1).long(),
        torch.where(ok, batch.ver, 0).to(pm_ver.dtype), "amax")
    return pm_busy2, pm_ver2, dd_vals, act.to(F).sum()


def _pick(mat, v, zero):
    """Injective scatter: at most one packet row per slot column."""
    return torch.where(mat, v[:, None], torch.tensor(zero, dtype=v.dtype,
                                                     device=v.device)
                       ).sum(0, dtype=v.dtype)


def _place(sc, j, scheme: int, rows, hpbc_j, batch: Batch, hop_stats):
    """Commit a batch into deep row ``j`` (switch j+2) and run its drain.

    Returns ``(row updates dict, hpbc_j, hop_stats, dd_vals, ended, next
    Batch)``.  Coalesce matching is injective (each hop holds at most one
    Dirty entry per line) and Empty slots are assigned by rank.
    Placement mutations are gated on ``commit <= crash_at``.
    """
    crash = sc["crash_at"]
    P = rows["dtag"].shape[1]
    dev = batch.active.device
    slot_ids = torch.arange(P, dtype=torch.int32, device=dev)
    slot_act = slot_ids < sc["deep_pbe"][j].to(torch.int32)
    act = batch.active
    any_act = act.any()
    dtag, dstate, dver = rows["dtag"][j], rows["dstate"][j], rows["dver"][j]

    arr = batch.emit + sc["hop_ns"]
    starts, hpbc_j = channels.fifo_service(hpbc_j, arr, act,
                                           sc["pbc_occ_ns"])
    classify = starts + sc["pbc_proc_ns"] + sc["deep_tag"][j]
    commit = classify + sc["deep_data"][j]

    # lazy-free observed once at the batch head (single settle point)
    t0 = torch.where(any_act, torch.where(act, classify, INF).min(), -INF)
    freed = (dstate == DRAIN) & (rows["ddd"][j] <= t0)
    state0 = torch.where(freed, EMPTY, dstate)

    co = act[:, None] & slot_act[None, :] \
        & (batch.addr[:, None] == dtag[None, :]) \
        & (state0 == DIRTY)[None, :]
    has_co = co.any(1)
    alloc = act & ~has_co
    empty = slot_act & (state0 == EMPTY)
    erank = torch.cumsum(empty.to(torch.int32), 0) - 1
    arank = torch.cumsum(alloc.to(torch.int32), 0) - 1
    placed = alloc & (arank < empty.to(torch.int32).sum())
    bypass = alloc & ~placed
    amat = placed[:, None] & empty[None, :] \
        & (arank[:, None] == erank[None, :])

    gate = commit <= crash
    mat = (co | amat) & gate[:, None]
    upd = mat.any(0)
    al = (amat & gate[:, None]).any(0)
    co_upd = (co & gate[:, None]).any(0)
    tag1 = torch.where(al, _pick(mat, batch.addr, 0), dtag)
    state1 = torch.where(al, DIRTY, state0).to(dstate.dtype)
    # Fan-in version ordering: a coalesce keeps the newest of the
    # arriving and resident versions, and the owner follows it.
    ver_in = _pick(mat, batch.ver, 0)
    ver1 = torch.where(al, ver_in,
                       torch.where(co_upd, torch.maximum(ver_in, dver), dver))
    keep_owner = co_upd & (dver > ver_in)
    owner1 = torch.where(upd & ~keep_owner, _pick(mat, batch.owner, 0),
                         rows["downer"][j])
    t_new = _pick(mat, commit, 0.0)
    lru1 = torch.where(upd, t_new, rows["dlru"][j])
    wt1 = torch.where(upd, t_new, rows["dwt"][j])

    ended = has_co | placed            # packets that stop at this hop
    hop_stats = hop_stats.clone()
    hop_stats[j + 1, H_FWD_CNT] += (ended & gate).to(F).sum()
    hop_stats[j + 1, H_FWD_SUM] += xla_sum(
        torch.where(ended & gate, commit - batch.emit, 0.0))
    hop_stats[j + 1, H_COALESCES] += (has_co & gate).to(F).sum()
    hop_stats[j + 1, H_BYPASS] += (bypass & gate).to(F).sum()

    # dd writeback: every committed packet acks its origin entry, gated
    # or not (a post-crash commit still yields a post-crash ack time)
    dd_vals = commit + (float(j + 2) - (batch.ohop.to(F) + 1.0)) \
        * sc["hop_ns"]

    # this hop's own drain-down (evaluated once, after the batch settles)
    dirty = slot_act & (state1 == DIRTY)
    dirty_cnt = dirty.to(F).sum()
    k_rf = torch.where(dirty_cnt >= sc["deep_thr"][j],
                       dirty_cnt - sc["deep_pre"][j], 0.0)
    k = dirty_cnt if scheme == 1 else k_rf     # PB forwards everything
    key = torch.where(dirty, lru1, INF)
    order = torch.argsort(key, stable=True)
    rank = torch.argsort(order, stable=True).to(F)
    to_drain = (rank < k) & dirty
    t_row = torch.clamp(torch.where(ended & gate, commit, -INF).max(),
                        min=0.0)
    state2 = torch.where(to_drain, DRAIN, state1).to(dstate.dtype)

    # the drain-down set leaves in LRU order (the wire order the oracle
    # replays)
    nxt = Batch(
        active=torch.cat([bypass, to_drain[order]]),
        addr=torch.cat([batch.addr, tag1[order]]),
        ver=torch.cat([batch.ver, ver1[order]]),
        owner=torch.cat([batch.owner, owner1[order]]),
        emit=torch.cat([torch.where(bypass, classify, 0.0),
                        torch.zeros((P,), dtype=F, device=dev) + t_row]),
        ohop=torch.cat([batch.ohop, torch.full((P,), j + 1,
                                               dtype=torch.int32,
                                               device=dev)]),
        oslot=torch.cat([batch.oslot, order.to(torch.int32)]),
    )
    row = dict(dtag=tag1, dstate=state2, dlru=lru1, dver=ver1,
               downer=owner1, dwt=wt1)
    return row, hpbc_j, hop_stats, dd_vals, ended, nxt


def rows_of(st) -> dict:
    """The deep-hop columns of the machine state as a mutable dict."""
    return dict(dtag=st.dtag, dstate=st.dstate, dlru=st.dlru, ddd=st.ddd,
                dver=st.dver, downer=st.downer, dwt=st.dwt)


def drain_pending(sc, scheme: int, rows) -> bool:
    """Whether a live deep row's own drain-down would drain now (k > 0).

    The reference runs both forwards of a buffered persist (the victim
    leg and the policy batch) whether or not they carry a packet, and
    each row evaluates its drain-down as it goes; the eager code skips a
    forward with no packet, which changes nothing while every row was
    left at or under its drain policy's count by the forward before.
    Only a schedule that lowers a row's threshold mid-run breaks that,
    and then the forward must run empty.
    """
    n_sw = float(sc["n_switches"])
    slot_ids = torch.arange(rows["dstate"].shape[1],
                            device=rows["dstate"].device)
    for j in range(rows["dstate"].shape[0]):
        if not float(j) + 2.0 <= n_sw:
            break
        slot_act = slot_ids < sc["deep_pbe"][j].to(torch.int32)
        dirty_cnt = (slot_act & (rows["dstate"][j] == DIRTY)).to(F).sum()
        k = dirty_cnt if scheme == 1 else torch.where(
            dirty_cnt >= sc["deep_thr"][j], dirty_cnt - sc["deep_pre"][j],
            0.0)
        if bool(k > 0.0):
            return True
    return False


def forward_chain(sc, scheme: int, rows, hpbc, hop_stats, batch: Batch, dd1,
                  pm_busy, pm_ver, *, n_banks: int, n_track: int):
    """Propagate a hop-1 drain batch down the whole chain.

    ``dd1`` is the hop-1 dd column the origin acks scatter into; ``rows``
    (see :func:`rows_of`) the deep columns the cascade threads through.
    Returns ``(dd1, rows, hpbc, hop_stats, pm_busy, pm_ver,
    n_pm_writes)``.  Row ``j`` is live when the config's depth covers
    switch j+2: the batch commits into it; at the first row past the
    depth every packet lands at PM, and the batch is spent (the
    reference's later rows and its closing landing see no active packet
    and change nothing).
    """
    D = rows["dtag"].shape[0]
    rows = dict(rows)
    n_sw = float(sc["n_switches"])
    pm_writes = torch.zeros((), dtype=F, device=pm_busy.device)
    for j in range(D):
        if not float(j) + 2.0 <= n_sw:
            pm_busy, pm_ver, ddv, n_l = _pm_land(
                sc, j + 1, batch, pm_busy, pm_ver, n_banks, n_track)
            dd1, rows["ddd"] = _scatter_dd(dd1, rows["ddd"], batch, ddv,
                                           batch.active)
            return (dd1, rows, hpbc, hop_stats, pm_busy, pm_ver,
                    pm_writes + n_l)
        row, hpbc_j, hop_stats, ddv, ended, batch_n = _place(
            sc, j, scheme, rows, hpbc[j], batch, hop_stats)
        for kf, v in row.items():
            rows[kf] = rows[kf].clone()
            rows[kf][j] = v
        hpbc = hpbc.clone()
        hpbc[j] = hpbc_j
        dd1, rows["ddd"] = _scatter_dd(dd1, rows["ddd"], batch, ddv,
                                       batch.active & ended)
        batch = batch_n
    # packets below the deepest allocated row write through to PM
    pm_busy, pm_ver, ddv, n_l = _pm_land(
        sc, D + 1, batch, pm_busy, pm_ver, n_banks, n_track)
    dd1, rows["ddd"] = _scatter_dd(dd1, rows["ddd"], batch, ddv,
                                   batch.active)
    return dd1, rows, hpbc, hop_stats, pm_busy, pm_ver, pm_writes + n_l


def deep_read(sc, st, addr, t):
    """Read-forwarding checks below hop 1 (shallowest live entry wins).

    Returns ``(hit, resp, dlru', hop_row)``: whether any deep hop can
    serve the read, the response time at the core, the LRU columns with
    the serving entry touched, and the serving row index.  An entry is
    visible only once its commit time has passed (``dwt <= t``) and
    servable under the same Dirty-or-late-Drain rule as hop 1.
    """
    D, P = st.dtag.shape
    dev = st.dtag.device
    slot_ids = torch.arange(P, dtype=torch.int32, device=dev)
    n_sw = float(sc["n_switches"])
    hits, resps, idxs = [], [], []
    for j in range(D):
        row_live = float(j) + 2.0 <= n_sw
        slot_act = slot_ids < sc["deep_pbe"][j].to(torch.int32)
        arr = t + sc["ow_cpu_sw1"] + (float(j) + 1.0) * sc["hop_ns"]
        live = slot_act & (st.dtag[j] == addr) \
            & (st.dstate[j] != EMPTY) & (st.dwt[j] <= t)
        served = live & ((st.dstate[j] == DIRTY)
                         | ((st.dstate[j] == DRAIN)
                            & (st.ddd[j] > arr + sc["fwd_margin"])))
        hits.append(bool(served.any()) and row_live)
        # a Dirty entry supersedes a late-Drain one (same rule as the
        # hop-1 pb_lookup: the Dirty copy is the newer version)
        sd = served & (st.dstate[j] == DIRTY)
        idxs.append(int(torch.argmax(sd.to(torch.int8))) if bool(sd.any())
                    else int(torch.argmax(served.to(torch.int8))))
        resps.append(arr + sc["pbc_read_ns"] + sc["deep_tag"][j]
                     + sc["deep_data"][j]
                     + sc["ow_cpu_sw1"] + (float(j) + 1.0) * sc["hop_ns"])
    any_hit = any(hits)
    first = hits.index(True) if any_hit else 0     # shallowest serving hop
    dlru = st.dlru
    if any_hit:
        dlru = dlru.clone()
        dlru[first, idxs[first]] = t
    return any_hit, resps[first], dlru, first
