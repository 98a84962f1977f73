"""Resource model: PM device banks and the PBC service port (torch port
of ``repro.core.engine.channels``).

Every shared resource is a scalar "next-free time".  A requester that
arrives at ``ready`` starts service at ``max(next_free, ready)`` and
holds the resource for its *occupancy* (device-internal pipelining lets
a PM bank accept the next request before the requester observes its
response, so occupancy < latency).

The PBC is a single FIFO front: persists and PI-routed reads serialize
on ``pbc_busy``; the head-of-line blocking of reads behind stalled
writes (the paper's Fig. 6b mechanism) falls out of this scalar.
"""
from __future__ import annotations

import torch

_INF = 1e30  # engine.state.INF (kept local: state imports no channels)


def bank_of(addr, n_banks: int):
    """Static interleave of cache lines across independent PM banks
    (floor modulo: the initial tag -1 maps to bank ``n_banks - 1``)."""
    return torch.remainder(addr, n_banks)


def service_start(busy, bank, ready):
    """When bank ``bank`` can begin serving a request arriving at ``ready``."""
    return torch.maximum(busy[bank], ready)


def reserve(busy, bank, start, occ):
    """Hold the bank from ``start`` for ``occ`` ns; returns updated vector."""
    out = busy.clone()
    out[bank] = start + occ
    return out


def pbc_start(pbc_busy, arrival, proc_ns):
    """PBC FIFO service start + processing for one packet."""
    return torch.maximum(pbc_busy, arrival) + proc_ns


def pbc_hold(pbc_busy, arrival, occ_ns):
    """Advance the PBC next-free time past one packet's issue interval."""
    return torch.maximum(pbc_busy, arrival) + occ_ns


def fifo_service(busy, arrivals, active, occ_ns):
    """Batch FIFO service of a deep-hop PBC / inter-switch channel.

    ``arrivals`` (Q,) are packet arrival times in channel order;
    ``active`` masks live packets.  Service start of packet q is
    ``max(arrival_q, start_{q-1} + occ)`` with the channel busy until
    ``busy``, solved in closed form with a cumulative max:

        start_q = occ*rank_q + max(busy, max_{i<=q}(arr_i - occ*rank_i))

    Returns ``(starts (Q,), busy_after ())``; inactive packets get INF
    starts and do not advance the channel.
    """
    rank = torch.cumsum(active.to(torch.float64), 0) - 1.0
    adj = torch.where(active, arrivals - occ_ns * rank,
                      torch.full_like(arrivals, -_INF))
    run = torch.cummax(adj, 0).values
    starts = torch.where(active, occ_ns * rank + torch.maximum(run, busy),
                         torch.full_like(arrivals, _INF))
    busy_after = torch.max(torch.where(active, starts + occ_ns,
                                       busy.expand_as(starts)))
    return starts, torch.maximum(busy_after, busy)
