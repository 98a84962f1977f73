"""The analysis exemplar: one small engine cell for the dynamic passes
(torch port of ``repro.analysis._engine``).

One small exemplar cell exercises every axis the passes read: PB_RF
over a 2-leaf fan-out fabric (deep-hop rows live for the spine, per-leaf
PBC column live, finite backpressure watermark), 2 tenants with quotas +
weighted victim, a tenant-scoped drain policy with a latency target, a
finite crash point, durability tracking and macro-stepping — the
reference's exemplar, built from the port's ``params``,
``scalars_from_config`` and ``traces.plan_runs``.

The reference traces the cell abstractly (``jax.make_jaxpr``), and its
``lax.switch`` traces every scheme's handlers.  The port's passes run
the plain ``core/engine/step.py::scan_cell`` on CPU tensors instead,
once under every ``Scheme`` (its Python branches run only the cell's
scheme), which takes seconds.  The same cell goes through the cell-scan
kernel on the card in ``chip_smoke.py``'s phase 16.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def example_inputs():
    """``(buffers, statics, sc)`` of the exemplar: the ``(ops, addrs,
    gaps, lengths, mlen)`` CPU tensors of one 4-core trace, the static
    keywords of ``scan_cell`` and the lowered config scalars."""
    from repro_torch.core.engine.state import scalars_from_config
    from repro_torch.core.params import (AllocPolicy, DrainPolicy,
                                         FabricTopology, Op, PBPolicy,
                                         PCSConfig, Schedule, Scheme,
                                         MACRO_KMAX)
    from repro_torch.core.traces import plan_runs

    # the 2-leaf fabric (finite backpressure watermark) keeps the fabric
    # operands (n_leaves/leaf_of_t/leaf_base/bp_high) in use and derives
    # the (8, 4) hop capacities; every schedulable knob is a 2-epoch
    # Schedule (one shared boundary), so the epoch_bounds vector and the
    # stacked per-epoch rows must feed the results, not just epoch 0's
    bound = 2.5e4
    cfg = PCSConfig(
        scheme=Scheme.PB_RF, n_cores=4,
        n_tenants=2, crash_at_ns=5.0e4,
        fabric=FabricTopology(n_leaves=2, leaf_pbe=(4, 4), spine_pbe=4,
                              placement=Schedule((bound,),
                                                 ((0, 1), (1, 0))),
                              bp_high=3.0),
        policy=PBPolicy(
            drain=DrainPolicy(
                per_tenant=True,
                threshold=Schedule((bound,), (0.75, 0.5)),
                preset=0.25,
                latency_target_ns=Schedule((bound,), (450.0, 300.0))),
            alloc=AllocPolicy(victim="weighted",
                              tenant_quota=Schedule((bound,),
                                                    ((4, 4), (3, 5))))))
    sc = scalars_from_config(cfg, n_tenants_max=2, n_deep_max=1,
                             n_leaves_max=2, n_epochs_max=2)

    C, L = 4, 16 + MACRO_KMAX
    kinds = [Op.PERSIST, Op.PM_READ, Op.DRAM_READ, Op.DRAM_WRITE,
             Op.COMPUTE, Op.PERSIST, Op.PM_READ, Op.BARRIER]
    ops = np.zeros((C, L), np.int32)
    addrs = np.zeros((C, L), np.int32)
    gaps = np.zeros((C, L), np.float32)
    for c in range(C):
        for i in range(16):
            ops[c, i] = int(kinds[i % len(kinds)])
            addrs[c, i] = (c * 16 + i) % 8
            gaps[c, i] = 10.0
    lengths = np.full((C,), 16, np.int32)
    mlen = plan_runs(ops, addrs, gaps, MACRO_KMAX)
    statics = dict(max_pbe=8, pm_banks=2, n_track=4, n_tenants_max=2,
                   n_deep_max=1, n_leaves_max=2, macro=True)
    buffers = tuple(torch.as_tensor(b) for b in (ops, addrs, gaps, lengths,
                                                 mlen))
    return buffers, statics, sc


def schemes() -> Tuple[int, ...]:
    from repro_torch.core.params import Scheme
    return tuple(int(s) for s in Scheme)


def run_cell(scheme: int, sc=None, *, return_state: bool = False):
    """``scan_cell``'s outputs of the exemplar under ``scheme``, with
    ``sc`` in place of its lowered config when given."""
    from repro_torch.core.engine.step import scan_cell

    (ops, addrs, gaps, lengths, mlen), statics, sc0 = example_inputs()
    return scan_cell(ops, addrs, gaps, lengths, scheme,
                     sc0 if sc is None else sc, mlen=mlen,
                     return_state=return_state, **statics)


def every_scheme(sc):
    """The exemplar's outputs under every scheme, from one ``sc`` — the
    port's counterpart of the reference's one traced cell, whose switch
    holds every scheme's handlers."""
    return tuple(run_cell(s, sc) for s in schemes())


def scalar_keys() -> List[str]:
    """Every key ``scalars_from_config`` lowers (the sweepable surface)."""
    _, _, sc = example_inputs()
    return sorted(sc)


def final_state_shapes() -> Dict[str, Tuple[str, Tuple[int, ...]]]:
    """column -> (dtype, shape) of the carry AFTER a full PB_RF cell
    run.  Catches a handler that silently widens a packed column just as
    well as an init-time regression — the carry must round-trip every
    step."""
    from repro_torch.core.params import Scheme

    st = run_cell(int(Scheme.PB_RF), return_state=True)[-1]
    return {k: (str(v.dtype).removeprefix("torch."), tuple(v.shape))
            for k, v in st._asdict().items()}
