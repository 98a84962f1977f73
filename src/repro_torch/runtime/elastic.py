"""Elastic remesh planning: re-solve (pod, data, model) for survivors
(port of ``repro.runtime.elastic``).

When nodes die, training restarts from the newest acked checkpoint on a
smaller mesh.  The planner keeps the model axis (set by memory, must
divide the weights) and shrinks the data axis, preserving global batch
via gradient accumulation.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    grad_accum: int          # microbatches to keep the global batch
    dropped_chips: int

    @property
    def n_chips(self) -> int:
        out = 1
        for s in self.shape:
            out *= s
        return out


def plan_mesh(available_chips: int, *, model_parallel: int = 16,
              target_data_parallel: int = 16,
              pods: int = 1) -> Optional[MeshPlan]:
    """Largest (pod, data, model) mesh that fits the surviving chips.

    The model axis is fixed (weight shards must stay complete); data
    parallel shrinks to the largest feasible power-of-two slice, and the
    lost throughput is made up with gradient accumulation.
    """
    per_pod = available_chips // pods
    dp = per_pod // model_parallel
    if dp < 1:
        return None
    used = pods * dp * model_parallel
    accum = max(1, -(-target_data_parallel // dp))  # ceil
    if pods > 1:
        return MeshPlan((pods, dp, model_parallel),
                        ("pod", "data", "model"), accum,
                        available_chips - used)
    return MeshPlan((dp, model_parallel), ("data", "model"), accum,
                    available_chips - used)
