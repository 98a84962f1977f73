"""PCS core, torch port: parameters, traces and the timed engine.

The untimed oracle (``repro.core.semantics``) is not part of this slice.
"""
from repro_torch.core.engine import (SimResult, simulate,  # noqa: F401
                                     simulate_cells, simulate_grid,
                                     simulate_sweep)
from repro_torch.core.params import (AllocPolicy, DrainPolicy,  # noqa: F401
                                     FabricTopology, LatencyProfile, Op,
                                     PBEState, PBPolicy, PCSConfig, Schedule,
                                     Scheme, config_from_fields)
from repro_torch.core.traces import (BurstyArrivals,  # noqa: F401
                                     DiurnalArrivals, PoissonArrivals, Trace,
                                     WORKLOADS, apply_arrivals,
                                     compose_tenants, fuzz_crash_ns,
                                     fuzz_trace, leaf_placement,
                                     make_mixed_tenant_trace,
                                     make_offered_load_trace,
                                     make_tenant_trace, make_trace,
                                     tenant_ids, trace_from_arrays)

__all__ = [
    "AllocPolicy", "DrainPolicy", "FabricTopology", "LatencyProfile",
    "Op", "PBEState", "PBPolicy", "PCSConfig", "Schedule", "Scheme",
    "SimResult", "simulate", "simulate_cells", "simulate_grid",
    "simulate_sweep", "config_from_fields",
    "BurstyArrivals", "DiurnalArrivals", "PoissonArrivals",
    "Trace", "WORKLOADS", "apply_arrivals", "compose_tenants",
    "fuzz_crash_ns", "fuzz_trace", "leaf_placement",
    "make_mixed_tenant_trace", "make_offered_load_trace",
    "make_tenant_trace", "make_trace", "tenant_ids", "trace_from_arrays",
]
