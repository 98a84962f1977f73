"""PCS core, torch port: parameters, traces, the untimed oracle
(``semantics``) and the timed engine."""
from repro_torch.core.engine import (SimResult,  # noqa: F401
                                     last_macro_abort_reasons,
                                     last_macro_hit_rate, simulate,
                                     simulate_cells, simulate_grid,
                                     simulate_sweep)
from repro_torch.core.params import (AllocPolicy, DrainPolicy,  # noqa: F401
                                     FabricTopology, LatencyProfile, Op,
                                     PBEState, PBPolicy, PCSConfig, Schedule,
                                     Scheme, config_from_fields)
from repro_torch.core.semantics import (Event, EventKind,  # noqa: F401
                                        PersistentBuffer, PersistentMemory)
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
    "Event", "EventKind", "PersistentBuffer", "PersistentMemory",
    "SimResult", "simulate", "simulate_cells", "simulate_grid",
    "simulate_sweep", "last_macro_abort_reasons", "last_macro_hit_rate",
    "config_from_fields",
    "BurstyArrivals", "DiurnalArrivals", "PoissonArrivals",
    "Trace", "WORKLOADS", "apply_arrivals", "compose_tenants",
    "fuzz_crash_ns", "fuzz_trace", "leaf_placement",
    "make_mixed_tenant_trace", "make_offered_load_trace",
    "make_tenant_trace", "make_trace", "tenant_ids", "trace_from_arrays",
]
