"""Hand-written Hopper kernels of the port, each beside its plain version.

  * ``tat_lookup`` — batched PB tag match (port of the Pallas
    ``repro.kernels.tat_lookup``); its match routine is shared with
  * ``cell_scan``  — the timed engine's per-cell issue-time merge loop
    (replaces the reference's ``lax.scan``).

``ref`` holds the plain versions.  Kernels build with ``nvcc`` at first
use (``_build``); importing this package builds and loads nothing.
"""
