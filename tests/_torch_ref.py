"""Scoped access to the JAX reference for the port's tests.

The reference engine does not import under the installed jax (0.9):
``repro/core/engine/grid.py`` runs ``from jax.experimental import
enable_x64``, which that version no longer has, and ``repro.core``
imports the engine.  :func:`reference` gets round this on the tests'
side only:

* it sets ``jax.experimental.enable_x64`` to a stand-in built on
  ``jax.enable_x64`` (:func:`x64_stand_in`), imports ``repro.core``,
  ``repro.core.engine``, ``repro.kernels``, ``repro.models`` (``moe``
  among them), ``repro.configs``, the training
  stack (``repro.persistence``, ``repro.optim``, ``repro.data``,
  ``repro.runtime``, ``repro.launch.steps``, ``repro.launch.train``)
  and the static analysis (``repro.analysis`` and its passes), and
  deletes the attribute again at once;
* reference functions that import ``enable_x64`` when called (the
  analysis's ``_engine.trace_engine`` and ``final_state_shapes``,
  ``dtypes.check_f32_leaks``) run inside the namespace's ``stand_in()``,
  which puts the stand-in back for the body only;
* on exit it takes every ``repro`` module it imported back out of
  ``sys.modules`` (and off its parent package), so the reference's own
  tests that run later in the same process see exactly the import state
  they would have seen without the port's tests.

Use it through a module-scoped fixture, never at import time: the test
runner's workers import every test file while collecting.

Importing this module also gives each of an xdist run's workers its
share of the cores for torch's intra-op threads (cores // workers, at
least one).  By default each worker takes every core, so six workers'
OpenMP threads outnumber the cores six to one and each parallel op
waits for its slowest thread: an emulated cell-scan case (its eager
``scan_cell`` against the kernel) took 73.8 s beside 5 busy processes
with every core and 39.3 s with one thread (37.7 s on an idle machine).
Every worker imports this module, since each one collects every file.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import math
import os
import sys
import types

import numpy as np
import torch

if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // int(
        os.environ["PYTEST_XDIST_WORKER_COUNT"])))

MEANS = ("persist_lat_ns", "read_lat_ns")


@contextlib.contextmanager
def x64_stand_in():
    """``jax.experimental.enable_x64`` as a stand-in built on
    ``jax.enable_x64`` for the body only (where jax lacks it)."""
    import jax
    import jax.experimental

    added = not hasattr(jax.experimental, "enable_x64")
    if added:
        jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)
    try:
        yield
    finally:
        if added:
            del jax.experimental.enable_x64


@contextlib.contextmanager
def reference():
    """Yield a namespace with the reference modules, ``x64()`` and
    ``stand_in()``."""
    import jax

    before = set(sys.modules)
    with x64_stand_in():
        import repro.core
        import repro.core.engine
        import repro.kernels
        from repro.core import params, semantics, traces
        from repro.core.engine import (channels, fabric, grid, handlers,
                                       policy, state)
        from repro.kernels import ref as kref
        from repro import configs
        from repro.models import attention, layers, moe, ssm, transformer
        from repro import data, optim, persistence, runtime
        from repro.launch import steps, train
        import repro.analysis.__main__ as amain
        from repro.analysis import (_engine as aengine, common as acommon,
                                    dtypes as adtypes, mirror as amirror,
                                    retrace as aretrace, sweeps as asweeps,
                                    twin as atwin)
        # the package re-exports the functions under the modules' names
        ktat = importlib.import_module("repro.kernels.tat_lookup")
        kflash = importlib.import_module("repro.kernels.flash_attention")
        kssd = importlib.import_module("repro.kernels.ssd_scan")
    try:
        yield types.SimpleNamespace(
            core=repro.core, params=params, semantics=semantics,
            traces=traces, state=state, fabric=fabric,
            channels=channels, policy=policy, handlers=handlers, grid=grid,
            kref=kref, ktat=ktat, kflash=kflash, kssd=kssd, layers=layers,
            attention=attention, ssm=ssm, moe=moe, transformer=transformer,
            configs=configs, persistence=persistence, optim=optim,
            data=data, runtime=runtime, steps=steps, train=train,
            analysis=types.SimpleNamespace(
                main=amain, engine=aengine, common=acommon, dtypes=adtypes,
                mirror=amirror, retrace=aretrace, sweeps=asweeps,
                twin=atwin),
            x64=lambda: jax.enable_x64(True), stand_in=x64_stand_in)
    finally:
        for name in sorted(set(sys.modules) - before, reverse=True):
            if name != "repro" and not name.startswith("repro."):
                continue
            mod = sys.modules.pop(name)
            parent, _, child = name.rpartition(".")
            if parent in sys.modules and \
                    getattr(sys.modules[parent], child, None) is mod:
                delattr(sys.modules[parent], child)


def ref_config(R, cfg):
    """The reference's twin of the port's config ``cfg`` (``R``: the
    reference's ``repro.core``): every init field, the policies,
    fabric, latency profile and schedules in it rebuilt from the
    reference's classes of the same names."""
    import enum

    def conv(v):
        if isinstance(v, tuple):
            return tuple(conv(x) for x in v)
        if not type(v).__module__.startswith("repro_torch"):
            return v
        twin = getattr(R, type(v).__name__)
        if isinstance(v, enum.Enum):
            return twin(v.value)
        return twin(**{f.name: conv(getattr(v, f.name))
                       for f in dataclasses.fields(v) if f.init})
    return conv(cfg)


def assert_same_result(got, want, label=""):
    """Field-by-field ``SimResult`` equality: exact, except the derived
    means, which may differ by 1 ulp (DESIGN.md "Bit-stability")."""
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray) or isinstance(g, np.ndarray):
            assert g is not None and w is not None, (label, f.name)
            assert np.array_equal(np.asarray(g), np.asarray(w)), \
                (label, f.name, g, w)
        elif f.name in MEANS and not math.isnan(w):
            assert abs(g - w) <= math.ulp(w), (label, f.name, g, w)
        elif isinstance(w, float) and math.isnan(w):
            assert math.isnan(g), (label, f.name, g)
        else:
            assert g == w, (label, f.name, g, w)
