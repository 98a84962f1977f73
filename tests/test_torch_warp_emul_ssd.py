"""The SSD kernels, run from their CUDA source on the CPU
(``_warp_emul``) against the plain ``ssd_scan_ref``: the FMA kernel,
the tensor-core kernel (its wgmma, copies, swizzle and chain flags done
by the twin header) in both dtypes, the wrapper's routes, the card
probe's text edits, and the f32 smoke models end to end against the JAX
reference with the emulated f32 tensor-core kernels swapped in."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import _warp_emul as we
from _warp_emul import CSRC
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels import ssd_tc_probe
from repro_torch.kernels.ref import ssd_scan_ref


@pytest.fixture(scope="module")
def model_libs(tmp_path_factory):
    return we.build(tmp_path_factory.mktemp("warp_emul_ssd"),
                    (("ssd_scan", "ssd_scan", we.SSD_LAUNCH),
                     ("ssd_scan_tc", "ssd_scan_tc", we.SSD_TC_LAUNCH),
                     ("flash_attention_tc", "flash_attention_tc",
                      we.FLASH_TC_LAUNCH)))


@pytest.mark.parametrize("s,chunk,init,dtype", [
    (128, 64, False, torch.float32), (100, 64, True, torch.float32),
    (200, 128, True, torch.float32), (64, 64, False, torch.bfloat16)])
def test_emulated_ssd_scan_equals_plain(model_libs, s, chunk, init, dtype):
    """The FMA kernel (f32) and the tensor-core kernel (bf16) on x, B and
    C as strided slices of one projection, as in the model; ragged S; a
    carried-in state."""
    x, dt, A, B, C, st = we.ssd_case(s + chunk, 1, s, 2, 16, 32, init, dtype)
    y, fin = we.run_ssd(model_libs, x, dt, A, B, C, st, chunk=chunk,
                      route=ss.FMA_F32 if dtype == torch.float32 else None)
    wy, wfin = ssd_scan_ref(x, dt, A, B, C, chunk=chunk, init_state=st)
    tol = 1e-4 if dtype == torch.float32 else 1e-1
    assert float((y.float() - wy.float()).abs().max()) < tol
    assert float((fin - wfin).abs().max()) < tol


@pytest.mark.parametrize("b,s,h,p,n,chunk,init,dtype", we.by_dtype([
    (1, 200, 2, 16, 32, 64, False, torch.bfloat16),  # 4 chunks, last ragged
    (1, 300, 3, 64, 128, 128, True, torch.bfloat16),   # 3 chunks, 3 heads
    (2, 197, 1, 64, 128, 64, True, torch.bfloat16),    # chunks of 64, N 128
    (1, 256, 2, 32, 64, 128, False, torch.bfloat16),   # 2 full chunks
    (1, 150, 5, 16, 32, 128, True, torch.bfloat16),    # 5 heads, P, N < 64
    (1, 200, 2, 16, 32, 64, False, torch.float32),
    (1, 300, 3, 64, 128, 128, True, torch.float32),
    (2, 197, 1, 64, 128, 64, True, torch.float32),
    (1, 150, 5, 16, 32, 128, True, torch.float32)]))
def test_emulated_ssd_tc_equals_plain(model_libs, b, s, h, p, n, chunk,
                                      init, dtype):
    """The tensor-core kernel's body, its wgmma, copies, swizzle and
    chain flags done by the twin header on the PTX ISA's documented
    layouts: strided slices, ragged S over several chunks (so the carry
    runs through the chain), a carried-in state, P and N padded to a
    64-wide tile, several heads and batches; bf16, and f32 in two bf16
    parts (its own entry) at the f32 limit."""
    x, dt, A, B, C, st = we.ssd_case(7 * s + p + n, b, s, h, p, n, init,
                                   dtype)
    assert ss.route(dtype, chunk, p, n)[0] == "ssd_scan_tc"
    y, fin = we.run_ssd(model_libs, x, dt, A, B, C, st, chunk=chunk)
    wy, wfin = ssd_scan_ref(x, dt, A, B, C, chunk=chunk, init_state=st)
    tol = 1e-3 if dtype == torch.float32 else 1e-1
    assert bool(torch.isfinite(y.float()).all())
    assert float((y.float() - wy.float()).abs().max()) < tol
    assert float((fin - wfin).abs().max()) < tol


def test_ssd_routes_by_dtype(model_libs):
    """Inside the tensor-core limits both dtypes take the tensor-core
    kernel; outside them (here chunk 32) f32 takes the FMA kernel, whose
    emulated run holds 1e-4, and bf16 raises.  The FMA library has no
    tensor-core entry."""
    assert ss.route(torch.bfloat16, 128, 64, 128) == ss.TC_BF16
    assert ss.route(torch.float32, 128, 64, 128) == ss.TC_F32
    assert ss.route(torch.float32, 32, 16, 32) == ss.FMA_F32
    assert ss.route(torch.float32, 128, 72, 128) == ss.FMA_F32
    assert ss.route(torch.bfloat16, 32, 16, 32) is None
    x, dt, A, B, C, st = we.ssd_case(5, 1, 150, 3, 16, 32, True,
                                   torch.float32)
    y, fin = we.run_ssd(model_libs, x, dt, A, B, C, st, chunk=32)
    wy, wfin = ssd_scan_ref(x, dt, A, B, C, chunk=32, init_state=st)
    assert float((y - wy).abs().max()) < 1e-4
    assert float((fin - wfin).abs().max()) < 1e-4
    with pytest.raises(ValueError, match="bf16 kernel takes"):
        ss.ssd_scan(x.bfloat16(), dt, A, B.bfloat16(), C.bfloat16(),
                    chunk=32)
    with pytest.raises(AttributeError):
        model_libs["ssd_scan"].ssd_scan_tc_launch


@pytest.fixture(scope="module")
def ref():
    from _torch_ref import reference
    with reference() as r:
        yield r


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-1.3b"])
def test_emulated_f32_tc_model_matches_reference(model_libs, ref,
                                                 monkeypatch, arch):
    """The f32 smoke model's prefill with its kernel call (attention or
    SSD) served by the emulated f32 tensor-core kernel, the route the card
    takes for f32, against the JAX reference's prefill on the same numpy
    weights and tokens: 1e-4 of the largest logit, the bound of
    ``test_torch_models`` for the plain versions."""
    import jax
    import jax.numpy as jnp

    from repro_torch import configs as tconfigs
    from repro_torch.models import attention as tattn
    from repro_torch.models import ssm as tssm
    from repro_torch.models import transformer as tt
    from repro_torch.models.convert import (numpy_params,
                                            params_from_reference)
    launched = []

    def emu_flash(q, k, v, *, causal=True, window=None):
        name, entry = fa.route(q.dtype, q.shape[-1])
        assert entry == fa.TC_F32[1]
        q, k, v = (fa._for_copies(x) for x in (q, k, v))
        out = torch.empty(q.shape, dtype=q.dtype)
        assert fa.launch(model_libs[name], q, k, v, out, causal=causal,
                         window=window, stream=None, entry=entry) == 0
        launched.append(entry)
        return out

    def emu_ssd(x, dt, A, B, C, *, chunk, init_state=None):
        name, entry = ss.route(x.dtype, chunk, x.shape[-1], B.shape[-1])
        assert entry == ss.TC_F32[1]
        x, B, C = (ss._for_copies(t) for t in (x, B, C))
        b, s, h, p = x.shape
        y = torch.empty(x.shape, dtype=x.dtype)
        fin = torch.empty((b, h, p, B.shape[-1]))
        init = None if init_state is None else init_state.contiguous()
        assert ss.launch_tc(model_libs[name], x, dt, A.contiguous(), B, C,
                            init, y, fin, ss.sync_buffer(x), chunk=chunk,
                            stream=None) == 0
        launched.append(entry)
        return y, fin

    monkeypatch.setattr(tattn, "flash_attention", emu_flash)
    monkeypatch.setattr(tssm, "ssd_scan", emu_ssd)
    jcfg = ref.configs.get_config(arch, smoke=True)
    tcfg = tconfigs.get_config(arch, smoke=True)
    tree = numpy_params(tcfg, 0)
    model = params_from_reference(tcfg, tree, "cpu")
    b, s = 2, 70
    toks = np.random.default_rng(3).integers(0, tcfg.vocab, (b, s))
    jl, _ = ref.transformer.prefill(jcfg, jax.tree.map(jnp.asarray, tree),
                                    {"tokens": jnp.asarray(toks)}, s + 1)
    with torch.inference_mode():
        tl_, _ = tt.prefill(model, {"tokens": torch.from_numpy(toks)}, s + 1)
    assert len(launched) == tcfg.n_layers
    jl = np.asarray(jl, np.float64)
    assert float(np.abs(tl_.numpy() - jl).max() / np.abs(jl).max()) < 1e-4



@pytest.mark.parametrize("name", sorted(ssd_tc_probe.VARIANTS))
def test_ssd_tc_probe_edits_apply(name):
    """Each ablation and precision variant of the card probe finds its
    anchors once in the tensor-core kernel's source and changes it (the
    base build alone is the source as it is), and so does its f32-output
    twin."""
    text = (CSRC / "ssd_scan_tc.cu").read_text()
    edits = ssd_tc_probe.VARIANTS[name]
    edited = ssd_tc_probe.variant_source(text, edits)
    assert (edited == text) == (name == "base")
    assert ssd_tc_probe.variant_source(
        text, edits + ssd_tc_probe.F32_OUT) != edited
