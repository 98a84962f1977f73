"""Where the tensor-core SSD kernel's time goes, and where its bf16
error comes from: a probe run on the card, not part of the port's path.

It builds ``csrc/ssd_scan_tc.cu`` as it is and once per variant below,
each a text edit of the source (an edit whose anchor is gone raises),
and runs the bf16 kernel of every build at mamba2-1.3b's prefill shape:
4 x 1024 steps, 64 heads of P = 64, N = 128, chunk 128, with x, B and C
slices of one projection as the model passes them.  For each build it
prints the kernel's mean device time and, over 8 seeds, its largest
difference from the plain version (``ssd_scan_ref``) on the same inputs
and how many outputs differ by more than the bf16 limit from the plain
version and from an f64 evaluation rounded to bf16.

Ablations (``ABLATIONS``; the ``no_*`` builds compute a wrong y by
design: their time beside the full build's is the share of what they
drop):

* ``parts1``, ``parts2``: M, the scaled x and the carry enter their
  products as one or two bf16 parts instead of three;
* ``no_mexp``: M's decay factors exp(da_cum[i] - da_cum[j]) left out;
* ``no_ydiag``: the M·x products dropped (and with them M);
* ``no_sc``: the chunk-state products S_c dropped;
* ``no_yoff``: the C·carry_inᵀ products dropped;
* ``no_chain``: the wait on chunk c - 1's flag dropped.

Precision variants (``PRECISION``: where the bf16 error came from).  The
repaired kernel (base) issues each accumulator's low products first
and gives each k-step of C·Bᵀ, each key tile of M·x and each pair of
parts of C·carry_inᵀ a fresh accumulator added on the CUDA cores;
``unrepaired`` undoes all of it (the kernel's numerics before the
repair), and the other variants change one thing:

* ``unrepaired_low_first``, ``unrepaired_cb_fresh``,
  ``unrepaired_y_fresh``: ``unrepaired`` with one part of the repair;
* ``unrepaired_exp_natural`` / ``exp_natural``: da_cum in natural units
  with ``expf``, as the plain version takes ``exp`` of its segment
  sums, instead of log2 units with ``exp2f``;
* ``unrepaired_scan_seq`` / ``scan_seq``: da_cum summed in order, as
  the plain version's ``cumsum`` on the card does, instead of a block
  scan;
* ``unrepaired_scan_f64`` / ``scan_f64``: da_cum scanned in f64 and
  kept as hi + lo floats, so that exponent differences lose nothing to
  the cumsum's magnitude;
* ``hi_first``, ``cb_one_acc``, ``y_shared``: the repaired kernel with
  one part of the repair undone (high products first; C·Bᵀ in one
  accumulator per key tile; M·x and C·carry_inᵀ in one accumulator
  each).

Every precision variant is also built with y stored as f32
(``<name>_f32``, ``F32_OUT``): its error before the rounding to bf16,
against the f64 evaluation, beside the plain version's in f32.  Run from
the root of the checkout on a machine with a CUDA card and ``nvcc``:

    PYTHONPATH=src python -m repro_torch.kernels.ssd_tc_probe [names]
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
from pathlib import Path

ABLATIONS = {
    "base": (),
    "parts1": (("return f32 ? 2 : 3;", "return f32 ? 2 : 1;"),),
    "parts2": (("return f32 ? 2 : 3;", "return f32 ? 2 : 2;"),),
    "no_mexp": (("exp2f(dr0 - dc)", "1.f"), ("exp2f(dr1 - dc)", "1.f")),
    "no_ydiag": (("wg::wgmma_rs<1>(f, frag,\n                        desc_sw128(sX",
                  "if (0) wg::wgmma_rs<1>(f, frag,\n"
                  "                        desc_sw128(sX"),),
    "no_sc": (("wg::wgmma_rs<1>(st[u], ",
               "if (0) wg::wgmma_rs<1>(st[u], "),),
    "no_yoff": (("wg::wgmma_ss<0>(\n          f,",
                 "if (0) wg::wgmma_ss<0>(\n          f,"),),
    "no_chain": (("while (wg::ld_acquire(flag) < c) {", "while (0) {"),),
}
_HI_FIRST = (("constexpr bool LOW_FIRST = true;",
              "constexpr bool LOW_FIRST = false;"),)
_CB_ONE_ACC = (("""    for (int i = 0; i < 32; ++i) cb[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk) {
      const uint32_t off = (kk / 4) * Q * 128 + (kk % 4) * 32;
      float f[32];
      wg::fence_acc(f);
      wg::wgmma_fence();
      wg::for_parts<IN, IN, LOW_FIRST>([&](int pi, int pj, bool first) {
        wg::wgmma_ss<0>(f, desc_sw128(sC + pi * TCB + off + w * 8192, 16,
                                      1024),
                        desc_sw128(sB + pj * TCB + off + j * 8192, 16, 1024),
                        !first);
      });
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_acc(f);
#pragma unroll
      for (int i = 0; i < 32; ++i) cb[j][i] += f[i];
    }""", """    for (int i = 0; i < 32; ++i) cb[j][i] = 0.f;
    wg::fence_acc(cb[j]);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk) {
      const uint32_t off = (kk / 4) * Q * 128 + (kk % 4) * 32;
      wg::for_parts<IN, IN, LOW_FIRST>([&](int pi, int pj, bool first) {
        wg::wgmma_ss<0>(cb[j], desc_sw128(sC + pi * TCB + off + w * 8192,
                                          16, 1024),
                        desc_sw128(sB + pj * TCB + off + j * 8192, 16, 1024),
                        1);
      });
    }
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_acc(cb[j]);"""),)
_Y_SHARED = (
    ("""    float f[32];
    wg::fence_acc(f);
    wg::wgmma_fence();
    wg::for_parts<OP, IN, LOW_FIRST>""",
     """    float (&f)[32] = yd;
    wg::fence_acc(f);
    wg::wgmma_fence();
    wg::for_parts<OP, IN, LOW_FIRST>"""),
    ("""                        !(first && kk == 0));
      }
    });
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_acc(f);
#pragma unroll
    for (int i = 0; i < 32; ++i) yd[i] += f[i];""",
     """                        1);
      }
    });
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_acc(f);"""),
    ("""    float f[32];
    wg::fence_acc(f);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk)""",
     """    float (&f)[32] = yo;
    wg::fence_acc(f);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk)"""),
    ("""          kk > 0);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_acc(f);
#pragma unroll
    for (int i = 0; i < 32; ++i) yo[i] += f[i];""",
     """          1);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_acc(f);"""))
_EXP_NATURAL = (
    ("const float A = a.A[h] * LOG2E;", "const float A = a.A[h];"),
    ("exp2f(dend - dcs[tid])", "expf(dend - dcs[tid])"),
    ("exp2f(dr0 - dc)", "expf(dr0 - dc)"),
    ("exp2f(dr1 - dc)", "expf(dr1 - dc)"),
    ("const float decay = exp2f(dend);", "const float decay = expf(dend);"),
    ("const float e0 = exp2f(dr0), e1 = exp2f(dr1);",
     "const float e0 = expf(dr0), e1 = expf(dr1);"))
_SCAN_SEQ = (("    dcs[tid] = v;",
              "    v = 0.f;\n    for (int k = 0; k <= tid; ++k) v += dts[k] * A;"
              "\n    dcs[tid] = v;"),)
# da_cum scanned in f64 and kept as hi + lo floats, so that the exponent
# differences of nearby steps lose no bits to the cumsum's magnitude
_SCAN_F64 = (
    ("template <class T, int Q, int NB>\n__global__",
     """__device__ __forceinline__ float2 hi_lo(double v) {
  const float hi = static_cast<float>(v);
  return make_float2(hi, static_cast<float>(v - hi));
}
__device__ __forceinline__ float ddiff(float2 a, float2 b) {
  return (a.x - b.x) + (a.y - b.y);
}
template <class T, int Q, int NB>\n__global__"""),
    ("rb = r + (3 * q + 5) * 4;", "rb = r + 16 * q + 36;"),
    ("""  float* dts = reinterpret_cast<float*>(sm + L.r);
  float* dcs = dts + Q;   // da_cum · log2(e): exponents for exp2f
  float* wts = dcs + Q;   // dt·exp(da_cum[-1] - da_cum), the x row factors
  float* wsum = wts + Q;  // the scan's warp totals (Q / 32 <= 4)
  int* tick = reinterpret_cast<int*>(wsum + 4);""",
     """  float2* dcs = reinterpret_cast<float2*>(sm + L.r);
  double* wsum = reinterpret_cast<double*>(dcs + Q);
  float* dts = reinterpret_cast<float*>(wsum + 4);
  float* wts = dts + Q;
  int* tick = reinterpret_cast<int*>(wts + Q);"""),
    ("""  const float A = a.A[h] * LOG2E;
  float v = tid < Q ? dts[tid] * A : 0.f;""",
     """  const double A = a.A[h] * 1.4426950408889634;
  double v = tid < Q ? dts[tid] * A : 0.0;"""),
    ("    const float u = __shfl_up_sync(0xffffffffu, v, off);",
     "    const double u = __shfl_up_sync(0xffffffffu, v, off);"),
    ("""    dcs[tid] = v;
  }
  __syncthreads();
  const float dend = dcs[Q - 1];
  if (tid < Q) wts[tid] = dts[tid] * exp2f(dend - dcs[tid]);""",
     """    dcs[tid] = hi_lo(v);
  }
  __syncthreads();
  const float2 dend = dcs[Q - 1];
  if (tid < Q) wts[tid] = dts[tid] * exp2f(ddiff(dend, dcs[tid]));"""),
    ("  const float dr0 = dcs[r0], dr1 = dcs[r0 + 8];",
     "  const float2 dr0 = dcs[r0], dr1 = dcs[r0 + 8];"),
    ("        const float dc = dcs[col], dtc = dts[col];",
     "        const float2 dc = dcs[col];\n        const float dtc = dts[col];"),
    ("exp2f(dr0 - dc)", "exp2f(ddiff(dr0, dc))"),
    ("exp2f(dr1 - dc)", "exp2f(ddiff(dr1, dc))"),
    ("const float decay = exp2f(dend);", "const float decay = exp2f(dend.x);"),
    ("const float e0 = exp2f(dr0), e1 = exp2f(dr1);",
     "const float e0 = exp2f(dr0.x), e1 = exp2f(dr1.x);"))
_UNREPAIRED = _HI_FIRST + _CB_ONE_ACC + _Y_SHARED
PRECISION = {
    # the kernel's numerics before the repair, and each part of the
    # repair or other candidate alone on them
    "unrepaired": _UNREPAIRED,
    "unrepaired_low_first": _CB_ONE_ACC + _Y_SHARED,
    "unrepaired_cb_fresh": _HI_FIRST + _Y_SHARED,
    "unrepaired_y_fresh": _HI_FIRST + _CB_ONE_ACC,
    "unrepaired_exp_natural": _UNREPAIRED + _EXP_NATURAL,
    "unrepaired_scan_seq": _UNREPAIRED + _SCAN_SEQ,
    "unrepaired_scan_f64": _UNREPAIRED + _SCAN_F64,
    # the repaired kernel with one part of the repair undone, or another
    # candidate on top
    "hi_first": _HI_FIRST,
    "cb_one_acc": _CB_ONE_ACC,
    "y_shared": _Y_SHARED,
    "exp_natural": _EXP_NATURAL,
    "scan_seq": _SCAN_SEQ,
    "scan_f64": _SCAN_F64,
}
VARIANTS = {**ABLATIONS, **PRECISION}
# y stored as f32 (the ``<name>_f32`` builds): the bf16 kernel's y before
# its rounding, for its error against the f64 evaluation.
F32_OUT = (
    ("  T* yp = static_cast<T*>(a.y) + (1LL * b * S * a.H + h) * P;",
     "  float* yp = static_cast<float*>(a.y) + (1LL * b * S * a.H + h) * P;"),
    ("    if constexpr (F32) {\n      if (t0 < S)",
     "    if constexpr (true) {\n      if (t0 < S)"))
SHAPE = dict(b=4, s=1024, h=64, p=64, n=128, chunk=128)
SPIN_CYCLES = 50_000_000


def variant_source(text: str, edits) -> str:
    """``text`` with each (anchor, replacement) applied; every anchor must
    occur exactly once."""
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"ssd_tc_probe: anchor {old!r} occurs "
                               f"{text.count(old)} times")
        text = text.replace(old, new)
    return text


def build(out_dir: Path, names=None) -> dict:
    """One nvcc per build (``names``, default every variant and the f32
    twin of every precision variant and of base), all at once; name ->
    (loaded library, the registers per thread of its kernels, from
    ptxas)."""
    from repro_torch.kernels import _build
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "ssd_scan_tc.cu").read_text()
    builds = dict(VARIANTS)
    builds.update({f"{k}_f32": v + F32_OUT
                   for k, v in VARIANTS.items()
                   if k in PRECISION or k == "base"})
    procs = {}
    for name in names or builds:
        src = out_dir / f"ssd_scan_tc_{name}.cu"
        src.write_text(variant_source(text, builds[name]))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.nvcc_flags("ssd_scan_tc"),
             f"-I{_build.CSRC}", "-o", str(out_dir / f"lib{name}.so"),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"ssd_tc_probe: {name} did not build\n{log}")
        libs[name] = (ctypes.CDLL(str(out_dir / f"lib{name}.so")),
                      [int(r) for r in re.findall(r"Used (\d+) registers",
                                                  log)])
    return libs


def inputs(torch, np, seed: int):
    """x, dt, A, B, C at SHAPE from ``seed``, x, B and C slices of one
    (B, S, H·P + 2N) tensor as the model's conv output gives them."""
    b, s, h, p, n = (SHAPE[k] for k in ("b", "s", "h", "p", "n"))
    rng = np.random.default_rng(seed)
    xbc = torch.tensor(rng.standard_normal((b, s, h * p + 2 * n)),
                       dtype=torch.float32, device="cuda").bfloat16()
    x = xbc[..., :h * p].reshape(b, s, h, p)
    B, C = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    dt = torch.tensor(rng.uniform(0.01, 0.2, (b, s, h)),
                      dtype=torch.float32, device="cuda")
    A = torch.tensor(-rng.uniform(0.5, 1.5, h), dtype=torch.float32,
                     device="cuda")
    return x, dt, A, B, C


def exact_y(torch, x, dt, A, B, C, chunk: int):
    """y of the plain version's chunked dual form evaluated in f64, before
    any rounding (S a multiple of ``chunk``, no initial state)."""
    f = torch.float64
    b, s, h, p = x.shape
    n, nc = B.shape[-1], s // chunk
    xc = x.to(f).reshape(b, nc, chunk, h, p)
    dtc = dt.to(f).reshape(b, nc, chunk, h)
    Bc = B.to(f).reshape(b, nc, chunk, n)
    Cc = C.to(f).reshape(b, nc, chunk, n)
    cs = torch.cumsum(dtc * A.to(f), dim=2)                 # (b,nc,q,h)
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]       # (b,nc,q,k,h)
    lower = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                  device=x.device))[None, None, :, :, None]
    m = (torch.einsum("bcqn,bckn->bcqk", Cc, Bc)[..., None]
         * torch.where(lower, torch.exp(seg.clamp(max=0)), 0.0)
         * dtc[:, :, None, :, :])
    y = torch.einsum("bcqkh,bckhp->bcqhp", m, xc)
    del seg, m
    states = torch.einsum("bcqn,bcqh,bcqhp->bchpn", Bc,
                          dtc * torch.exp(cs[:, :, -1:] - cs), xc)
    carry = torch.zeros((b, h, p, n), dtype=f, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * torch.exp(cs[:, c, -1])[..., None, None] \
            + states[:, c]
    y += torch.einsum("bcqn,bcqh,bchpn->bcqhp", Cc, torch.exp(cs),
                      torch.stack(prev, dim=1))
    return y.reshape(b, s, h, p)


def _f32_err(torch, y, exact, big):
    """[max, rms, mean over |y| >= 16] of |y - exact|."""
    e = (y.double() - exact).abs()
    return [float(e.max()), float(e.pow(2).mean().sqrt()),
            float(e[big].mean())]


def main(seeds=range(8), reps: int = 20, limit: float = 0.1,
         names=None) -> dict:
    """Per build: the mean time over ``reps`` calls on the first seed's
    inputs, and on every seed the largest difference from the plain
    version and how many outputs differ from it by more than ``limit``
    (the bf16 tolerance).  The plain version's own order floor (chunk 64
    against chunk 128) is counted the same way, and every build and the
    plain version are also held against the f64 evaluation rounded to
    bf16 (``exact_over``: outputs past ``limit`` from it).  The ``_f32``
    builds and the plain version in f32 give ``f32_err``: [max, rms, mean
    over |y| >= 16] of their f32 y's distance from the f64 evaluation."""
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels.ref import ssd_scan_ref
    if not torch.cuda.is_available():
        raise SystemExit("ssd_tc_probe: no CUDA device")
    libs = build(_build.BUILD_DIR.parent / "ssd_tc_probe", names)
    q = SHAPE["chunk"]
    stream = torch.cuda.current_stream().cuda_stream
    out = {"shape": SHAPE, "seeds": list(seeds), "limit": limit,
           "plain_order_floor": [], "plain_order_over": [],
           "plain_exact_over": [], "plain_f32_err": [], "max_abs_y": [],
           "builds": {k: {"max_abs_err": [], "over": [], "exact_over": [],
                          "f32_err": [], "registers": r}
                      for k, (_, r) in libs.items()}}
    for seed in seeds:
        x, dt, A, B, C = inputs(torch, np, seed)
        want = ssd_scan_ref(x, dt, A, B, C, chunk=q)[0].float()
        d64 = (ssd_scan_ref(x, dt, A, B, C, chunk=64)[0].float()
               - want).abs()
        out["plain_order_floor"].append(float(d64.max()))
        out["plain_order_over"].append(int((d64 > limit).sum()))
        out["max_abs_y"].append(float(want.abs().max()))
        exact64 = exact_y(torch, x, dt, A, B, C, q)
        big = exact64.abs() >= 16
        exact = exact64.bfloat16().float()
        out["plain_exact_over"].append(int(((want - exact).abs() > limit)
                                           .sum()))
        out["plain_f32_err"].append(_f32_err(torch, ssd_scan_ref(
            x.float(), dt, A, B.float(), C.float(), chunk=q)[0], exact64,
            big))
        y = torch.empty(x.shape, dtype=torch.bfloat16, device="cuda")
        y32 = torch.empty(x.shape, dtype=torch.float32, device="cuda")
        fin = torch.empty((*x.shape[:1], x.shape[2], x.shape[3],
                           B.shape[-1]), dtype=torch.float32, device="cuda")
        syncs = [ss.sync_buffer(x) for _ in range(reps + 1)]
        for name, (lib, _) in libs.items():
            rec = out["builds"][name]
            if name.endswith("_f32"):    # y stored as f32: bf16 inputs
                _build.check(ss.launch_tc(lib, x, dt, A, B, C, None, y32,
                                          fin, syncs[-1].zero_(), chunk=q,
                                          stream=stream), name)
                torch.cuda.synchronize()
                rec["f32_err"].append(_f32_err(torch, y32, exact64, big))
                continue

            def run(sync):
                _build.check(ss.launch_tc(lib, x, dt, A, B, C, None, y, fin,
                                          sync, chunk=q, stream=stream),
                             name)
            for t in syncs:
                t.zero_()
            run(syncs[-1])
            torch.cuda.synchronize()
            d = (y.float() - want).abs()
            rec["max_abs_err"].append(float(d.max()))
            rec["over"].append(int((d > limit).sum()))
            rec["exact_over"].append(int(((y.float() - exact).abs() > limit)
                                         .sum()))
            if seed != seeds[0]:
                continue
            start, stop = (torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
            torch.cuda._sleep(SPIN_CYCLES)   # time the kernels, not the host
            start.record()
            for t in syncs[:reps]:
                run(t)
            stop.record()
            torch.cuda.synchronize()
            rec["ms"] = start.elapsed_time(stop) / reps

    def mean(rows):
        return [float(np.mean([r[i] for r in rows])) for i in range(3)]
    base = out["builds"].get("base", {}).get("ms", float("nan"))
    print(f"ssd_tc_probe (4, 1024, 64, 64) N=128 chunk 128 bf16, seeds "
          f"{list(seeds)}: |y| up to {max(out['max_abs_y']):.1f}; the "
          f"plain version at chunk 64 vs 128 differs by up to "
          f"{max(out['plain_order_floor']):.4g}, outputs past {limit} per "
          f"seed {out['plain_order_over']}; the plain version's outputs "
          f"past {limit} from the f64 evaluation per seed "
          f"{out['plain_exact_over']}; its f32 y from the f64 evaluation "
          f"[max, rms, mean at |y| >= 16], mean over seeds "
          f"{mean(out['plain_f32_err'])}")
    for name, rec in out["builds"].items():
        if name.endswith("_f32"):
            print(f"ssd_tc_probe {name}: f32 y from the f64 evaluation "
                  f"[max, rms, mean at |y| >= 16], mean over seeds "
                  f"{mean(rec['f32_err'])}", flush=True)
            continue
        print(f"ssd_tc_probe {name}: {rec['ms']:.4f} ms "
              f"({rec['ms'] - base:+.4f} ms against base), max abs error "
              f"vs the plain version {max(rec['max_abs_err']):.4g} (per "
              f"seed {rec['max_abs_err']}), outputs past {limit} per seed "
              f"{rec['over']}, past {limit} from the f64 evaluation per "
              f"seed {rec['exact_over']}, registers {rec['registers']}",
              flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    import sys
    main(names=sys.argv[1:] or None)
