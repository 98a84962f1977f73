"""Where the tensor-core SSD kernel's time goes, and what its three-part
operands buy: a probe run on the card, not part of the port's path.

It builds ``csrc/ssd_scan_tc.cu`` as it is and once per ablation below,
each a text edit of the source (an edit whose anchor is gone raises),
and runs every build at mamba2-1.3b's prefill shape: 4 x 1024 steps, 64
heads of P = 64, N = 128, chunk 128, bf16, with x, B and C slices of one
projection as the model passes them.  For each build it prints the
kernel's mean device time and, over several seeds, its largest
difference from the plain version (``ssd_scan_ref``) on the same inputs
and how many outputs differ from it by more than the bf16 limit.

* ``parts1``, ``parts2``: M, the scaled x and the carry enter their
  products as one or two bf16 parts instead of three;
* ``no_mexp``: M's decay factors exp(da_cum[i] - da_cum[j]) left out;
* ``no_ydiag``: the M·x products dropped (and with them M);
* ``no_sc``: the chunk-state products S_c dropped;
* ``no_yoff``: the C·carry_inᵀ products dropped;
* ``no_chain``: the wait on chunk c - 1's flag dropped.

The ``no_*`` builds compute a wrong y by design: their time beside the
full build's is the share of what they drop.  Run from the root of the
checkout on a machine with a CUDA card and ``nvcc``:

    PYTHONPATH=src python -m repro_torch.kernels.ssd_tc_probe
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
from pathlib import Path

ABLATIONS = {
    "base": (),
    "parts1": (("constexpr int PARTS = 3;", "constexpr int PARTS = 1;"),),
    "parts2": (("constexpr int PARTS = 3;", "constexpr int PARTS = 2;"),),
    "no_mexp": (("exp2f(dr0 - dc)", "1.f"), ("exp2f(dr1 - dc)", "1.f")),
    "no_ydiag": (("wg::wgmma_rs<1>(yd, ", "if (0) wg::wgmma_rs<1>(yd, "),),
    "no_sc": (("wg::wgmma_rs<1>(st[u], ",
               "if (0) wg::wgmma_rs<1>(st[u], "),),
    "no_yoff": (("wg::wgmma_ss<0>(\n          yo,",
                 "if (0) wg::wgmma_ss<0>(\n          yo,"),),
    "no_chain": (("while (wg::ld_acquire(flag) < c) {", "while (0) {"),),
}
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


def build(out_dir: Path) -> dict:
    """One nvcc per ablation, all at once; name -> (loaded library, the
    registers per thread of its kernels, from ptxas)."""
    from repro_torch.kernels import _build
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "ssd_scan_tc.cu").read_text()
    procs = {}
    for name, edits in ABLATIONS.items():
        src = out_dir / f"ssd_scan_tc_{name}.cu"
        src.write_text(variant_source(text, edits))
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


def main(seeds=range(8), reps: int = 20, limit: float = 0.1) -> dict:
    """Per build: the mean time over ``reps`` calls on the first seed's
    inputs, and on every seed the largest difference from the plain
    version and how many outputs differ from it by more than ``limit``
    (the bf16 tolerance).  The plain version's own order floor (chunk 64
    against chunk 128) is counted the same way, and every build and the
    plain version are also held against the f64 evaluation rounded to
    bf16 (``exact_over``: outputs past ``limit`` from it)."""
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels.ref import ssd_scan_ref
    if not torch.cuda.is_available():
        raise SystemExit("ssd_tc_probe: no CUDA device")
    libs = build(_build.BUILD_DIR.parent / "ssd_tc_probe")
    q = SHAPE["chunk"]
    stream = torch.cuda.current_stream().cuda_stream
    out = {"shape": SHAPE, "seeds": list(seeds), "limit": limit,
           "plain_order_floor": [], "plain_order_over": [],
           "plain_exact_over": [], "max_abs_y": [],
           "builds": {k: {"max_abs_err": [], "over": [], "exact_over": [],
                          "registers": r} for k, (_, r) in libs.items()}}
    for seed in seeds:
        x, dt, A, B, C = inputs(torch, np, seed)
        want = ssd_scan_ref(x, dt, A, B, C, chunk=q)[0].float()
        d64 = (ssd_scan_ref(x, dt, A, B, C, chunk=64)[0].float()
               - want).abs()
        out["plain_order_floor"].append(float(d64.max()))
        out["plain_order_over"].append(int((d64 > limit).sum()))
        out["max_abs_y"].append(float(want.abs().max()))
        exact = exact_y(torch, x, dt, A, B, C, q).bfloat16().float()
        out["plain_exact_over"].append(int(((want - exact).abs() > limit)
                                           .sum()))
        y = torch.empty(x.shape, dtype=torch.bfloat16, device="cuda")
        fin = torch.empty((*x.shape[:1], x.shape[2], x.shape[3],
                           B.shape[-1]), dtype=torch.float32, device="cuda")
        syncs = [ss.sync_buffer(x) for _ in range(reps + 1)]
        for name, (lib, _) in libs.items():
            def run(sync):
                _build.check(ss.launch_tc(lib, x, dt, A, B, C, None, y, fin,
                                          sync, chunk=q, stream=stream),
                             name)
            for t in syncs:
                t.zero_()
            run(syncs[-1])
            torch.cuda.synchronize()
            d = (y.float() - want).abs()
            rec = out["builds"][name]
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
    base = out["builds"]["base"]["ms"]
    print(f"ssd_tc_probe (4, 1024, 64, 64) N=128 chunk 128 bf16, seeds "
          f"{list(seeds)}: |y| up to {max(out['max_abs_y']):.1f}; the "
          f"plain version at chunk 64 vs 128 differs by up to "
          f"{max(out['plain_order_floor']):.4g}, outputs past {limit} per "
          f"seed {out['plain_order_over']}; the plain version's outputs "
          f"past {limit} from the f64 evaluation per seed "
          f"{out['plain_exact_over']}")
    for name, rec in out["builds"].items():
        print(f"ssd_tc_probe {name}: {rec['ms']:.4f} ms "
              f"({base - rec['ms']:+.4f} ms against base), max abs error "
              f"vs the plain version {max(rec['max_abs_err']):.4g} (per "
              f"seed {rec['max_abs_err']}), outputs past {limit} per seed "
              f"{rec['over']}, past {limit} from the f64 evaluation per "
              f"seed {rec['exact_over']}, registers {rec['registers']}",
              flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
