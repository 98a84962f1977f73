"""The CUDA kernels' own source, run on the CPU against the plain versions.

There is no ``nvcc`` on a CPU-only machine, but the bodies of the
kernels in ``csrc/`` are plain C++ apart from a handful of CUDA
constructs.  ``warp_emul/cuda_emul.h`` supplies those for g++ (a warp =
32 threads, a block = one or more warps, intrinsics and
``__syncthreads`` through a barrier) and ``warp_emul/cuda_bf16.h`` the
bf16 type, so the kernels' logic — warp reductions, lane-owned slots,
the read-then-write phases, the tiles shared by a block's threads — is
checked here against the plain versions with the wrappers' own launch
code.  The card itself is checked by ``chip_smoke.py``.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core as P
from repro_torch.core.engine import grid
from repro_torch.kernels import cell_scan as cs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels import ssd_tc_probe
from repro_torch.kernels import tat_lookup as tl
from repro_torch.kernels.ref import (flash_attention_ref, ssd_scan_ref,
                                     tat_lookup_ref)

CSRC = Path(tl.__file__).resolve().parent / "csrc"
EMUL = Path(__file__).resolve().parent / "warp_emul"

# Defined before the kernel's source in every emulated cell-scan library:
# a step inside a committed macro window that does not select the
# window's core is counted (window_faults below).
CELL_SCAN_PRELUDE = r'''
#include <atomic>
static std::atomic<int> g_window_faults{0};
#define CELL_SCAN_WINDOW_CHECK(ok) \
  do {                             \
    if (!(ok)) ++g_window_faults;  \
  } while (0)
'''

CELL_SCAN_LAUNCH = r'''
alignas(16) unsigned char smem_raw[1 << 20];
// EMU_MAC / EMU_EP: the library's third of the instantiations, built
// beside the others at once — with macro-steps off, every EP = false one
// (EMU_EP 0) or the EP = true ones the scheduled cases need (EMU_EP 1:
// SPL 1, and SPL 2 at D = 3); with them on (EMU_MAC 1), SPL 1's at every
// D, FAB and EP; a grid outside the library's third is refused
template <int SPL, int D, bool FAB>
static bool emu_ep(Args& a, int n_cells, bool ep, bool mac) {
  if (mac != static_cast<bool>(EMU_MAC)) return false;
#if EMU_MAC
  if constexpr (SPL == 1) {
    if (ep)
      emu_run(n_cells, [&] { cell_scan_kernel<SPL, D, FAB, true, true>(a); });
    else
      emu_run(n_cells, [&] { cell_scan_kernel<SPL, D, FAB, false, true>(a); });
    return true;
  }
  return false;
#else
  if (ep != static_cast<bool>(EMU_EP)) return false;
#if EMU_EP
  if constexpr (SPL == 1 || (SPL == 2 && D == 3)) {
    emu_run(n_cells, [&] { cell_scan_kernel<SPL, D, FAB, true, false>(a); });
    return true;
  }
  return false;
#else
  emu_run(n_cells, [&] { cell_scan_kernel<SPL, D, FAB, false, false>(a); });
  return true;
#endif
#endif
}
template <int SPL, int D>
static bool emu_d(Args& a, int n_cells, bool fab, bool ep, bool mac) {
  return fab ? emu_ep<SPL, D, true>(a, n_cells, ep, mac)
             : emu_ep<SPL, D, false>(a, n_cells, ep, mac);
}
template <int SPL>
static bool emu_spl(Args& a, int n_cells, int n_deep, bool fab, bool ep,
                    bool mac) {
  switch (n_deep) {
    case 0: return emu_ep<SPL, 0, false>(a, n_cells, ep, mac);
    case 1: return emu_d<SPL, 1>(a, n_cells, fab, ep, mac);
    case 2: return emu_d<SPL, 2>(a, n_cells, fab, ep, mac);
    default: return emu_d<SPL, 3>(a, n_cells, fab, ep, mac);
  }
}
extern "C" int window_faults() { return g_window_faults.exchange(0); }
extern "C" int cell_scan_launch(
    const int* ops, const int* addrs, const float* gaps, const int* lengths,
    const int* cell_trace, const int* cell_cfg, const int* schemes,
    const double* sc_table, const double* ten_table,
    const double* lat_edges, double* runtime, double* stats,
    double* hop_stats, int* durable_ver, double* n_recov,
    double* recov_ns, double* recov_t, long long* steps, long long* lookups,
    int* aver, const double* chain_table, double* recov_h,
    const double* fab_table, double* recov_l, const double* ep_table,
    const double* ep_bounds, const signed char* mlen, long long* macro_ops,
    long long* macro_aborts, int n_cells, int C, int L, int P, int B, int A,
    int T, int n_track, int n_deep, int n_leaves, int n_epochs, int macro,
    cudaStream_t) {
  const bool fab = n_leaves > 1;
  const bool ep = n_epochs > 1;
  const int NL = fab ? n_leaves : 1;
  Args a{ops, addrs, gaps, lengths, cell_trace, cell_cfg, schemes,
         sc_table, ten_table, lat_edges, runtime, stats, hop_stats,
         durable_ver, n_recov, recov_ns, recov_t, steps, lookups, aver,
         C, L, P, B, A, T, n_track, {}, chain_table, recov_h, {},
         fab_table, recov_l, {}, NL, ep_table, ep_bounds, n_epochs,
         mlen, macro_ops, macro_aborts};
  if (n_deep < 0 || n_deep > 3 || n_leaves < 1 || n_leaves > MAX_LEAVES ||
      (fab && n_deep < 1) || n_epochs < 1 || n_epochs > MAX_EPOCHS)
    return 1;
  size_t smem = carve(a.lay, nullptr, C, P, B, T, NL);
  if (n_deep > 0) smem = carve_chain(a.clay, nullptr, smem, P, B, n_deep);
  if (fab) smem = carve_fab(a.flay, nullptr, smem, T);
  if (smem > sizeof(smem_raw)) return 1;
  wg::emu_smem_base = smem_raw;
  const bool mac = macro != 0;
  const bool ran =
      P <= 32   ? emu_spl<1>(a, n_cells, n_deep, fab, ep, mac)
      : P <= 64 ? emu_spl<2>(a, n_cells, n_deep, fab, ep, mac)
                : emu_spl<MAX_SPL>(a, n_cells, n_deep, fab, ep, mac);
  return ran ? 0 : 1;
}
// the chain's warp primitives on one emulated warp: lane l's __clz of
// masks[l], the warp's __reduce_or_sync of masks, lane l's
// tat_first_each answer for req[l] over a table of 64 slots (tag, live;
// slot 32 j + l on lane l), nth_set_bit(masks[l], ks[l]), and
// tat_first_key over lane l's keys[l]
extern "C" void warp_primitives(const int* req, const int* tag,
                                const int* live, const unsigned* masks,
                                const int* ks, const int* keys, int* clz,
                                unsigned* ored, int* first, int* nth,
                                int* least) {
  emu_run(1, [&] {
    const int l = threadIdx.x;
    clz[l] = __clz(masks[l]);
    ored[l] = __reduce_or_sync(FULL, masks[l]);
    const int tg[2] = {tag[l], tag[32 + l]};
    const bool lv[2] = {live[l] != 0, live[32 + l] != 0};
    first[l] = tat_first_each(req[l], tg, lv, 2);
    nth[l] = nth_set_bit(masks[l], ks[l]);
    least[l] = tat_first_key(keys[l]);
  });
}
// the chain's commit-latency sum over (position, value) addends of a
// batch of Q packets
extern "C" double chunk_sum(int Q, int n, const int* pos, const double* v) {
  ChunkSum s(Q);
  for (int i = 0; i < n; ++i) s.add(pos[i], v[i]);
  return s.sum();
}
'''

TAT_LOOKUP_LAUNCH = r'''
int table[1 << 16];
extern "C" int tat_lookup_launch(const int* req, const int* tat,
                                 const int* states, int* out_idx,
                                 int* out_state, int r, int n, int,
                                 cudaStream_t) {
  if (2 * n > (1 << 16)) return 1;
  emu_run((r + 31) / 32, [&] {
    tat_lookup_kernel(req, tat, states, out_idx, out_state, r, n);
  });
  return 0;
}
'''

FLASH_LAUNCH = r'''
namespace flash { alignas(16) float flash_smem[1 << 16]; }
template <class T, int D>
static int emu_flash(const flash::Args& a, int blocks) {
  if (flash::smem_floats(D) > (1 << 16)) return 1;
  emu_run(blocks, [&] { flash::flash_kernel<T, D>(a); }, flash::NT);
  return 0;
}
template <class T>
static int emu_flash_d(const flash::Args& a, int d, int blocks) {
  switch (d) {
    case 16: return emu_flash<T, 16>(a, blocks);
    case 32: return emu_flash<T, 32>(a, blocks);
    case 64: return emu_flash<T, 64>(a, blocks);
    case 128: return emu_flash<T, 128>(a, blocks);
    case 256: return emu_flash<T, 256>(a, blocks);
    default: return 1;
  }
}
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o,
    const long long* st, int B, int H, int S, int D, int g, int causal,
    int window, float scale, cudaStream_t) {
  flash::Args a{q, k, v, o, st[0], st[1], st[2], st[3], st[4], st[5],
                st[6], st[7], st[8], st[9], st[10], st[11],
                H, S, g, causal, window, scale};
  const int blocks = B * H * ((S + flash::BQ - 1) / flash::BQ);
  return emu_flash_d<float>(a, D, blocks);
}
'''

FLASH_TC_LAUNCH = r'''
namespace fatc {
alignas(1024) unsigned char fatc_smem[smem_bytes(256, false)];
static_assert(smem_bytes(F32_MAX_D, true) <= smem_bytes(256, false));
}
template <class T, int D>
static int emu_flash_tc(const fatc::Args& a, int blocks) {
  wg::emu_smem_base = fatc::fatc_smem;
  emu_run(blocks, [&] { fatc::flash_tc_kernel<T, D>(a); }, fatc::NT);
  return 0;
}
template <class T>
static int emu_flash_tc_t(const void* q, const void* k, const void* v,
                          void* o, const long long* st, int B, int H, int S,
                          int D, int g, int causal, int window, float scale) {
  fatc::Args a{q, k, v, o, st[0], st[1], st[2], st[3], st[4], st[5],
               st[6], st[7], st[8], st[9], st[10], st[11],
               H, S, g, causal, window, scale};
  const int blocks = B * H * ((S + fatc::BQ - 1) / fatc::BQ);
  switch (D) {
    case 16: return emu_flash_tc<T, 16>(a, blocks);
    case 32: return emu_flash_tc<T, 32>(a, blocks);
    case 64: return emu_flash_tc<T, 64>(a, blocks);
    case 128: return emu_flash_tc<T, 128>(a, blocks);
    case 256:
      if constexpr (!std::is_same<T, float>::value)
        return emu_flash_tc<T, 256>(a, blocks);
      return 1;
    default: return 1;
  }
}
extern "C" int flash_attention_tc_launch(
    const void* q, const void* k, const void* v, void* o,
    const long long* st, int B, int H, int S, int D, int g, int causal,
    int window, float scale, cudaStream_t) {
  return emu_flash_tc_t<__nv_bfloat16>(q, k, v, o, st, B, H, S, D, g,
                                       causal, window, scale);
}
extern "C" int flash_attention_tc_f32_launch(
    const void* q, const void* k, const void* v, void* o,
    const long long* st, int B, int H, int S, int D, int g, int causal,
    int window, float scale, cudaStream_t) {
  return emu_flash_tc_t<float>(q, k, v, o, st, B, H, S, D, g, causal,
                               window, scale);
}
'''

SSD_LAUNCH = r'''
namespace ssd { alignas(16) float ssd_smem[1 << 16]; }
extern "C" int ssd_scan_launch(
    const void* x, const float* dt, const float* A, const void* Bm,
    const void* Cm, const float* init, void* y, float* fin,
    const long long* st, int batch, int S, int H, int P, int N, int Q,
    cudaStream_t) {
  ssd::Args a{x, dt, A, Bm, Cm, init, y, fin, st[0], st[1], st[2], st[3],
              st[4], st[5], st[6], st[7], st[8], st[9], S, H, P, N, Q};
  if (ssd::smem_floats(Q, P, N) > (1 << 16)) return 1;
  emu_run(batch * H, [&] { ssd::ssd_kernel<float>(a); }, ssd::NT);
  return 0;
}
'''

SSD_TC_LAUNCH = r'''
namespace ssdtc {
alignas(1024) unsigned char ssdtc_smem[smem_bytes(128, 2, true)];
static_assert(smem_bytes(128, 2, false) <= smem_bytes(128, 2, true));
}
template <class T, int Q, int NB>
static int emu_ssd_tc(const ssdtc::Args& a, int blocks) {
  wg::emu_smem_base = ssdtc::ssdtc_smem;
  emu_run(blocks, [&] { ssdtc::ssd_tc_kernel<T, Q, NB>(a); }, 2 * Q);
  return 0;
}
template <class T>
static int emu_ssd_tc_t(const void* x, const float* dt, const float* A,
                        const void* Bm, const void* Cm, const float* init,
                        void* y, float* fin, int* sync, const long long* st,
                        int batch, int S, int H, int P, int N, int Q) {
  if (P < 8 || P > 64 || P % 8 || N < 8 || N > 128 || N % 8) return 1;
  ssdtc::Args a{x, dt, A, Bm, Cm, init, y, fin, sync,
                st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                st[8], st[9], batch, S, H, P, N};
  const int blocks = (S + Q - 1) / Q * batch * H;
  if (blocks == 0) return 0;
  const bool wide = N > 64;
  if (Q == 64) return wide ? emu_ssd_tc<T, 64, 2>(a, blocks)
                           : emu_ssd_tc<T, 64, 1>(a, blocks);
  if (Q == 128) return wide ? emu_ssd_tc<T, 128, 2>(a, blocks)
                            : emu_ssd_tc<T, 128, 1>(a, blocks);
  return 1;
}
extern "C" int ssd_scan_tc_launch(
    const void* x, const float* dt, const float* A, const void* Bm,
    const void* Cm, const float* init, void* y, float* fin, int* sync,
    const long long* st, int batch, int S, int H, int P, int N, int Q,
    cudaStream_t) {
  return emu_ssd_tc_t<__nv_bfloat16>(x, dt, A, Bm, Cm, init, y, fin, sync,
                                     st, batch, S, H, P, N, Q);
}
extern "C" int ssd_scan_tc_f32_launch(
    const void* x, const float* dt, const float* A, const void* Bm,
    const void* Cm, const float* init, void* y, float* fin, int* sync,
    const long long* st, int batch, int S, int H, int P, int N, int Q,
    cudaStream_t) {
  return emu_ssd_tc_t<float>(x, dt, A, Bm, Cm, init, y, fin, sync, st,
                             batch, S, H, P, N, Q);
}
'''


def _emulated_source(name: str, launcher: str, prelude: str = "") -> str:
    src = (CSRC / f"{name}.cu").read_text()
    body = src.split("// ---- host entry point")[0]
    body = body.replace("#include <cuda_runtime.h>",
                        f'#include "{EMUL / "cuda_emul.h"}"')
    for header in CSRC.glob("*.cuh"):
        twin = EMUL / header.name        # a host twin of PTX primitives
        body = body.replace(f'#include "{header.name}"',
                            f'#include "{twin if twin.exists() else header}"')
    return prelude + body + launcher


def _build(out: Path, sources) -> dict:
    """Each ``(library, kernel source, launcher[, prelude])`` of
    ``sources`` built by its own g++, all at once; ``{library:
    loaded}``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to build the emulated kernels")
    procs = []
    for lib, name, launcher, *prelude in sources:
        cpp = out / f"{lib}.cpp"
        cpp.write_text(_emulated_source(name, launcher, *prelude))
        so = out / f"lib{lib}.so"
        procs.append((lib, so, subprocess.Popen(
            [gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC",
             "-shared", "-pthread", f"-I{EMUL}", "-o", str(so), str(cpp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    loaded = {}
    for lib, so, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"g++ of {lib} failed:\n{log.decode()}")
        loaded[lib] = ctypes.CDLL(str(so))
    return loaded


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("warp_emul"),
                  tuple((lib, "cell_scan", f"#define EMU_EP {ep}\n"
                         f"#define EMU_MAC {mac}\n" + CELL_SCAN_LAUNCH,
                         CELL_SCAN_PRELUDE)
                        for lib, ep, mac in (("cell_scan", 0, 0),
                                             ("cell_scan_ep", 1, 0),
                                             ("cell_scan_mac", 0, 1)))
                  + (("tat_lookup", "tat_lookup", TAT_LOOKUP_LAUNCH),))


@pytest.fixture(scope="module")
def model_libs(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("warp_emul_model"),
                  tuple((n, n, launcher) for n, launcher in (
                      ("flash_attention", FLASH_LAUNCH),
                      ("flash_attention_tc", FLASH_TC_LAUNCH),
                      ("ssd_scan", SSD_LAUNCH),
                      ("ssd_scan_tc", SSD_TC_LAUNCH))))


@pytest.mark.parametrize("r,n", [(256, 16), (1024, 256), (8, 16), (37, 5)])
def test_emulated_tat_lookup_equals_plain(libs, r, n):
    rng = np.random.default_rng(r * 7 + n)
    req, tat, st = (torch.tensor(rng.integers(lo, hi, k), dtype=torch.int32)
                    for lo, hi, k in ((0, 2 * n, r), (0, 2 * n, n),
                                      (0, 3, n)))
    idx = torch.empty(r, dtype=torch.int32)
    out = torch.empty(r, dtype=torch.int32)
    fn = libs["tat_lookup"].tat_lookup_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    assert fn(req.data_ptr(), tat.data_ptr(), st.data_ptr(), idx.data_ptr(),
              out.data_ptr(), r, n, 1, None) == 0
    want = tat_lookup_ref(req, tat, st)
    assert torch.equal(idx, want[0]) and torch.equal(out, want[1])


def _cases():
    S = P.Scheme
    fz = [P.fuzz_trace(seed, n_cores=4, n_slots=100, n_tenants=2)[0]
          for seed in range(2)]
    pols = [P.PBPolicy(alloc=P.AllocPolicy(victim="weighted")),
            P.PBPolicy(alloc=P.AllocPolicy(tenant_quota=(3, 5))),
            P.PBPolicy(drain=P.DrainPolicy(per_tenant=True,
                                           latency_target_ns=300.0))]
    small = [P.make_trace(n, persist_budget=50)
             for n in ("radiosity", "lu_cont")]
    # cores whose streams end at once (length 0 and 1) beside cores that
    # go on: the trace-entry ring refills past a stream's end, and a
    # tenant loses its cores while the other keeps running
    short = []
    for seed, p_barrier in ((5, 0.0), (6, 0.05)):
        tr = P.fuzz_trace(seed, n_cores=6, n_slots=120, n_tenants=2,
                          p_barrier=p_barrier)[0]
        lengths = tr.lengths.copy()
        lengths[0], lengths[4] = 0, 1
        short.append(P.trace_from_arrays(f"short{seed}", tr.ops, tr.addrs,
                                         tr.gaps, lengths))
    # more cores than lanes: a lane owns cores lane, lane + 32
    many = [P.fuzz_trace(7, n_cores=40, n_slots=100, n_tenants=2)[0]]
    deep_rf = P.PBPolicy(drain=P.DrainPolicy(threshold=0.95, preset=0.05))
    chain_fz = [P.fuzz_trace(seed, n_cores=3, n_slots=50, n_addrs=6,
                             p_persist=0.7)[0] for seed in (0, 1)]
    fab_fz = [P.fuzz_trace(seed, n_cores=4, n_slots=50, n_addrs=6,
                           n_tenants=4, p_persist=0.7)[0] for seed in (0, 1)]
    # epoch schedules: one boundary on the fuzzed traces' time scale
    # (slots 1 ms apart) and one on the dense traces' (tens of ns a op)
    Sch, fb = P.Schedule, P.fuzz_crash_ns
    place0 = P.leaf_placement(4, 2, "packed")
    place1 = tuple(1 - p for p in place0)

    def flip(b, quota=None):
        return dict(fabric=P.FabricTopology(2, (4, 4), 4,
                                            Sch((b,), (place0, place1))),
                    policy=P.PBPolicy(alloc=P.AllocPolicy(
                        tenant_quota=quota)))
    return {
        "schemes": (small, [P.PCSConfig(scheme=s) for s in S], 0),
        "crash": (small, [P.PCSConfig(scheme=s).with_crash(t)
                          for s in S for t in (4e3, 9e3)], 16),
        "tenants": (fz, [P.PCSConfig(scheme=s, n_pbe=8, n_tenants=2,
                                     policy=p)
                         for s in (S.PB, S.PB_RF) for p in pols]
                    + [P.PCSConfig(scheme=S.PB_RF, n_pbe=8, n_tenants=2,
                                   crash_at_ns=2.5e7)], 8),
        "slots": (small[:1], [P.PCSConfig(scheme=s, n_pbe=n, pm_banks=3)
                              for s in (S.PB, S.PB_RF)
                              for n in (1, 33, 128)], 0),
        "short_cores": (short, [P.PCSConfig(scheme=s, n_pbe=n, n_tenants=2,
                                            policy=p)
                                for s in (S.PB, S.PB_RF) for n in (8, 40)
                                for p in pols[1:]], 8),
        "many_cores": (many, [P.PCSConfig(scheme=s, n_pbe=16, n_tenants=2)
                              for s in S], 8),
        # switch chains, one grid per deep-row count D = depth - 1
        # (mixed with depth-1 and NoPB cells); crash points, uneven and
        # bypass-heavy capacities, tenants
        "chain_d1": (chain_fz + small[:1],
                     [P.PCSConfig(scheme=s, n_pbe=4, n_switches=2)
                      .with_crash(t) for s in S for t in (3e7, 1e12)]
                     + [P.PCSConfig(scheme=S.PB_RF, n_pbe=4),
                        P.PCSConfig(scheme=S.PB, n_switches=2,
                                    pbe_per_hop=(4, 1))], 8),
        "chain_d2": (chain_fz + small[:1],
                     [P.PCSConfig(scheme=s, n_pbe=3, n_switches=3,
                                  pbe_per_hop=hp).with_crash(t)
                      for s in (S.PB, S.PB_RF)
                      for hp in ((3, 2, 1), (3, 4, 4))
                      for t in (2e7, 1e12)]
                     + [P.PCSConfig(scheme=S.NOPB, n_switches=3),
                        P.PCSConfig(scheme=S.PB_RF, n_pbe=3, n_tenants=2,
                                    n_switches=2)], 8),
        "chain_d3": (chain_fz + small[:1],
                     [P.PCSConfig(scheme=s, n_pbe=4, n_switches=4)
                      .with_crash(t) for s in (S.PB, S.PB_RF)
                      for t in (1.5e7, 3.5e7, 1e12)]
                     + [P.PCSConfig(scheme=S.PB_RF, n_pbe=4, n_switches=4,
                                    pbe_per_hop=(4, 2, 1, 1)),
                        P.PCSConfig(scheme=S.PB, n_pbe=4, n_switches=3)],
                     8),
        "chain_wide": (small[:1], [P.PCSConfig(scheme=s, n_pbe=n,
                                               n_switches=3)
                                   for s in (S.PB, S.PB_RF)
                                   for n in (40, 70)], 0),
        # batches of more than 32 packets (the kernel's scans, ranks and
        # bypass list carried from tile to tile): a PB_RF drain-down from
        # 95 % to 5 % fill, narrow deep rows that most packets bypass;
        # SPL 2 (n_pbe 40) and SPL 4 (70, 128)
        "chain_long_spl2": ([_synth(0, 300)],
                            [P.PCSConfig(scheme=S.PB_RF, n_pbe=40,
                                         n_switches=d, policy=deep_rf,
                                         pbe_per_hop=hp)
                             for d, hp in ((3, None), (4, (40, 4, 4, 4)))]
                            + [P.PCSConfig(scheme=S.PB, n_pbe=40,
                                           n_switches=4)], 0),
        "chain_long_spl4": ([_synth(0, 300)],
                            [P.PCSConfig(scheme=S.PB_RF, n_pbe=n,
                                         n_switches=d, policy=deep_rf,
                                         pbe_per_hop=hp)
                             for n, d, hp in ((70, 3, (70, 8, 4)),
                                              (70, 4, None),
                                              (128, 4, (128, 128, 8, 4)))],
                            0),
        # every line on PM bank 0 of 3 (the modulo path of bank_of)
        "chain_bank": ([_synth(1, 100, stride=3)],
                       [P.PCSConfig(scheme=s, n_pbe=40, n_switches=4,
                                    pm_banks=3, policy=pol, pbe_per_hop=hp)
                        for s, pol, hp in ((S.PB_RF, deep_rf, (40, 4, 4, 4)),
                                           (S.PB_RF, deep_rf, None),
                                           (S.PB, P.PBPolicy(), None))], 0),
        # power lost while a batch is in flight: some of its commits (at
        # a deep row) or PM landings fall before the crash, some after
        "chain_gate": ([_synth(0, 300)],
                       [P.PCSConfig(scheme=S.PB_RF, n_pbe=40, n_switches=d,
                                    policy=deep_rf, pbe_per_hop=hp)
                        .with_crash(t)
                        for d, hp, ts in ((4, (40, 8, 4, 4),
                                           (14e3, 26e3, 38e3)),
                                          (3, None, (14e3, 22e3, 54e3)))
                        for t in ts], 64),
        # five lines on three cores: the deep rows coalesce again and
        # again, and a packet meets many Dirty entries of its row
        "chain_dup": ([_synth(2, 5, n_cores=3, L=150, gap=30.0,
                              p_read=0.3)],
                      [P.PCSConfig(scheme=s, n_pbe=hp[0], n_switches=4,
                                   pbe_per_hop=hp, policy=pol)
                       for s, pol in ((S.PB, P.PBPolicy()),
                                      (S.PB_RF, deep_rf))
                       for hp in ((4, 1, 1, 1), (4, 4, 4, 4))], 16),
        # fan-out fabrics (one grid per case, FAB instantiations): leaf
        # windows beside a chain cell and a depth-1 cell sharing the grid
        # (the n_leaves < 2 bypass), uneven and wide leaves (SPL 2)
        "fabric_l2_packed": (fab_fz + [_fab_probe(4, 40)],
                             [P.PCSConfig(scheme=s, n_cores=4, n_tenants=4,
                                          fabric=f).with_crash(t)
                              for s in (S.PB, S.PB_RF)
                              for f in (_fab(4, (4, 4), 4, "packed"),
                                        _fab(4, (3, 5), 2, "spread"),
                                        _fab(4, (24, 24), 8, "packed"))
                              for t in (2e7, 1e12)]
                             + [P.PCSConfig(scheme=S.PB_RF, n_pbe=8,
                                            n_cores=4, n_tenants=4,
                                            n_switches=2,
                                            pbe_per_hop=(8, 4)),
                                P.PCSConfig(scheme=S.PB, n_pbe=8,
                                            n_cores=4, n_tenants=4)], 8),
        # spine backpressure: watermarks the spine's Dirty entries reach
        "fabric_l4_spread_bp": (fab_fz + [_fab_probe(4, 40)],
                                [P.PCSConfig(scheme=s, n_cores=4,
                                             n_tenants=4, fabric=f,
                                             policy=pol)
                                 for s in (S.PB, S.PB_RF)
                                 for f in (_fab(4, (2, 2, 2, 2), 4, "spread",
                                                2.0),
                                           _fab(4, (4, 4), 4, "packed", 1.0))
                                 for pol in (P.PBPolicy(), deep_rf)], 8),
        # eight leaves of 2 PBEs, one tenant a leaf
        "fabric_l8": ([_fab_probe(8, 30)],
                      [P.PCSConfig(scheme=s, n_cores=8, n_tenants=8,
                                   fabric=_fab(8, (2,) * 8, 8, mode, bp))
                       for s in (S.PB, S.PB_RF)
                       for mode, bp in (("packed", None), ("spread", 4.0))],
                      0),
        # chain cells up to 4 switches and fabric cells in one grid:
        # D = 3, NL = 4
        "fabric_mixed": (fab_fz,
                         [P.PCSConfig(scheme=s, n_pbe=4, n_cores=4,
                                      n_tenants=4, n_switches=d)
                          for s in (S.PB, S.PB_RF) for d in (2, 4)]
                         + [P.PCSConfig(scheme=s, n_cores=4, n_tenants=4,
                                        fabric=f)
                            for s in (S.PB, S.PB_RF)
                            for f in (_fab(4, (2, 2, 2, 2), 4, "spread",
                                           2.0),
                                      _fab(4, (8,), 4, "packed"))], 8),
        # power lost with survivors on several leaves
        "fabric_crash": ([_fab_probe(4, 60)],
                         [P.PCSConfig(scheme=s, n_cores=4, n_tenants=4,
                                      fabric=f).with_crash(t)
                          for s in (S.PB, S.PB_RF)
                          for f in (_fab(4, (4, 4), 4, "spread"),
                                    _fab(4, (2, 2, 2, 2), 4, "packed", 2.0))
                          for t in (9e3, 2.1e4, 4.4e4)], 64),
        # epoch schedules at D = 0 (the EP instantiation): a quota step, a
        # drain-threshold tighten (global and per tenant) and an SLO target
        # switched on, beside a static cell
        "epochs_d0": (fz[:1] + [_synth(3, 40, n_cores=2)],
                      [P.PCSConfig(scheme=s, n_pbe=8, n_tenants=2, policy=p)
                       .with_crash(t)
                       for b in (fb(50), 4e3)
                       for s, p in (
                           (S.PB_RF, P.PBPolicy(alloc=P.AllocPolicy(
                               tenant_quota=Sch((b,), ((3, 5), (6, 2)))))),
                           (S.PB, P.PBPolicy(alloc=P.AllocPolicy(
                               tenant_quota=Sch((b,), ((4, 4), (2, 6)))))),
                           (S.PB_RF, P.PBPolicy(drain=P.DrainPolicy(
                               threshold=Sch((b,), (0.75, 0.375)),
                               preset=0.25))),
                           (S.PB_RF, P.PBPolicy(drain=P.DrainPolicy(
                               threshold=Sch((b,), (0.5, 0.875)),
                               preset=Sch((b,), (0.25, 0.5)),
                               per_tenant=True))),
                           (S.PB_RF, P.PBPolicy(drain=P.DrainPolicy(
                               latency_target_ns=Sch((b,), (None, 300.0))))))
                       for t in (INF_NS, 1.5 * b)]
                      + [P.PCSConfig(scheme=S.PB_RF, n_pbe=8, n_tenants=2)],
                      8),
        # a placement flip (and a quota step) over a 2-leaf fabric, power
        # lost before and after the boundary: D = 1, FAB and EP
        "epochs_fabric": (fab_fz[:1] + [_fab_probe(4, 40)],
                          [P.PCSConfig(scheme=s, n_cores=4, n_tenants=4,
                                       **flip(b, q)).with_crash(t)
                           for b in (fb(25), 2e4)
                           for s in (S.PB, S.PB_RF)
                           for q in (None, Sch((b,), ((2, 2, 2, 2),
                                                      (4, 2, 1, 1))))
                           for t in (0.5 * b, 1.5 * b, INF_NS)], 64),
        # drain thresholds over a 2-hop chain's deep row stepped down and
        # up mid-run: a row left over its new count drains on a forward
        # with no packet (chain.drain_pending)
        "epochs_chain": ([_synth(0, 300), _synth(4, 60, n_cores=3)],
                         [P.PCSConfig(scheme=S.PB_RF, n_pbe=16, n_switches=2,
                                      policy=P.PBPolicy(drain=P.DrainPolicy(
                                          threshold=Sch((b,), thr),
                                          preset=0.125))).with_crash(t)
                          for b in (3e3, 5e3)
                          for thr in ((0.875, 0.375), (0.375, 0.875),
                                      (1.0, 0.25))
                          for t in (INF_NS, 1.2 * b)]
                         + [P.PCSConfig(scheme=S.PB, n_pbe=16, n_switches=2)],
                         16),
        # threshold steps over chains of 3 and 4 switches whose deeper rows
        # hold more entries than hop 1: rows 1 and 2 left over their new
        # drain count drain on forwards with no packet (D = 3, SPL 1)
        "epochs_deep": ([_synth(0, 300, p_read=0.0)],
                        [P.PCSConfig(scheme=S.PB_RF, n_pbe=hp[0],
                                     n_switches=len(hp), pbe_per_hop=hp,
                                     policy=P.PBPolicy(drain=P.DrainPolicy(
                                         threshold=Sch((b,), (0.875, 0.25)),
                                         preset=0.125))).with_crash(t)
                         for hp, b in (((4, 8, 8, 16), 2e3),
                                       ((8, 8, 8, 8), 6e3), ((4, 8, 8), 2e3))
                         for t in (INF_NS, 1.5 * b)]
                        + [P.PCSConfig(scheme=S.PB, n_pbe=4, n_switches=4)],
                        16),
        # a 3-switch threshold step beside a scheduled fabric (D = 2, FAB,
        # EP, SPL 1)
        "epochs_d2": (fab_fz[:1] + [_synth(4, 60, n_cores=4)],
                      [P.PCSConfig(scheme=S.PB_RF, n_pbe=4, n_cores=4,
                                   n_tenants=4, n_switches=3,
                                   pbe_per_hop=(4, 8, 8),
                                   policy=P.PBPolicy(drain=P.DrainPolicy(
                                       threshold=Sch((b,), (0.875, 0.25)),
                                       preset=0.125)))
                       for b in (fb(20), 2e3)]
                      + [P.PCSConfig(scheme=S.PB_RF, n_cores=4, n_tenants=4,
                                     **flip(fb(20)))], 8),
        # SPL 2: a 4-switch threshold step over 40 hop-1 PBEs beside a
        # scheduled fabric of 40 leaf PBEs (D = 3, FAB, EP)
        "epochs_spl2": ([_synth(0, 300, p_read=0.0, n_cores=4)],
                        [P.PCSConfig(scheme=S.PB_RF, n_pbe=40, n_cores=4,
                                     n_switches=4, pbe_per_hop=(40, 8, 8, 8),
                                     policy=P.PBPolicy(drain=P.DrainPolicy(
                                         threshold=Sch((3e3,), (0.5, 0.125)),
                                         preset=0.0625))),
                         P.PCSConfig(scheme=S.PB, n_cores=4, n_tenants=4,
                                     fabric=P.FabricTopology(
                                         2, (20, 20), 4,
                                         Sch((3e3,), (place0, place1))))],
                        8),
        # static and scheduled cells in one grid (E = 3: a threshold that
        # tightens then relaxes over a 2-hop chain's deep row, a flip with
        # one boundary, padded), the static ones in all their kinds
        "epochs_mixed": (fab_fz,
                         [P.PCSConfig(scheme=S.PB_RF, n_pbe=4, n_cores=4,
                                      n_tenants=4, n_switches=2,
                                      policy=P.PBPolicy(drain=P.DrainPolicy(
                                          threshold=Sch((fb(15), fb(30)),
                                                        (0.75, 0.25, 1.0)),
                                          preset=0.125))).with_crash(fb(40)),
                          P.PCSConfig(scheme=S.PB, n_cores=4, n_tenants=4,
                                      **flip(fb(20))).with_crash(fb(33)),
                          P.PCSConfig(scheme=S.PB_RF, n_pbe=4, n_cores=4,
                                      n_tenants=4, n_switches=2),
                          P.PCSConfig(scheme=S.PB_RF, n_pbe=8, n_cores=4,
                                      n_tenants=4),
                          P.PCSConfig(scheme=S.NOPB, n_cores=4, n_tenants=4),
                          P.PCSConfig(scheme=S.PB_RF, n_cores=4, n_tenants=4,
                                      fabric=_fab(4, (4, 4), 4, "spread"))],
                         8),
        # macro-steps (the MAC = true library, SPL 1).  Commits: one core
        # of persist/read pairs to fresh lines (no other core to
        # interleave), each scheme, an SLO target that tightens PB_RF's
        # drain-down and a PB_RF whose drain-down fires mid-run
        "macro_commits": ([_fig1_probe(60), _fig1_probe(40, gap=50.0)],
                          [P.PCSConfig(scheme=s) for s in S]
                          + [P.PCSConfig(scheme=S.PB_RF, n_pbe=4,
                                         policy=P.PBPolicy(
                                             drain=P.DrainPolicy(
                                                 latency_target_ns=300.0)))],
                          8),
        # every abort reason in one grid (D = 1, FAB, EP): computes
        # (window), a fabric, a 2-switch chain, a threshold step inside a
        # window (epoch_boundary), several cores (interleave), PB read
        # hits (guard)
        "macro_reasons": (small[:1] + [_fig1_probe(40, gap=500.0),
                                       _hit_probe()],
                          [P.PCSConfig(scheme=S.PB), P.PCSConfig(
                              scheme=S.PB_RF, n_pbe=4),
                           P.PCSConfig(scheme=S.PB, n_switches=2),
                           P.PCSConfig(scheme=S.PB_RF, n_tenants=2,
                                       fabric=P.FabricTopology(2, (4, 4), 4,
                                                               (0, 1))),
                           P.PCSConfig(scheme=S.PB, policy=P.PBPolicy(
                               drain=P.DrainPolicy(
                                   threshold=Sch((2.5e4,), (0.75, 0.5)),
                                   preset=0.25)))], 8),
        # dead runs after a crash, advancing up to MACRO_KMAX slots past
        # the trace-entry ring's RING = 4, at points that also cut
        # committed windows
        "macro_dead": (small + [_fig1_probe(60)],
                       [P.PCSConfig(scheme=s).with_crash(t) for s in S
                        for t in (2e3, 5e3, 9e4)], 16),
        # tenants under quotas, weighted victims and a per-tenant SLO
        "macro_tenants": (fz, [P.PCSConfig(scheme=s, n_pbe=8, n_tenants=2,
                                           policy=p)
                               for s in (S.PB, S.PB_RF) for p in pols], 8),
        # more cores than lanes: the other cores' least key over lanes
        # holding two cores each (cores that run one after another, whose
        # windows commit, beside the fuzzed ones)
        "macro_many_cores": (many + [_staggered(36)],
                             [P.PCSConfig(scheme=s, n_pbe=16, n_tenants=2)
                              for s in S], 8),
    }


def _fig1_probe(n_pairs, gap=2000.0):
    """``benchmarks/fig1_switch_depth.py``'s probe, cut: one core of
    persist/read pairs to fresh lines, ``gap`` ns apart."""
    ops = np.tile(np.int32([int(P.Op.PERSIST), int(P.Op.PM_READ)]),
                  n_pairs)[None]
    addrs = np.stack([np.arange(n_pairs), (1 << 20) + np.arange(n_pairs)],
                     1).reshape(1, -1).astype(np.int32)
    return P.trace_from_arrays(f"probe{n_pairs}", ops, addrs,
                               np.full(ops.shape, gap, np.float32),
                               np.full(1, ops.shape[1], np.int32))


def _staggered(n_cores, n_pairs=10):
    """``n_cores`` cores of persist/read pairs to lines of their own,
    100 ns apart, core c starting at c ms: each runs alone but at its
    neighbours' edges."""
    ops = np.tile(np.int32([int(P.Op.PERSIST), int(P.Op.PM_READ)]),
                  (n_cores, n_pairs))
    addrs = ((np.arange(n_cores)[:, None] << 16)
             + np.arange(2 * n_pairs)[None, :]).astype(np.int32)
    gaps = np.full(ops.shape, 100.0, np.float32)
    gaps[:, 0] = 1e6 * np.arange(n_cores)
    return P.trace_from_arrays("staggered", ops, addrs, gaps,
                               np.full(n_cores, ops.shape[1], np.int32))


def _hit_probe(n=12):
    """One core: a persist to a line, then reads of it and of a fresh
    one, 10 ns apart (each window's first read hits the PB)."""
    ops = np.tile(np.int32([int(P.Op.PERSIST), int(P.Op.PM_READ),
                            int(P.Op.PM_READ)]), n)[None]
    addrs = np.stack([3 * np.arange(n)] * 2 + [3 * np.arange(n) + 1],
                     1).reshape(1, -1).astype(np.int32)
    return P.trace_from_arrays("hit_probe", ops, addrs,
                               np.full(ops.shape, 10.0, np.float32),
                               np.full(1, ops.shape[1], np.int32))


INF_NS = 1e30     # crash_at that never comes


def _fab(n_tenants, leaf_pbe, spine_pbe, mode, bp_high=None):
    """A fan-out fabric over ``leaf_pbe``'s leaves, its tenants placed by
    ``mode`` (``leaf_placement``)."""
    n = len(leaf_pbe)
    return P.FabricTopology(n, leaf_pbe, spine_pbe,
                            P.leaf_placement(n_tenants, n, mode),
                            bp_high=bp_high)


def _fab_probe(n_cores, n_ops, gap=500.0):
    """``benchmarks/fig_fabric.py``'s probe trace: per core (one tenant
    each) ``n_ops`` persists to a hot set of 64 lines of its own block,
    each followed by a PM read of a fresh line, ``gap`` ns apart."""
    L = 2 * n_ops
    ops = np.zeros((n_cores, L), np.int32)
    addrs = np.zeros((n_cores, L), np.int32)
    for c in range(n_cores):
        for i in range(n_ops):
            ops[c, 2 * i] = int(P.Op.PERSIST)
            addrs[c, 2 * i] = (c << 16) + i % 64
            ops[c, 2 * i + 1] = int(P.Op.PM_READ)
            addrs[c, 2 * i + 1] = (c << 16) + (1 << 10) + i
    return P.trace_from_arrays("fab_probe", ops, addrs,
                               np.full((n_cores, L), gap, np.float32),
                               np.full(n_cores, L, np.int32))


def _synth(seed, n_addrs, *, stride=1, n_cores=2, L=200, gap=40.0,
           p_read=0.2):
    """Persists (and a share of PM reads) to random lines of
    ``stride * range(n_addrs)``, ``gap`` ns apart on every core."""
    rng = np.random.default_rng(seed)
    ops = np.where(rng.random((n_cores, L)) < p_read, int(P.Op.PM_READ),
                   int(P.Op.PERSIST)).astype(np.int32)
    addrs = (stride * rng.integers(0, n_addrs, (n_cores, L))).astype(np.int32)
    return P.trace_from_arrays(f"synth{seed}", ops, addrs,
                               np.full((n_cores, L), gap, np.float32),
                               np.full(n_cores, L, np.int32))


# What each case must reach in the eager chain (see _chain_batches).
REACH = {
    "chain_long_spl2": lambda r: r["place"] > 32 and r["land"] > 32,
    "chain_long_spl4": lambda r: r["place"] > 64 and r["land"] > 64,
    "chain_bank": lambda r: r["bank"] > 32,
    "chain_gate": lambda r: r["place_split"] > 0 and r["land_split"] > 0,
    "chain_dup": lambda r: r["coalesces"] > 0,
    "fabric_l4_spread_bp": lambda r: r["deferred"] > 0,
    "epochs_d0": lambda r: r["epochs"] == {0, 1},
    "epochs_fabric": lambda r: r["epochs"] == {0, 1},
    "epochs_mixed": lambda r: r["epochs"] == {0, 1, 2},
    "epochs_chain": lambda r: r["epochs"] == {0, 1} and r["pending"] > 0,
    "epochs_deep": lambda r: {1, 2} <= r["pending_rows"],
    "epochs_d2": lambda r: r["epochs"] == {0, 1},
    "epochs_spl2": lambda r: r["epochs"] == {0, 1},
    # a committed window and a dead run each longer than the ring
    "macro_commits": lambda r: r["window_max"] > 4,
    "macro_dead": lambda r: r["dead_max"] > 4 and r["window_max"] > 4,
    "macro_reasons": lambda r: r["window_max"] > 1,
}


# The kernel instantiation a case must run: (SPL, D, FAB, EP, MAC).
INSTANTIATION = {"epochs_deep": (1, 3, False, True, False),
                 "epochs_d2": (1, 2, True, True, False),
                 "epochs_spl2": (2, 3, True, True, False),
                 "macro_commits": (1, 0, False, False, True),
                 "macro_reasons": (1, 1, True, True, True)}


@pytest.fixture
def chain_batches(monkeypatch):
    """What the eager chain's batches held: the most active packets at a
    deep row and at PM, the most on one PM bank, the batches whose commit
    gate fell between their packets (at a row, at PM), the deep-row
    coalesces, the batches that named a line twice (none can: every
    hop holds at most one Dirty entry per line, and a packet bypasses a
    row only when it holds none for its line), the schedule epochs the
    steps resolved, the forwards run with no packet for a deep row left
    over its drain count, and the longest committed macro window and
    dead-run collapse (``window_max``, ``dead_max``, in trace slots)."""
    from repro_torch.core.engine import chain, channels, policy, step
    r = dict(place=0, land=0, bank=0, place_split=0, land_split=0,
             coalesces=0, repeats=0, deferred=0, epochs=set(), pending=0,
             pending_rows=set(), window_max=0, dead_max=0)
    place, land = chain._place, chain._pm_land
    drain = policy.drain_threshold_preset

    def seen(batch):
        a = batch.addr[batch.active].tolist()
        r["repeats"] += len(a) != len(set(a))
        return len(a)

    def _place(sc, j, scheme, rows, hpbc_j, batch, hop_stats):
        out = place(sc, j, scheme, rows, hpbc_j, batch, hop_stats)
        r["place"] = max(r["place"], seen(batch))
        starts, _ = channels.fifo_service(hpbc_j, batch.emit + sc["hop_ns"],
                                          batch.active, sc["pbc_occ_ns"])
        cm = (starts + sc["pbc_proc_ns"] + sc["deep_tag"][j]
              + sc["deep_data"][j])[out[4] & batch.active]
        r["place_split"] += bool((cm <= sc["crash_at"]).any()) \
            and bool((cm > sc["crash_at"]).any())
        r["coalesces"] += int(out[2][j + 1, 2] - hop_stats[j + 1, 2])
        return out

    def _land(sc, pos, batch, pm_busy, pm_ver, n_banks, n_track):
        out = land(sc, pos, batch, pm_busy, pm_ver, n_banks, n_track)
        if seen(batch):
            r["land"] = max(r["land"], int(batch.active.sum()))
            banks = torch.remainder(batch.addr[batch.active], n_banks)
            r["bank"] = max(r["bank"], int(torch.bincount(banks).max()))
            dd = out[2][batch.active]
            r["land_split"] += bool((dd <= sc["crash_at"]).any()) \
                and bool((dd > sc["crash_at"]).any())
        return out
    def _drain(*args, defer=None, **kw):
        # a drain-down the spine's backpressure held back
        if defer is not None and bool(defer):
            r["deferred"] += float(drain(*args, **kw)[3]) > 0
        return drain(*args, defer=defer, **kw)
    resolve = step.resolve_epoch_sc

    def _resolve(sc, t_issue):
        if "epoch_bounds" in sc:
            r["epochs"].add(int((sc["epoch_bounds"] <= t_issue).sum()))
        return resolve(sc, t_issue)
    pending = chain.drain_pending

    def _pending(sc, scheme, rows):
        out = pending(sc, scheme, rows)
        r["pending"] += out
        # the live rows a lowered threshold left over their drain count
        slots = torch.arange(rows["dstate"].shape[1])
        for j in range(rows["dstate"].shape[0]):
            if float(j) + 2.0 <= float(sc["n_switches"]):
                cnt = ((slots < sc["deep_pbe"][j].to(torch.int32))
                       & (rows["dstate"][j] == 1)).double().sum()
                k = cnt if scheme == 1 else torch.where(
                    cnt >= sc["deep_thr"][j], cnt - sc["deep_pre"][j], 0.0)
                if bool(k > 0.0):
                    r["pending_rows"].add(j)
        return out
    macro_step = step.macro_step

    def _macro_step(ctx, st, ops, addrs, gaps64, lengths, mlen, tsel, live,
                    *a, **kw):
        out = macro_step(ctx, st, ops, addrs, gaps64, lengths, mlen, tsel,
                         live, *a, **kw)
        if out[0] is not None:
            key = "window_max" if live else "dead_max"
            r[key] = max(r[key], out[1])
        return out
    monkeypatch.setattr(step, "macro_step", _macro_step)
    monkeypatch.setattr(step, "resolve_epoch_sc", _resolve)
    monkeypatch.setattr(chain, "drain_pending", _pending)
    monkeypatch.setattr(chain, "_place", _place)
    monkeypatch.setattr(chain, "_pm_land", _land)
    monkeypatch.setattr(policy, "drain_threshold_preset", _drain)
    return r


@pytest.mark.parametrize("case", ["schemes", "crash", "tenants", "slots",
                                  "short_cores", "many_cores", "chain_d1",
                                  "chain_d2", "chain_d3", "chain_wide",
                                  "chain_long_spl2", "chain_long_spl4",
                                  "chain_bank", "chain_gate", "chain_dup",
                                  "fabric_l2_packed", "fabric_l4_spread_bp",
                                  "fabric_l8", "fabric_mixed",
                                  "fabric_crash", "epochs_d0",
                                  "epochs_fabric", "epochs_chain",
                                  "epochs_mixed", "epochs_deep",
                                  "epochs_d2", "epochs_spl2",
                                  "macro_commits", "macro_reasons",
                                  "macro_dead", "macro_tenants",
                                  "macro_many_cores"])
def test_emulated_cell_scan_equals_eager_scan_cell(libs, chain_batches,
                                                   case):
    """The emulated kernel against the eager ``scan_cell`` on every
    output; the ``macro`` cases run the MAC library with macro-steps on
    (the other cases with them off), its counters included, and every
    step inside a committed window must select the window's core."""
    traces, configs, track = _cases()[case]
    macro = case.startswith("macro")
    pairs = [(i, j) for i in range(len(traces)) for j in range(len(configs))]
    args, kw = grid.cell_inputs(traces, configs, [p[0] for p in pairs],
                                [p[1] for p in pairs], track_addrs=track,
                                macro=macro)
    want = cs.cell_scan(*args, **kw)
    assert chain_batches["repeats"] == 0
    if case in REACH:
        assert REACH[case](chain_batches), chain_batches
    got = cs._empty_out(len(pairs), kw["n_tenants_max"], max(track, 1),
                        kw["n_deep_max"], "cpu", kw["n_leaves_max"])
    lib = libs["cell_scan_mac" if macro else "cell_scan_ep"
               if args[11].shape[1] > 1 else "cell_scan"]
    assert cs.launch(lib, list(args), got,
                     max_pbe=kw["max_pbe"], pm_banks=kw["pm_banks"],
                     n_track=track, n_deep=kw["n_deep_max"],
                     n_leaves=kw["n_leaves_max"], macro=macro,
                     stream=None) == 0
    for f in cs.CellScanOut._fields:
        if f != "lookups":
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert int(got.lookups.sum()) > 0
    assert lib.window_faults() == 0
    if macro:
        assert int(want.macro_ops.sum()) > 0
        if case == "macro_reasons":
            assert bool((want.macro_aborts.sum(0) > 0).all()), \
                want.macro_aborts.sum(0)
    else:
        assert int(want.macro_ops.abs().sum()) == 0
        assert int(want.macro_aborts.abs().sum()) == 0
    if case.startswith(("chain", "fabric")):
        # the chain's rows saw commits, and its hops hold survivors
        assert float(want.hop_stats[:, 1:, 1].sum()) > 0
        if track:
            assert float(want.recov_h[:, 1:].sum()) > 0
    if case.startswith("fabric"):
        assert kw["n_leaves_max"] > 1
    if case in ("fabric_crash", "epochs_fabric"):
        # some cell's survivors sit on at least two leaves
        assert int(((want.recov_l > 0).sum(1) >= 2).sum()) > 0
    if case.startswith("epochs"):
        assert args[11].shape[1] == (3 if case == "epochs_mixed" else 2)
    if case in INSTANTIATION:
        assert cs.instantiation(kw["max_pbe"], kw["n_deep_max"],
                                kw["n_leaves_max"], args[11].shape[1],
                                macro) == INSTANTIATION[case]


@pytest.mark.parametrize("seed", range(4))
def test_emulated_warp_primitives(libs, seed):
    """The emulation of __clz and __reduce_or_sync, and the chain's
    tat_first_each (the lowest live slot with the lane's tag, or -1),
    nth_set_bit and tat_first_key (the least key over the warp), against
    their definitions."""
    rng = np.random.default_rng(seed)
    req = rng.integers(0, 12, 32).astype(np.int32)
    tag = rng.integers(0, 12, 64).astype(np.int32)
    live = (rng.random(64) < 0.5).astype(np.int32)
    masks = rng.integers(1, 1 << 32, 32, dtype=np.uint64).astype(np.uint32)
    masks[:3] = (1, 1 << 31, 0)
    ks = np.array([rng.integers(0, max(bin(int(m)).count("1"), 1))
                   for m in masks], np.int32)
    keys = np.where(rng.random(32) < 0.7, 0x7fffffff,
                    rng.integers(0, 3 << 8, 32)).astype(np.int32)
    ored = np.zeros(32, np.uint32)
    clz, first, nth, least = (np.zeros(32, np.int32) for _ in range(4))
    fn = libs["cell_scan"].warp_primitives
    fn.argtypes = [ctypes.c_void_p] * 11
    fn(*(a.ctypes.data for a in (req, tag, live, masks, ks, keys, clz,
                                 ored, first, nth, least)))
    assert (ored == np.bitwise_or.reduce(masks)).all()
    assert (least == keys.min()).all()
    for lane in range(32):
        assert clz[lane] == 32 - int(masks[lane]).bit_length()
        hits = [s for s in range(64) if live[s] and tag[s] == req[lane]]
        assert first[lane] == (hits[0] if hits else -1)
        bits = [b for b in range(32) if int(masks[lane]) >> b & 1]
        if bits:
            assert nth[lane] == bits[ks[lane]]


@pytest.mark.parametrize("q", [9, 32, 48, 64, 80, 130, 384])
def test_emulated_chunk_sum_equals_xla_sum(libs, q):
    """The kernel's commit-latency sum adds a batch's addends in the
    order of the eager ``chain.xla_sum`` (the reference's XLA order)."""
    from repro_torch.core.engine.chain import xla_sum
    fn = libs["cell_scan"].chunk_sum
    fn.restype = ctypes.c_double
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    rng = np.random.default_rng(q)
    for _ in range(50):
        v = rng.standard_normal(q) * 10.0 ** rng.integers(-3, 8, q)
        v[rng.random(q) < 0.5] = 0.0
        pos = np.flatnonzero(v).astype(np.int32)
        vals = np.ascontiguousarray(v[pos])
        got = fn(q, len(pos), pos.ctypes.data, vals.ctypes.data)
        assert got == float(xla_sum(torch.tensor(v))), q


@pytest.mark.parametrize("b,h,hkv,s,d,causal,window,dtype", [
    (1, 2, 2, 128, 32, True, None, torch.float32),
    (1, 2, 2, 128, 32, True, 48, torch.float32),
    (1, 2, 2, 128, 32, False, None, torch.float32),
    (1, 2, 2, 96, 16, False, 40, torch.float32),
    (2, 4, 2, 70, 16, True, None, torch.float32),
    (1, 3, 1, 64, 64, True, None, torch.bfloat16)])
def test_emulated_flash_attention_equals_plain(model_libs, b, h, hkv, s, d,
                                               causal, window, dtype):
    """The FMA kernel (f32) and the tensor-core kernel (bf16) on strided
    (B, S, H, D) views, as the model passes them; GQA; ragged S; bf16
    loads and stores."""
    rng = np.random.default_rng(s + d + h)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, n, d))
                                .astype(np.float32)).to(dtype)
               .transpose(1, 2) for n in (h, hkv, hkv))
    out = torch.empty_like(q)
    assert out.stride() == q.stride()
    name, entry = fa.FMA_F32 if dtype == torch.float32 else fa.TC_BF16
    assert fa.launch(model_libs[name], q, k, v, out, causal=causal,
                     window=window, stream=None, entry=entry) == 0
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    assert float((out.float() - want.float()).abs().max()) < tol


def _by_dtype(rows):
    """Rows ending in a dtype: bf16 rows keep the ids they had before the
    dtype column, f32 rows get an ``f32-`` prefix."""
    return [pytest.param(*r, id=("f32-" if r[-1] == torch.float32 else "")
                         + "-".join(str(x) for x in r[:-1])) for r in rows]


@pytest.mark.parametrize("b,h,hkv,s,d,causal,window,dtype", _by_dtype([
    (1, 3, 1, 100, 64, True, None, torch.bfloat16),   # GQA g = 3, ragged S
    (1, 3, 1, 200, 64, True, 64, torch.bfloat16),     # window: empty rows
    (1, 2, 2, 96, 128, False, None, torch.bfloat16),
    (1, 2, 1, 130, 128, True, 64, torch.bfloat16),
    (1, 3, 1, 70, 256, True, None, torch.bfloat16),
    (2, 2, 1, 64, 32, True, None, torch.bfloat16),    # D < 64: zero-padded
    (1, 3, 1, 100, 64, True, None, torch.float32),
    (1, 3, 1, 200, 64, True, 64, torch.float32),
    (1, 2, 2, 96, 128, False, None, torch.float32),
    (1, 2, 1, 130, 128, True, 64, torch.float32),
    (2, 2, 1, 64, 32, True, None, torch.float32),
    (1, 2, 1, 70, 16, False, 40, torch.float32)]))
def test_emulated_flash_tc_equals_plain(model_libs, b, h, hkv, s, d, causal,
                                        window, dtype):
    """The tensor-core kernel's body, its wgmma, copies and swizzle done
    by the twin header on the PTX ISA's documented layouts, in the
    model's strided (B, S, H, D) layout: GQA, window, ragged S; bf16, and
    f32 in three bf16 parts (its own entry) at the f32 limit."""
    rng = np.random.default_rng(3 * s + d + h)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, n, d))
                                .astype(np.float32)).to(dtype)
               .transpose(1, 2) for n in (h, hkv, hkv))
    out = torch.empty_like(q)
    name, entry = fa.route(dtype, d)
    assert name == "flash_attention_tc"
    assert fa.launch(model_libs[name], q, k, v, out, causal=causal,
                     window=window, stream=None, entry=entry) == 0
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    assert bool(torch.isfinite(out.float()).all())
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    assert float((out.float() - want.float()).abs().max()) < tol


def test_flash_routes_by_dtype(model_libs):
    """bf16 takes the tensor-core kernel at every head dim, f32 takes it up
    to D = 128 and the FMA kernel at D = 256; an f32 input at D = 256 run
    through its route's emulated kernel holds 2e-5, the tensor-core
    kernel refuses it, and a head dim no route takes raises."""
    assert all(fa.route(torch.bfloat16, d) == fa.TC_BF16
               for d in fa.HEAD_DIMS)
    assert [fa.route(torch.float32, d) for d in fa.HEAD_DIMS] == \
        [fa.TC_F32] * 4 + [fa.FMA_F32]
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 70, n, 256))
                                .astype(np.float32)).transpose(1, 2)
               for n in (3, 1, 1))
    out = torch.empty_like(q)
    name, entry = fa.route(q.dtype, 256)
    assert fa.launch(model_libs[name], q, k, v, out, causal=True,
                     window=None, stream=None, entry=entry) == 0
    want = flash_attention_ref(q, k, v, causal=True)
    assert float((out - want).abs().max()) < 2e-5
    assert fa.launch(model_libs["flash_attention_tc"], q, k, v, out,
                     causal=True, window=None, stream=None,
                     entry=fa.TC_F32[1]) != 0
    with pytest.raises(AttributeError):   # the FMA library has no bf16 entry
        model_libs[name].flash_attention_tc_launch
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q[..., :48], k[..., :48], v[..., :48])


def _ssd_case(seed, b, s, h, p, n, init, dtype):
    """x, B and C as strided slices of one projection, as in the model;
    dt and A in f32; a carried-in state or None."""
    rng = np.random.default_rng(seed)
    xbc = torch.from_numpy(rng.standard_normal((b, s, h * p + 2 * n))
                           .astype(np.float32)).to(dtype)
    x = xbc[..., :h * p].reshape(b, s, h, p)
    B, C = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (b, s, h))
                          .astype(np.float32))
    A = torch.from_numpy(-rng.uniform(0.5, 1.5, h).astype(np.float32))
    st = (torch.from_numpy(rng.standard_normal((b, h, p, n))
                           .astype(np.float32)) if init else None)
    return x, dt, A, B, C, st


def _run_ssd(model_libs, x, dt, A, B, C, st, *, chunk, route=None):
    """The emulated kernel of ``route`` (default: the wrapper's route for
    x's dtype and shape); returns (y, fin).  Both start as NaN, so an
    output the kernel leaves unwritten fails the check."""
    b, s, h, p = x.shape
    y = torch.full((b, s, h, p), float("nan"), dtype=x.dtype)
    fin = torch.full((b, h, p, B.shape[-1]), float("nan"))
    name, _ = route or ss.route(x.dtype, chunk, p, B.shape[-1])
    if name == "ssd_scan_tc":
        rc = ss.launch_tc(model_libs[name], x, dt, A, B, C, st, y, fin,
                          ss.sync_buffer(x), chunk=chunk, stream=None)
    else:
        rc = ss.launch(model_libs[name], x, dt, A, B, C, st, y, fin,
                       chunk=chunk, stream=None)
    assert rc == 0
    return y, fin


@pytest.mark.parametrize("s,chunk,init,dtype", [
    (128, 64, False, torch.float32), (100, 64, True, torch.float32),
    (200, 128, True, torch.float32), (64, 64, False, torch.bfloat16)])
def test_emulated_ssd_scan_equals_plain(model_libs, s, chunk, init, dtype):
    """The FMA kernel (f32) and the tensor-core kernel (bf16) on x, B and
    C as strided slices of one projection, as in the model; ragged S; a
    carried-in state."""
    x, dt, A, B, C, st = _ssd_case(s + chunk, 1, s, 2, 16, 32, init, dtype)
    y, fin = _run_ssd(model_libs, x, dt, A, B, C, st, chunk=chunk,
                      route=ss.FMA_F32 if dtype == torch.float32 else None)
    wy, wfin = ssd_scan_ref(x, dt, A, B, C, chunk=chunk, init_state=st)
    tol = 1e-4 if dtype == torch.float32 else 1e-1
    assert float((y.float() - wy.float()).abs().max()) < tol
    assert float((fin - wfin).abs().max()) < tol


@pytest.mark.parametrize("b,s,h,p,n,chunk,init,dtype", _by_dtype([
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
    x, dt, A, B, C, st = _ssd_case(7 * s + p + n, b, s, h, p, n, init,
                                   dtype)
    assert ss.route(dtype, chunk, p, n)[0] == "ssd_scan_tc"
    y, fin = _run_ssd(model_libs, x, dt, A, B, C, st, chunk=chunk)
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
    x, dt, A, B, C, st = _ssd_case(5, 1, 150, 3, 16, 32, True,
                                   torch.float32)
    y, fin = _run_ssd(model_libs, x, dt, A, B, C, st, chunk=32)
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


SPLIT_LAUNCH = r'''
extern "C" void split_parts_n(const float* a, uint32_t* out, int n,
                              int parts) {
  emu_run(1, [&] {
    for (int i = 0; i < n; i += 2) {
      uint32_t p3[3], p2[2];
      if (parts == 3) wg::split_parts(a[i], a[i + 1], p3);
      else wg::split_parts(a[i], a[i + 1], p2);
      for (int s = 0; s < parts; ++s)
        out[(i / 2) * parts + s] = parts == 3 ? p3[s] : p2[s];
    }
  });
}
'''


def _split_values():
    """Values near powers of two (a few ulps either side), subnormals,
    +-0 and random normals, in f32."""
    rng = np.random.default_rng(0)
    near = [np.nextafter(np.float32(2.0) ** k, np.float32(sgn * np.inf),
                         dtype=np.float32)
            for k in range(-100, 120, 7) for sgn in (1, -1)]
    ulps = [np.float32(2.0) ** k * np.float32(1 + j * 2.0 ** -23)
            for k in (-3, 0, 5) for j in range(-3, 4)]
    sub = [np.float32(v) for v in (1e-45, 3e-42, 1.17e-38, 5.9e-39, -2e-40)]
    tiny = [np.float32(2.0) ** -115 * np.float32(1.337)]
    vals = np.array(near + ulps + sub + tiny + [0.0, -0.0], np.float32)
    rand = (rng.standard_normal(512) * np.exp(rng.uniform(-20, 20, 512)))
    vals = np.concatenate([vals, rand.astype(np.float32)])
    return vals if vals.size % 2 == 0 else np.append(vals, np.float32(1))


@pytest.mark.parametrize("parts", [2, 3])
def test_split_parts_exact(tmp_path, parts):
    """``wg::split_parts`` (csrc/wgmma_tile.cuh): the first part is the
    value rounded to bf16 (as torch rounds), each part rounds what the
    parts before it left, three parts give back every f32 down to 2^-110
    exactly (below, within half of bf16's smallest subnormal, 2^-134)
    and two parts to 2^-17 relative; +-0 keeps its sign."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to build the emulated kernels")
    cpp = tmp_path / "split.cpp"
    cpp.write_text(f'#include "{EMUL / "cuda_emul.h"}"\n'
                   f'#include "{EMUL / "hopper.cuh"}"\n'
                   f'#include "{CSRC / "wgmma_tile.cuh"}"\n' + SPLIT_LAUNCH)
    so = tmp_path / "libsplit.so"
    subprocess.run([gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC",
                    "-shared", "-pthread", f"-I{EMUL}", "-o", str(so),
                    str(cpp)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    a = _split_values()
    out = np.zeros(a.size // 2 * parts, np.uint32)
    lib.split_parts_n.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_int]
    lib.split_parts_n(a.ctypes.data, out.ctypes.data, a.size, parts)
    words = out.reshape(-1, parts)
    # part s of value 2i is the low half of word s, of value 2i + 1 the high
    halves = np.stack([words & 0xFFFF, words >> 16], axis=1)  # (n/2, 2, P)
    bits = halves.reshape(-1, parts).astype(np.uint32) << 16
    p = bits.view(np.float32).astype(np.float64)             # (n, parts)
    hi = torch.from_numpy(a).bfloat16().float().numpy()
    assert np.array_equal(p[:, 0].astype(np.float32).view(np.uint32),
                          hi.view(np.uint32))
    total = p.sum(axis=1)
    err = np.abs(total - a.astype(np.float64))
    if parts == 3:
        big = np.abs(a) >= 2.0 ** -110
        assert np.all(err[big] == 0)
        assert np.all(err[~big] <= 2.0 ** -134)
    else:
        assert np.all(err <= 2.0 ** -17 * np.abs(a.astype(np.float64))
                      + 2.0 ** -134)
    zero = a == 0
    assert np.array_equal(np.signbit(p[zero, 0]), np.signbit(a[zero]))


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
