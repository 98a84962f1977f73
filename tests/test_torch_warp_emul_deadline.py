"""The warp emulation's guard against a deadlock (``tests/warp_emul``): a
wait on a warp barrier, a named barrier or an mbarrier that can never
complete aborts after ``EMU_DEADLINE`` with a message that names the
barrier, its count and its arrivals, instead of holding its test until
the suite's time limit.  An arrival that comes early for the next phase
(after the arrival that completes a phase, before the phase moves on)
waits for that next phase: one that passed it at once would hide a
missing synchronisation.  The program is built with a deadline of one
second (``EMU_DEADLINE_S``)."""
from __future__ import annotations

import shutil
import subprocess

import pytest

from _warp_emul import EMUL

PROGRAM = r'''
#include "cuda_emul.h"
#include "hopper.cuh"
#include <cstdlib>

int main(int argc, char** argv) {
  const int which = std::atoi(argv[1]);
  if (which == 3) {  // phase 5 has both arrivals, its end not yet made
    EmuBarrier b(2, "early", 0);
    b.word.store((uint64_t{5} << 32) | 2);
    const unsigned p = b.arrive();  // counts toward phase 6
    b.word.fetch_add((uint64_t{1} << 32) - 2);  // the completer ends 5
    b.wait(p);  // phase 6 has 1 of its 2 arrivals: waits, then aborts
    return 0;
  }
  emu_run(1, [which] {
    if (which == 0) {         // lane 5 leaves before the warp's sync
      if (threadIdx.x != 5) __syncwarp();
    } else if (which == 1) {  // a named barrier of two warps, one arrives
      wg::bar_sync(1, 64);
    } else {                  // an mbarrier on which no thread arrives
      if (threadIdx.x == 0) wg::mbar_init(0, 1);
      __syncthreads();
      wg::mbar_wait(0, 0);
    }
  });
  return 0;
}
'''

# case -> what its abort prints
CASES = {
    "warp": "warp barrier 0 of 32 threads: phase 0 never completed "
            "(31 arrived)",
    "named": "named barrier 1 of 64 threads: phase 0 never completed "
             "(32 arrived)",
    "mbarrier": "mbarrier at 0: phase 0 never completed (1 of 1 arrivals "
                "pending, 0 tx bytes)",
    "early": "early barrier 0 of 2 threads: phase 6 never completed "
             "(1 arrived)",
}


@pytest.fixture(scope="module")
def program(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to build the emulated kernels")
    out = tmp_path_factory.mktemp("deadline")
    (out / "deadline.cpp").write_text(PROGRAM)
    subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", f"-I{EMUL}",
                    "-DEMU_DEADLINE_S=1", "-o", str(out / "deadline"),
                    str(out / "deadline.cpp")], check=True)
    return out


@pytest.mark.parametrize("case", CASES)
def test_a_wait_that_cannot_complete_aborts_naming_its_barrier(program,
                                                               case):
    proc = subprocess.run([str(program / "deadline"),
                           str(list(CASES).index(case))], cwd=program,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0
    assert CASES[case] in proc.stderr, proc.stderr
