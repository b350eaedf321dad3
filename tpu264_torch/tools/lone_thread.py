"""Latencies a lone CUDA thread sees, measured on the card.

    python -m tpu264_torch.tools.lone_thread

The CABAC coder (kernel K1) is one thread a slice: its time is the number
of instructions on its path times what a thread that has no other warp to
hide behind waits for each.  This script measures those waits: a chain of
dependent instructions of one type (add, byte permute, variable shift,
select, count-leading-zeros, shared-memory load) and a loop whose only
content is a taken branch, each run by one thread of one block, timed
with `clock64()` (cycles an instruction) and with CUDA events (so the
clock the card ran at shows too).  It prints one JSON object.

It compiles its own small CUDA source with `nvcc` (the one the kernel
library is built with) and needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from tpu264_torch.kernels import _build

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

#define REP16(s) s s s s s s s s s s s s s s s s

// kind: 0 add, 1 byte permute, 2 variable shift, 3 select on a predicate
// made from the value, 4 count leading zeros, 5 shared-memory load,
// 6 a loop of one taken branch, an add and a compare
__global__ void chain_kernel(int kind, int n, uint32_t seed, uint32_t* out,
                             long long* cycles) {
  __shared__ uint32_t ring[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    ring[i] = (uint32_t)((i * 37 + 11) & 255) * 4u;
  __syncthreads();
  if (threadIdx.x != 0) return;
  uint32_t x = seed, y = seed | 1u;
  const long long t0 = clock64();
  if (kind == 0) {
    for (int i = 0; i < n; i += 16) {
      REP16(asm volatile("add.u32 %0, %0, %1;" : "+r"(x) : "r"(y));)
    }
  } else if (kind == 1) {
    for (int i = 0; i < n; i += 16) {
      REP16(asm volatile("prmt.b32 %0, %0, %1, %0;" : "+r"(x) : "r"(y));)
    }
  } else if (kind == 2) {
    for (int i = 0; i < n; i += 16) {
      REP16(asm volatile("shl.b32 %0, %1, %0;" : "+r"(x) : "r"(y));)
    }
  } else if (kind == 3) {
    for (int i = 0; i < n; i += 16) {
      REP16(asm volatile("{ .reg .pred p; setp.lt.u32 p, %0, %1; "
                         "selp.u32 %0, %1, %0, p; }" : "+r"(x) : "r"(y));)
    }
  } else if (kind == 4) {
    for (int i = 0; i < n; i += 16) {
      REP16(asm volatile("clz.b32 %0, %0;" : "+r"(x));)
    }
  } else if (kind == 5) {
    uint32_t a = (uint32_t)__cvta_generic_to_shared(ring) + (seed & 0x3FCu);
    const uint32_t base = (uint32_t)__cvta_generic_to_shared(ring);
    for (int i = 0; i < n; i += 16) {
      REP16(asm volatile("{ .reg .u32 t; ld.shared.u32 t, [%0]; "
                         "add.u32 %0, t, %1; }" : "+r"(a) : "r"(base)
                         : "memory");)
    }
    x = a;
  } else {
    int i = 0;
    asm volatile("{ .reg .pred p;\n"
                 "LOOP:\n"
                 " add.s32 %0, %0, 1;\n"
                 " setp.lt.s32 p, %0, %1;\n"
                 " @p bra LOOP;\n"
                 "}" : "+r"(i) : "r"(n));
    x = (uint32_t)i;
  }
  const long long t1 = clock64();
  out[0] = x;
  cycles[0] = t1 - t0;
}

extern "C" int lone_thread_chain(int kind, int n, uint32_t* out,
                                 long long* cycles, void* stream) {
  chain_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(kind, n, 12345u, out,
                                                   cycles);
  return (int)cudaGetLastError();
}
"""

KINDS = ["add", "byte_permute", "variable_shift", "compare_and_select",
         "count_leading_zeros", "shared_load_and_add", "taken_branch_loop"]
# instructions on the dependent chain of one repetition of each kind
CHAIN_LEN = [1, 1, 1, 2, 1, 2, 3]


def main() -> int:
    if not torch.cuda.is_available():
        print("lone_thread needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    n = 1 << 20
    res = {"card": smi.stdout.strip().splitlines()[0], "repetitions": n,
           "kinds": {}}
    with tempfile.TemporaryDirectory() as tmp:
        src, so = Path(tmp) / "lone_thread.cu", Path(tmp) / "lone_thread.so"
        src.write_text(SOURCE)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                        str(so), str(src)], check=True)
        lib = ctypes.CDLL(str(so))
        out = torch.zeros(1, dtype=torch.int32, device="cuda")
        cyc = torch.zeros(1, dtype=torch.int64, device="cuda")
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        for kind, name in enumerate(KINDS):
            def run():
                err = lib.lone_thread_chain(
                    kind, n, ctypes.c_void_p(out.data_ptr()),
                    ctypes.c_void_p(cyc.data_ptr()), stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
            run()
            torch.cuda.synchronize()
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            t0.record()
            run()
            t1.record()
            torch.cuda.synchronize()
            ms, cycles = t0.elapsed_time(t1), int(cyc[0])
            res["kinds"][name] = {
                "cycles_a_repetition": cycles / n,
                "chain_instructions": CHAIN_LEN[kind],
                "ns_a_repetition": 1e6 * ms / n,
                "clock_ghz": cycles / (1e6 * ms)}
    print(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
