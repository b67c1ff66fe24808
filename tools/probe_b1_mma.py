#!/usr/bin/env python3
"""Throughput probe: Hopper's 1-bit tensor-core product against the int8
tensor cores and the CUDA cores' XOR + popcount.

    python3 tools/probe_b1_mma.py

Builds one small CUDA source per instruction with nvcc (sm_90a) into
``build/probe_b1_mma/`` and times a register-only loop of it over the whole
card with CUDA events (no memory traffic: the instruction's own rate):

  * ``mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.xor.popc`` and the
    ``.and.popc`` form (the PTX ISA has both from sm_80 on);
  * ``mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32`` (the int8 tensor
    cores, for scale);
  * ``__popc(a ^ w)`` summed in int32 on the CUDA cores (32 +/-1 products
    a word).

Each line gives the +/-1 (or int8) multiply-adds per second as operations
(two a product, as the published peaks count them).  It decides which unit
the wide-rows kernel of ``src/repro_torch/csrc/binary_matmul.cu`` is built
on.  Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "probe_b1_mma"

HEAD = r"""
#include <cuda_runtime.h>
#include <stdint.h>
constexpr int ILP = 8;
"""

# body of the timed loop for one accumulator set d[j]: (instruction, MACs a
# warp per instruction)
MMA_B1 = r"""
__device__ __forceinline__ void op(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.BITOP.popc "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
"""

MMA_S8 = r"""
__device__ __forceinline__ void op(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
"""

POPC = r"""
__device__ __forceinline__ void op(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += __popc(a[i] ^ b0);
}
"""

KERNEL = r"""
__global__ void probe(int* out, int iters) {
  uint32_t a[4] = {threadIdx.x * 2654435761u, threadIdx.x ^ 0x9e3779b9u,
                   blockIdx.x * 40503u, threadIdx.x + 12345u};
  uint32_t b0 = threadIdx.x * 97u + 1u, b1 = blockIdx.x * 31u + 7u;
  int d[ILP][4];
#pragma unroll
  for (int j = 0; j < ILP; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < ILP; ++j) op(d[j], a, b0 ^ (0x9e3779b9u * j), b1);
    b0 = b0 * 1664525u + 1013904223u;      // no two POPCs on the same operands
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < ILP; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s += d[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" cudaError_t run(void* out, int blocks, int threads, int iters, cudaStream_t st) {
  probe<<<blocks, threads, 0, st>>>(static_cast<int*>(out), iters);
  return cudaGetLastError();
}
"""

# name: (source, multiply-adds a warp per op() call)
CASES = {
    "b1 mma m16n8k256 .xor.popc": (MMA_B1.replace("BITOP", "xor"),
                                   16 * 8 * 256),
    "b1 mma m16n8k256 .and.popc": (MMA_B1.replace("BITOP", "and"),
                                   16 * 8 * 256),
    "s8 mma m16n8k32": (MMA_S8, 16 * 8 * 32),
    "CUDA cores __popc(a ^ w)": (POPC, 32 * 4 * 32),   # 32 lanes x 4 words
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA device")
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"nvidia-smi: {smi.stdout.strip()}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads, iters = sms * 8, 128, 4096
    ilp = 8
    out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ok = True
    for i, (name, (body, macs_warp)) in enumerate(CASES.items()):
        src = OUT / f"case{i}.cu"
        src.write_text(HEAD + body + KERNEL)
        lib_path = OUT / f"libcase{i}.so"
        cmd = ["/usr/local/cuda/bin/nvcc", "-gencode",
               "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-o", str(lib_path), str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            print(f"{name}: nvcc refused it:\n{res.stdout}{res.stderr}")
            ok = False
            continue
        sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                               str(lib_path)], capture_output=True, text=True)
        ops = sorted({ln.split()[1].rstrip(";") for ln in sass.stdout.splitlines()
                      if ln.strip().startswith("/*") and len(ln.split()) > 1
                      and ("MMA" in ln or "POPC" in ln)})
        lib = ctypes.CDLL(str(lib_path))
        lib.run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_void_p]
        lib.run.restype = ctypes.c_int

        def launch():
            err = lib.run(out.data_ptr(), blocks, threads, iters, stream)
            assert err == 0, f"launch failed: {err}"

        launch()
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            launch()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        ms = sorted(times)[2]
        warps = blocks * threads // 32
        macs = macs_warp * ilp * iters * warps
        print(f"{name}: {ms:.3f} ms for {macs:.3e} multiply-adds, "
              f"{2 * macs / ms / 1e9:.1f} TOP/s (SASS: {' '.join(ops)})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
