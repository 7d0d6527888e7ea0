// cp.async building blocks shared by the port's CUDA-core kernels
// (matmul/csrc/matmul.cu, flash/csrc/flash.cu): asynchronous copies from
// device memory into shared memory, 4 or 16 bytes a thread, that zero-fill
// what is masked, and their commit / wait groups.
//
// A copy with `ok` false reads nothing (its source size is 0) and writes
// zeros, so a ragged edge costs no branch; its source pointer is then only
// a placeholder, which callers set to the tensor's base.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace cp_async {

using sm90::smem_addr;

// 4 bytes through L1 (`.ca`: the only cache mode a 4-byte copy may take).
__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

// 16 bytes, bypassing L1 (`.cg`); dst and src on 16 bytes.
__device__ __forceinline__ void copy16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Waits until at most `pending` of this thread's committed groups are in
// flight.  Other threads' copies are seen only after a barrier.
template <int pending>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

}  // namespace cp_async
