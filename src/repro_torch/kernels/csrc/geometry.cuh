// What one launch of a kernel is given: its grid, threads per block and
// dynamic shared memory.  Each launcher of the port computes a Launch with
// one function and launches with it; the library's `*_geometry` export
// hands the same numbers to the host, where the kernel lint's launch model
// (repro_torch/analysis/launch_model.py) is held to them on the card.

#pragma once

#include <cuda_runtime.h>

namespace geometry {

struct Launch {
  dim3 grid;
  int threads;
  int smem;  // dynamic shared memory per block, bytes
};

// The body of every `*_geometry` export: g into grid3[3], threads and smem;
// with attrs (may be null), the kernel's static shared memory and the most
// threads a block of it may have, from cudaFuncGetAttributes.  Host only;
// launches nothing.  Returns 0 or the CUDA error.
template <typename Kernel>
int export_launch(const Launch& g, Kernel* kernel, int* grid3, int* threads, long long* smem,
                  long long* attrs) {
  grid3[0] = static_cast<int>(g.grid.x);
  grid3[1] = static_cast<int>(g.grid.y);
  grid3[2] = static_cast<int>(g.grid.z);
  *threads = g.threads;
  *smem = g.smem;
  if (attrs != nullptr) {
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
    if (e != cudaSuccess) return static_cast<int>(e);
    attrs[0] = static_cast<long long>(a.sharedSizeBytes);
    attrs[1] = static_cast<long long>(a.maxThreadsPerBlock);
  }
  return 0;
}

}  // namespace geometry
