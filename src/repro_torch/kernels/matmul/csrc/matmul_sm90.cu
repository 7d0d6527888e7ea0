// K1 on the tensor cores: bf16 x @ w with an fp32 accumulator, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/matmul/kernel.py::matmul_pallas
// (body _matmul_kernel) for bf16 operands whose K and N are multiples of 8
// (TMA needs 16-byte strides); fp32 and other shapes stay on the CUDA-core
// kernel in matmul.cu.  The same function: (M,K) @ (K,N) -> (M,N) bf16,
// fp32 accumulation, one round-to-nearest-even cast on store.
//
// What bounds it on the card: at the main path's shape (32768x3584) @
// (3584x12288) it does 2*M*N*K = 2.9e12 operations on 0.13 GB of x, w and
// out, about 1000 operations per byte against the H100's ~295 for bf16, so
// it is bound by the tensor cores (989 TFLOP/s), not by memory.
//
// What the design does about it: each block computes a 128x256 output tile
// with two consumer warpgroups of 64x256 each, issuing
// wgmma.m64n256k16 (bf16 in, fp32 accumulators in registers, 128 a
// thread).  One producer thread keeps a ring of 4 stages of 48 KB full
// with TMA: the x tile (128x64, K-major) and the w tile (64x256) as it lies
// in memory, N contiguous, i.e. MN-major, read by wgmma's transposed-B
// form, so w is never transposed (the fused mm+RS calls K1 8 times on one
// w).  Both tiles land with the 128-byte swizzle that wgmma's descriptors
// name.  Full/empty mbarriers pace the ring (the producer arms `full` with
// the stage's byte count); each consumer keeps one k-tile of wgmma in
// flight and frees a stage once the wgmma that read it has retired.
// setmaxnreg moves registers from the producer warpgroup (40) to the
// consumers (232).  Blocks walk the output in groups of 16 row tiles, so
// the tiles running at once share x rows and w columns in L2.
//
// The contract fusion rests on: each output element is one fp32 sum over
// the K tiles in increasing order, each tile's 4 k-steps in order, on the
// tensor cores, whatever M, the tile a row lands in, or how many rows a
// call has: tile shape, K order and route depend on dtype, K and N only.
// No split-K, no atomics.  So per-chunk calls are bit-identical to one
// whole-M call.  TMA zero-fills the ragged edges of loads; stores are
// masked at the ragged M and N edges.

#include "../../csrc/geometry.cuh"
#include "../../csrc/sm90.cuh"

namespace {

using namespace sm90;

constexpr int BM = 128;
constexpr int BN = 256;
constexpr int BK = 64;
constexpr int STAGES = 4;
constexpr int THREADS = 384;               // 2 consumer warpgroups + 1 producer warpgroup
constexpr int A_BYTES = BM * BK * 2;       // x tile, 128 rows of 128 bytes
constexpr int B_BOX_BYTES = BK * 64 * 2;   // one TMA box of w: 64 k-rows x 64 n
constexpr int B_BYTES = (BN / 64) * B_BOX_BYTES;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;  // 48 KB
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
constexpr int GROUP_M = 16;                // row tiles per raster group

// D(64x256, fp32) (+)= A(64x16, smem, K-major) * B(16x256, smem, MN-major)
__device__ __forceinline__ void wgmma_m64n256k16_ss_tb1(float* d, uint64_t da, uint64_t db,
                                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__global__ void __launch_bounds__(THREADS, 1)
matmul_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap, __nv_bfloat16* __restrict__ out,
                   int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;  // swizzle atoms need 1024
  const uint32_t bars = base + STAGES * STAGE_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };

  const int tiles_m = (M + BM - 1) / BM;
  const int tiles_n = (N + BN - 1) / BN;
  const int per_group = GROUP_M * tiles_n;
  const int first_m = (blockIdx.x / per_group) * GROUP_M;
  const int group_m = min(GROUP_M, tiles_m - first_m);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % group_m) * BM;
  const int n0 = (in_group / group_m) * BN;
  const int n_k = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);   // the producer's arrive.expect_tx (+ the bytes)
      mbar_init(empty(s), 2);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer warpgroup: one thread issues every TMA load
    regs_dealloc<40>();
    if (threadIdx.x == 256) {
      prefetch_tensormap(&xmap);
      prefetch_tensormap(&wmap);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < n_k; ++kt) {
        mbar_wait(empty(stage), phase ^ 1);
        const uint32_t sa = base + stage * STAGE_BYTES;
        mbar_arrive_expect_tx(full(stage), STAGE_BYTES);
        tma_load_2d(sa, &xmap, full(stage), kt * BK, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j) {
          tma_load_2d(sa + A_BYTES + j * B_BOX_BYTES, &wmap, full(stage), n0 + 64 * j, kt * BK);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // consumer warpgroup wg: output rows m0 + 64*wg .. +63
    regs_alloc<232>();
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;

    int stage = 0, prev = -1;
    uint32_t phase = 0;
    for (int kt = 0; kt < n_k; ++kt) {
      mbar_wait(full(stage), phase);
      const uint32_t sa = base + stage * STAGE_BYTES + wg * (64 * 128);
      const uint32_t sb = base + stage * STAGE_BYTES + A_BYTES;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // A: +32 bytes per 16 k inside the swizzle atom; rows 8 apart by 1024.
        // B: +16 k-rows of 128 bytes per k-step; n blocks of 64 a box apart.
        wgmma_m64n256k16_ss_tb1(acc, desc_sw128(sa + 32 * kk, 16, 1024),
                                desc_sw128(sb + 2048 * kk, B_BOX_BYTES, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous k-tile's wgmma has retired: free its stage
      fence_regs(acc);
      if (prev >= 0 && threadIdx.x % 128 == 0) mbar_arrive(empty(prev));
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // accumulator fragment: warp w of the warpgroup holds rows 16w..16w+15;
    // acc[4j + 2h + e] is row lane/4 + 8h, column 8j + 2*(lane%4) + e
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int row = m0 + wg * 64 + (t / 32) * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      if (col >= N) continue;  // N % 8 == 0: col < N implies col + 1 < N
      if (row < M) {
        *reinterpret_cast<uint32_t*>(out + (int64_t)row * N + col) =
            pack_bf16x2(acc[4 * j], acc[4 * j + 1]);
      }
      if (row + 8 < M) {
        *reinterpret_cast<uint32_t*>(out + (int64_t)(row + 8) * N + col) =
            pack_bf16x2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

// The launch: one block per 128x256 output tile, the tiles of the raster above.
geometry::Launch launch_geometry(int M, int N) {
  return {dim3(((M + BM - 1) / BM) * ((N + BN - 1) / BN)), THREADS, SMEM_BYTES};
}

}  // namespace

// Plain C interface for ctypes: bf16 x (M,K) @ w (K,N) -> out (M,N), all
// contiguous and 16-byte aligned, K % 8 == 0 and N % 8 == 0.  Returns 0
// when the kernel launched, else cudaGetLastError() or an sm90.cuh code.
extern "C" int pccl_matmul_sm90(const void* x, const void* w, void* out, int M, int N, int K,
                                void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 || N % 8) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t xstrides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t xbox[2] = {BK, BM};
  const cuuint64_t wdims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t wstrides[1] = {(cuuint64_t)N * 2};
  const cuuint32_t wbox[2] = {64, BK};
  int err = make_map_bf16(&xmap, x, 2, xdims, xstrides, xbox);
  if (err != 0) return err;
  err = make_map_bf16(&wmap, w, 2, wdims, wstrides, wbox);
  if (err != 0) return err;
  const geometry::Launch g = launch_geometry(M, N);
  cudaError_t e = cudaFuncSetAttribute(matmul_sm90_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  matmul_sm90_kernel<<<g.grid, g.threads, g.smem, static_cast<cudaStream_t>(stream)>>>(
      xmap, wmap, static_cast<__nv_bfloat16*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// What pccl_matmul_sm90 launches for (M, N): grid, threads, dynamic smem
// and (attrs, may be null) the kernel's static smem and thread limit.
extern "C" int pccl_matmul_sm90_geometry(int M, int N, int* grid3, int* threads, long long* smem,
                                         long long* attrs) {
  return geometry::export_launch(launch_geometry(M, N), matmul_sm90_kernel, grid3, threads, smem,
                                 attrs);
}
