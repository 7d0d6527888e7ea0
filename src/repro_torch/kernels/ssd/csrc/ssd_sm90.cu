// K4 on the tensor cores: the bf16 Mamba-2 SSD chunked scan for Hopper
// (sm_90a), at P = N = chunk = 64 (Zamba2's head dim, state size and chunk).
//
// Replaces the TPU kernel src/repro/kernels/ssd/kernel.py::ssd_pallas (body
// _ssd_kernel) for bf16 X, B and C; fp32 and other shapes stay on the
// CUDA-core route in ssd.cu.  The same function as there (ssd.cu's note):
// Y (B,S,H,P) and the final state in X's dtype, from an fp32 initial state,
// with B and C shared across heads (B,S,N) or per head (B,S,H,N).
//
// The TPU carried the state R across a sequential chunk grid axis; Hopper's
// blocks run in no order.  So the scan is three passes (ssd_common.cuh), and
// passes 1 and 3 have one independent 64 x 64 tile product per (b, h,
// chunk): 20,480 blocks of one warpgroup at Zamba2's prefill (4, 4096, 80,
// 64), where one block per (b, h) walking 64 chunks in order gave 320.
//
// What bounds each pass, and what the design does about it:
//   1. Chunk states S_c = X^T (dte * B), dte = exp(total - cum): reads X's
//      tile and B's, writes S_c in fp32 (16 KB a chunk, twice X's bytes):
//      bytes.  TMA brings both 64 x 64 tiles with the 128-byte swizzle.
//      Threads scale B's rows by dte in shared memory (the swizzle permutes
//      16-byte pieces within a row, so a row's scale ignores it) into a bf16
//      hi and lo tile, fence the async proxy, and one wgmma m64n64k16 chain
//      of 8 k-steps (X^T hi, then X^T lo), both operands MN-major (the
//      transposed-A form), sums over s.
//   2. The recurrence R = exp(total_c) R + S_c across chunks: elementwise,
//      reads S (fp32), writes R_before in bf16, the dtype pass 3 feeds to
//      wgmma: bytes.  Loads of S_c are issued 8 chunks ahead of their use.
//   3. Outputs: reads X, B, C and R_before (4 tiles by TMA), writes Y: bytes.
//      acc = C R_before^T and G = C B^T by wgmma (both K-major); acc's rows
//      are scaled by exp(cum_t), G is masked to s <= t and decayed by
//      exp(cum_t - cum_s) on its accumulator fragments into W, split into
//      bf16 hi and lo register A operands, and acc += W_hi X + W_lo X by the
//      register-A form with X MN-major.  Rows at or past S are not stored.
// Numerics: X, B, C arrive in bf16 and R_before is stored in bf16; dte * B
// and W are fp32 factors of sums over 64 steps, and one bf16 rounding of
// either puts the outputs outside the bf16 tolerance (2e-2) at the serving
// shape, so each goes to wgmma as a hi + lo pair (about 16 bits) at the
// cost of 8 k-steps instead of 4, which the card has to spare: every pass
// is bound by bytes.
// Per call that is X read twice, S written and read in fp32, R_before
// written and read in bf16, and Y written: about 1.5 GB at the serving
// shape, against 0.34 GB for X and Y alone, so the passes' floor is about
// 0.45 ms on an H100.  A single-pass scan that chains the state between
// blocks would remove S and R_before from device memory.
//
// Ragged S: X and per-head B/C have 4-D tensor maps (64, H, S, B) and shared
// B/C 3-D maps (64, S, B), so S is a dimension of its own and TMA fills rows
// at or past S with zeros instead of reading the next sequence; la reads 0
// there, as the reference pads it.  Each block's one mbarrier wait traps
// after 4 s (sm90.cuh), so a lost TMA ends the launch instead of hanging it.

#include "../../csrc/sm90.cuh"
#include "ssd_common.cuh"

namespace {

using namespace sm90;
using namespace ssd;

constexpr int L = 64;                 // chunk = P = N on this route
constexpr int THREADS = 128;          // one warpgroup
constexpr int TILE = 64 * 64 * 2;     // one bf16 64 x 64 tile: 64 rows of 128 bytes
constexpr int STATES_SMEM = 1024 + 3 * TILE + 16 + L * 4;
constexpr int OUTPUTS_SMEM = 1024 + 4 * TILE + 16 + L * 4;

// D(64x64, fp32) (+)= A(64x16, smem, K-major) * B(16x64, smem, K-major): C R^T and C B^T
__device__ __forceinline__ void wgmma_m64n64k16_ss_tb0(float* d, uint64_t da, uint64_t db,
                                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64x64, fp32) += A(64x16, bf16 registers) * B(16x64, smem, MN-major): acc += W X
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb1(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The chunk's B or C tile: a 4-D map over per-head (64, H, S, B), a 3-D map
// over shared (64, S, B).
__device__ __forceinline__ void load_bc(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                        const Chunk& k, int bc_per_head) {
  if (bc_per_head) tma_load_4d(dst, map, bar, 0, k.h, k.c * L, k.b);
  else tma_load_3d(dst, map, bar, 0, k.c * L, k.b);
}

// hi + lo in bf16, the pair that carries v to about 16 bits: the products
// that sum over a chunk's 64 steps take their fp32 factor (dte * B, W) as
// two bf16 operands, since one bf16 rounding of it alone puts K4 outside
// the bf16 tolerance at the serving shape.
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16x2(a, b);
  const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  lo = pack_bf16x2(a - h.x, b - h.y);
}

// Pass 1: S_c = X^T (dte * B) in fp32, and total_c.
__global__ void __launch_bounds__(THREADS)
ssd_states_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap bmap, const float* __restrict__ la,
                       float* __restrict__ states, float* __restrict__ totals, int S, int H,
                       int nc, int bc_per_head) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms need 1024
  uint8_t* gbase = smem_raw + (base - raw);
  // X, then dte * B as bf16 hi (in place of B) and lo
  const uint32_t xs = base, bs = base + TILE, bl = base + 2 * TILE, bar = base + 3 * TILE;
  float* cum = reinterpret_cast<float*>(gbase + 3 * TILE + 16);

  const int tid = threadIdx.x;
  const Chunk k = chunk_of_block(H, nc);
  const int s0 = k.c * L;
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(bar, 2 * TILE);  // zero-filled rows past S count too
    tma_load_4d(xs, &xmap, bar, 0, k.h, s0, k.b);
    load_bc(bs, &bmap, bar, k, bc_per_head);
  }
  if (tid < 32) chunk_cumsum(la + ((int64_t)k.b * S + s0) * H + k.h, H, min(L, S - s0), L, cum);
  __syncthreads();
  const float total = cum[L - 1];
  mbar_wait(bar, 0);

  // dte * B as hi (in place) and lo, each at B's byte offset in its tile,
  // so both keep B's swizzle: 512 pieces of 16 bytes, row = piece / 8
  for (int i = tid; i < 64 * 8; i += THREADS) {
    uint4* piece = reinterpret_cast<uint4*>(gbase + TILE + 16 * i);
    const float d = expf(total - cum[i / 8]);
    uint4 hi = *piece, lo;
    uint32_t* h = reinterpret_cast<uint32_t*>(&hi);
    uint32_t* l = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&h[j]));
      split_bf16x2(f.x * d, f.y * d, h[j], l[j]);
    }
    *piece = hi;
    *reinterpret_cast<uint4*>(gbase + 2 * TILE + 16 * i) = lo;
  }
  fence_proxy_async();
  __syncthreads();

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    // both MN-major: +16 rows of 128 bytes per k-step; X^T hi, then X^T lo
    const uint32_t b = (kk < 4 ? bs : bl) + 2048 * (kk % 4);
    wgmma_m64n64k16_ss_ta1_tb1(acc, desc_sw128(xs + 2048 * (kk % 4), TILE, 1024),
                               desc_sw128(b, TILE, 1024), kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);

  // acc[4j + 2h + e] is row (p) 16*warp + lane/4 + 8h, column (n) 8j + 2*(lane%4) + e
  const int64_t bhc = ((int64_t)k.b * H + k.h) * nc + k.c;
  float* out = states + bhc * 64 * 64;
  const int lane = tid % 32;
  const int row = (tid / 32) * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<float2*>(out + row * 64 + 8 * j + c0) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(out + (row + 8) * 64 + 8 * j + c0) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  if (tid == 0) totals[bhc] = total;
}

// Pass 3: Y = exp(cum_t) (C R_before^T) + (tril(exp(cum_t - cum_s)) * (C B^T)) X.
__global__ void __launch_bounds__(THREADS)
ssd_outputs_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap bmap,
                        const __grid_constant__ CUtensorMap cmap,
                        const __grid_constant__ CUtensorMap rmap, const float* __restrict__ la,
                        __nv_bfloat16* __restrict__ Y, int S, int H, int nc, int bc_per_head) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t xs = base, bs = base + TILE, cs = base + 2 * TILE, rs = base + 3 * TILE;
  const uint32_t bar = base + 4 * TILE;
  float* cum = reinterpret_cast<float*>(gbase + 4 * TILE + 16);

  const int tid = threadIdx.x;
  const Chunk k = chunk_of_block(H, nc);
  const int s0 = k.c * L;
  const int64_t bhc = ((int64_t)k.b * H + k.h) * nc + k.c;
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(bar, 4 * TILE);
    tma_load_4d(xs, &xmap, bar, 0, k.h, s0, k.b);
    load_bc(bs, &bmap, bar, k, bc_per_head);
    load_bc(cs, &cmap, bar, k, bc_per_head);
    tma_load_2d(rs, &rmap, bar, 0, (int)(bhc * 64));  // R_before: (p, n) rows of the scratch
  }
  if (tid < 32) chunk_cumsum(la + ((int64_t)k.b * S + s0) * H + k.h, H, min(L, S - s0), L, cum);
  __syncthreads();
  mbar_wait(bar, 0);

  float acc[32], g[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = g[i] = 0.0f;
  fence_regs(acc);
  fence_regs(g);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // K-major: +32 bytes (16 n) per k-step inside the swizzle atom
    wgmma_m64n64k16_ss_tb0(g, desc_sw128(cs + 32 * kk, 16, 1024), desc_sw128(bs + 32 * kk, 16, 1024),
                           kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_m64n64k16_ss_tb0(acc, desc_sw128(cs + 32 * kk, 16, 1024),
                           desc_sw128(rs + 32 * kk, 16, 1024), kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(g);

  // fragment rows: this thread holds rows r0 (h = 0) and r0 + 8 (h = 1);
  // element 4j + 2h + e is column 8j + 2*(lane%4) + e
  const int lane = tid % 32;
  const int r0 = (tid / 32) * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const float cum0 = cum[r0], cum1 = cum[r0 + 8];
  const float e0 = expf(cum0), e1 = expf(cum1);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const bool hi = (i / 2) % 2;
    acc[i] *= hi ? e1 : e0;
    const int t = r0 + (hi ? 8 : 0);
    const int s = 8 * (i / 4) + c0 + (i % 2);
    g[i] = s <= t ? expf((hi ? cum1 : cum0) - cum[s]) * g[i] : 0.0f;
  }
  // W as bf16 hi and lo, each the A fragments of the 4 k16 slices over s
  uint32_t w[32];
#pragma unroll
  for (int i = 0; i < 16; ++i) split_bf16x2(g[2 * i], g[2 * i + 1], w[i], w[16 + i]);
  fence_regs(acc);
  fence_regs(w);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    // X MN-major: +16 rows (s) of 128 bytes per k-step; W hi X, then W lo X
    wgmma_m64n64k16_rs_tb1(acc, &w[4 * kk], desc_sw128(xs + 2048 * (kk % 4), TILE, 1024));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);

  const int64_t row_stride = (int64_t)H * 64;
  __nv_bfloat16* yb = Y + ((int64_t)k.b * S + s0) * row_stride + (int64_t)k.h * 64;
  const int valid = min(L, S - s0);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + c0;
    if (r0 < valid) {
      *reinterpret_cast<uint32_t*>(yb + r0 * row_stride + col) = pack_bf16x2(acc[4 * j], acc[4 * j + 1]);
    }
    if (r0 + 8 < valid) {
      *reinterpret_cast<uint32_t*>(yb + (r0 + 8) * row_stride + col) =
          pack_bf16x2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

}  // namespace

// Plain C interface for ctypes.  bf16 X and Y (B,S,H,64), B and C (B,S,64)
// or (B,S,H,64) by bc_per_head, fin (B,H,64,64); fp32 la (B,S,H) and init
// (B,H,64,64, may be null: zero state); chunk 64.  Scratch from the caller:
// fp32 states (B,H,nc,64,64) and totals (B,H,nc), bf16 before
// (B,H,nc,64,64), nc = ceil(S / 64).  Everything contiguous, X, B, C and
// before 16-byte aligned.  Three launches on `stream`; returns 0 when all
// three launched, else the first non-zero cudaGetLastError() or sm90.cuh
// code.
extern "C" int pccl_ssd_sm90(const void* X, const void* la, const void* Bm, const void* Cm,
                             const void* init, void* Y, void* fin, void* states, void* totals,
                             void* before, int B, int S, int H, int bc_per_head, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nc = (S + L - 1) / L;
  const cuuint32_t box4[4] = {64, 1, L, 1};
  const cuuint64_t xdims[4] = {64, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t xstrides[3] = {128, (cuuint64_t)H * 128, (cuuint64_t)S * H * 128};
  const cuuint32_t box3[3] = {64, L, 1};
  const cuuint64_t sdims[3] = {64, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t sstrides[2] = {128, (cuuint64_t)S * 128};
  const cuuint32_t box2[2] = {64, 64};
  const cuuint64_t rdims[2] = {64, (cuuint64_t)B * H * nc * 64};
  const cuuint64_t rstrides[1] = {128};
  CUtensorMap xmap, bmap, cmap, rmap;
  int err = make_map_bf16(&xmap, X, 4, xdims, xstrides, box4);
  if (err == 0) {
    err = bc_per_head ? make_map_bf16(&bmap, Bm, 4, xdims, xstrides, box4)
                      : make_map_bf16(&bmap, Bm, 3, sdims, sstrides, box3);
  }
  if (err == 0) {
    err = bc_per_head ? make_map_bf16(&cmap, Cm, 4, xdims, xstrides, box4)
                      : make_map_bf16(&cmap, Cm, 3, sdims, sstrides, box3);
  }
  if (err == 0) err = make_map_bf16(&rmap, before, 2, rdims, rstrides, box2);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(ssd_states_sm90_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, STATES_SMEM);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(ssd_outputs_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             OUTPUTS_SMEM);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = B * H * nc;
  const float* laf = static_cast<const float*>(la);
  float* st = static_cast<float*>(states);
  float* tot = static_cast<float*>(totals);
  ssd_states_sm90_kernel<<<blocks, THREADS, STATES_SMEM, s>>>(xmap, bmap, laf, st, tot, S, H, nc,
                                                              bc_per_head);
  int r = static_cast<int>(cudaGetLastError());
  if (r != 0) return r;
  r = launch_recurrence<__nv_bfloat16, __nv_bfloat16>(st, tot, static_cast<const float*>(init),
                                                      before, fin, B * H, nc, 64 * 64, s);
  if (r != 0) return r;
  ssd_outputs_sm90_kernel<<<blocks, THREADS, OUTPUTS_SMEM, s>>>(
      xmap, bmap, cmap, rmap, laf, static_cast<__nv_bfloat16*>(Y), S, H, nc, bc_per_head);
  return static_cast<int>(cudaGetLastError());
}
