// K4 on the tensor cores beyond one tile: the bf16 Mamba-2 SSD chunked scan
// for Hopper (sm_90a) with chunk 64 and P, N multiples of 64 other than
// (64, 64): the mLSTM's P = 1024, N = 512 (xLSTM-1.3B), P = 128, N = 128.
//
// Replaces the TPU kernel src/repro/kernels/ssd/kernel.py::ssd_pallas (body
// _ssd_kernel) for bf16 X, B and C at these widths; ssd_sm90.cu keeps P = N
// = chunk = 64 (Zamba2) and ssd.cu fp32 and every other shape.  The same
// function as there (ssd.cu's note): Y (B,S,H,P) and the final state in
// bf16, from an fp32 initial state, with B and C shared across heads
// (B,S,N) or per head (B,S,H,N).
//
// The TPU kept a head's whole (P, N) state in VMEM: 2 MiB in fp32 at the
// mLSTM's widths, nine times the shared memory a Hopper block may use.  So
// the scan runs as ssd_sm90.cu's three passes (ssd_common.cuh) with P cut
// into 64-row P-tiles, one block of one warpgroup per (b, h, chunk,
// P-tile), P-tiles fastest so that the blocks of a chunk run together and
// share its B and C in L2: 16,384 blocks in each of passes 1 and 3 at the
// mLSTM's prefill (4, 4096, 4, 1024), N = 512.  N is walked in 64-column
// N-slices that TMA streams through a ring of STAGES buffers, one mbarrier
// a buffer, while wgmma consumes the slice before.
//
// What bounds each pass, and what the design does about it:
//   1. Chunk states S_c = (dte * X)^T B, dte = exp(total - cum): a block
//      reads one 64 x 64 X tile and writes 64 x N fp32 rows of S_c (128 KB
//      at N = 512): bytes, of the store.  The block scales its X tile by
//      dte once, into a bf16 hi tile (in place) and a lo tile, and every
//      N-slice of B goes from TMA straight to wgmma (8 k-steps of m64n64k16:
//      hi, then lo; both operands MN-major), so no thread touches B.  (The
//      P = 64 route scales B instead: it has one B tile a block, here a
//      block would scale all N / 64 of them.)  Each slice's accumulator goes
//      through a padded fp32 staging tile in shared memory and out as whole
//      256-byte rows, a float4 a thread: on an H100 the pass takes ~0.85 ms
//      at the mLSTM's prefill this way, ~0.94 ms storing the fragments
//      straight from registers (32-byte pieces of 8 rows a warp store).
//   2. The recurrence R = exp(total_c) R + S_c across chunks: ssd_common.cuh's
//      loop, with the state before each chunk stored as a bf16 hi + lo pair
//      (below): elementwise, reads S and writes R_before, 4 bytes an element
//      each: bytes.  A thread takes 4 neighbouring elements, so each load
//      of S_c is 16 bytes and each store of hi or lo 8.
//   3. Outputs Y = exp(cum_t) (C R_before^T) + W X, W = tril(exp(cum_t -
//      cum_s)) * (C B^T): per block the X tile, the chunk's C and B (N
//      columns each, shared in L2 by the chunk's P-tiles) and the tile's 64
//      x N rows of R_before (hi and lo, 128 KB at N = 512), and 64 x 64 of Y
//      out: bytes.  Each ring stage holds an N-slice of C, of B and of
//      R_before's hi and lo; per slice 4 k-steps add C B^T into G and 8 add
//      C R_hi^T + C R_lo^T into acc, all K-major.  W needs the sum over
//      the whole N, so each P-tile block sums its own G (32 k-steps at N =
//      512, on tensor cores that have the time to spare) rather than
//      reading an fp32 (B,H,nc,64,64) scores scratch that pass 1 would
//      write: no extra pass-1 role, no extra buffer, and B's slices come
//      from L2.  Then acc's rows are scaled by exp(cum_t), G is masked and
//      decayed on its fragments into W, split into bf16 hi and lo register
//      A operands, and acc += W_hi X + W_lo X (8 k-steps, X MN-major).
//      Rows at or past S are not stored.
// Numerics: X, B, C arrive in bf16; the fp32 factors that are summed over a
// chunk's 64 steps (dte * X and W) go to wgmma as hi + lo pairs, as on the
// P = 64 route; and so does R_before, which C R_before^T sums over N: the
// P = 64 route's one bf16 rounding of it, summed over N = 512, puts Y
// outside the bf16 tolerance (2e-2) at the mLSTM's widths, where the pair
// keeps it within a fifth of it (tests/test_torch_kernels.py mirrors these
// rounding points on the CPU).  Offsets into states, R_before and Y are
// 64-bit (B·H·nc·P·N passes 2^31 at batch 16).
//
// Ragged S: X and per-head B/C have 4-D tensor maps (P or N, H, S, B) and
// shared B/C 3-D maps (N, S, B), so S is a dimension of its own and TMA
// fills rows at or past S with zeros; la reads 0 there, as the reference
// pads it.  Every mbarrier wait traps after 4 s (sm90.cuh).  The wgmma
// wrappers of the K-major and register-A forms, split_bf16x2 and the B/C
// loads are those of ssd_sm90.cu, which this file leaves as it is.

#include "../../csrc/sm90.cuh"
#include "ssd_common.cuh"

namespace {

using namespace sm90;
using namespace ssd;

constexpr int L = 64;                 // chunk; rows of a P-tile, columns of an N-slice
constexpr int THREADS = 128;          // one warpgroup
constexpr int STATES_STAGES = 2;      // N-slices of B in flight in pass 1
constexpr int OUTPUTS_STAGES = 2;     // N-slices of C, B, R_hi and R_lo in flight in pass 3
constexpr int OUT_ROW = 72;           // floats a row of pass 1's staging tile (64 + 8 of pad)
constexpr int PAIR_VEC = 4;           // elements of a state per thread of pass 2
constexpr int TILE = 64 * 64 * 2;     // one bf16 64 x 64 tile: 64 rows of 128 bytes
constexpr int STATES_SMEM =
    1024 + (2 + STATES_STAGES) * TILE + 64 * OUT_ROW * 4 + 8 * (STATES_STAGES + 1) + L * 4;
constexpr int OUTPUTS_SMEM =
    1024 + (1 + 4 * OUTPUTS_STAGES) * TILE + 8 * (OUTPUTS_STAGES + 1) + L * 4;

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

// hi + lo in bf16, the pair that carries v to about 16 bits
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16x2(a, b);
  const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  lo = pack_bf16x2(a - h.x, b - h.y);
}

// A block's (b, h, chunk) and the first row p0 of its P-tile; P-tiles fastest.
struct Tile {
  Chunk k;
  int p0;
};

__device__ __forceinline__ Tile tile_of_block(int H, int nc, int ptiles) {
  Tile t;
  t.p0 = (blockIdx.x % ptiles) * 64;
  t.k = chunk_of(blockIdx.x / ptiles, H, nc);
  return t;
}

// Columns n0 .. n0 + 63 of the chunk's B or C rows: a 4-D map over per-head
// (N, H, S, B), a 3-D map over shared (N, S, B).
__device__ __forceinline__ void load_bc(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                        const Chunk& k, int n0, int bc_per_head) {
  if (bc_per_head) tma_load_4d(dst, map, bar, n0, k.h, k.c * L, k.b);
  else tma_load_3d(dst, map, bar, n0, k.c * L, k.b);
}

// Pass 1: rows p0 .. p0 + 63 of S_c = (dte * X)^T B in fp32, an N-slice at
// a time, and total_c (from the P-tile at p0 = 0).
__global__ void __launch_bounds__(THREADS)
ssd_states_sm90_tiled_kernel(const __grid_constant__ CUtensorMap xmap,
                             const __grid_constant__ CUtensorMap bmap,
                             const float* __restrict__ la, float* __restrict__ states,
                             float* __restrict__ totals, int S, int H, int P, int N, int nc,
                             int bc_per_head) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms need 1024
  uint8_t* gbase = smem_raw + (base - raw);
  // X (then dte * X as bf16 hi, in place), its lo, the ring of B's N-slices,
  // the staging tile of S_c's rows; X's mbarrier, then one a ring buffer
  constexpr int SBUF = (2 + STATES_STAGES) * TILE;
  const uint32_t xs = base, xl = base + TILE, ring = base + 2 * TILE;
  float* sbuf = reinterpret_cast<float*>(gbase + SBUF);
  const uint32_t xbar = base + SBUF + 64 * OUT_ROW * 4;
  float* cum = reinterpret_cast<float*>(gbase + SBUF + 64 * OUT_ROW * 4 + 8 * (STATES_STAGES + 1));

  const int tid = threadIdx.x;
  const Tile t = tile_of_block(H, nc, P / 64);
  const Chunk k = t.k;
  const int s0 = k.c * L, slices = N / 64;
  if (tid == 0) {
    for (int i = 0; i <= STATES_STAGES; ++i) mbar_init(xbar + 8 * i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(xbar, TILE);  // zero-filled rows past S count too
    tma_load_4d(xs, &xmap, xbar, t.p0, k.h, s0, k.b);
    for (int j = 0; j < STATES_STAGES && j < slices; ++j) {
      const uint32_t bar = xbar + 8 * (1 + j);
      mbar_arrive_expect_tx(bar, TILE);
      load_bc(ring + j * TILE, &bmap, bar, k, 64 * j, bc_per_head);
    }
  }
  if (tid < 32) chunk_cumsum(la + ((int64_t)k.b * S + s0) * H + k.h, H, min(L, S - s0), L, cum);
  __syncthreads();
  const float total = cum[L - 1];
  mbar_wait(xbar, 0);

  // dte * X as hi (in place) and lo, each at X's byte offset in its tile, so
  // both keep X's swizzle: 512 pieces of 16 bytes, row (s) = piece / 8
  for (int i = tid; i < 64 * 8; i += THREADS) {
    uint4* piece = reinterpret_cast<uint4*>(gbase + 16 * i);
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
    *reinterpret_cast<uint4*>(gbase + TILE + 16 * i) = lo;
  }
  fence_proxy_async();
  __syncthreads();

  // acc[4q + 2h + e] is row (p) 16*warp + lane/4 + 8h, column (n) 8q + 2*(lane%4) + e
  const int64_t bhc = ((int64_t)k.b * H + k.h) * nc + k.c;
  const int lane = tid % 32;
  float* sr = sbuf + ((tid / 32) * 16 + lane / 4) * OUT_ROW + 2 * (lane % 4);
  float* out = states + (bhc * P + t.p0) * N;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  for (int j = 0; j < slices; ++j) {
    const int stage = j % STATES_STAGES;
    const uint32_t bs = ring + stage * TILE, bar = xbar + 8 * (1 + stage);
    mbar_wait(bar, (j / STATES_STAGES) & 1);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      // both MN-major: +16 rows (s) of 128 bytes per k-step; (dte X)^T hi, then lo
      const uint32_t a = (kk < 4 ? xs : xl) + 2048 * (kk % 4);
      wgmma_m64n64k16_ss_ta1_tb1(acc, desc_sw128(a, TILE, 1024),
                                 desc_sw128(bs + 2048 * (kk % 4), TILE, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every warp's wgmma has read this buffer: refill it
    if (tid == 0 && j + STATES_STAGES < slices) {
      mbar_arrive_expect_tx(bar, TILE);
      load_bc(bs, &bmap, bar, k, 64 * (j + STATES_STAGES), bc_per_head);
    }
    // the accumulator into the staging tile (rows 8 floats apart in banks:
    // two wavefronts a float2 store), then out as whole rows: a warp stores
    // two 256-byte rows of S_c a float4 instruction.  The next slice writes
    // the tile only after its own wgmma wait and the barrier above.
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      *reinterpret_cast<float2*>(sr + 8 * q) = make_float2(acc[4 * q], acc[4 * q + 1]);
      *reinterpret_cast<float2*>(sr + 8 * OUT_ROW + 8 * q) =
          make_float2(acc[4 * q + 2], acc[4 * q + 3]);
    }
    __syncthreads();
    float* o = out + 64 * j;
#pragma unroll
    for (int i = tid; i < 64 * 16; i += THREADS) {
      *reinterpret_cast<float4*>(o + (i / 16) * (int64_t)N + 4 * (i % 16)) =
          *reinterpret_cast<const float4*>(sbuf + (i / 16) * OUT_ROW + 4 * (i % 16));
    }
  }
  if (t.p0 == 0 && tid == 0) totals[bhc] = total;
}

// Pass 2: ssd_common.cuh's recurrence with PAIR_VEC neighbouring elements
// e .. e + 3 of a (b, h)'s P x N state a thread (P·N is a multiple of 4096,
// so they share their (b, h)): 16-byte loads of S_c, and the state before
// chunk c stored as a bf16 hi + lo pair, before[bh][c][0][e] and
// before[bh][c][1][e], 8 bytes each; the state after the last chunk to fin
// in bf16.
__global__ void __launch_bounds__(RECURRENCE_THREADS)
ssd_recurrence_pair_kernel(const float* __restrict__ states, const float* __restrict__ totals,
                           const float* __restrict__ init, __nv_bfloat16* __restrict__ before,
                           __nv_bfloat16* __restrict__ fin, int BH, int nc, int PN) {
  const int64_t i = ((int64_t)blockIdx.x * RECURRENCE_THREADS + threadIdx.x) * PAIR_VEC;
  if (i >= (int64_t)BH * PN) return;
  const int64_t bh = i / PN, e = i % PN;
  const float* s = states + bh * nc * PN + e;
  const float* tot = totals + bh * nc;
  __nv_bfloat16* r = before + bh * nc * 2 * PN + e;
  float4 R = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (init) R = make_float4(init[i], init[i + 1], init[i + 2], init[i + 3]);
  for (int c0 = 0; c0 < nc; c0 += UNROLL) {
    float4 sv[UNROLL];
    float dv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const bool ok = c0 + u < nc;
      sv[u] = ok ? *reinterpret_cast<const float4*>(s + (int64_t)(c0 + u) * PN)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      dv[u] = ok ? tot[c0 + u] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (c0 + u < nc) {
        const int64_t o = (int64_t)(c0 + u) * 2 * PN;
        const float2 h0 = __bfloat1622float2(__floats2bfloat162_rn(R.x, R.y));
        const float2 h1 = __bfloat1622float2(__floats2bfloat162_rn(R.z, R.w));
        *reinterpret_cast<uint2*>(r + o) = make_uint2(pack_bf16x2(R.x, R.y), pack_bf16x2(R.z, R.w));
        *reinterpret_cast<uint2*>(r + o + PN) =
            make_uint2(pack_bf16x2(R.x - h0.x, R.y - h0.y), pack_bf16x2(R.z - h1.x, R.w - h1.y));
        const float d = expf(dv[u]);
        R = make_float4(R.x * d + sv[u].x, R.y * d + sv[u].y, R.z * d + sv[u].z,
                        R.w * d + sv[u].w);
      }
    }
  }
  *reinterpret_cast<uint2*>(fin + i) = make_uint2(pack_bf16x2(R.x, R.y), pack_bf16x2(R.z, R.w));
}

// Pass 2's launch: one thread per PAIR_VEC elements of the BH states of PN.
geometry::Launch pair_recurrence_geometry(int BH, int PN) {
  const int64_t n = (int64_t)BH * PN / PAIR_VEC;
  return {dim3((unsigned)((n + RECURRENCE_THREADS - 1) / RECURRENCE_THREADS)), RECURRENCE_THREADS, 0};
}

// N-slice n0 of the chunk's C and B rows and of the tile's R_before rows, hi
// (from row rrow of the 2-D map) and lo (P rows further), into the ring
// buffer at `stage`, counted on `bar`.
__device__ __forceinline__ void load_outputs_slice(uint32_t stage, uint32_t bar,
                                                   const CUtensorMap* bmap,
                                                   const CUtensorMap* cmap,
                                                   const CUtensorMap* rmap, const Chunk& k,
                                                   int rrow, int P, int n0, int bc_per_head) {
  mbar_arrive_expect_tx(bar, 4 * TILE);
  load_bc(stage, cmap, bar, k, n0, bc_per_head);
  load_bc(stage + TILE, bmap, bar, k, n0, bc_per_head);
  tma_load_2d(stage + 2 * TILE, rmap, bar, n0, rrow);
  tma_load_2d(stage + 3 * TILE, rmap, bar, n0, rrow + P);
}

// Pass 3: columns p0 .. p0 + 63 of
// Y = exp(cum_t) (C R_before^T) + (tril(exp(cum_t - cum_s)) * (C B^T)) X.
__global__ void __launch_bounds__(THREADS)
ssd_outputs_sm90_tiled_kernel(const __grid_constant__ CUtensorMap xmap,
                              const __grid_constant__ CUtensorMap bmap,
                              const __grid_constant__ CUtensorMap cmap,
                              const __grid_constant__ CUtensorMap rmap,
                              const float* __restrict__ la, __nv_bfloat16* __restrict__ Y, int S,
                              int H, int P, int N, int nc, int bc_per_head) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  // X, then the ring (a buffer: C, B, R_hi and R_lo slices); X's mbarrier,
  // then one a ring buffer
  const uint32_t xs = base, ring = base + TILE;
  const uint32_t xbar = base + (1 + 4 * OUTPUTS_STAGES) * TILE;
  float* cum = reinterpret_cast<float*>(gbase + (1 + 4 * OUTPUTS_STAGES) * TILE +
                                        8 * (OUTPUTS_STAGES + 1));

  const int tid = threadIdx.x;
  const Tile t = tile_of_block(H, nc, P / 64);
  const Chunk k = t.k;
  const int s0 = k.c * L, slices = N / 64;
  const int64_t bhc = ((int64_t)k.b * H + k.h) * nc + k.c;
  const int rrow = (int)(2 * bhc * P + t.p0);  // the tile's first hi row of R_before's 2-D map
  if (tid == 0) {
    for (int i = 0; i <= OUTPUTS_STAGES; ++i) mbar_init(xbar + 8 * i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(xbar, TILE);
    tma_load_4d(xs, &xmap, xbar, t.p0, k.h, s0, k.b);
    for (int j = 0; j < OUTPUTS_STAGES && j < slices; ++j) {
      load_outputs_slice(ring + j * 4 * TILE, xbar + 8 * (1 + j), &bmap, &cmap, &rmap, k, rrow,
                         P, 64 * j, bc_per_head);
    }
  }
  if (tid < 32) chunk_cumsum(la + ((int64_t)k.b * S + s0) * H + k.h, H, min(L, S - s0), L, cum);
  __syncthreads();

  float acc[32], g[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = g[i] = 0.0f;
  for (int j = 0; j < slices; ++j) {
    const int stage = j % OUTPUTS_STAGES;
    const uint32_t cs = ring + stage * 4 * TILE, bs = cs + TILE, rs = cs + 2 * TILE;
    const uint32_t bar = xbar + 8 * (1 + stage);
    mbar_wait(bar, (j / OUTPUTS_STAGES) & 1);
    fence_regs(acc);
    fence_regs(g);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // K-major: +32 bytes (16 n) per k-step inside the swizzle atom
      wgmma_m64n64k16_ss_tb0(g, desc_sw128(cs + 32 * kk, 16, 1024),
                             desc_sw128(bs + 32 * kk, 16, 1024), j > 0 || kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      // C R_hi^T, then C R_lo^T (the tile after R_hi's)
      wgmma_m64n64k16_ss_tb0(acc, desc_sw128(cs + 32 * (kk % 4), 16, 1024),
                             desc_sw128(rs + (kk / 4) * TILE + 32 * (kk % 4), 16, 1024),
                             j > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(g);
    __syncthreads();  // every warp's wgmma has read this buffer: refill it
    if (tid == 0 && j + OUTPUTS_STAGES < slices) {
      load_outputs_slice(cs, bar, &bmap, &cmap, &rmap, k, rrow, P, 64 * (j + OUTPUTS_STAGES),
                         bc_per_head);
    }
  }
  mbar_wait(xbar, 0);

  // fragment rows: this thread holds rows r0 (h = 0) and r0 + 8 (h = 1);
  // element 4q + 2h + e is column 8q + 2*(lane%4) + e
  const int lane = tid % 32;
  const int r0 = (tid / 32) * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const float cum0 = cum[r0], cum1 = cum[r0 + 8];
  const float e0 = expf(cum0), e1 = expf(cum1);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const bool hi = (i / 2) % 2;
    acc[i] *= hi ? e1 : e0;
    const int tt = r0 + (hi ? 8 : 0);
    const int s = 8 * (i / 4) + c0 + (i % 2);
    g[i] = s <= tt ? expf((hi ? cum1 : cum0) - cum[s]) * g[i] : 0.0f;
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

  const int64_t row_stride = (int64_t)H * P;
  __nv_bfloat16* yb = Y + ((int64_t)k.b * S + s0) * row_stride + (int64_t)k.h * P + t.p0;
  const int valid = min(L, S - s0);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int col = 8 * q + c0;
    if (r0 < valid) {
      *reinterpret_cast<uint32_t*>(yb + r0 * row_stride + col) = pack_bf16x2(acc[4 * q], acc[4 * q + 1]);
    }
    if (r0 + 8 < valid) {
      *reinterpret_cast<uint32_t*>(yb + (r0 + 8) * row_stride + col) =
          pack_bf16x2(acc[4 * q + 2], acc[4 * q + 3]);
    }
  }
}

// The launches of passes 1 (states) and 3 (outputs): one block per (b, h,
// chunk) and P-tile.
geometry::Launch states_geometry(int B, int S, int H, int P) {
  return {dim3(B * H * ((S + L - 1) / L) * (P / 64)), THREADS, STATES_SMEM};
}

geometry::Launch outputs_geometry(int B, int S, int H, int P) {
  return {dim3(B * H * ((S + L - 1) / L) * (P / 64)), THREADS, OUTPUTS_SMEM};
}

bool widths_ok(int B, int S, int H, int P, int N) {
  return B > 0 && S > 0 && H > 0 && P > 0 && N > 0 && P % 64 == 0 && N % 64 == 0;
}

}  // namespace

// Plain C interface for ctypes.  bf16 X and Y (B,S,H,P), B and C (B,S,N) or
// (B,S,H,N) by bc_per_head, fin (B,H,P,N); fp32 la (B,S,H) and init
// (B,H,P,N, may be null: zero state); chunk 64, P and N multiples of 64.
// Scratch from the caller: fp32 states (B,H,nc,P,N) and totals (B,H,nc),
// bf16 before (B,H,nc,2,P,N): hi, lo; nc = ceil(S / 64).  Everything
// contiguous, X, B, C and before 16-byte aligned, 2·B·H·nc·P within int32
// (a TMA coordinate).
// Three launches on `stream`; returns 0 when all three launched, else the
// first non-zero cudaGetLastError() or sm90.cuh code.
extern "C" int pccl_ssd_sm90_tiled(const void* X, const void* la, const void* Bm, const void* Cm,
                                   const void* init, void* Y, void* fin, void* states,
                                   void* totals, void* before, int B, int S, int H, int P, int N,
                                   int bc_per_head, void* stream) {
  if (!widths_ok(B, S, H, P, N)) return static_cast<int>(cudaErrorInvalidValue);
  const int nc = (S + L - 1) / L;
  const cuuint64_t b_ = B, s_ = S, h_ = H, p_ = P, n_ = N;
  const cuuint32_t box4[4] = {64, 1, L, 1};
  const cuuint64_t xdims[4] = {p_, h_, s_, b_};
  const cuuint64_t xstrides[3] = {p_ * 2, h_ * p_ * 2, s_ * h_ * p_ * 2};
  const cuuint64_t hdims[4] = {n_, h_, s_, b_};
  const cuuint64_t hstrides[3] = {n_ * 2, h_ * n_ * 2, s_ * h_ * n_ * 2};
  const cuuint32_t box3[3] = {64, L, 1};
  const cuuint64_t sdims[3] = {n_, s_, b_};
  const cuuint64_t sstrides[2] = {n_ * 2, s_ * n_ * 2};
  const cuuint32_t box2[2] = {64, 64};
  const cuuint64_t rdims[2] = {n_, 2 * b_ * h_ * (cuuint64_t)nc * p_};
  const cuuint64_t rstrides[1] = {n_ * 2};
  CUtensorMap xmap, bmap, cmap, rmap;
  int err = make_map_bf16(&xmap, X, 4, xdims, xstrides, box4);
  if (err == 0) {
    err = bc_per_head ? make_map_bf16(&bmap, Bm, 4, hdims, hstrides, box4)
                      : make_map_bf16(&bmap, Bm, 3, sdims, sstrides, box3);
  }
  if (err == 0) {
    err = bc_per_head ? make_map_bf16(&cmap, Cm, 4, hdims, hstrides, box4)
                      : make_map_bf16(&cmap, Cm, 3, sdims, sstrides, box3);
  }
  if (err == 0) err = make_map_bf16(&rmap, before, 2, rdims, rstrides, box2);
  if (err != 0) return err;
  const geometry::Launch g1 = states_geometry(B, S, H, P), g3 = outputs_geometry(B, S, H, P);
  cudaError_t e = cudaFuncSetAttribute(ssd_states_sm90_tiled_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, g1.smem);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(ssd_outputs_sm90_tiled_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, g3.smem);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* laf = static_cast<const float*>(la);
  float* st = static_cast<float*>(states);
  float* tot = static_cast<float*>(totals);
  ssd_states_sm90_tiled_kernel<<<g1.grid, g1.threads, g1.smem, s>>>(xmap, bmap, laf, st, tot, S,
                                                                     H, P, N, nc, bc_per_head);
  int r = static_cast<int>(cudaGetLastError());
  if (r != 0) return r;
  const geometry::Launch g2 = pair_recurrence_geometry(B * H, P * N);
  ssd_recurrence_pair_kernel<<<g2.grid, g2.threads, g2.smem, s>>>(
      st, tot, static_cast<const float*>(init), static_cast<__nv_bfloat16*>(before),
      static_cast<__nv_bfloat16*>(fin), B * H, nc, P * N);
  r = static_cast<int>(cudaGetLastError());
  if (r != 0) return r;
  ssd_outputs_sm90_tiled_kernel<<<g3.grid, g3.threads, g3.smem, s>>>(
      xmap, bmap, cmap, rmap, laf, static_cast<__nv_bfloat16*>(Y), S, H, P, N, nc, bc_per_head);
  return static_cast<int>(cudaGetLastError());
}

// What pass `pass` (1 states, 2 recurrence, 3 outputs) of pccl_ssd_sm90_tiled
// launches for X (B,S,H,P) and state size N: grid, threads, dynamic smem and
// (attrs, may be null) the kernel's static smem and thread limit.
extern "C" int pccl_ssd_sm90_tiled_geometry(int pass, int B, int S, int H, int P, int N,
                                            int* grid3, int* threads, long long* smem,
                                            long long* attrs) {
  if (!widths_ok(B, S, H, P, N)) return static_cast<int>(cudaErrorInvalidValue);
  if (pass == 1)
    return geometry::export_launch(states_geometry(B, S, H, P), ssd_states_sm90_tiled_kernel,
                                   grid3, threads, smem, attrs);
  if (pass == 2)
    return geometry::export_launch(pair_recurrence_geometry(B * H, P * N),
                                   ssd_recurrence_pair_kernel, grid3, threads, smem, attrs);
  if (pass == 3)
    return geometry::export_launch(outputs_geometry(B, S, H, P), ssd_outputs_sm90_tiled_kernel,
                                   grid3, threads, smem, attrs);
  return static_cast<int>(cudaErrorInvalidValue);
}
