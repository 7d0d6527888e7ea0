// K4: the Mamba-2 SSD chunked scan, for Hopper (sm_90a): the CUDA-core route
// (fp32, and bf16 shapes off the tensor-core routes of ssd_sm90.cu and
// ssd_sm90_tiled.cu).
//
// Replaces the TPU kernel src/repro/kernels/ssd/kernel.py::ssd_pallas (body
// _ssd_kernel).  For each (batch b, head h) and each chunk of L steps, with
// cum = cumsum(la) over the chunk and total = cum[L-1]:
//
//     Y_diag = (tril(exp(cum_t - cum_s)) * (C B^T)) X         (L x P)
//     Y_off  = exp(cum_t) * (C R^T)                            (L x P)
//     R'     = exp(total) * R + (X * exp(total - cum))^T B    (P x N)
//
// and emits Y = Y_diag + Y_off and the state after the last chunk.  Unlike
// the TPU kernel it takes an fp32 initial state R, and it reads B and C
// shared across heads, (B,S,N), by index; per-head (B,S,H,N) B and C work
// too.  A ragged last chunk is masked: rows past S load as zeros, as the
// reference's zero padding, and are not stored.  The TPU carried R across a
// sequential chunk grid axis; Hopper's blocks run in no order, so the scan
// is three passes (ssd_common.cuh): chunk states with the chunk's scores
// C B^T, the recurrence across chunks, outputs.
//
// What bounds it on the card.  At Zamba2's fp32 prefill X (4, 4096, 80, 64),
// N = 64, the passes move 2.39 GB (X, the fp32 chunk states S and the
// states before each chunk R, written and read once each): 0.71 ms at 3.35
// TB/s, against 0.48 ms of fp32 FMA at 67 TFLOP/s, so bytes bound it there.
// At the mLSTM's X (4, 4096, 4, 1024), N = 512, passes 1 and 3 do 1.09 and
// 1.15 ms of FMA against 0.72 and 0.80 ms of bytes: operations bound them,
// and pass 2 (1.3 ms of bytes) the rest.  fp32 stays off the tensor cores:
// TF32 misses the fp32 tolerance.  What keeps an FMA loop from its rate is
// feeding it: an SM's shared memory gives each of 32 lanes one 4-byte word
// a clock against 128 FMA lanes, so a lane has to do 4 FMAs for every word
// it reads.
//
// What the design does about it:
// - Every product is a 32 x 64 tile a warp, 8x8 register tile a lane, read
//   as float4: 4 loads feed 64 FMAs, 16.0 FMAs a 16-byte load, 4.0 a word.
//   Pass 1 stages both operands k-major: X and B of the states as rows of
//   the chunk lie in memory, C and B of the scores transposed by 4-byte
//   copies (4 rows x 8 k a warp instruction, rows padded to 4 mod 32
//   floats: 32 banks).  Pass 3 stages C and R of C R^T k-contiguous as
//   they lie in memory, by 16-byte copies, in rows of 32 floats whose
//   16-byte chunks are XOR-swizzled by the row's group of 4, so the 4 rows
//   of C and the 8 rows of R a warp reads lie in distinct banks; W of W X
//   likewise in rows of 16, X k-major.  R, the largest operand, takes no
//   4-byte copies: they cost an instruction and a request an element.
// - Operands reach shared memory through cp.async rings over the reduction
//   slices (L for the states and W X, 16 deep; N for C R^T, 32 deep, and
//   the scores, 8): 3 stages in pass 1 (67,200 B a block at L = 64, two
//   blocks an SM), 4 in pass 3 (172,160 B a block).  A block runs up to 4
//   tiles in turn on one ring, so the next tile's copies fly during this
//   one's epilogue (fewer where the grid would not fill the card).  X * dte
//   and W = tril(exp(cum_t - cum_s)) * (C B^T) are formed in place once a
//   slice has landed, one slice ahead of the
//   multiply: one barrier a slice.  Masked copies zero-fill the ragged
//   chunk and the P and N edges; bf16 goes through registers, widened to
//   fp32; 16-byte copies where rows allow (fp32, widths % 4 == 0, 16-byte
//   bases), else 4-byte ones.
// - Tiles by width: a states tile is 256 columns of X by 64 of N, an
//   outputs tile 64 steps by 256 columns of X.  Where B and C are shared and
//   P is 64 or 128 a tile holds 4 or 2 heads side by side (Zamba2: 20
//   tiles a chunk in each pass); else one head's P-range (the mLSTM: 32
//   states and 4 outputs tiles a chunk).
// - Shared B and C (Zamba2): C B^T once per (b, chunk), kept raw in an fp32
//   (B, nc, L, L) scratch (4.2 MB, not 335.5 MB per head), its exp mask
//   applied per head as pass 3 reads it; per-head B and C (the mLSTM):
//   (B, H, nc, L, L).  The scores blocks come first in pass 1's grid.
//
// The bit contract: every element of S, of the raw scores, of C R^T and of
// W X is one fp32 fmaf chain from 0 over its reduction index in increasing
// order (no split-K, no atomics); zero-filled slots past an edge add
// fmaf(0, 0, acc) = acc; X * dte, exp(cum_t - cum_s) * scores and
// yd + exp(cum_t) * yo are the same expressions on the same values as
// before this design, so Y and the final state keep their bits at any
// tiling.

#include <type_traits>

#include "../../csrc/cp_async.cuh"
#include "ssd_common.cuh"

namespace {

using namespace ssd;

constexpr int THREADS = 256;       // 8 warps
constexpr int TILE = 64;           // columns of a warp's 32 x 64 tile; a score tile's side
constexpr int BK = 16;             // reduction slice of the states and W X
constexpr int BKN = 32;            // reduction slice of C R^T: a 128-byte row of C and R
constexpr int SCORE_BK = 8;        // reduction slice of the scores
constexpr int PAD = 4;             // floats after each row of a staged slice
constexpr int WIDE = 256;          // X columns of a states or outputs tile
constexpr int HEADS = 4;           // heads side by side in a tile, at most (P = 64)
constexpr int SCORE_TILES = 4;     // score tiles of a scores block, two warps each
constexpr int STATES_ITEMS = 4;    // states tiles a pass-1 block runs in turn, at most
constexpr int OUTPUTS_ITEMS = 4;   // outputs tiles a pass-3 block runs in turn, at most
constexpr int FILL = 264;          // blocks that fill an H100 (132 SMs) two deep
constexpr int STATES_STAGES = 3;
constexpr int OUTPUTS_STAGES = 4;
constexpr int FACTS = 32;          // words at the head of a block's shared memory: its tiles

constexpr int XROW = WIDE + PAD;   // k-major rows of X and of the scores' C^T, B^T: 4 mod 32
constexpr int BROW = TILE + PAD;   // k-major rows of a states tile's B
// a pass-1 slot: X and B of a states slice, or C^T and B^T of a scores slice
constexpr int STAGE1 = BK * XROW + BK * BROW > 2 * SCORE_BK * XROW ? BK * XROW + BK * BROW
                                                                   : 2 * SCORE_BK * XROW;
// a pass-3 slot: C then R (k-contiguous, BKN a row), or W by heads (BK a row) then X
constexpr int STAGE3 = TILE * BKN + WIDE * BKN;
static_assert(HEADS * TILE * BK + BK * XROW <= STAGE3, "a W X slice fits a pass-3 slot");
static_assert(THREADS == 32 * 8 && WIDE == 4 * TILE && SCORE_TILES * 2 * 32 == THREADS,
              "8 warps: 8 x 1 on a states tile, 2 x 4 on scores and outputs");
static_assert(XROW % 32 == 4, "4-byte copies of 4 rows x 8 k a warp land in 32 banks");
static_assert(BKN == 32 && BK == 16, "swizzles of 8 and 4 chunks a row");

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// What the launches of a scan take, from its shape.  Columns m of a GEMM
// walk X's columns of head group `hg`: all H * P when `flat` (B and C
// shared, P = 64 or 128: heads side by side), else head hg's P.  Column m
// is head hg + (m >> lg), p = m & pmask.
struct Plan {
  int nc, flat, lg, pmask, gm, heads, groups, lt;
  int mt, nt, states_items, states_per, states_blocks, score_groups, score_items, score_blocks;
  int outputs_items, outputs_per, outputs_blocks;
  __host__ __device__ Plan(int B, int S, int H, int P, int N, int L, int per_head) {
    nc = cdiv(S, L);
    flat = !per_head && (P == 64 || P == 128);
    lg = flat ? (P == 64 ? 6 : 7) : 30;
    pmask = flat ? P - 1 : (1 << 30) - 1;
    gm = flat ? H * P : P;
    heads = flat ? WIDE / P : 1;
    groups = flat ? 1 : H;
    lt = cdiv(L, TILE);
    mt = cdiv(gm, WIDE);
    nt = cdiv(N, TILE);
    states_items = B * nc * groups * mt * nt;
    states_per = per_block(states_items, STATES_ITEMS);
    states_blocks = cdiv(states_items, states_per);
    score_groups = per_head ? H : 1;
    score_items = B * score_groups * nc * lt * lt;
    score_blocks = cdiv(score_items, SCORE_TILES);
    outputs_items = B * nc * groups * lt * mt;
    outputs_per = per_block(outputs_items, OUTPUTS_ITEMS);
    outputs_blocks = cdiv(outputs_items, outputs_per);
  }
  // tiles a block runs in turn: up to `most`, fewer where the grid would
  // not fill the card two deep
  __host__ __device__ static int per_block(int items, int most) {
    const int per = items / FILL;
    return per < 1 ? 1 : per > most ? most : per;
  }
};

// One tile of pass 1 or 3: batch b, chunk c, head group hg, first X column
// m0 of the group, first N column (pass 1) or step (pass 3) r0, and the
// chunk's rows before S.  A block's tiles sit at the head of its shared
// memory (FACTS words), worked out once.
struct alignas(16) Tile {
  int b, c, hg, m0, r0, valid;
};
// A scores tile: where the rows of its C (steps t) and of its B (steps s)
// start, and how many lie before S and the chunk's end.
struct alignas(16) ScoreTile {
  long long c_off, b_off;
  int c_valid, b_valid;
};
static_assert(STATES_ITEMS * sizeof(Tile) <= FACTS * 4 &&
                  OUTPUTS_ITEMS * sizeof(Tile) <= FACTS * 4 &&
                  SCORE_TILES * sizeof(ScoreTile) <= FACTS * 4,
              "a block's tile facts fit");

// Tile x of pass 1 (rows: m-tiles of 256, columns: n-tiles of 64) or pass 3
// (rows: 64-step tiles of the chunk, columns: m-tiles of 256).
__device__ __forceinline__ Tile tile_of(const Plan& pl, int x, int S, int L, bool states) {
  Tile t;
  const int inner = states ? pl.nt : pl.mt, outer = states ? pl.mt : pl.lt;
  const int a = x % inner;
  x /= inner;
  const int o = x % outer;
  x /= outer;
  t.m0 = (states ? o : a) * WIDE;
  t.r0 = (states ? a : o) * TILE;
  t.hg = x % pl.groups;
  x /= pl.groups;
  t.c = x % pl.nc;
  t.b = x / pl.nc;
  t.valid = min(L, S - t.c * L);
  return t;
}

// n_ok leading elements of src[0..3] into dst[0..3] as fp32, the rest as
// zeros: one 16-byte cp.async when vec (fp32, 16-byte aligned, n_ok 0 or
// 4), else 4-byte ones; bf16 is loaded and widened in registers.
template <typename T>
__device__ __forceinline__ void copy_four(float* dst, const T* src, const T* base, int n_ok,
                                          bool vec) {
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      cp_async::copy16(dst, n_ok > 0 ? src : base, n_ok > 0);
      return;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) cp_async::copy4(dst + q, q < n_ok ? src + q : base, q < n_ok);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) dst[q] = q < n_ok ? to_f32(src[q]) : 0.0f;
  }
}

template <typename T>
__device__ __forceinline__ void copy_one(float* dst, const T* src, const T* base, bool ok) {
  if constexpr (std::is_same<T, float>::value) {
    cp_async::copy4(dst, ok ? src : base, ok);
  } else {
    *dst = ok ? to_f32(*src) : 0.0f;
  }
}

__device__ __forceinline__ int prefix(int limit, int at) { return max(0, min(4, limit - at)); }

// acc[i][j] += sum_k A(i, k) B(k, j) over the KS steps of one slice, k in
// order.  A and B k-major (rows lda, ldb floats), both read as float4: a
// lane's rows i are 0..3 and 16..19 past A, its columns j 0..3 and 32..35
// past B.
template <int KS, int lda, int ldb>
__device__ __forceinline__ void mma_km(float (&acc)[8][8], const float* A, const float* B) {
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const float4 a0 = ld4(A + k * lda), a1 = ld4(A + k * lda + 16);
    const float4 b0 = ld4(B + k * ldb), b1 = ld4(B + k * ldb + 32);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// A k-contiguous operand: rows of RL floats (32 or 16), 16-byte chunk c of
// row r stored at chunk c ^ ((r >> 2) & (RL / 4 - 1)), so the rows 4 apart
// that the lanes of a warp read (A: 4 rows a step, B: 8) lie in distinct banks.
template <int RL>
__device__ __forceinline__ int swz(int r, int c) {
  return r * RL + ((c ^ ((r >> 2) & (RL / 4 - 1))) << 2);
}

// acc[i][j] += sum_k A(i, k) B(k, j) over the KS steps of one slice, k in
// order.  A k-contiguous (rows RL floats, swizzled), B k-major (rows ldb):
// a lane's rows are r0 + 0..3 and r0 + 16..19 (r0 a multiple of 4), its
// columns 0..3 and 32..35 past B; A is read as float4 along k.
template <int KS, int RL, int ldb>
__device__ __forceinline__ void mma_ck(float (&acc)[8][8], const float* A, int r0, const float* B) {
#pragma unroll
  for (int c = 0; c < KS / 4; ++c) {
    float4 a4[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a4[i] = ld4(A + swz<RL>(r0 + (i & 3) + 16 * (i >> 2), c));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b0 = ld4(B + (4 * c + kk) * ldb), b1 = ld4(B + (4 * c + kk) * ldb + 32);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a = kk == 0 ? a4[i].x : kk == 1 ? a4[i].y : kk == 2 ? a4[i].z : a4[i].w;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
      }
    }
  }
}

// The same with B k-contiguous too (rows RL floats, swizzled): a lane's
// columns are c0 + 0..3 and c0 + 32..35, each read as float4 along k.
template <int KS, int RL>
__device__ __forceinline__ void mma_cc(float (&acc)[8][8], const float* A, int r0, const float* B,
                                       int c0) {
#pragma unroll
  for (int c = 0; c < KS / 4; ++c) {
    float4 a4[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a4[i] = ld4(A + swz<RL>(r0 + (i & 3) + 16 * (i >> 2), c));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 b4 = ld4(B + swz<RL>(c0 + (j & 3) + 32 * (j >> 2), c));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float b = kk == 0 ? b4.x : kk == 1 ? b4.y : kk == 2 ? b4.z : b4.w;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float a = kk == 0 ? a4[i].x : kk == 1 ? a4[i].y : kk == 2 ? a4[i].z : a4[i].w;
          acc[i][j] = fmaf(a, b, acc[i][j]);
        }
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
}

// Where a stream of slices stands: tile it, slice kt of the tile's nk.
struct Pos {
  int it, kt;
  __device__ __forceinline__ void next(int nk) {
    if (++kt == nk) {
      kt = 0;
      ++it;
    }
  }
};

// The slices of n_tiles tiles, nk each, in turn through a STAGES-slot
// cp.async ring of `stage` floats a slot, slice g in slot g % STAGES.
// `prepare` runs while the first slices are in flight; `post` rewrites
// slice g + 1 in place once it has landed, while slice g is multiplied;
// one barrier a slice.  Each callback takes (tile, slice, slot).
template <int STAGES, typename Issue, typename Prepare, typename Post, typename Compute>
__device__ __forceinline__ void ring(float* slots, int stage, int n_tiles, int nk, Issue issue,
                                     Prepare prepare, Post post, Compute compute) {
  static_assert(STAGES >= 3, "post needs slice g + 1 landed while slice g is multiplied");
  const int n = n_tiles * nk;
  Pos pi{0, 0}, pp{0, 0}, pc{0, 0};
#pragma unroll 1
  for (int g = 0; g < STAGES - 1; ++g) {
    if (g < n) issue(pi.it, pi.kt, slots + (g % STAGES) * stage);
    pi.next(nk);
    cp_async::commit();
  }
  prepare();
  cp_async::wait<STAGES - 2>();  // slice 0
  __syncthreads();
  if (n > 0) post(pp.it, pp.kt, slots);
  pp.next(nk);
#pragma unroll 1
  for (int g = 0; g < n; ++g) {
    cp_async::wait<STAGES - 3>();  // this thread's copies of slice g + 1 have landed
    __syncthreads();               // everyone's have; slice g is posted; slot (g - 1) is free
    const int next = g + STAGES - 1;
    if (next < n) issue(pi.it, pi.kt, slots + (next % STAGES) * stage);
    pi.next(nk);
    cp_async::commit();
    if (g + 1 < n) post(pp.it, pp.kt, slots + ((g + 1) % STAGES) * stage);
    pp.next(nk);
    compute(pc.it, pc.kt, slots + (g % STAGES) * stage);
    pc.next(nk);
  }
}

// Pass 1, a scores block: SCORE_TILES 64 x 64 tiles of the raw chunk scores
// C B^T, fp32, reduced over N in slices, two warps a tile; into scores
// (B, groups, nc, L, L), groups 1 for shared B and C, else H.
template <typename T>
__device__ __forceinline__ void scores_block(const Plan& pl, float* smem, float* slots,
                                             const T* Bm, const T* Cm, float* scores, int S,
                                             int H, int N, int L, int per_head) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = lane >> 3, tx = lane & 7, wm = warp & 1, wn = warp >> 1;
  const int first = blockIdx.x * SCORE_TILES;
  const int64_t bc_row = per_head ? (int64_t)H * N : N;
  ScoreTile* facts = reinterpret_cast<ScoreTile*>(smem);
  if (tid < SCORE_TILES) {  // tile (b, group, c, ti, tj): C's rows ti * 64.., B's tj * 64..
    int x = first + tid;
    const bool ok = x < pl.score_items;
    const int tj = x % pl.lt;
    x /= pl.lt;
    const int ti = x % pl.lt;
    x /= pl.lt;
    const int c = x % pl.nc;
    x /= pl.nc;
    const int g = x % pl.score_groups, b = x / pl.score_groups;
    const int valid = min(L, S - c * L);
    const int64_t row0 = (int64_t)b * S + c * L;
    ScoreTile f;
    f.c_off = (row0 + ti * TILE) * bc_row + (int64_t)g * N;
    f.b_off = (row0 + tj * TILE) * bc_row + (int64_t)g * N;
    f.c_valid = ok ? valid - ti * TILE : 0;
    f.b_valid = ok ? valid - tj * TILE : 0;
    facts[tid] = f;
  }
  __syncthreads();
  auto issue = [&](int, int kt, float* slot) {  // C^T, then B^T
    const int n0 = kt * SCORE_BK;
    constexpr int PER_SIDE = SCORE_TILES * TILE * SCORE_BK / THREADS;
#pragma unroll
    for (int i = 0; i < 2 * PER_SIDE; ++i) {
      const int q = (i % PER_SIDE) * 8 + warp;  // the side's warp instruction: 4 columns x 8 k
      const int col = (q & 63) * 4 + (lane >> 3), k = (q >> 6) * 8 + (lane & 7), r = col & 63;
      const ScoreTile f = facts[col >> 6];
      const bool c_side = i < PER_SIDE;
      const T* src = c_side ? Cm + f.c_off : Bm + f.b_off;
      copy_one(slot + (c_side ? 0 : SCORE_BK * XROW) + k * XROW + col, src + r * bc_row + n0 + k,
               c_side ? Cm : Bm, r < (c_side ? f.c_valid : f.b_valid) && n0 + k < N);
    }
  };
  float acc[8][8];
  zero(acc);
  ring<STATES_STAGES>(
      slots, STAGE1, 1, cdiv(N, SCORE_BK), issue, [] {}, [](int, int, float*) {},
      [&](int, int, float* slot) {  // A(t, n) = C, B(n, s) = B, both k-major
        mma_km<SCORE_BK, XROW, XROW>(acc, slot + wn * TILE + wm * 32 + ty * 4,
                                     slot + SCORE_BK * XROW + wn * TILE + tx * 4);
      });
  int x = first + wn;
  if (x >= pl.score_items) return;
  const int tj = x % pl.lt;
  x /= pl.lt;
  const int ti = x % pl.lt;
  x /= pl.lt;  // (b, group, c)
  float* out = scores + (int64_t)x * L * L;
  const bool g16 = L % 4 == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = ti * TILE + wm * 32 + ty * 4 + (i & 3) + 16 * (i >> 2);
    if (t >= L) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = tj * TILE + tx * 4 + 32 * h;
      float* dst = out + (int64_t)t * L + s;
      if (g16 && s < L) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
        continue;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (s + e < L) dst[e] = acc[i][4 * h + e];
    }
  }
}

// Pass 1.  Blocks 0 .. score_blocks-1 compute the chunks' raw scores
// (scores_block); the others up to STATES_ITEMS states tiles each in turn: rows
// m0 .. m0+255 of the group's X columns by columns n0 .. n0+63 of
// S_c = (X * exp(total - cum))^T B, fp32, reduced over the chunk's L steps
// (and each head's total_c, from the tile holding its first row, n0 = 0).
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
ssd_states_kernel(const T* __restrict__ X, const float* __restrict__ la, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, float* __restrict__ states,
                  float* __restrict__ totals, float* __restrict__ scores, int B, int S, int H,
                  int P, int N, int L, int bc_per_head) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Plan pl(B, S, H, P, N, L, bc_per_head);
  float* dte = smem + FACTS;  // [STATES_ITEMS][HEADS][L]: exp(total - cum) of each tile's heads
  float* slots = dte + STATES_ITEMS * HEADS * L;
  if ((int)blockIdx.x < pl.score_blocks) {
    scores_block<T>(pl, smem, slots, Bm, Cm, scores, S, H, N, L, bc_per_head);
    return;
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = lane >> 3, tx = lane & 7;
  const int first = ((int)blockIdx.x - pl.score_blocks) * pl.states_per;
  const int items = min(pl.states_per, pl.states_items - first);
  const int64_t x_row = (int64_t)H * P, bc_row = bc_per_head ? (int64_t)H * N : N;
  const bool is_f32 = std::is_same<T, float>::value;
  const bool x16 = is_f32 && P % 4 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0;
  const bool b16 = is_f32 && N % 4 == 0 && reinterpret_cast<uintptr_t>(Bm) % 16 == 0;
  Tile* tiles = reinterpret_cast<Tile*>(smem);
  if (tid < items) tiles[tid] = tile_of(pl, first + tid, S, L, true);
  __syncthreads();

  auto issue = [&](int it, int kt, float* slot) {
    const Tile t = tiles[it];
    const int s0 = kt * BK;
    const T* xc = X + ((int64_t)t.b * S + t.c * L + s0) * x_row + (int64_t)t.hg * P + t.m0;
#pragma unroll
    for (int i = 0; i < BK * WIDE / 4 / THREADS; ++i) {  // X: 16 steps x 256 columns
      const int e = tid + i * THREADS, k = e >> 6, c4 = (e & 63) * 4;
      copy_four(slot + k * XROW + c4, xc + k * x_row + c4, X,
                s0 + k < t.valid ? prefix(pl.gm, t.m0 + c4) : 0, x16);
    }
    const T* bc = Bm + ((int64_t)t.b * S + t.c * L + s0) * bc_row +
                  (bc_per_head ? (int64_t)t.hg * N : 0) + t.r0;
    const int k = tid >> 4, c4 = (tid & 15) * 4;  // B: 16 steps x 64 columns
    copy_four(slot + BK * XROW + k * BROW + c4, bc + k * bc_row + c4, Bm,
              s0 + k < t.valid ? prefix(N, t.r0 + c4) : 0, b16);
  };
  auto prepare = [&] {  // each tile's heads: cum, total_c, then dte = exp(total - cum)
    for (int pair = warp; pair < items * pl.heads; pair += THREADS / 32) {
      const int it = pair / pl.heads, jt = pair - it * pl.heads;
      const Tile t = tiles[it];
      const int h = t.hg + (t.m0 >> pl.lg) + jt;
      float* cum = dte + (it * HEADS + jt) * L;
      if (h >= H) continue;
      chunk_cumsum(la + ((int64_t)t.b * S + t.c * L) * H + h, H, t.valid, L, cum);
      __syncwarp();
      const float total = cum[L - 1];
      __syncwarp();
      for (int r = lane; r < L; r += 32) cum[r] = expf(total - cum[r]);
      if (lane == 0 && t.r0 == 0 && ((h - t.hg) << pl.lg) >= t.m0)  // the head's row 0 is here
        totals[((int64_t)t.b * H + h) * pl.nc + t.c] = total;
    }
  };
  auto post = [&](int it, int kt, float* slot) {  // X * dte, in place
    const int m0 = tiles[it].m0, s0 = kt * BK;
#pragma unroll
    for (int i = 0; i < BK * WIDE / 4 / THREADS; ++i) {
      const int e = tid + i * THREADS, k = e >> 6, c4 = (e & 63) * 4;
      if (s0 + k >= L) continue;
      const int jt = ((m0 + c4) >> pl.lg) - (m0 >> pl.lg);
      const float d = dte[(it * HEADS + jt) * L + s0 + k];
      float4* v = reinterpret_cast<float4*>(slot + k * XROW + c4);
      float4 x = *v;
      x.x *= d;
      x.y *= d;
      x.z *= d;
      x.w *= d;
      *v = x;
    }
  };
  float acc[8][8];
  zero(acc);
  const int nk = cdiv(L, BK);
  auto compute = [&](int it, int kt, float* slot) {
    // A(m, s) = X * dte, B(s, n): rows warp * 32 + ty * 4 (+ 16), columns tx * 4 (+ 32)
    mma_km<BK, XROW, BROW>(acc, slot + warp * 32 + ty * 4, slot + BK * XROW + tx * 4);
    if (kt != nk - 1) return;
    const Tile t = tiles[it];  // the tile's last slice: store it
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = t.m0 + warp * 32 + ty * 4 + (i & 3) + 16 * (i >> 2);
      const int h = t.hg + (m >> pl.lg), p = m & pl.pmask;
      if (h >= H || p >= P) continue;
      float* row = states + ((((int64_t)t.b * H + h) * pl.nc + t.c) * P + p) * N;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int n = t.r0 + tx * 4 + 32 * q;
        if (N % 4 == 0 && n < N) {
          *reinterpret_cast<float4*>(row + n) = make_float4(acc[i][4 * q], acc[i][4 * q + 1],
                                                            acc[i][4 * q + 2], acc[i][4 * q + 3]);
          continue;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < N) row[n + e] = acc[i][4 * q + e];
      }
    }
    zero(acc);
  };
  ring<STATES_STAGES>(slots, STAGE1, items, nk, issue, prepare, post, compute);
}

// Pass 3, up to OUTPUTS_ITEMS tiles a block in turn: steps t0 .. t0+63 of the
// chunk by X columns m0 .. m0+255 of the group, Y = W X + exp(cum_t) *
// (C R^T), with R the (fp32) state before the chunk (pass 2) and W =
// tril(exp(cum_t - cum_s)) * scores (pass 1): C R^T over N in slices, then
// W X over the chunk's steps, on one ring.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
ssd_outputs_kernel(const T* __restrict__ X, const float* __restrict__ la,
                   const T* __restrict__ Cm, const float* __restrict__ scores,
                   const float* __restrict__ before, T* __restrict__ Y, int B, int S, int H,
                   int P, int N, int L, int bc_per_head) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Plan pl(B, S, H, P, N, L, bc_per_head);
  float* cums = smem + FACTS;                        // [OUTPUTS_ITEMS][HEADS][L]
  float* ecums = cums + OUTPUTS_ITEMS * HEADS * L;   // exp(cum)
  float* slots = ecums + OUTPUTS_ITEMS * HEADS * L;
  constexpr int R3 = TILE * BKN, X3 = HEADS * TILE * BK;  // where R and X start in a slot
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = lane >> 3, tx = lane & 7, wm = warp & 1, wn = warp >> 1;
  const int first = blockIdx.x * pl.outputs_per;
  const int items = min(pl.outputs_per, pl.outputs_items - first);
  const int nkn = cdiv(N, BKN), nk = nkn + cdiv(L, BK);
  const int64_t x_row = (int64_t)H * P, bc_row = bc_per_head ? (int64_t)H * N : N;
  const bool is_f32 = std::is_same<T, float>::value;
  const bool x16 = is_f32 && P % 4 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0;
  const bool c16 = is_f32 && N % 4 == 0 && reinterpret_cast<uintptr_t>(Cm) % 16 == 0;
  Tile* tiles = reinterpret_cast<Tile*>(smem);
  if (tid < items) tiles[tid] = tile_of(pl, first + tid, S, L, false);
  __syncthreads();

  auto issue = [&](int it, int kt, float* slot) {
    const Tile t = tiles[it];
    if (kt < nkn) {  // C and R, k-contiguous: a thread's 16-byte chunks, 8 a 128-byte row
      const int n0 = kt * BKN;
      const T* cc = Cm + ((int64_t)t.b * S + t.c * L + t.r0) * bc_row +
                    (bc_per_head ? (int64_t)t.hg * N : 0) + n0;
#pragma unroll
      for (int i = 0; i < TILE * BKN / 4 / THREADS; ++i) {
        const int e = tid + i * THREADS, r = e >> 3, q = e & 7;
        copy_four(slot + swz<BKN>(r, q), cc + r * bc_row + 4 * q, Cm,
                  t.r0 + r < t.valid ? prefix(N, n0 + 4 * q) : 0, c16);
      }
#pragma unroll
      for (int i = 0; i < WIDE * BKN / 4 / THREADS; ++i) {
        const int e = tid + i * THREADS, col = e >> 3, q = e & 7;
        const int m = t.m0 + col, h = t.hg + (m >> pl.lg), p = m & pl.pmask;
        const float* src = before + ((((int64_t)t.b * H + h) * pl.nc + t.c) * P + p) * N + n0;
        copy_four(slot + R3 + swz<BKN>(col, q), src + 4 * q, before,
                  h < H && p < P ? prefix(N, n0 + 4 * q) : 0, N % 4 == 0);
      }
      return;
    }
    const int s0 = (kt - nkn) * BK;
    const int64_t g = bc_per_head ? ((int64_t)t.b * H + t.hg) * pl.nc + t.c
                                  : (int64_t)t.b * pl.nc + t.c;  // the tile's L x L scores
    const int r = tid >> 2, q = tid & 3;  // the scores' rows t0.., 16 steps: a chunk a thread
    copy_four(slot + swz<BK>(r, q), scores + (g * L + t.r0 + r) * L + s0 + 4 * q, scores,
              t.r0 + r < L ? prefix(L, s0 + 4 * q) : 0, L % 4 == 0);
    const T* xc = X + ((int64_t)t.b * S + t.c * L + s0) * x_row + (int64_t)t.hg * P + t.m0;
#pragma unroll
    for (int i = 0; i < BK * WIDE / 4 / THREADS; ++i) {  // X: 16 steps x 256 columns
      const int e = tid + i * THREADS, k = e >> 6, c4 = (e & 63) * 4;
      copy_four(slot + X3 + k * XROW + c4, xc + k * x_row + c4, X,
                s0 + k < t.valid ? prefix(pl.gm, t.m0 + c4) : 0, x16);
    }
  };
  auto prepare = [&] {  // each tile's heads: cum and exp(cum)
    for (int pair = warp; pair < items * pl.heads; pair += THREADS / 32) {
      const int it = pair / pl.heads, jt = pair - it * pl.heads;
      const Tile t = tiles[it];
      const int h = t.hg + (t.m0 >> pl.lg) + jt;
      float* cum = cums + (it * HEADS + jt) * L;
      float* ecum = ecums + (it * HEADS + jt) * L;
      if (h < H) {
        chunk_cumsum(la + ((int64_t)t.b * S + t.c * L) * H + h, H, t.valid, L, cum);
        __syncwarp();
        for (int r = lane; r < L; r += 32) ecum[r] = expf(cum[r]);
      } else {
        for (int r = lane; r < L; r += 32) cum[r] = ecum[r] = 0.0f;  // columns past H
      }
    }
  };
  auto post = [&](int it, int kt, float* slot) {  // W = tril(exp(cum_t - cum_s)) * scores
    if (kt < nkn) return;
    const int r = tid >> 2, q = tid & 3, at = swz<BK>(r, q);  // a thread's chunk of 4 steps
    const int t = tiles[it].r0 + r, s0 = (kt - nkn) * BK + 4 * q;
    const float4 raw = ld4(slot + at);
    const float g[4] = {raw.x, raw.y, raw.z, raw.w};
    for (int jt = pl.heads - 1; jt >= 0; --jt) {  // head 0 last: it holds the raw scores
      const float* cum = cums + (it * HEADS + jt) * L;
      float w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = s0 + e;
        w[e] = t < L && s < L && t >= s ? expf(cum[t] - cum[s]) * g[e] : 0.0f;
      }
      *reinterpret_cast<float4*>(slot + jt * TILE * BK + at) = make_float4(w[0], w[1], w[2], w[3]);
    }
  };
  float yo[8][8], yd[8][8];
  zero(yo);
  zero(yd);
  auto compute = [&](int it, int kt, float* slot) {
    // rows wm * 32 + ty * 4 (+ 16), columns wn * 64 + tx * 4 (+ 32)
    if (kt < nkn) {  // A(t, n) = C, B(n, p) = R, both k-contiguous
      mma_cc<BKN, BKN>(yo, slot, wm * 32 + ty * 4, slot + R3, wn * TILE + tx * 4);
      return;
    }
    const Tile tile = tiles[it];
    const int jw = ((tile.m0 + wn * TILE) >> pl.lg) - (tile.m0 >> pl.lg);  // the warp's head
    // A(t, s) = W, B(s, p) = X
    mma_ck<BK, BK, XROW>(yd, slot + jw * TILE * BK, wm * 32 + ty * 4,
                         slot + X3 + wn * TILE + tx * 4);
    if (kt != nk - 1) return;  // the tile's last slice: store it
    const float* ecum = ecums + (it * HEADS + jw) * L;
    const bool y16 = is_f32 && P % 4 == 0 && reinterpret_cast<uintptr_t>(Y) % 16 == 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = tile.r0 + wm * 32 + ty * 4 + (i & 3) + 16 * (i >> 2);
      if (t >= tile.valid) continue;
      T* yrow = Y + ((int64_t)tile.b * S + tile.c * L + t) * x_row + (int64_t)tile.hg * P;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = tile.m0 + wn * TILE + tx * 4 + 32 * h;
        if (m >= pl.gm) continue;
        T* dst = yrow + m;
        if constexpr (std::is_same<T, float>::value) {
          if (y16) {
            *reinterpret_cast<float4*>(dst) =
                make_float4(from_f32<float>(yd[i][4 * h] + ecum[t] * yo[i][4 * h]),
                            from_f32<float>(yd[i][4 * h + 1] + ecum[t] * yo[i][4 * h + 1]),
                            from_f32<float>(yd[i][4 * h + 2] + ecum[t] * yo[i][4 * h + 2]),
                            from_f32<float>(yd[i][4 * h + 3] + ecum[t] * yo[i][4 * h + 3]));
            continue;
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * h + e;
          if (m + e < pl.gm) dst[e] = from_f32<T>(yd[i][j] + ecum[t] * yo[i][j]);
        }
      }
    }
    zero(yo);
    zero(yd);
  };
  ring<OUTPUTS_STAGES>(slots, STAGE3, items, nk, issue, prepare, post, compute);
}

size_t states_smem(int L) {
  return sizeof(float) *
         (FACTS + (size_t)STATES_ITEMS * HEADS * L + (size_t)STATES_STAGES * STAGE1);
}

size_t outputs_smem(int L) {
  return sizeof(float) *
         (FACTS + 2 * (size_t)OUTPUTS_ITEMS * HEADS * L + (size_t)OUTPUTS_STAGES * STAGE3);
}

// The launches of passes 1 (the scores blocks, then the states blocks) and
// 3 (outputs), each a block of THREADS over its tiles.
geometry::Launch states_geometry(int B, int S, int H, int P, int N, int L, int per_head) {
  const Plan pl(B, S, H, P, N, L, per_head);
  return {dim3(pl.score_blocks + pl.states_blocks), THREADS, (int)states_smem(L)};
}

geometry::Launch outputs_geometry(int B, int S, int H, int P, int N, int L, int per_head) {
  const Plan pl(B, S, H, P, N, L, per_head);
  return {dim3(pl.outputs_blocks), THREADS, (int)outputs_smem(L)};
}

template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)  // all of L1 as shared memory: the rings of every resident block fit
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

template <typename T>
int launch(const void* X, const float* la, const void* Bm, const void* Cm, const float* init,
           void* Y, void* fin, float* states, float* totals, float* before, float* scores, int B,
           int S, int H, int P, int N, int L, int bc_per_head, cudaStream_t stream) {
  const int nc = (S + L - 1) / L;
  const geometry::Launch g1 = states_geometry(B, S, H, P, N, L, bc_per_head);
  const geometry::Launch g3 = outputs_geometry(B, S, H, P, N, L, bc_per_head);
  cudaError_t err = allow_smem(ssd_states_kernel<T>, g1.smem);
  if (err == cudaSuccess) err = allow_smem(ssd_outputs_kernel<T>, g3.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* x = static_cast<const T*>(X);
  const T* bm = static_cast<const T*>(Bm);
  const T* cm = static_cast<const T*>(Cm);
  ssd_states_kernel<T><<<g1.grid, g1.threads, g1.smem, stream>>>(
      x, la, bm, cm, states, totals, scores, B, S, H, P, N, L, bc_per_head);
  int e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  e = launch_recurrence<float, T>(states, totals, init, before, fin, B * H, nc, P * N, stream);
  if (e != 0) return e;
  ssd_outputs_kernel<T><<<g3.grid, g3.threads, g3.smem, stream>>>(
      x, la, cm, scores, before, static_cast<T*>(Y), B, S, H, P, N, L, bc_per_head);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int geometry_of(int pass, int B, int S, int H, int P, int N, int L, int per_head, int* grid3,
                int* threads, long long* smem, long long* attrs) {
  if (pass == 1)
    return geometry::export_launch(states_geometry(B, S, H, P, N, L, per_head),
                                   ssd_states_kernel<T>, grid3, threads, smem, attrs);
  if (pass == 2)
    return geometry::export_launch(recurrence_geometry(B * H, P * N),
                                   ssd_recurrence_kernel<float, T>, grid3, threads, smem, attrs);
  if (pass == 3)
    return geometry::export_launch(outputs_geometry(B, S, H, P, N, L, per_head),
                                   ssd_outputs_kernel<T>, grid3, threads, smem, attrs);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Shared memory the larger of passes 1 and 3 needs per block, in bytes (the
// wrapper refuses more than the card gives a block): the rings, and each
// tile's decays, which grow with the chunk L.
extern "C" long long pccl_ssd_smem_bytes(int L) {
  const size_t a = states_smem(L), b = outputs_smem(L);
  return static_cast<long long>(a > b ? a : b);
}

// Plain C interface for ctypes.  dtype: 0 = float32, 1 = bfloat16 (X, B, C,
// Y, fin); la and init are float32; init may be null (zero state).  X and Y
// (B,S,H,P), la (B,S,H), B and C (B,S,N) or (B,S,H,N) by bc_per_head, init
// and fin (B,H,P,N), all contiguous.  Scratch from the caller, fp32: states
// and before (B,H,nc,P,N), totals (B,H,nc), scores (B,nc,L,L) for shared B
// and C or (B,H,nc,L,L) per head, nc = ceil(S / L).  Three launches on
// `stream`; returns the first non-zero cudaGetLastError() after a launch
// (0 = all three launched).
extern "C" int pccl_ssd(int dtype, const void* X, const void* la, const void* Bm, const void* Cm,
                        const void* init, void* Y, void* fin, void* states, void* totals,
                        void* before, void* scores, int B, int S, int H, int P, int N, int L,
                        int bc_per_head, void* stream) {
  const float* laf = static_cast<const float*>(la);
  const float* initf = static_cast<const float*>(init);
  float* st = static_cast<float*>(states);
  float* tot = static_cast<float*>(totals);
  float* rb = static_cast<float*>(before);
  float* sc = static_cast<float*>(scores);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(X, laf, Bm, Cm, initf, Y, fin, st, tot, rb, sc, B, S, H, P, N, L,
                         bc_per_head, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(X, laf, Bm, Cm, initf, Y, fin, st, tot, rb, sc, B, S, H, P, N,
                                 L, bc_per_head, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// What pass `pass` (1 states, 2 recurrence, 3 outputs) of pccl_ssd launches
// for dtype and X (B,S,H,P), N, chunk L, shared or per-head B and C: grid,
// threads, dynamic smem and (attrs, may be null) the kernel's static smem
// and thread limit.
extern "C" int pccl_ssd_geometry(int dtype, int pass, int B, int S, int H, int P, int N, int L,
                                 int bc_per_head, int* grid3, int* threads, long long* smem,
                                 long long* attrs) {
  if (dtype == 0)
    return geometry_of<float>(pass, B, S, H, P, N, L, bc_per_head, grid3, threads, smem, attrs);
  if (dtype == 1)
    return geometry_of<__nv_bfloat16>(pass, B, S, H, P, N, L, bc_per_head, grid3, threads, smem,
                                      attrs);
  return static_cast<int>(cudaErrorInvalidValue);
}
