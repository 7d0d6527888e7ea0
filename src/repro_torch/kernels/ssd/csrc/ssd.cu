// K4: the Mamba-2 SSD chunked scan, for Hopper (sm_90a): the CUDA-core route
// (fp32, and bf16 shapes off the tensor-core route of ssd_sm90.cu).
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
// the TPU kernel it takes an fp32 initial state R (the model's prefill hands
// one in), and it reads B and C shared across heads, (B,S,N), by index: the
// TPU path broadcast them to (B,S,H,N), which would read H times the bytes.
// Per-head (B,S,H,N) B and C work too.  A ragged last chunk is masked: rows
// past S load as zeros, as the reference's zero padding, and are not stored.
// The final state is written in X's dtype, as ssd_reference returns it.
//
// The TPU carried R across a sequential chunk grid axis.  Hopper's blocks
// run in no order, so the scan is three passes (ssd_common.cuh): chunk
// states, the recurrence across chunks, outputs.  A block stages at most a
// 64-column tile of X (a P-tile) and a 64-column slice of B, C and the state
// (an N-slice) in shared memory, so every width fits a block; the TPU kept
// the whole (P, N) state in VMEM, which at the mLSTM's P = 1024, N = 512
// (2 MiB in fp32) is nine times the shared memory a Hopper block may use.
//   1. states: one block per (b, h, chunk, P-tile) computes that tile's
//      rows of (X * dte)^T B, an N-slice at a time; one more block per
//      (b, h, chunk) computes the chunk's masked scores
//      W = tril(exp(cum_t - cum_s)) * (C B^T), reduced over N-slices, into
//      an fp32 (B, H, nc, L, L) scratch, so that pass 3's P-tiles read W
//      and do not each recompute it.  fp32 FMA on the CUDA cores:
//      operations.
//   2. recurrence: elementwise, reads S and writes R_before, both fp32:
//      bytes.
//   3. outputs: one block per (b, h, chunk, P-tile): C R_before^T for the
//      tile's columns, reduced over N-slices with C and R_before staged a
//      slice at a time, then W X; fp32 FMA: operations.
// Blocks of passes 1 and 3: 40,960 and 20,480 at Zamba2's fp32 prefill
// (4, 4096, 80, 64), N = 64; 17,408 and 16,384 at the mLSTM's
// (4, 4096, 4, 1024), N = 512.  Each product is register-tiled 4 x 4 per
// thread over 64 x 64 output tiles (tile_mma), so each shared-memory read
// feeds 4 FMAs; rows are padded to odd strides so transposed reads hit
// distinct banks.  Every sum runs over its reduction axis in order, across
// slices too, so the outputs do not depend on the tiling.  fp32 stays off
// the tensor cores: TF32, their fp32 input, misses the fp32 tolerance.

#include "ssd_common.cuh"

namespace {

using namespace ssd;

constexpr int THREADS = 256;  // 16 x 16
constexpr int TILE = 64;      // rows and columns of one tile_mma output tile

// The widths a block stages: a P-tile of pt columns of X (rows of the
// state), N-slices of nt columns of B, C and the state, L-tiles of lt rows
// of C and W; ptiles P-tiles cover P.
struct Widths {
  int pt, nt, lt, ptiles;
  __host__ __device__ Widths(int P, int N, int L)
      : pt(P < TILE ? P : TILE), nt(N < TILE ? N : TILE), lt(L < TILE ? L : TILE),
        ptiles((P + TILE - 1) / TILE) {}
};

// acc[i][j] += sum_k A(i0+ty+16i, k) * B(k, j0+tx+16j) for k < K, with
// A(i, k) = A[i*a_i + k*a_k] and B(k, j) = B[k*b_k + j*b_j] in shared memory.
// Rows >= M and columns >= NC read as 0.  One fp32 FMA per k, k in order.
__device__ __forceinline__ void tile_mma(float (&acc)[4][4], int i0, int j0, int M, int NC,
                                         int K, const float* A, int a_i, int a_k,
                                         const float* B, int b_k, int b_j, int ty, int tx) {
  int ai[4], bj[4];
  bool iv[4], jv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = i0 + ty + 16 * i;
    iv[i] = r < M;
    ai[i] = iv[i] ? r * a_i : 0;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = j0 + tx + 16 * j;
    jv[j] = c < NC;
    bj[j] = jv[j] ? c * b_j : 0;
  }
  for (int k = 0; k < K; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = iv[i] ? A[ai[i] + k * a_k] : 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = jv[j] ? B[k * b_k + bj[j]] : 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
}

// Where one chunk's operands lie in device memory.
template <typename T>
struct ChunkIn {
  const T* x;        // X[b, s0, h, :], rows H*P apart
  const T* bm;       // B[b, s0, (h,) :], rows bc_row apart
  const T* cm;
  const float* la;   // la[b, s0, h], H apart
  int64_t x_row, bc_row;
  int valid;         // rows of the chunk before S

  __device__ ChunkIn(const T* X, const T* Bm, const T* Cm, const float* la_, int S, int H,
                     int P, int N, int L, int bc_per_head, const Chunk& k) {
    const int s0 = k.c * L;
    x_row = (int64_t)H * P;
    x = X + ((int64_t)k.b * S + s0) * x_row + (int64_t)k.h * P;
    bc_row = bc_per_head ? (int64_t)H * N : (int64_t)N;
    const int64_t bc_off = ((int64_t)k.b * S + s0) * bc_row + (bc_per_head ? (int64_t)k.h * N : 0);
    bm = Bm ? Bm + bc_off : nullptr;
    cm = Cm ? Cm + bc_off : nullptr;
    la = la_ + ((int64_t)k.b * S + s0) * H + k.h;
    valid = min(L, S - s0);
  }
};

// rows x cols of a chunk operand into shared memory (row stride ld) as fp32,
// rows at or past `valid` as zeros
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src, int64_t src_row,
                                          int rows, int cols, int valid) {
  for (int e = threadIdx.x; e < rows * cols; e += THREADS) {
    const int r = e / cols, q = e % cols;
    dst[r * ld + q] = r < valid ? to_f32(src[r * src_row + q]) : 0.0f;
  }
}

template <typename T>
__device__ __forceinline__ void store_tile(T* dst, int64_t ld, const float (&acc)[4][4], int rows,
                                           int cols, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      if (c < cols) dst[r * ld + c] = from_f32<T>(acc[i][j]);
    }
  }
}

// Pass 1.  Tiles 0 .. ptiles-1 of a chunk: rows [64 tile, 64 tile + pc) of
// S_c = (X * exp(total - cum))^T B, fp32, an N-slice at a time (tile 0 also
// writes total_c).  Tile ptiles: the chunk's W = tril(exp(cum_t - cum_s)) *
// (C B^T), L x L fp32, reduced over N-slices.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_states_kernel(const T* __restrict__ X, const float* __restrict__ la, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, float* __restrict__ states,
                  float* __restrict__ totals, float* __restrict__ scores, int S, int H, int P,
                  int N, int L, int nc, int bc_per_head) {
  extern __shared__ float smem[];
  const Widths w(P, N, L);
  const int NP = w.nt + 1;
  float* cum = smem;         // L
  float* dte = cum + L;      // L: exp(total - cum)
  float* tiles = dte + L;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int tile = blockIdx.x % (w.ptiles + 1);
  const Chunk k = chunk_of(blockIdx.x / (w.ptiles + 1), H, nc);
  const ChunkIn<T> in(X, Bm, Cm, la, S, H, P, N, L, bc_per_head, k);
  const int64_t bhc = ((int64_t)k.b * H + k.h) * nc + k.c;
  if (tid < 32) chunk_cumsum(in.la, H, in.valid, L, cum);
  __syncthreads();

  if (tile == w.ptiles) {
    float* cs = tiles;            // lt x NP: rows of C, one N-slice
    float* bs = cs + w.lt * NP;   // lt x NP: rows of B, one N-slice
    float* wo = scores + bhc * L * L;
    for (int i0 = 0; i0 < L; i0 += w.lt)
      for (int j0 = 0; j0 < L; j0 += w.lt) {
        const int rows = min(w.lt, L - i0), cols = min(w.lt, L - j0);
        float acc[4][4];
        zero(acc);
        if (j0 < i0 + rows)  // tiles above the diagonal stay 0
          for (int n0 = 0; n0 < N; n0 += w.nt) {
            const int ncols = min(w.nt, N - n0);
            __syncthreads();  // the previous slice's reads are done
            load_rows(cs, NP, in.cm + i0 * in.bc_row + n0, in.bc_row, rows, ncols, in.valid - i0);
            load_rows(bs, NP, in.bm + j0 * in.bc_row + n0, in.bc_row, cols, ncols, in.valid - j0);
            __syncthreads();
            // A(t, n) = cs[t][n], B(n, s) = bs[s][n]
            tile_mma(acc, 0, 0, rows, cols, ncols, cs, NP, 1, bs, 1, NP, ty, tx);
          }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = i0 + ty + 16 * i;
          if (t >= i0 + rows) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = j0 + tx + 16 * j;
            if (s < j0 + cols) wo[(int64_t)t * L + s] = t >= s ? expf(cum[t] - cum[s]) * acc[i][j] : 0.0f;
          }
        }
      }
    return;
  }

  const int p0 = tile * TILE, pc = min(w.pt, P - p0);
  float* xs = tiles;             // L x pt: X[:, p0:p0+pc], then X * exp(total - cum)
  float* bs = xs + L * w.pt;     // L x NP: one N-slice of B
  const float total = cum[L - 1];
  for (int r = tid; r < L; r += THREADS) dte[r] = expf(total - cum[r]);
  load_rows(xs, w.pt, in.x + p0, in.x_row, L, pc, in.valid);
  load_rows(bs, NP, in.bm, in.bc_row, L, min(w.nt, N), in.valid);  // the first N-slice
  __syncthreads();
  for (int e = tid; e < L * pc; e += THREADS) xs[(e / pc) * w.pt + e % pc] *= dte[e / pc];

  float* out = states + (bhc * P + p0) * N;
  for (int n0 = 0; n0 < N; n0 += w.nt) {
    const int ncols = min(w.nt, N - n0);
    if (n0 > 0) {
      __syncthreads();  // the previous slice's reads of bs are done
      load_rows(bs, NP, in.bm + n0, in.bc_row, L, ncols, in.valid);
    }
    __syncthreads();  // xs is scaled; this slice of B is in
    float acc[4][4];
    zero(acc);
    // A(p, s) = xs[s][p], B(s, n) = bs[s][n]
    tile_mma(acc, 0, 0, pc, ncols, L, xs, 1, w.pt, bs, NP, 1, ty, tx);
    store_tile(out + n0, N, acc, pc, ncols, ty, tx);
  }
  if (tile == 0 && tid == 0) totals[bhc] = total;
}

// Pass 3, one block per (b, h, chunk, P-tile): the tile's columns of
// Y = W X + exp(cum_t) * (C R^T), with W from pass 1 and R the (fp32) state
// before the chunk; C R^T is reduced over N-slices, an L-tile at a time.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_outputs_kernel(const T* __restrict__ X, const float* __restrict__ la,
                   const T* __restrict__ Cm, const float* __restrict__ scores,
                   const float* __restrict__ before, T* __restrict__ Y, int S, int H, int P,
                   int N, int L, int nc, int bc_per_head) {
  extern __shared__ float smem[];
  const Widths w(P, N, L);
  const int NP = w.nt + 1, LP = L + 1;
  float* cum = smem;               // L
  float* ecum = cum + L;           // L: exp(cum)
  float* xs = ecum + L;            // L x pt: X[:, p0:p0+pc]
  float* ws = xs + L * w.pt;       // lt x LP: rows of W
  float* cs = ws + w.lt * LP;      // lt x NP: rows of C, one N-slice
  float* rs = cs + w.lt * NP;      // pt x NP: R[p0:p0+pc, one N-slice]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int tile = blockIdx.x % w.ptiles;
  const Chunk k = chunk_of(blockIdx.x / w.ptiles, H, nc);
  const ChunkIn<T> in(X, nullptr, Cm, la, S, H, P, N, L, bc_per_head, k);
  const int64_t bhc = ((int64_t)k.b * H + k.h) * nc + k.c;
  const int p0 = tile * TILE, pc = min(w.pt, P - p0);
  load_rows(xs, w.pt, in.x + p0, in.x_row, L, pc, in.valid);
  if (tid < 32) chunk_cumsum(in.la, H, in.valid, L, cum);
  __syncthreads();
  for (int r = tid; r < L; r += THREADS) ecum[r] = expf(cum[r]);

  const float* rb = before + (bhc * P + p0) * N;
  const float* wb = scores + bhc * L * L;
  T* yb = Y + ((int64_t)k.b * S + k.c * L) * in.x_row + (int64_t)k.h * P + p0;
  for (int i0 = 0; i0 < L; i0 += w.lt) {
    const int rows = min(w.lt, L - i0);
    __syncthreads();  // the previous L-tile's reads of ws, cs and rs are done
    // W's rows go in with the first N-slice, so their loads are in flight together
    load_rows(ws, LP, wb + (int64_t)i0 * L, L, rows, L, rows);
    float yo[4][4];
    zero(yo);
    for (int n0 = 0; n0 < N; n0 += w.nt) {
      const int ncols = min(w.nt, N - n0);
      if (n0 > 0) __syncthreads();  // the previous slice's reads are done
      load_rows(cs, NP, in.cm + i0 * in.bc_row + n0, in.bc_row, rows, ncols, in.valid - i0);
      load_rows(rs, NP, rb + n0, N, pc, ncols, pc);
      __syncthreads();
      // A(t, n) = cs[t][n], B(n, p) = rs[p][n]
      tile_mma(yo, 0, 0, rows, pc, ncols, cs, NP, 1, rs, 1, NP, ty, tx);
    }
    float yd[4][4];
    zero(yd);
    // A(t, s) = ws[t][s], B(s, p) = xs[s][p]
    tile_mma(yd, 0, 0, rows, pc, L, ws, LP, 1, xs, w.pt, 1, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = i0 + ty + 16 * i;
      if (t >= i0 + rows || t >= in.valid) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = tx + 16 * j;
        if (p < pc) yb[t * in.x_row + p] = from_f32<T>(yd[i][j] + ecum[t] * yo[i][j]);
      }
    }
  }
}

size_t states_smem(int P, int N, int L) {
  const Widths w(P, N, L);
  const size_t NP = w.nt + 1;
  const size_t state_tile = (size_t)L * w.pt + (size_t)L * NP, score_tile = 2 * w.lt * NP;
  return sizeof(float) * (2 * (size_t)L + (state_tile > score_tile ? state_tile : score_tile));
}

size_t outputs_smem(int P, int N, int L) {
  const Widths w(P, N, L);
  const size_t NP = w.nt + 1, LP = (size_t)L + 1;
  return sizeof(float) *
         (2 * (size_t)L + (size_t)L * w.pt + w.lt * LP + w.lt * NP + w.pt * NP);
}

template <typename T>
int launch(const void* X, const float* la, const void* Bm, const void* Cm, const float* init,
           void* Y, void* fin, float* states, float* totals, float* before, float* scores, int B,
           int S, int H, int P, int N, int L, int bc_per_head, cudaStream_t stream) {
  const int nc = (S + L - 1) / L;
  const Widths w(P, N, L);
  const size_t smem1 = states_smem(P, N, L), smem3 = outputs_smem(P, N, L);
  cudaError_t err = cudaFuncSetAttribute(ssd_states_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_outputs_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem3);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* x = static_cast<const T*>(X);
  const T* bm = static_cast<const T*>(Bm);
  const T* cm = static_cast<const T*>(Cm);
  ssd_states_kernel<T><<<B * H * nc * (w.ptiles + 1), THREADS, smem1, stream>>>(
      x, la, bm, cm, states, totals, scores, S, H, P, N, L, nc, bc_per_head);
  int e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  e = launch_recurrence<float, T>(states, totals, init, before, fin, B * H, nc, P * N, stream);
  if (e != 0) return e;
  ssd_outputs_kernel<T><<<B * H * nc * w.ptiles, THREADS, smem3, stream>>>(
      x, la, cm, scores, before, static_cast<T*>(Y), S, H, P, N, L, nc, bc_per_head);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory the larger of passes 1 and 3 needs per block, in bytes (the
// wrapper refuses more than the card gives a block).
extern "C" long long pccl_ssd_smem_bytes(int P, int N, int L) {
  const size_t a = states_smem(P, N, L), b = outputs_smem(P, N, L);
  return static_cast<long long>(a > b ? a : b);
}

// Plain C interface for ctypes.  dtype: 0 = float32, 1 = bfloat16 (X, B, C,
// Y, fin); la and init are float32; init may be null (zero state).  X and Y
// (B,S,H,P), la (B,S,H), B and C (B,S,N) or (B,S,H,N) by bc_per_head, init
// and fin (B,H,P,N), all contiguous.  Scratch from the caller, fp32: states
// and before (B,H,nc,P,N), totals (B,H,nc), scores (B,H,nc,L,L),
// nc = ceil(S / L).  Three launches on `stream`; returns the first non-zero
// cudaGetLastError() after a launch (0 = all three launched).
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
