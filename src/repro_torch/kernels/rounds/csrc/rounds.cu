// One round of a compiled schedule on the rank-stacked buffer, in one pass
// over device memory: for every (receiver d, slot j) pair of the round, the
// source row (the sending rank's chunk) is added into, or stored over, the
// destination row (the receiver's slot).  The same kernel copies rows by a
// table for the engine's other rank-stacked index copies (the compact
// all-to-all's final gather, the reduce-scatter's diagonal, the all-gather's
// diagonal store).
//
// Replaces no TPU kernel: the JAX package lowers a round to a ppermute and
// leaves the gather and the scatter to XLA.  The port ran them as PyTorch's
// advanced indexing: a gather of the payload (reads C bytes, writes C), for a
// reduce a gather of the receive slots and an add (reads 3C, writes 2C), then
// an index_put (reads C, writes C): 8C bytes where a reduce needs 3C (read
// the payload and the slot, write the slot) and 4C where a store needs 2C,
// through a generic kernel that computes a 64-bit offset for every element
// and issues no vector loads.
//
// What bounds it on the card: bytes alone, 3C for a reduce and 2C for a
// store, at 3.35 TB/s; the add is one fp32 operation a 6 bytes or more.
// What the design does about it:
// - One pass: a block takes one pair and a tile of THREADS x UNROLL units of
//   the chunk, so every byte of the source row and the destination row is
//   read once and the destination written once.  A unit is 16 bytes where
//   the chunk's bytes and both bases allow (one vector load or store a
//   thread), else one element; the launcher chooses, the kernel masks the
//   chunk's ragged end.  A thread issues all its loads before any store:
//   UNROLL vectors of the source (and of the destination, for a reduce) are
//   in flight at once.  The grid is (tiles of the chunk, slot, receiver), so
//   any chunk of a megabyte or more gives every one of the 132 SMs several
//   blocks.
// - The rows come from the engine's own (rank, slot) tables: a block reads
//   the sending rank (src_ranks[d], or d), the sending slot (src_ids[p], or
//   j) and the receive slot (dst_ids[p], or j), and the row is rank * slots
//   + slot, with slots the operand's chunks a rank, in 64 bits, so a stacked
//   buffer past 2^31 elements is addressed exactly.  The tables are uploaded
//   once a schedule and device; nothing is uploaded a round.  A null table
//   is the identity, for a scratch buffer or a result laid out by pair.
// - A reduce adds each element once in fp32 and rounds once to the buffer's
//   dtype (fp16, bf16), as torch's a + b does; fp32, fp64 and the integer
//   dtypes add in their own type.  The result is bit for bit the index path's.
// - No atomics, no shared memory, no grid-wide sync, no allocation.  The
//   engine decides at compile time whether a round can run in place: where a
//   rank's send slots and receive slots meet within the round, a block could
//   overwrite a row another block has still to read, so the round runs as two
//   launches through a scratch buffer (gather, then add or store).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>
#include <string.h>

#include "../../csrc/geometry.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;  // units a thread: all loads in flight, then the stores
constexpr int TILE = THREADS * UNROLL;  // units a block takes of one pair's chunk

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half(v);  // round to nearest even, as torch's cast
}

// a + b as torch adds two tensors of T: sub-fp32 types in fp32, rounded once
template <typename T> __device__ __forceinline__ T add(T a, T b) { return a + b; }
template <> __device__ __forceinline__ __nv_bfloat16 add(__nv_bfloat16 a, __nv_bfloat16 b) {
  return from_f32<__nv_bfloat16>(to_f32(a) + to_f32(b));
}
template <> __device__ __forceinline__ __half add(__half a, __half b) {
  return from_f32<__half>(to_f32(a) + to_f32(b));
}

// A store (or a row copy): the destination takes the source's bytes.
struct Store {
  static constexpr bool kReadsDst = false;
  template <typename V> __device__ __forceinline__ static V apply(V, V s) { return s; }
};

// A reduce: the destination becomes destination + source, element by element.
template <typename T>
struct Add {
  static constexpr bool kReadsDst = true;
  template <typename V> __device__ __forceinline__ static V apply(V d, V s) {
    constexpr int N = sizeof(V) / sizeof(T);
    T a[N], b[N];
    memcpy(a, &d, sizeof(V));
    memcpy(b, &s, sizeof(V));
#pragma unroll
    for (int i = 0; i < N; ++i) a[i] = add(a[i], b[i]);
    memcpy(&d, a, sizeof(V));
    return d;
  }
};

// Block (tile, slot j, receiver d) moves units [tile * TILE, tile * TILE +
// TILE) of pair p = d * k + j, masked at row_units, from source row
// (src_ranks[d] or d) * src_slots + (src_ids[p] or j) to destination row
// d * dst_slots + (dst_ids[p] or j); rows of row_units units of V.
template <typename V, typename Op>
__global__ void __launch_bounds__(THREADS)
stacked_round_kernel(const unsigned char* src, unsigned char* dst, const long long* src_ranks,
                     const long long* src_ids, const long long* dst_ids, long long src_slots,
                     long long dst_slots, long long row_units) {
  const long long d = blockIdx.z, j = blockIdx.y;
  const long long pair = d * gridDim.y + j;
  const long long s_row = (src_ranks != nullptr ? src_ranks[d] : d) * src_slots
                          + (src_ids != nullptr ? src_ids[pair] : j);
  const long long d_row = d * dst_slots + (dst_ids != nullptr ? dst_ids[pair] : j);
  const V* s = reinterpret_cast<const V*>(src) + s_row * row_units;
  V* dp = reinterpret_cast<V*>(dst) + d_row * row_units;
  const long long first = static_cast<long long>(blockIdx.x) * TILE + threadIdx.x;
  V sv[UNROLL], dv[UNROLL];
#pragma unroll
  for (int i = 0; i < UNROLL; ++i) {
    const long long u = first + i * THREADS;
    if (u < row_units) {
      sv[i] = s[u];
      if constexpr (Op::kReadsDst) dv[i] = dp[u];
    }
  }
#pragma unroll
  for (int i = 0; i < UNROLL; ++i) {
    const long long u = first + i * THREADS;
    if (u < row_units) dp[u] = Op::apply(dv[i], sv[i]);
  }
}

using Kernel = void (*)(const unsigned char*, unsigned char*, const long long*, const long long*,
                        const long long*, long long, long long, long long);
using Launcher = int (*)(const geometry::Launch&, const void*, void*, const long long*,
                         const long long*, const long long*, long long, long long, long long,
                         cudaStream_t);

// The launch: one block per (tile of the chunk, slot, receiver), no shared memory.
geometry::Launch launch_geometry(long long row_units, int n, int k) {
  return {dim3(static_cast<unsigned>((row_units + TILE - 1) / TILE), k, n), THREADS, 0};
}

template <typename V, typename Op>
int launch(const geometry::Launch& g, const void* src, void* dst, const long long* src_ranks,
           const long long* src_ids, const long long* dst_ids, long long src_slots,
           long long dst_slots, long long row_units, cudaStream_t stream) {
  stacked_round_kernel<V, Op><<<g.grid, g.threads, g.smem, stream>>>(
      static_cast<const unsigned char*>(src), static_cast<unsigned char*>(dst), src_ranks,
      src_ids, dst_ids, src_slots, dst_slots, row_units);
  return static_cast<int>(cudaGetLastError());
}

struct Route {
  Kernel kernel;
  Launcher launch;
};

template <typename V, typename Op>
Route route() {
  return {stacked_round_kernel<V, Op>, launch<V, Op>};
}

template <typename T>
Route add_route(int unit) {
  if (unit == 16) return route<uint4, Add<T>>();
  if (unit == static_cast<int>(sizeof(T))) return route<T, Add<T>>();
  return {nullptr, nullptr};
}

// op 0 stores units of `unit` bytes (1, 2, 4, 8 or 16); op 1..6 adds fp32,
// fp64, fp16, bf16, int32, int64 in units of 16 bytes or of one element.
Route pick(int op, int unit) {
  switch (op) {
    case 0:
      switch (unit) {
        case 1: return route<uint8_t, Store>();
        case 2: return route<uint16_t, Store>();
        case 4: return route<uint32_t, Store>();
        case 8: return route<uint2, Store>();
        case 16: return route<uint4, Store>();
        default: return {nullptr, nullptr};
      }
    case 1: return add_route<float>(unit);
    case 2: return add_route<double>(unit);
    case 3: return add_route<__half>(unit);
    case 4: return add_route<__nv_bfloat16>(unit);
    case 5: return add_route<int32_t>(unit);
    case 6: return add_route<int64_t>(unit);
    default: return {nullptr, nullptr};
  }
}

}  // namespace

// Plain C interface for ctypes.  src and dst are the buffers' bases (dst may
// be src), of src_slots and dst_slots rows a rank; src_ranks a device table
// of n int64 ranks, src_ids and dst_ids of n * k int64 slots, each null for
// the identity.  Returns cudaGetLastError() after the launch (0 = launched),
// or cudaErrorInvalidValue for an op and unit it has no kernel of.
extern "C" int pccl_stacked_round(int op, int unit, const void* src, void* dst,
                                  const long long* src_ranks, const long long* src_ids,
                                  const long long* dst_ids, long long src_slots,
                                  long long dst_slots, long long row_units, int n, int k,
                                  void* stream) {
  const Route r = pick(op, unit);
  if (r.launch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return r.launch(launch_geometry(row_units, n, k), src, dst, src_ranks, src_ids, dst_ids,
                  src_slots, dst_slots, row_units, static_cast<cudaStream_t>(stream));
}

// What pccl_stacked_round launches for (op, unit, row_units, n, k): grid,
// threads, dynamic smem and (attrs, may be null) the kernel's static smem and
// thread limit.
extern "C" int pccl_stacked_round_geometry(int op, int unit, long long row_units, int n, int k,
                                           int* grid3, int* threads, long long* smem,
                                           long long* attrs) {
  const Route r = pick(op, unit);
  if (r.kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return geometry::export_launch(launch_geometry(row_units, n, k), r.kernel, grid3, threads, smem,
                                 attrs);
}
