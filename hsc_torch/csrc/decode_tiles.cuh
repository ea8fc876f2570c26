// The tiled event walk that both decode kernels share (int_decode.cu,
// ordered_decode.cu): one design, two arithmetics.
//
// Channels: the table [K, W, C] and each output row [N, C] are row-major, so
// an event at position p adds the W * C contiguous taps of its atom's row at
// element offset p * C of the block's flattened row of N * C floats.  The
// walk below runs on that flattened row (positions p * C, widths W * C); an
// event's liveness is still tested on p.  The integer decode passes C = 1.
//
// Grid: one CTA per (block b, tile of kTile consecutive elements of the
// flattened row), flattened into blockIdx.x, so a 64-block flagship batch is
// 1024 CTAs over 132 SMs and no size depends on N or C (there is no
// block-size ceiling).  Each thread owns kRun contiguous elements of the
// tile in registers.
//
// Events are staged kChunk at a time, each thread taking kPer consecutive
// ones with one 16-byte load per field where the row allows it (scalar loads
// where M % 4 != 0 or a row starts unaligned).  Each chunk's list for the
// tile holds the live events (before `count`, 0 <= p <= N - W, 0 <= atom < K,
// exactly as the plain versions skip the rest) whose window [p C, (p + W) C)
// meets the tile.  The list is built with a block-wide prefix sum over the
// threads' counts in thread order, which is stream order, so it is stable:
// the list keeps the stream's order.  Shared memory is bounded by the chunk,
// not by M, `count` or N.  An event wider than a tile is listed in every
// tile it meets.
//
// Then every thread walks the whole list in order and adds each listed
// event's taps to the samples it owns (Op::add), reading the table
// (bank or rep_q, [K, W C]) through L1.  A sample has one owner, so its adds
// happen in stream order in that thread: no atomics, no reordering.
//
// The tile goes out as float4 stores from registers when the row is 16-byte
// aligned, else through a shared tile: single floats up to the first 16-byte
// boundary, float4 stores, single floats at the ragged end.
//
// An order-free Op (kScatter) may instead sum into a shared tile of 32-bit
// words: warps take the listed events, lanes their taps, and each tap is one
// shared atomicAdd; the owners then read their samples from the tile.
//
// Op gives: Table (the table's element type), Acc (the per-sample sum, which
// starts at +0), kScatter, staged(code, s) (the value kept per listed event,
// from the code and the block's scalar), add(acc, staged, tap) (the owner
// walk) or scatter(word, staged, tap) (the shared tile), and finish(acc, s).

#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

// the tile's shape and the walk's unroll, chosen on an H100 (PERF.md, PR 5);
// `scripts/torch_decode_ab.py --variant=-D...` builds others to time them
// against these
#ifndef HSC_DECODE_THREADS
#define HSC_DECODE_THREADS 128
#endif
#ifndef HSC_DECODE_RUN
#define HSC_DECODE_RUN 8
#endif
#ifndef HSC_DECODE_UNROLL
#define HSC_DECODE_UNROLL 4
#endif
constexpr int kThreads = HSC_DECODE_THREADS;
constexpr int kUnroll = HSC_DECODE_UNROLL;  // list entries walked per step
constexpr int kWarps = kThreads / 32;
constexpr int kRun = HSC_DECODE_RUN;    // contiguous samples a thread owns
constexpr int kTile = kThreads * kRun;  // samples a CTA owns
constexpr int kPer = 4;                 // events a thread stages per chunk
constexpr int kChunk = kThreads * kPer; // events staged per round
static_assert(kRun % 4 == 0, "a thread's run goes out as whole float4s");

struct TileList {
  int pos[kChunk];
  int atom[kChunk];
  int val[kChunk];  // Op::staged of the event
  int warp_total[kWarps];
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <class Op>
__device__ __forceinline__ float4 finish4(const typename Op::Acc* acc, float s) {
  return make_float4(Op::finish(acc[0], s), Op::finish(acc[1], s), Op::finish(acc[2], s), Op::finish(acc[3], s));
}

// Stages events [c0, c0 + kChunk) of one block's rows and lists the tile's
// live ones in stream order; returns the list's length.  The caller needs no
// barrier between walking one chunk's list and staging the next: the first
// barrier here is passed only when every thread has finished its walk.
template <class Op>
__device__ __forceinline__ int stage_chunk(const int* pos_row, const int* atom_row, const int* code_row,
                                           bool vec, int c0, int n_ev, int M, int K, int W, int N, int C,
                                           int t0, int t_end, float s, TileList& L) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = c0 + kPer * tid;
  int p[kPer], a[kPer], c[kPer];
  if (vec && g + kPer <= M) {
    const int4 p4 = *reinterpret_cast<const int4*>(pos_row + g);
    const int4 a4 = *reinterpret_cast<const int4*>(atom_row + g);
    const int4 c4 = *reinterpret_cast<const int4*>(code_row + g);
    p[0] = p4.x; p[1] = p4.y; p[2] = p4.z; p[3] = p4.w;
    a[0] = a4.x; a[1] = a4.y; a[2] = a4.z; a[3] = a4.w;
    c[0] = c4.x; c[1] = c4.y; c[2] = c4.z; c[3] = c4.w;
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const bool in = g + j < n_ev;
      p[j] = in ? pos_row[g + j] : -1;
      a[j] = in ? atom_row[g + j] : 0;
      c[j] = in ? code_row[g + j] : 0;
    }
  }
  unsigned keep = 0;
  int n_keep = 0;
  const int WC = W * C;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    // dead events are never in a valid stream; they are skipped, as in the
    // plain versions, rather than read or written out of bounds
    const bool live = g + j < n_ev && p[j] >= 0 && p[j] <= N - W && a[j] >= 0 && a[j] < K;
    p[j] = live ? p[j] * C : 0;  // the event's offset in the flattened row
    if (live && p[j] < t_end && p[j] + WC > t0) {
      keep |= 1u << j;
      ++n_keep;
    }
  }
  // exclusive prefix of n_keep in thread order (= stream order)
  int incl = n_keep;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) L.warp_total[warp] = incl;
  __syncthreads();
  int slot = incl - n_keep, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int t = L.warp_total[w];
    slot += w < warp ? t : 0;
    total += t;
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (keep >> j & 1u) {
      L.pos[slot] = p[j];
      L.atom[slot] = a[j];
      L.val[slot] = Op::staged(c[j], s);
      ++slot;
    }
  }
  __syncthreads();
  return total;
}

template <class Op>
__global__ void __launch_bounds__(kThreads)
decode_tiles_kernel(const int* __restrict__ positions,          // [B, M]
                    const int* __restrict__ atoms,              // [B, M]
                    const int* __restrict__ codes,              // [B, M]
                    const int* __restrict__ count,              // [B]
                    const float* __restrict__ scalar,           // [B] scale or amp_step
                    const typename Op::Table* __restrict__ table,  // [K, W, C]
                    float* __restrict__ out,                    // [B, N, C]
                    int M, int K, int W, int N, int C, int n_tiles) {
  __shared__ TileList L;
  __shared__ __align__(16) float s_tile[kTile];
  const int tid = threadIdx.x;
  const int b = blockIdx.x / n_tiles;
  // the flattened row: NC elements, WC taps an event (C == 1: N and W)
  const int NC = N * C, WC = W * C;
  const int t0 = (blockIdx.x - b * n_tiles) * kTile;
  const int t_end = min(t0 + kTile, NC);
  const int s0 = t0 + tid * kRun;  // this thread's run
  const size_t row = static_cast<size_t>(b) * M;
  const int* pos_row = positions + row;
  const int* atom_row = atoms + row;
  const int* code_row = codes + row;
  const bool vec = aligned16(pos_row) && aligned16(atom_row) && aligned16(code_row);
  const int n_ev = min(max(count[b], 0), M);
  const float s = scalar[b];

  typename Op::Acc acc[kRun] = {};
  // an order-free Op sums into the shared tile instead (zeroed here; the
  // first barrier of the staging orders this before any add)
  typename Op::Acc* acc_sh = reinterpret_cast<typename Op::Acc*>(s_tile);
  if constexpr (Op::kScatter) {
#pragma unroll
    for (int q = 0; q < kRun; q += 4) *reinterpret_cast<uint4*>(acc_sh + tid * kRun + q) = make_uint4(0, 0, 0, 0);
  }
  // the first chunk is staged before n_ev is known to be > 0, so its loads
  // overlap the loads of count and the scalar
  int c0 = 0;
  do {
    const int n_list = stage_chunk<Op>(pos_row, atom_row, code_row, vec, c0, n_ev, M, K, W, N, C, t0, t_end, s, L);
    if constexpr (Op::kScatter) {
      // warps take the listed events, lanes their taps inside the tile
      const int lane = tid & 31;
      for (int i = tid >> 5; i < n_list; i += kWarps) {
        const int p = L.pos[i];
        const int v = L.val[i];
        const typename Op::Table* trow = table + static_cast<size_t>(L.atom[i]) * WC;
        const int u_end = min(WC, t_end - p);
        for (int u = max(0, t0 - p) + lane; u < u_end; u += 32) Op::scatter(acc_sh + (p + u - t0), v, __ldg(trow + u));
      }
    } else {
#pragma unroll (kUnroll)
      for (int i = 0; i < n_list; ++i) {
        const int p = L.pos[i];
        if (p >= s0 + kRun || p + WC <= s0) continue;
        const int v = L.val[i];
        const typename Op::Table* trow = table + static_cast<size_t>(L.atom[i]) * WC;
#pragma unroll
        for (int j = 0; j < kRun; ++j) {
          const int u = s0 + j - p;
          if (u >= 0 && u < WC) Op::add(acc[j], v, __ldg(trow + u));
        }
      }
    }
    c0 += kChunk;
  } while (c0 < n_ev);
  if constexpr (Op::kScatter) {
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kRun; q += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(acc_sh + tid * kRun + q);
      acc[q] = v.x;
      acc[q + 1] = v.y;
      acc[q + 2] = v.z;
      acc[q + 3] = v.w;
    }
  }

  float* orow = out + static_cast<size_t>(b) * NC;
  if (aligned16(orow)) {  // t0 and s0 are multiples of 4: every run is aligned
    if (s0 + kRun <= NC) {
#pragma unroll
      for (int q = 0; q < kRun; q += 4)
        *reinterpret_cast<float4*>(orow + s0 + q) = finish4<Op>(acc + q, s);
    } else {
#pragma unroll
      for (int j = 0; j < kRun; ++j)
        if (s0 + j < NC) orow[s0 + j] = Op::finish(acc[j], s);
    }
    return;
  }
  // an unaligned row (N C % 4 != 0): through the shared tile
#pragma unroll
  for (int q = 0; q < kRun; q += 4)
    *reinterpret_cast<float4*>(s_tile + tid * kRun + q) = finish4<Op>(acc + q, s);
  __syncthreads();
  const int len = t_end - t0;
  float* o = orow + t0;
  const int head = min(len, static_cast<int>((4 - ((reinterpret_cast<uintptr_t>(o) >> 2) & 3)) & 3));
  const int n_vec = (len - head) >> 2;
  if (tid < head) o[tid] = s_tile[tid];
  for (int q = tid; q < n_vec; q += kThreads) {
    const float* src = s_tile + head + 4 * q;
    *reinterpret_cast<float4*>(o + head + 4 * q) = make_float4(src[0], src[1], src[2], src[3]);
  }
  for (int i = head + 4 * n_vec + tid; i < len; i += kThreads) o[i] = s_tile[i];
}

// Launches the kernel on `stream` for a table of C channels; returns the
// launch's error.  The kernel uses only static shared memory (under 48 KB),
// so no function attribute is set per call.
template <class Op>
int launch_decode_tiles(const int* positions, const int* atoms, const int* codes, const int* count,
                        const float* scalar, const typename Op::Table* table, float* out, int B, int M,
                        int K, int W, int N, int C, void* stream) {
  if (B == 0) return cudaSuccess;
  if (K < 1 || W < 1 || N < W || M < 0 || C < 1 || static_cast<long long>(N) * C > INT_MAX - kTile)
    return cudaErrorInvalidValue;
  const int n_tiles = (N * C + kTile - 1) / kTile;
  const long long grid = static_cast<long long>(B) * n_tiles;
  if (grid > INT_MAX) return cudaErrorInvalidValue;
  decode_tiles_kernel<Op><<<static_cast<unsigned>(grid), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      positions, atoms, codes, count, scalar, table, out, M, K, W, N, C, n_tiles);
  return cudaGetLastError();
}

}  // namespace
