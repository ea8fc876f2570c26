// The int8 level >= 1 init (hier_init='int8') on Hopper, from the emitting
// level's events: the whole score buffer (raw-atom rows and singleton rows),
// the block energies e0 and the peaks.  No dense feature map is built or read.
//
// Replaces: hsc_tpu/ops/init_kernels.py :: _sparse_init_kernel (the Pallas
// kernel behind sparse_init_raw_pallas) and the singleton-row, e0 and peak
// part of hsc_tpu/ops/encode.py :: int8_assemble_batched.  Spec:
// hsc_tpu/oracle/mp.py :: int8_init_scores.  The plain PyTorch version is
// hsc_torch/ops/encode.py :: int8_init_from_events_torch (the hand-off map
// feature_map_int, then encode_init_int_batched).
//
//   m[p, a]    = sum of the live event codes at cell (p, a), mod 2^32
//   m -> four balanced base-256 digits d_0..d_3; bank code -> planes b_0, b_1
//   T_s[k, t]  = sum_{j+q=s} sum_{u, a} d_j[t+u, a] * b_q[k, u, a]   (s = 0..4)
//   raw[k, t]  = (((T0 + 256 T1) + (65536 T2 + 2^24 T3)) + 2^32 T4) * g
//                in f32, each operation rounded; g = f32(prev_scale * step)
//   sing[a, t] = f32(m[t, a]) * prev_scale                          (t < npos)
//   e0         = sum over the cells of (f32(m) * prev_scale)^2
//   peak       = max |score| over both row sets
//
// What bounds it is bytes: the score buffer written once (at the flagship
// level 1, 64 x 96 x 16289 f32 = 400 MB per 64-block batch, 0.12 ms at
// 3.35 TB/s) against ~1 G integer operations for the ~512 cells of a block.
// The map is 0.05% dense, so the design never touches it:
//
//  1. cell_kernel, one CTA per block: the live events (index < count, on the
//     map) sorted by the key pos * C + atom, equal keys merged into int32
//     cell sums, written in key order; an index of where the cells of each
//     run of kIndexStride positions start; e0 (f32
//     squares summed in double in a fixed order, so it is deterministic) and
//     the singleton peak.  O(M log^2 M) per block: the JAX package's
//     aggregate_codes is an O(M^2) equality matrix.  The sort is bitonic
//     over P, the next power of two >= M: in shared memory while its 3 P
//     ints (keys, codes, cell counts) fit the card's opt-in limit (P <=
//     16384 on an H100), past that in the block's own slice of a global
//     workspace with the same network, barriers and run sums.  That route
//     is a chain of dependent L2 round trips per compare-exchange: slow,
//     but it keeps every event count CodecConfig admits on the card.
//  2. score_kernel, grid (tiles of kTile positions, blocks): a CTA reads the
//     cells of its window [t0, t0 + kTile + W - 1) from the index (one
//     contiguous range: no map scan, no search, no atomics on shared memory),
//     kCellRound at a time.  It stages their digits and, with 16-byte loads
//     all in flight at once, the part of each cell's plane rows that its
//     positions meet (the rows are zero-padded to a multiple of 8 offsets),
//     so the inner loop reads shared memory only (loading the planes from L2
//     inside the loop waits on one L2 round trip per cell).  Each thread
//     keeps the five int32 taps of one position and kAtomsPerThread raw
//     atoms in registers and adds each tap as one 4-way byte dot product
//     (__dp4a of the digit word (d_s, d_{s-1}, 0, 0) and the plane word
//     (b0, b1, 0, 0)).  A warp stores each raw row's 32 consecutive
//     positions straight from the registers (128 coalesced bytes).
//     Singleton rows are f32(0) *
//     prev_scale streamed out in aligned 16-byte stores (npos is odd at the
//     flagship, so rows start at any alignment; a row's ragged ends go out
//     as single floats), then the cells of the tile's own positions over
//     them.  Every element of the buffer is written, so the caller hands over
//     torch.empty.  Staging the raw rows in a shared tile for 16-byte stores
//     costs 2-3 barriers per 32 rows and measured 15% slower (PERF.md).
//
// Exactness: every tap fits int32 under CodecConfig's W * C <= 65535 bound
// (at most 2 W C products of size <= 2^14), and int32 wraparound is a ring
// homomorphism, so the order in which cells are added cannot change a tap.
// Digits are taken from the CELL SUM, as the dense spec digitizes the map.
// The recombination spells every rounding (__int2float_rn, __fmul_rn,
// __fadd_rn; the build passes -fmad=false).  The peak takes atomicMax on the
// bits of |score|: non-negative floats order like their bits, and max is
// exact.  Only e0 differs from the plain version, whose f32 reduction runs
// in torch's order: it is not serialized and moves only the SNR stop.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kCellThreads = 512;
constexpr int kMaxEvents = 1 << 24;  // events per block: 3 P and the sort's indexes stay int
constexpr int kIndexStride = 32;   // positions per index entry
constexpr int kTile = 128;         // score positions per CTA, one per thread
constexpr int kGroups = 4;         // atom groups per CTA
constexpr int kAtomsPerThread = 8;  // taps of 8 atoms x 5 in registers
constexpr int kRows = kGroups * kAtomsPerThread;  // raw rows per pass
constexpr int kThreads = kTile * kGroups;
constexpr int kCellRound = 8;       // cells staged per round, with their planes
constexpr int kPlaneChunk = 8;      // plane entries (char2) per 16-byte load
constexpr int kChunks = kTile / 4 + 1;  // 16-byte chunks a tile's row segment meets
constexpr int kSentinel = 0x7fffffff;  // key of a dead event, above every cell
static_assert(kTile % kIndexStride == 0 && kTile % kPlaneChunk == 0, "tile geometry");
static_assert(kCellThreads / 32 <= 32, "one warp scans the warp totals");

// four balanced base-256 digits of v, packed one per byte.  The arithmetic
// is the JAX package's int32 formula; the subtraction is done on unsigned
// words so it wraps like the reference's int32 instead of overflowing.
__device__ __forceinline__ uint32_t pack_digits(int v) {
  uint32_t packed = 0;
  int r = v;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int d = static_cast<int>((static_cast<uint32_t>(r) + 128u) & 255u) - 128;
    packed |= (static_cast<uint32_t>(d) & 255u) << (8 * j);
    r = static_cast<int>(static_cast<uint32_t>(r) - static_cast<uint32_t>(d)) >> 8;
  }
  return packed | ((static_cast<uint32_t>(r) & 255u) << 24);
}

// exclusive prefix sum of one int per thread over the CTA; *total gets the sum
__device__ int block_exclusive_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kCellThreads / 32 ? s_warp[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    s_warp[lane] = w;  // inclusive over the warps
  }
  __syncthreads();
  *total = s_warp[kCellThreads / 32 - 1];
  return (warp > 0 ? s_warp[warp - 1] : 0) + x - v;
}

__global__ void __launch_bounds__(kCellThreads)
cell_kernel(const int* __restrict__ positions,  // [B, M]
            const int* __restrict__ atoms,      // [B, M]
            const int* __restrict__ codes,      // [B, M]
            const int* __restrict__ count,      // [B]
            const float* __restrict__ prev_scale,  // [B]
            int* __restrict__ cell_key,         // [B, M] pos * C + atom, ascending
            int* __restrict__ cell_val,         // [B, M] cell sums
            int* __restrict__ index,            // [B, n_index]
            float* __restrict__ e0,             // [B]
            unsigned int* __restrict__ peak_bits,  // [B] singleton peak
            int* __restrict__ sort_ws,          // null, or [B, 3 P]: the sort in device memory
            int M, int P, int N, int C, int npos, int n_index) {
  extern __shared__ int smem[];
  // the sort's arrays: in shared memory, or in this block's slice of the
  // workspace (__syncthreads orders a CTA's global writes as it does its
  // shared ones, so the network below is the same code on either)
  int* sort = sort_ws ? sort_ws + static_cast<size_t>(blockIdx.x) * 3 * P : smem;
  int* s_key = sort;            // [P]
  int* s_code = sort + P;       // [P]; a run's first slot ends with its sum
  int* s_cell = sort + 2 * P;   // [P] cells before each slot
  __shared__ int s_warp[32];
  __shared__ double s_e0[kCellThreads / 32];
  __shared__ float s_peak[kCellThreads / 32];

  const int b = blockIdx.x, tid = threadIdx.x;
  const int live = min(max(count[b], 0), M);
  const size_t row = static_cast<size_t>(b) * M;
  for (int i = tid; i < P; i += kCellThreads) {
    int key = kSentinel, code = 0;
    if (i < live) {
      const int p = positions[row + i], a = atoms[row + i];
      if (p >= 0 && p < N && a >= 0 && a < C) {
        key = p * C + a;
        code = codes[row + i];
      }
    }
    s_key[i] = key;
    s_code[i] = code;
  }
  __syncthreads();
  // bitonic sort by key; equal keys may end in any order (their sum mod 2^32
  // does not depend on it)
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < P; i += kCellThreads) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const int ki = s_key[i], kj = s_key[ixj];
          if ((ki > kj) == ((i & k) == 0)) {
            s_key[i] = kj;
            s_key[ixj] = ki;
            const int c = s_code[i];
            s_code[i] = s_code[ixj];
            s_code[ixj] = c;
          }
        }
      }
      __syncthreads();
    }
  }
  // each thread takes a contiguous range of slots; the first slot of a run of
  // equal keys sums the run into its own code slot (no other thread reads it)
  const int per = (P + kCellThreads - 1) / kCellThreads;
  const int lo = min(tid * per, P), hi = min(lo + per, P);
  int starts = 0;
  for (int i = lo; i < hi; ++i) {
    const int key = s_key[i];
    if (key != kSentinel && (i == 0 || s_key[i - 1] != key)) {
      uint32_t sum = 0;
      for (int j = i; j < P && s_key[j] == key; ++j) sum += static_cast<uint32_t>(s_code[j]);
      s_code[i] = static_cast<int>(sum);
      ++starts;
    }
  }
  int n_cells;
  int before = block_exclusive_scan(starts, s_warp, &n_cells);
  const float ps = prev_scale[b];
  double e = 0.0;
  float pk = 0.0f;
  for (int i = lo; i < hi; ++i) {
    s_cell[i] = before;
    const int key = s_key[i];
    if (key != kSentinel && (i == 0 || s_key[i - 1] != key)) {
      const int v = s_code[i];
      cell_key[row + before] = key;
      cell_val[row + before] = v;
      const float x = __fmul_rn(__int2float_rn(v), ps);
      e += static_cast<double>(__fmul_rn(x, x));
      if (key / C < npos) pk = fmaxf(pk, fabsf(x));
      ++before;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    e += __shfl_xor_sync(0xffffffffu, e, off);
    pk = fmaxf(pk, __shfl_xor_sync(0xffffffffu, pk, off));
  }
  if ((tid & 31) == 0) {
    s_e0[tid >> 5] = e;
    s_peak[tid >> 5] = pk;
  }
  __syncthreads();
  // index[j] = cells with position < j * kIndexStride: the count before the
  // first slot whose key reaches j * kIndexStride * C
  for (int j = tid; j < n_index; j += kCellThreads) {
    const long long target = static_cast<long long>(j) * kIndexStride * C;
    int l = 0, h = P;
    while (l < h) {
      const int mid = (l + h) >> 1;
      if (s_key[mid] < target) l = mid + 1; else h = mid;
    }
    index[static_cast<size_t>(b) * n_index + j] = l < P ? s_cell[l] : n_cells;
  }
  if (tid == 0) {
    double s = 0.0;
    float m = 0.0f;
    for (int w = 0; w < kCellThreads / 32; ++w) {
      s += s_e0[w];
      m = fmaxf(m, s_peak[w]);
    }
    e0[b] = __double2float_rn(s);
    peak_bits[b] = __float_as_uint(m);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
score_kernel(const int* __restrict__ cell_key,    // [B, M]
             const int* __restrict__ cell_val,    // [B, M]
             const int* __restrict__ index,       // [B, n_index]
             const float* __restrict__ prev_scale,  // [B]
             const uint4* __restrict__ planes,    // [C, n_raw, Wp] (b0, b1) pairs
             float* __restrict__ out,             // [B, n_raw + C, npos]
             unsigned int* __restrict__ peak_bits,  // [B], holds the singleton peak
             float step, int M, int C, int n_raw, int W, int npos, int n_index, int n_chunks) {
  __shared__ int s_pos[kCellRound];
  __shared__ int s_atom[kCellRound];
  __shared__ int s_chunk0[kCellRound];
  __shared__ uint32_t s_dig[kCellRound];
  // the plane entries each staged cell meets in this tile, in 16-byte chunks:
  // chunk j of slot (c, r) is chunk s_chunk0[c] + j of the plane row
  // (atom s_atom[c], raw atom k_base + r)
  extern __shared__ uint4 s_planes[];

  const int tid = threadIdx.x, b = blockIdx.y, t0 = blockIdx.x * kTile;
  const int i = tid % kTile, grp = tid / kTile, t = t0 + i;
  const int row_chunks = (W + kPlaneChunk - 1) / kPlaneChunk;  // chunks of a padded plane row
  const int slot = n_chunks * kPlaneChunk;  // plane entries per staged row
  const int* keys = cell_key + static_cast<size_t>(b) * M;
  const int* vals = cell_val + static_cast<size_t>(b) * M;
  const int* idx = index + static_cast<size_t>(b) * n_index;
  const int last = n_index - 1;
  const int win_lo = idx[t0 / kIndexStride];
  const int win_hi = idx[min((t0 + kTile + W - 1 + kIndexStride - 1) / kIndexStride, last)];
  const int own_hi = idx[min((t0 + kTile) / kIndexStride, last)];
  const float ps = prev_scale[b];
  const float g = __fmul_rn(ps, step);
  const long long block_f = static_cast<long long>(b) * (n_raw + C) * npos + t0;
  float peak = 0.0f;

  // raw rows, kRows at a time
  for (int k_base = 0; k_base < n_raw; k_base += kRows) {
    const int k0 = k_base + grp * kAtomsPerThread;
    int taps[5][kAtomsPerThread];
#pragma unroll
    for (int s = 0; s < 5; ++s)
#pragma unroll
      for (int kk = 0; kk < kAtomsPerThread; ++kk) taps[s][kk] = 0;
    for (int base = win_lo; base < win_hi; base += kCellRound) {
      const int n = min(kCellRound, win_hi - base);
      __syncthreads();  // the last round's cells and planes are read
      if (tid < n) {
        const int key = keys[base + tid];
        const int p = key / C;
        s_pos[tid] = p;
        s_atom[tid] = key - p * C;
        // the tile's positions meet offsets p - t0 - kTile + 1 .. p - t0
        s_chunk0[tid] = max(p - t0 - kTile + 1, 0) / kPlaneChunk;
        s_dig[tid] = pack_digits(vals[base + tid]);
      }
      __syncthreads();
      // stage the planes with 16-byte loads, all of the round's at once
      for (int q = tid; q < n * kRows * n_chunks; q += kThreads) {
        const int c = q / (kRows * n_chunks), r = q / n_chunks - c * kRows, j = q % n_chunks;
        const int k = k_base + r, chunk = s_chunk0[c] + j;
        s_planes[q] = k < n_raw && chunk < row_chunks
                          ? planes[(static_cast<size_t>(s_atom[c]) * n_raw + k) * row_chunks + chunk]
                          : make_uint4(0u, 0u, 0u, 0u);
      }
      __syncthreads();
      if (t >= npos) continue;
      const unsigned short* staged = reinterpret_cast<const unsigned short*>(s_planes);
      for (int c = 0; c < n; ++c) {
        const int u = s_pos[c] - t;
        if (static_cast<unsigned>(u) >= static_cast<unsigned>(W)) continue;
        // T_s = sum_{j+q=s} d_j b_q as one 4-way byte dot product each: the
        // plane word is (b0, b1, 0, 0), the digit words (d_s, d_{s-1}, 0, 0)
        const uint32_t dg = s_dig[c];
        const int w0 = static_cast<int>(dg & 255u);
        const int w1 = static_cast<int>(__byte_perm(dg, 0u, 0x4401));
        const int w2 = static_cast<int>(__byte_perm(dg, 0u, 0x4412));
        const int w3 = static_cast<int>(__byte_perm(dg, 0u, 0x4423));
        const int w4 = static_cast<int>(__byte_perm(dg, 0u, 0x4434));
        const unsigned short* pl = staged + (c * kRows + grp * kAtomsPerThread) * slot +
                                   (u - s_chunk0[c] * kPlaneChunk);
#pragma unroll
        for (int kk = 0; kk < kAtomsPerThread; ++kk) {
          const int pw = static_cast<int>(pl[kk * slot]);
          taps[0][kk] = __dp4a(w0, pw, taps[0][kk]);
          taps[1][kk] = __dp4a(w1, pw, taps[1][kk]);
          taps[2][kk] = __dp4a(w2, pw, taps[2][kk]);
          taps[3][kk] = __dp4a(w3, pw, taps[3][kk]);
          taps[4][kk] = __dp4a(w4, pw, taps[4][kk]);
        }
      }
    }
    if (t < npos) {
#pragma unroll
      for (int kk = 0; kk < kAtomsPerThread; ++kk) {
        if (k0 + kk >= n_raw) continue;
        float tf[5];
#pragma unroll
        for (int s = 0; s < 5; ++s) tf[s] = __int2float_rn(taps[s][kk]);
        const float lo = __fadd_rn(tf[0], __fmul_rn(256.0f, tf[1]));
        const float hi = __fadd_rn(__fmul_rn(65536.0f, tf[2]), __fmul_rn(16777216.0f, tf[3]));
        const float rr = __fadd_rn(__fadd_rn(lo, hi), __fmul_rn(4294967296.0f, tf[4]));
        const float sc = __fmul_rn(rr, g);
        out[block_f + static_cast<long long>(k0 + kk) * npos + i] = sc;
        peak = fmaxf(peak, fabsf(sc));
      }
    }
  }

  // singleton rows: f32(0) * prev_scale (what the plain version computes for
  // an empty cell) streamed out, then the tile's own cells over it; their
  // peak came from the cell kernel
  const float empty = __fmul_rn(0.0f, ps);
  const long long sing_f = block_f + static_cast<long long>(n_raw) * npos;
  for (int q = tid; q < C * kChunks; q += kThreads) {
    const int a = q / kChunks, j = q - a * kChunks;
    const long long f = sing_f + static_cast<long long>(a) * npos;
    const int shift = static_cast<int>(f & 3);
    const int i0 = 4 * j - shift;
    float* dst = out + (f - shift + 4 * j);
    if (i0 >= 0 && i0 + 4 <= kTile && t0 + i0 + 4 <= npos) {
      *reinterpret_cast<float4*>(dst) = make_float4(empty, empty, empty, empty);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (i0 + e >= 0 && i0 + e < kTile && t0 + i0 + e < npos) dst[e] = empty;
    }
  }
  __syncthreads();  // the cells' stores land after the fill's
  for (int c = win_lo + tid; c < own_hi; c += kThreads) {
    const int key = keys[c];
    const int p = key / C, a = key - p * C;
    if (p < npos)
      out[sing_f + static_cast<long long>(a) * npos + (p - t0)] = __fmul_rn(__int2float_rn(vals[c]), ps);
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    peak = fmaxf(peak, __shfl_xor_sync(0xffffffffu, peak, off));
  if ((tid & 31) == 0 && peak > 0.0f) atomicMax(&peak_bits[b], __float_as_uint(peak));
}

// the sort's length: the next power of two >= M
int sort_len(int M) {
  int P = 1;
  while (P < M) P <<= 1;
  return P;
}

// The most dynamic shared memory the cell kernel may ask for on the current
// device: the card's opt-in limit per block less its static shared memory.
// On first use on a device it also lifts both kernels' limits to that, once,
// so that no launch sets a function attribute.
cudaError_t dynamic_smem_limit(int* bytes) {
  constexpr int kMaxDevices = 64;
  static int limit[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && limit[dev] > 0) {
    *bytes = limit[dev];
    return cudaSuccess;
  }
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  int v = 0;
  const void* kernels[2] = {reinterpret_cast<const void*>(cell_kernel),
                            reinterpret_cast<const void*>(score_kernel)};
  for (int i = 0; i < 2; ++i) {
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, kernels[i]);
    if (err != cudaSuccess) return err;
    const int room = optin - static_cast<int>(fa.sharedSizeBytes);
    err = cudaFuncSetAttribute(kernels[i], cudaFuncAttributeMaxDynamicSharedMemorySize, room);
    if (err != cudaSuccess) return err;
    if (i == 0) v = room;
  }
  if (dev < kMaxDevices) limit[dev] = v;
  *bytes = v;
  return cudaSuccess;
}

}  // namespace

// Ints of global workspace per block that the cell kernel's sort of M events
// needs on the current device: 0 while it fits in shared memory, else 3 P
// (keys, codes and cell counts).  A CUDA error is returned negated.
extern "C" int hsc_int8_init_workspace(int M) {
  if (M < 0 || M > kMaxEvents) return -static_cast<int>(cudaErrorInvalidValue);
  int limit = 0;
  const cudaError_t err = dynamic_smem_limit(&limit);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int P = sort_len(M);
  return 3 * static_cast<size_t>(P) * sizeof(int) <= static_cast<size_t>(limit) ? 0 : 3 * P;
}

// `work` holds 2 * B * M + B * n_index ints: the cells' keys and sums, then
// the index.  The caller's n_index must be ceil(N / 32) + 1.  `sort_ws` is
// null, or B slices of hsc_int8_init_workspace(M) ints that hold the sort
// where it does not fit in shared memory.
extern "C" int hsc_int8_init(const int* positions, const int* atoms, const int* codes,
                             const int* count, const float* prev_scale, const void* planes,
                             int* work, int* sort_ws, float* out, float* e0,
                             unsigned int* peak_bits, float step, int B, int M, int N, int C,
                             int n_raw, int W, int n_index, void* stream) {
  const int npos = N - W + 1;
  if (B == 0) return cudaSuccess;
  if (B > 65535 || M < 0 || M > kMaxEvents || C < 1 || n_raw < 1 || W < 1 || npos < 1 ||
      static_cast<long long>(N) * C >= kSentinel ||
      n_index != (N + kIndexStride - 1) / kIndexStride + 1)
    return cudaErrorInvalidValue;
  int limit = 0;
  cudaError_t err = dynamic_smem_limit(&limit);
  if (err != cudaSuccess) return err;
  const int P = sort_len(M);
  const bool in_smem = 3 * static_cast<size_t>(P) * sizeof(int) <= static_cast<size_t>(limit);
  if (!in_smem && sort_ws == nullptr) return cudaErrorInvalidValue;  // needs the workspace
  const int smem = in_smem ? 3 * P * static_cast<int>(sizeof(int)) : 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* cell_key = work;
  int* cell_val = work + static_cast<size_t>(B) * M;
  int* index = work + 2 * static_cast<size_t>(B) * M;
  cell_kernel<<<B, kCellThreads, smem, s>>>(positions, atoms, codes, count, prev_scale, cell_key,
                                            cell_val, index, e0, peak_bits,
                                            in_smem ? nullptr : sort_ws, M, P, N, C, npos,
                                            n_index);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // a staged plane row holds the chunks that any kTile consecutive offsets
  // can meet, or the whole padded row when that is shorter (at most 68 KB)
  const int n_chunks = min((W + kPlaneChunk - 1) / kPlaneChunk, kTile / kPlaneChunk + 1);
  const int plane_smem = kCellRound * kRows * n_chunks * static_cast<int>(sizeof(uint4));
  const dim3 grid((npos + kTile - 1) / kTile, B);
  score_kernel<<<grid, kThreads, plane_smem, s>>>(cell_key, cell_val, index, prev_scale,
                                                  static_cast<const uint4*>(planes), out, peak_bits,
                                                  step, M, C, n_raw, W, npos, n_index, n_chunks);
  return cudaGetLastError();
}
