// The int8 level >= 1 init (hier_init='int8') on Hopper: the raw-atom score
// rows and their per-block peak, from the exact int32 feature map.
//
// Replaces: hsc_tpu/ops/init_kernels.py :: _sparse_init_kernel (the Pallas
// kernel behind sparse_init_raw_pallas).  Spec: the raw rows of
// hsc_tpu/oracle/mp.py :: int8_init_scores, bitwise
// hsc_tpu/ops/encode.py :: encode_init_int_raw.  The plain PyTorch version
// is hsc_torch/ops/encode.py :: encode_init_int_raw_torch.
//
//   map cell m -> four balanced base-256 digits d_0..d_3 (each in [-128, 127])
//   bank code  -> two balanced digits, the int8 planes b_0, b_1
//   T_s[k, t]  = sum_{j+p=s} sum_{u, a} d_j[t+u, a] * b_p[k, u, a]   (s = 0..4)
//   raw[k, t]  = (((T0 + 256 T1) + (65536 T2 + 2^24 T3)) + 2^32 T4) * g
//                in f32, each operation rounded; g = f32(prev_scale * step)
//   peak       = max |raw| over the block
//
// The map is sparse (at the flagship about 512 nonzero cells of 16353 x 64
// per block), so the dense conv of the plain version spends almost all of
// its ~2.8 T multiply-adds per 64-block batch on zeros.  What bounds this
// kernel is bytes: reading the int32 map (268 MB per flagship batch) and
// writing the raw rows (133 MB).  Design, output-stationary: one CTA takes
// one block, a tile of kTile score positions and up to kAtomsPerCta raw
// atoms.  It scans the map rows [t0, t0 + kTile + W - 1) that reach its
// tile, in rounds of kCap cells, and compacts the nonzero cells with their
// digits into shared memory.  Each thread owns one position t and
// kAtomsPerThread atoms and keeps their five taps in int32 registers; for
// every staged cell (p, a) with t <= p < t + W it adds the digit products
// with the planes at offset p - t, read through L1/L2 from a [C, n_raw, W]
// copy of the planes (consecutive positions read consecutive offsets).
//
// Exactness: every tap fits int32 under CodecConfig's W * C <= 65535 bound
// (at most 2 W C products of size <= 2^14), and int32 wraparound is a ring
// homomorphism, so the order in which cells arrive (compaction order is
// racy) cannot change a tap.  The digits are taken from the CELL SUM, so
// duplicate events need no pre-aggregation (the TPU kernel's O(M^2)
// aggregate_codes is not ported).  The recombination spells every rounding
// (__int2float_rn, __fmul_rn, __fadd_rn; the build passes -fmad=false).  The
// peak takes atomicMax on the bits of |raw|: non-negative floats order like
// their bits, and max is exact.  No float atomics.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kTile = 128;          // score positions per CTA (one per thread)
constexpr int kGroups = 4;          // atom groups per CTA
constexpr int kAtomsPerThread = 8;  // taps of 8 atoms x 5 in registers
constexpr int kAtomsPerCta = kGroups * kAtomsPerThread;
constexpr int kThreads = kTile * kGroups;
constexpr int kCap = 4 * kThreads;  // cells scanned per round

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

__device__ __forceinline__ int digit(uint32_t packed, int j) {
  return static_cast<int>(static_cast<int8_t>((packed >> (8 * j)) & 255u));
}

__global__ void __launch_bounds__(kThreads)
sparse_init_kernel(const int* __restrict__ m_int,       // [B, N, C]
                   const float* __restrict__ g,         // [B]
                   const char2* __restrict__ planes,    // [C, n_raw, W] (b0, b1)
                   float* __restrict__ out,             // [B, *, npos], block stride out_bstride
                   unsigned int* __restrict__ peak_bits,  // [B], zeroed by the caller
                   int N, int C, int n_raw, int W, int npos, long long out_bstride) {
  __shared__ int s_pos[kCap];
  __shared__ int s_atom[kCap];
  __shared__ uint32_t s_dig[kCap];
  __shared__ int s_n;

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int t0 = blockIdx.x * kTile;
  const int t = t0 + tid % kTile;
  const int k0 = blockIdx.y * kAtomsPerCta + (tid / kTile) * kAtomsPerThread;

  // unsigned words: their wraparound is the int32 ring's, with no signed
  // overflow (none happens under the config bound anyway)
  uint32_t taps[5][kAtomsPerThread];
#pragma unroll
  for (int s = 0; s < 5; ++s)
#pragma unroll
    for (int kk = 0; kk < kAtomsPerThread; ++kk) taps[s][kk] = 0u;

  const int* map = m_int + static_cast<size_t>(b) * N * C;
  const long long cell_lo = static_cast<long long>(t0) * C;
  const long long cell_hi = static_cast<long long>(min(t0 + kTile + W - 1, N)) * C;
  for (long long base = cell_lo; base < cell_hi; base += kCap) {
    if (tid == 0) s_n = 0;
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kCap / kThreads; ++r) {
      const long long idx = base + r * kThreads + tid;
      if (idx < cell_hi) {
        const int v = map[idx];
        if (v != 0) {
          const int slot = atomicAdd(&s_n, 1);
          s_pos[slot] = static_cast<int>(idx / C);
          s_atom[slot] = static_cast<int>(idx % C);
          s_dig[slot] = pack_digits(v);
        }
      }
    }
    __syncthreads();
    const int n_cells = t < npos ? s_n : 0;
    for (int i = 0; i < n_cells; ++i) {
      const int u = s_pos[i] - t;
      if (u < 0 || u >= W) continue;
      const uint32_t dg = s_dig[i];
      const int d0 = digit(dg, 0), d1 = digit(dg, 1), d2 = digit(dg, 2), d3 = digit(dg, 3);
      const char2* row = planes + (static_cast<size_t>(s_atom[i]) * n_raw) * W + u;
#pragma unroll
      for (int kk = 0; kk < kAtomsPerThread; ++kk) {
        if (k0 + kk < n_raw) {
          const char2 bp = row[static_cast<size_t>(k0 + kk) * W];
          const int b0 = bp.x, b1 = bp.y;
          taps[0][kk] += static_cast<uint32_t>(d0 * b0);
          taps[1][kk] += static_cast<uint32_t>(d0 * b1 + d1 * b0);
          taps[2][kk] += static_cast<uint32_t>(d1 * b1 + d2 * b0);
          taps[3][kk] += static_cast<uint32_t>(d2 * b1 + d3 * b0);
          taps[4][kk] += static_cast<uint32_t>(d3 * b1);
        }
      }
    }
    __syncthreads();  // the next round overwrites the staged cells
  }

  float peak = 0.0f;
  if (t < npos) {
    const float gb = g[b];
    float* o = out + static_cast<size_t>(b) * out_bstride + t;
#pragma unroll
    for (int kk = 0; kk < kAtomsPerThread; ++kk) {
      const int k = k0 + kk;
      if (k >= n_raw) continue;
      float tf[5];
#pragma unroll
      for (int s = 0; s < 5; ++s) tf[s] = __int2float_rn(static_cast<int>(taps[s][kk]));
      const float lo = __fadd_rn(tf[0], __fmul_rn(256.0f, tf[1]));
      const float hi = __fadd_rn(__fmul_rn(65536.0f, tf[2]), __fmul_rn(16777216.0f, tf[3]));
      const float rr = __fadd_rn(__fadd_rn(lo, hi), __fmul_rn(4294967296.0f, tf[4]));
      const float sc = __fmul_rn(rr, gb);
      o[static_cast<size_t>(k) * npos] = sc;
      peak = fmaxf(peak, fabsf(sc));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    peak = fmaxf(peak, __shfl_xor_sync(0xffffffffu, peak, off));
  if ((tid & 31) == 0 && peak > 0.0f) atomicMax(&peak_bits[b], __float_as_uint(peak));
}

}  // namespace

extern "C" int hsc_sparse_init(const int* m_int, const float* g, const void* planes,
                               float* out, unsigned int* peak_bits, int B, int N, int C,
                               int n_raw, int W, long long out_bstride, void* stream) {
  const int npos = N - W + 1;
  if (B == 0) return cudaSuccess;
  if (C < 1 || n_raw < 1 || W < 1 || npos < 1) return cudaErrorInvalidValue;
  const dim3 grid((npos + kTile - 1) / kTile, (n_raw + kAtomsPerCta - 1) / kAtomsPerCta, B);
  if (grid.y > 65535u || grid.z > 65535u) return cudaErrorInvalidValue;
  sparse_init_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      m_int, g, static_cast<const char2*>(planes), out, peak_bits, N, C, n_raw, W, npos,
      out_bstride);
  return cudaGetLastError();
}
