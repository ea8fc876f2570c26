// Greedy convolutional matching pursuit on Hopper: one CTA encodes one block,
// and each sweep decides all of its candidates in one pass.
//
// Replaces: hsc_tpu/ops/mp_kernels.py :: _mp_kernel (:83, the fused Pallas
// greedy loop, launched by _mp_pallas_stage).  It computes the spec of
// hsc_tpu/oracle/mp.py :: mp_encode given an injected init, bitwise: the
// plain PyTorch version is hsc_torch/ops/encode.py :: mp_encode_from_init_torch.
// The Mosaic layout (roll placement, 128-lane chunks, folded selection rows,
// MXU one-hot extraction) has no meaning here and is not carried over.
//
// What bounds it on this card.  Bytes: the scores are read once to build the
// selection cache, K x npos f32 per block -- 64 x 16353 x 4 B = 4.2 MB at
// the flat flagship, 268 MB per 64-block batch, 0.080 ms at 3.35 TB/s; 96 x
// 16289 x 4 B per block at level 1 of the flagship hierarchy, 400 MB, 0.119
// ms.  Latency: a block is a chain of at least num_coefs / num_select
// dependent sweeps (>= 64 at the flat flagship, >= 24 at level 1), each a
// selection, a decision and a small update, so what one sweep costs in
// barriers and memory round trips sets the time.  The scores stay in global
// memory (4.2 MB per block is far beyond 227 KB of shared memory) and are
// updated IN PLACE: the caller's buffer is the loop state.  The selection
// cache holds per position the largest |score| * weight over the atoms (f32)
// and the lowest atom that reaches it (u16), 6 bytes per position (96 KB at
// npos 16353).  It lives in shared memory where it fits the card's opt-in
// limit (npos up to ~38,000 at 227 KB); a longer block keeps it in a
// per-block slice of a global workspace that the wrapper allocates, with the
// same code and arithmetic (L1 and L2 serve it), so no block size is refused.
// Measured
// (scripts/torch_mp_loop_phases.py): phase D below, which reads and writes
// the K x (2W-1) scores of every accepted window in device memory (0.53 GB
// each way per 64-block batch at the flat flagship, 0.62 GB at level 1),
// takes half of the time at level 0 and two thirds at level 1; the first
// pass takes a sixth.
//
// Design: blocks are the parallel axis (grid = B, 512 threads each).  Every
// num_select S >= 1 runs as sweeps; S = 1 is the plain greedy loop (see the
// plain version's docstring).  One sweep has three block-wide barriers,
// whatever S is:
//   A. segmented argmax of the selection cache -> one candidate per spec
//      segment (seg_len = 128*ceil(npos/(128*S))); each warp scans a run of
//      whole 128-position steps (four positions a lane, one conflict-free
//      16-byte load), reduces with lowest-index tie-breaks, and merges into
//      a per-segment 64-bit key (value bits << 32 | ~position) with a shared
//      atomicMax -- value first, then the LOWEST position, like argmax.  Key
//      0 means the segment has no candidate (it lies past npos).
//   C. warp 0, one lane per candidate: the atom is the cache's (the lowest
//      atom of the column's weighted maximum, as the atom argmax defines
//      it), the score is read at (atom, position), and the code is
//      sign*floor(|s*inv|+0.5) clipped to +-maxcode, with c_hat and the two
//      products of the energy recursion.  Then lane 0 walks the S decisions
//      in candidate order: emit (code != 0), the 2W-1 guard against the last
//      EMITTED position, the budget, the energy recursion in the oracle's op
//      order and the SNR stop; it writes the events and a compact list of
//      the accepted windows.  Meanwhile the other warps ask L2 for every
//      candidate's update window and Gram rows (prefetch).
//   D. every accepted window is updated at once: one thread owns one
//      (accepted candidate, column) pair, subtracts c_hat * G[:, f, lag] from
//      all K scores of its column (16 atoms' loads in flight before any
//      store) and writes the column's new maximum and atom into the cache.
// A sweep that accepts nothing ends the block.  The first pass over the
// scores builds the cache the same way, 32 atoms' loads in flight.
//
// Why the parallel sweep is bitwise the serial one (the oracle accepts the
// candidates left to right and updates after each accept).  The candidates
// come from the sweep-start cache in both.  Candidates lie in increasing
// segments, so their positions increase.  A candidate that the guard admits
// lies >= 2W-1 after the last emitted position, hence >= 2W-1 after every
// position emitted earlier in the sweep: its column is outside every earlier
// update window (which reach W-1 to either side), so the atom and score it
// reads in C are exactly the ones the serial loop would read.  A candidate
// whose column lies inside an earlier window is within W-1 of that window's
// position, so the guard rejects it whatever its code, and a rejected
// candidate emits nothing.  The decisions in C are therefore the serial ones,
// made by the same rounded operations in the same order (the products
// (2 c_hat) s and c_hat^2 do not depend on the running energy, so computing
// them ahead changes no bit).  Windows of two accepted candidates are >= 2W-1
// apart and disjoint, so the updates of D touch each score at most once and
// commute, and each column's cache entry is the maximum over its final
// scores, as after the serial update.
//
// Spec rules (docs/DESIGN.md "Numerical reproducibility"): no division in the
// loop (scale and 1/scale come from the host), round half away from zero as
// sign(y)*floor(|y|+0.5) (never rintf), and every product and sum rounded on
// its own (__fmul_rn / __fsub_rn / __fadd_rn, and the build passes
// -fmad=false).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

// Phase clocks, for scripts/torch_mp_loop_phases.py only: built with
// -DHSC_MP_PHASE_CLOCKS, thread 0 of every CTA adds the cycles it spends in
// the first pass, in phase A, in phase C's gather and walk, and in phase D
// (each up to the barrier or warp sync that ends it) and the sweep count to
// g_phase_cycles.  The library the port loads is built without it, and
// PHASE_MARK is then empty.
#ifdef HSC_MP_PHASE_CLOCKS
__device__ unsigned long long g_phase_cycles[6];
#define PHASE_MARK(slot)                    \
  do {                                      \
    if (tid == 0) {                         \
      const long long now = clock64();      \
      phase[slot] += now - phase_last;      \
      phase_last = now;                     \
    }                                       \
  } while (0)
#else
#define PHASE_MARK(slot) \
  do {                   \
  } while (0)
#endif

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// atoms whose loads one thread has in flight at once: all of a chunk is
// loaded before any of it is used, and 32 values (16 scores and 16 Gram
// entries in phase D, 32 scores in the first pass) stay within the 128
// registers a thread of a 512-thread CTA may hold
constexpr int kChunk = 16;
constexpr unsigned kFull = 0xffffffffu;

// (v, i) beats (bv, bi): larger value, then lower index
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// lane 0 ends with the warp's best (value, index)
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(kFull, v, off);
    const int oi = __shfl_down_sync(kFull, i, off);
    if (beats(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// selection-cache values are |score| * weight >= +0, whose float bits order
// like the values; ~position makes the lower position the larger key
__device__ __forceinline__ unsigned long long pack_key(float v, int i) {
  return (static_cast<unsigned long long>(__float_as_uint(v)) << 32) |
         static_cast<unsigned>(~static_cast<unsigned>(i));
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// ask L2 for the 128-byte lines of [p, p + n) floats
__device__ __forceinline__ void prefetch_span(const float* p, int n) {
  const uintptr_t last = reinterpret_cast<uintptr_t>(p + n - 1);
  for (uintptr_t a = reinterpret_cast<uintptr_t>(p) & ~uintptr_t(127); a <= last; a += 128)
    prefetch_l2(reinterpret_cast<const void*>(a));
}

// The column's selection-cache entry from its K scores `col[g * npos]`:
// the largest |score| * weight and the LOWEST atom that reaches it.  With
// `update`, every score first becomes s - c_hat * G (grow[g * lag]) and is
// written back.  `chunk` loads are issued before any of their values is used.
template <bool update, int chunk>
__device__ __forceinline__ void column_max(float* col, const float* grow, float c_hat, int K, int npos,
                                           int lag, const float* wsh, float& m, int& f) {
  m = -1.f;
  f = 0;
  for (int g0 = 0; g0 < K; g0 += chunk) {
    float v[chunk], gv[update ? chunk : 1];
    const float* src = col;
    const float* gsrc = grow;
#pragma unroll
    for (int u = 0; u < chunk; ++u) {
      if (g0 + u < K) {
        v[u] = *src;
        if (update) gv[update ? u : 0] = *gsrc;
      }
      src += npos;
      gsrc += lag;
    }
#pragma unroll
    for (int u = 0; u < chunk; ++u) {
      if (g0 + u < K) {
        float x = v[u];
        if (update) {
          x = __fsub_rn(x, __fmul_rn(c_hat, gv[update ? u : 0]));
          col[static_cast<size_t>(u) * npos] = x;
        }
        const float y = __fmul_rn(fabsf(x), wsh[g0 + u]);
        if (y > m) {  // atoms rise: strict > keeps the lowest
          m = y;
          f = g0 + u;
        }
      }
    }
    col += static_cast<size_t>(chunk) * npos;
    grow += static_cast<size_t>(chunk) * lag;
  }
}

// the selection cache's bytes: npos rounded up to a multiple of 128 (a
// multiple of 768 bytes, so what follows it stays 16-byte aligned)
__host__ __device__ __forceinline__ size_t cache_bytes(int npos) {
  return static_cast<size_t>((npos + 127) / 128 * 128) * (sizeof(float) + sizeof(unsigned short));
}

__global__ void __launch_bounds__(kThreads, 1)
mp_encode_kernel(float* __restrict__ scores,        // [B, K, npos], in place
                 const float* __restrict__ e0,      // [B]
                 const float* __restrict__ scale,   // [B]
                 const float* __restrict__ inv,     // [B]
                 const float* __restrict__ gram_t,  // [K, K, 2W-1]
                 const float* __restrict__ weights, // [K]
                 int* __restrict__ positions,       // [B, M]
                 int* __restrict__ atoms,           // [B, M]
                 int* __restrict__ codes,           // [B, M]
                 int* __restrict__ count_out,       // [B]
                 float* __restrict__ eres_out,      // [B]
                 unsigned char* __restrict__ cache_ws,  // [B, cache bytes] or null
                 int K, int W, int npos, int M, int S, int seg_len, int span,
                 float maxcode, int has_tol, float snr_factor) {
  // the selection cache holds npos rounded up to a multiple of 128, a whole
  // phase-A step (entries past npos are never taken as candidates); in shared
  // memory, or in this block's slice of cache_ws (16-byte aligned: 6 * ncache
  // is a multiple of 16, and so is the workspace's base)
  extern __shared__ __align__(16) unsigned char smem[];
  const int ncache = (npos + 127) / 128 * 128;
  unsigned char* cache = cache_ws ? cache_ws + blockIdx.x * cache_bytes(npos) : smem;
  float* colmax = reinterpret_cast<float*>(cache);                          // [ncache]
  unsigned short* colarg = reinterpret_cast<unsigned short*>(colmax + ncache);  // [ncache]
  unsigned long long* cand =
      reinterpret_cast<unsigned long long*>(cache_ws ? smem : smem + cache_bytes(npos));  // [S]
  float* wsh = reinterpret_cast<float*>(cand + S);  // [K] selection weights
  float* cand_s = wsh + K;          // [S] score at (f, t)
  float* cand_c = cand_s + S;       // [S] c_hat = code * scale
  float* cand_e2 = cand_c + S;      // [S] (2 c_hat) s
  float* cand_c2 = cand_e2 + S;     // [S] c_hat^2
  float* acc_c = cand_c2 + S;       // [S] c_hat of the accepted
  int* cand_t = reinterpret_cast<int*>(acc_c + S);  // [S] position, -1: none
  int* cand_f = cand_t + S;         // [S] atom
  int* cand_code = cand_f + S;      // [S] code
  int* acc_t = cand_code + S;       // [S] accepted positions
  int* acc_f = acc_t + S;           // [S] accepted atoms
  __shared__ int n_acc_sh;
  __shared__ int stop_sh;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x;
  const int lag = 2 * W - 1;
  float* sc = scores + static_cast<size_t>(b) * K * npos;
  int* pos_out = positions + static_cast<size_t>(b) * M;
  int* atom_out = atoms + static_cast<size_t>(b) * M;
  int* code_out = codes + static_cast<size_t>(b) * M;
  const float scale_b = scale[b];
  const float inv_b = inv[b];

#ifdef HSC_MP_PHASE_CLOCKS
  long long phase[6] = {0, 0, 0, 0, 0, 0};  // init, A, C's gather, C's walk, D, sweeps
  long long phase_last = clock64();
#endif
  // per-block state, meaningful in thread 0 only
  int count = 0;
  float e_res = e0[b];
  const float snr_thr = __fmul_rn(e0[b], snr_factor);
  bool done = !(scale_b > 0.f);  // an all-zero block emits nothing
  bool stop = done || M == 0;    // the same value in every thread

  for (int i = tid; i < M; i += kThreads) {
    pos_out[i] = 0;
    atom_out[i] = 0;
    code_out[i] = 0;
  }
  for (int g = tid; g < K; g += kThreads) wsh[g] = weights[g];
  for (int j = tid; j < S; j += kThreads) cand[j] = 0ull;  // 0 = no candidate
  __syncthreads();
  // the selection cache: each column's weighted maximum and its atom
  for (int p = tid; p < npos && !stop; p += kThreads) {
    float m;
    int f;
    column_max<false, 2 * kChunk>(sc + p, gram_t, 0.f, K, npos, lag, wsh, m, f);
    colmax[p] = m;
    colarg[p] = static_cast<unsigned short>(f);
  }
  __syncthreads();
  PHASE_MARK(0);

  while (!stop) {
    // ---- A: one candidate per segment from the sweep-start cache ----------
    // Each warp scans its run of `span` positions in steps of 128, four per
    // lane (one conflict-free 16-byte shared load); seg_len is a multiple of
    // 128, so a step never straddles a segment.
    {
      const int end = min((warp + 1) * span, npos);
      float bv = -1.f;
      int bi = INT_MAX;
      int seg = -1;
      for (int base = warp * span; base < end; base += 128) {
        const int sj = base / seg_len;  // uniform across the warp
        if (sj != seg) {
          if (seg >= 0) {
            warp_argmax(bv, bi);
            if (lane == 0 && bi != INT_MAX) atomicMax(&cand[seg], pack_key(bv, bi));
          }
          seg = sj;
          bv = -1.f;
          bi = INT_MAX;
        }
        const int p = base + 4 * lane;
        const float4 v4 = *reinterpret_cast<const float4*>(colmax + p);
        // positions rise per lane: strict > keeps the first
        if (p < npos && v4.x > bv) { bv = v4.x; bi = p; }
        if (p + 1 < npos && v4.y > bv) { bv = v4.y; bi = p + 1; }
        if (p + 2 < npos && v4.z > bv) { bv = v4.z; bi = p + 2; }
        if (p + 3 < npos && v4.w > bv) { bv = v4.w; bi = p + 3; }
      }
      if (seg >= 0) {
        warp_argmax(bv, bi);
        if (lane == 0 && bi != INT_MAX) atomicMax(&cand[seg], pack_key(bv, bi));
      }
    }
    __syncthreads();
    PHASE_MARK(1);

    // ---- C: warp 0 decides; the other warps warm L2 for phase D -------------
    if (warp == 0) {
      // every candidate at once: its atom is the cache's, its score and code
      // the sweep-start ones
      for (int j = lane; j < S; j += 32) {
        const unsigned long long key = cand[j];
        int t = -1, f = 0, code = 0;
        float s = 0.f, c_hat = 0.f;
        if (key != 0ull) {
          t = static_cast<int>(~static_cast<unsigned>(key & 0xffffffffull));
          f = colarg[t];
          s = sc[static_cast<size_t>(f) * npos + t];
          const float y = __fmul_rn(s, inv_b);
          float r = floorf(__fadd_rn(fabsf(y), 0.5f));
          r = y > 0.f ? r : (y < 0.f ? -r : 0.f);
          r = fminf(fmaxf(r, -maxcode), maxcode);
          code = static_cast<int>(r);
          c_hat = __fmul_rn(static_cast<float>(code), scale_b);
        }
        cand_t[j] = t;
        cand_f[j] = f;
        cand_code[j] = code;
        cand_s[j] = s;
        cand_c[j] = c_hat;
        cand_e2[j] = __fmul_rn(__fmul_rn(2.f, c_hat), s);
        cand_c2[j] = __fmul_rn(c_hat, c_hat);
      }
      __syncwarp();
      PHASE_MARK(2);
      if (lane == 0) {
        // the serial walk, in candidate order
        int n_acc = 0;
        int last_t = -1;
#pragma unroll 4
        for (int j = 0; j < S; ++j) {
          const int t = cand_t[j];
          const int code = cand_code[j];
          if (t < 0 || done || count >= M || code == 0) continue;
          if (last_t >= 0 && t - last_t < lag) continue;  // interference guard
          pos_out[count] = t;
          atom_out[count] = cand_f[j];
          code_out[count] = code;
          ++count;
          // e - (2 c_hat) s + c_hat^2 in the oracle's op order
          e_res = __fadd_rn(__fsub_rn(e_res, cand_e2[j]), cand_c2[j]);
          last_t = t;
          acc_t[n_acc] = t;
          acc_f[n_acc] = cand_f[j];
          acc_c[n_acc] = cand_c[j];
          ++n_acc;
          if (has_tol && e_res <= snr_thr) done = true;
        }
        if (n_acc == 0) done = true;  // a sweep that accepts nothing ends the block
        n_acc_sh = n_acc;
        stop_sh = done || count >= M;
      }
    } else {
      for (int j = warp - 1; j < S; j += kWarps - 1) {
        const unsigned long long key = cand[j];
        if (key == 0ull) continue;
        const int t = static_cast<int>(~static_cast<unsigned>(key & 0xffffffffull));
        const int lo = max(0, t - W + 1);
        const int wlen = min(npos, t + W) - lo;
        for (int g = lane; g < K; g += 32) prefetch_span(sc + static_cast<size_t>(g) * npos + lo, wlen);
        const float* gf = gram_t + static_cast<size_t>(colarg[t]) * K * lag;
        for (int q = lane * 32; q < K * lag; q += 32 * 32) prefetch_l2(gf + q);
      }
    }
    __syncthreads();
    PHASE_MARK(3);
    stop = stop_sh;
    const int n_acc = n_acc_sh;

    // ---- D: every accepted window at once, one column per thread -----------
    for (int j = tid; j < S; j += kThreads) cand[j] = 0ull;  // for the next phase A
    for (int idx = tid; idx < n_acc * lag; idx += kThreads) {
      const int a = idx / lag;
      const int c = idx - a * lag;
      const int p = acc_t[a] - (W - 1) + c;
      if (p < 0 || p >= npos) continue;
      float m;
      int f;
      column_max<true, kChunk>(sc + p, gram_t + static_cast<size_t>(acc_f[a]) * K * lag + c, acc_c[a], K, npos,
                       lag, wsh, m, f);
      colmax[p] = m;
      colarg[p] = static_cast<unsigned short>(f);
    }
    __syncthreads();
    PHASE_MARK(4);
#ifdef HSC_MP_PHASE_CLOCKS
    if (tid == 0) ++phase[5];
#endif
  }

  if (tid == 0) {
    count_out[b] = count;
    eres_out[b] = fmaxf(e_res, 0.f);
#ifdef HSC_MP_PHASE_CLOCKS
    for (int i = 0; i < 6; ++i)
      atomicAdd(&g_phase_cycles[i], static_cast<unsigned long long>(phase[i]));
#endif
  }
}

// the shared memory beside the selection cache: the candidates, weights and
// per-candidate scratch
size_t rest_bytes(int K, int S) {
  return sizeof(unsigned long long) * S + sizeof(float) * K + sizeof(int) * 10 * S;
}

// The most dynamic shared memory a launch may ask for on the current device:
// the card's opt-in limit per block less the kernel's static shared memory.
// On first use on a device it also lifts the kernel's limit to that, once,
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
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, mp_encode_kernel);
  if (err != cudaSuccess) return err;
  const int v = optin - static_cast<int>(fa.sharedSizeBytes);
  err = cudaFuncSetAttribute(mp_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, v);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices) limit[dev] = v;
  *bytes = v;
  return cudaSuccess;
}

}  // namespace

// Bytes of global workspace per block that a launch at (K, npos, S) needs for
// its selection cache on the current device: 0 when the cache fits in shared
// memory beside the rest, else the cache's size (a multiple of 16); a CUDA
// error is returned negated.
extern "C" int hsc_mp_encode_workspace(int K, int npos, int S) {
  if (K < 1 || npos < 1 || S < 1) return -static_cast<int>(cudaErrorInvalidValue);
  int limit = 0;
  const cudaError_t err = dynamic_smem_limit(&limit);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (cache_bytes(npos) + rest_bytes(K, S) <= static_cast<size_t>(limit)) return 0;
  return static_cast<int>(cache_bytes(npos));
}

// `cache_ws`: null, or B slices of hsc_mp_encode_workspace(K, npos, S) bytes
// (16-byte aligned) that hold the selection caches instead of shared memory.
extern "C" int hsc_mp_encode(float* scores, const float* e0, const float* scale,
                             const float* inv, const float* gram_t,
                             const float* weights, int* positions, int* atoms,
                             int* codes, int* count, float* e_res, int B, int K,
                             int W, int npos, int M, int S, float maxcode,
                             int has_tol, float snr_factor, void* cache_ws, void* stream) {
  if (B == 0) return cudaSuccess;
  // atoms are cached as 16-bit indexes
  if (K < 1 || K > 65535 || W < 1 || npos < 1 || M < 0 || S < 1) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(cache_ws) % 16 != 0) return cudaErrorMisalignedAddress;
  const int seg_len = 128 * ((npos + 128 * S - 1) / (128 * S));
  // each warp's phase-A run: whole 128-position steps
  const int span = 128 * ((npos + kWarps * 128 - 1) / (kWarps * 128));
  const size_t smem = rest_bytes(K, S) + (cache_ws ? 0 : cache_bytes(npos));
  int limit = 0;
  const cudaError_t err = dynamic_smem_limit(&limit);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(limit)) return cudaErrorInvalidValue;  // needs a workspace
  mp_encode_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      scores, e0, scale, inv, gram_t, weights, positions, atoms, codes, count, e_res,
      static_cast<unsigned char*>(cache_ws), K, W, npos, M, S, seg_len, span, maxcode, has_tol,
      snr_factor);
  return cudaGetLastError();
}

#ifdef HSC_MP_PHASE_CLOCKS
// copies the phase totals to `out` [6] and zeroes them
extern "C" int hsc_mp_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
  if (err != cudaSuccess) return err;
  const unsigned long long zero[6] = {0, 0, 0, 0, 0, 0};
  return cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
}
#endif

extern "C" const char* hsc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
