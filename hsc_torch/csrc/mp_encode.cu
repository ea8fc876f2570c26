// Greedy convolutional matching pursuit on Hopper: one CTA encodes one block.
//
// Replaces: hsc_tpu/ops/mp_kernels.py :: _mp_kernel (the fused Pallas greedy
// loop, launched by _mp_pallas_stage).  It computes the spec of
// hsc_tpu/oracle/mp.py :: mp_encode given an injected init, bitwise: the
// plain PyTorch version is hsc_torch/ops/encode.py :: mp_encode_from_init_torch.
// The Mosaic layout (roll placement, 128-lane chunks, folded selection rows,
// MXU one-hot extraction) has no meaning here and is not carried over.
//
// What bounds it on this card: a block is a serial chain of accepts, each a
// selection followed by a small update (K x (2W-1) scores).  The work per
// accept is tiny, so the time is latency: block-wide barriers and the reads
// of the update window from L2 / device memory.  Flagship scores are
// K x npos f32 = 64 x 16353 x 4 B = 4.2 MB per block, far beyond the 227 KB
// of shared memory, so they stay in global memory (a scratch copy the
// wrapper makes); only the per-position selection cache (npos f32, 64 KB)
// lives in shared memory, where the argmax scans it.
//
// Design: blocks are the parallel axis (grid = B).  Every num_select S >= 1
// runs as sweeps; S = 1 is the plain greedy loop (see the plain version's
// docstring).  Per sweep:
//   A. segmented argmax of the selection cache -> one candidate per spec
//      segment (seg_len = 128*ceil(npos/(128*S))); warps scan contiguous
//      32-aligned runs, reduce with lowest-index tie-breaks, and merge into a
//      per-segment 64-bit key (value bits << 32 | ~position) with a shared
//      atomicMax — value first, then the LOWEST position, like argmax.
//   per candidate, left to right:
//   B. warp 0: atom argmax at the candidate column (lowest atom on ties);
//      thread 0 quantizes, checks code != 0, the 2W-1 guard and the budget,
//      records the event and runs the energy recursion and the SNR stop.
//   C. all warps: subtract c_hat * G[:, f, :] over the window (warps over
//      atoms, lanes over columns) and take each warp's column maxima.
//   D. merge the warps' maxima into the selection cache.
// Thread 0 owns the per-block state; it publishes each decision through a
// double-buffered shared slot, so a barrier separates every write of a slot
// from the reads of its previous value.
//
// Spec rules (docs/DESIGN.md "Numerical reproducibility"): no division in the
// loop (scale and 1/scale come from the host), round half away from zero as
// sign(y)*floor(|y|+0.5) (never rintf), and every product and sum rounded on
// its own (__fmul_rn / __fsub_rn / __fadd_rn, and the build passes
// -fmad=false).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// (v, i) beats (bv, bi): larger value, then lower index
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// lane 0 ends with the warp's best (value, index)
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_down_sync(kFull, v, off);
    int oi = __shfl_down_sync(kFull, i, off);
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

struct Decision {
  int emit;
  int f;
  int stop;
  float c_hat;
};

__global__ void __launch_bounds__(kThreads)
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
                 int K, int W, int npos, int M, int S, int seg_len,
                 float maxcode, int has_tol, float snr_factor) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* cand = smem;                        // [S]
  float* colmax = reinterpret_cast<float*>(cand + S);     // [npos]
  float* wsh = colmax + npos;                             // [K]
  const int lag = 2 * W - 1;
  float* part = wsh + K;                                  // [kWarps, lag]
  __shared__ Decision slot[2];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x;
  float* sc = scores + static_cast<size_t>(b) * K * npos;
  int* pos_out = positions + static_cast<size_t>(b) * M;
  int* atom_out = atoms + static_cast<size_t>(b) * M;
  int* code_out = codes + static_cast<size_t>(b) * M;
  const float scale_b = scale[b];
  const float inv_b = inv[b];

  // per-block state, meaningful in thread 0 only
  int count = 0;
  float e_res = e0[b];
  const float snr_thr = __fmul_rn(e0[b], snr_factor);
  bool done = !(scale_b > 0.f);  // an all-zero block emits nothing
  int last_t = -1;
  bool any = false;

  for (int i = tid; i < M; i += kThreads) {
    pos_out[i] = 0;
    atom_out[i] = 0;
    code_out[i] = 0;
  }
  for (int g = tid; g < K; g += kThreads) wsh[g] = weights[g];
  __syncthreads();
  for (int p = tid; p < npos; p += kThreads) {
    float m = 0.f;
    for (int g = 0; g < K; ++g)
      m = fmaxf(m, __fmul_rn(fabsf(sc[static_cast<size_t>(g) * npos + p]), wsh[g]));
    colmax[p] = m;
  }

  int step = 0;  // publish counter: slot[step & 1]
  if (tid == 0) slot[0].stop = done || count >= M;
  __syncthreads();
  bool stop = slot[step & 1].stop;
  ++step;

  // each warp scans one contiguous, 32-aligned run of positions in phase A;
  // seg_len is a multiple of 128, so a 32-wide group never straddles segments
  const int run = ((npos + kWarps - 1) / kWarps + 31) & ~31;

  while (!stop) {
    // ---- A: one candidate per segment from the sweep-start cache ----------
    for (int j = tid; j < S; j += kThreads) cand[j] = 0ull;  // 0 = no candidate
    __syncthreads();
    {
      const int p1 = min((warp + 1) * run, npos);
      float bv = -1.f;
      int bi = INT_MAX;
      int seg = -1;
      for (int base = warp * run; base < p1; base += 32) {
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
        const int p = base + lane;
        if (p < p1) {
          const float v = colmax[p];
          if (v > bv) {  // positions rise per lane: strict > keeps the first
            bv = v;
            bi = p;
          }
        }
      }
      if (seg >= 0) {
        warp_argmax(bv, bi);
        if (lane == 0 && bi != INT_MAX) atomicMax(&cand[seg], pack_key(bv, bi));
      }
    }
    __syncthreads();
    if (tid == 0) {
      last_t = -1;
      any = false;
    }

    for (int j = 0; j < S && !stop; ++j) {
      const unsigned long long key = cand[j];
      if (key == 0ull) continue;  // segment lies past npos
      const int t = static_cast<int>(~static_cast<unsigned>(key & 0xffffffffull));

      // ---- B: atom argmax at column t, quantize, decide ------------------
      if (warp == 0) {
        float bv = -1.f;
        int bi = INT_MAX;
        for (int g = lane; g < K; g += 32) {
          const float v = __fmul_rn(fabsf(sc[static_cast<size_t>(g) * npos + t]), wsh[g]);
          if (v > bv) {
            bv = v;
            bi = g;
          }
        }
        warp_argmax(bv, bi);
        if (lane == 0) {
          const int f = bi;
          const float s = sc[static_cast<size_t>(f) * npos + t];
          const float y = __fmul_rn(s, inv_b);
          float r = floorf(__fadd_rn(fabsf(y), 0.5f));
          r = y > 0.f ? r : (y < 0.f ? -r : 0.f);
          r = fminf(fmaxf(r, -maxcode), maxcode);
          const int code = static_cast<int>(r);
          const bool guard_ok = last_t < 0 || t - last_t >= lag;
          const bool emit = !done && code != 0 && guard_ok && count < M;
          float c_hat = 0.f;
          if (emit) {
            c_hat = __fmul_rn(static_cast<float>(code), scale_b);
            pos_out[count] = t;
            atom_out[count] = f;
            code_out[count] = code;
            ++count;
            // e - (2 c_hat) s + c_hat^2 in the oracle's op order
            e_res = __fadd_rn(__fsub_rn(e_res, __fmul_rn(__fmul_rn(2.f, c_hat), s)),
                              __fmul_rn(c_hat, c_hat));
            last_t = t;
            any = true;
            if (has_tol && e_res <= snr_thr) done = true;
          }
          Decision& d = slot[step & 1];
          d.emit = emit;
          d.f = f;
          d.c_hat = c_hat;
          d.stop = done || count >= M;
        }
      }
      __syncthreads();
      const Decision d = slot[step & 1];
      ++step;
      stop = d.stop;
      if (!d.emit) continue;

      // ---- C: window update + per-warp column maxima ---------------------
      const int lo = max(0, t - W + 1);
      const int wlen = min(npos, t + W) - lo;
      const int dlo = lo - (t - W + 1);
      const float* grow = gram_t + static_cast<size_t>(d.f) * K * lag + dlo;
      for (int c = lane; c < wlen; c += 32) {
        float m = 0.f;
        for (int g = warp; g < K; g += kWarps) {
          float* sp = sc + static_cast<size_t>(g) * npos + lo + c;
          const float v = __fsub_rn(*sp, __fmul_rn(d.c_hat, grow[static_cast<size_t>(g) * lag + c]));
          *sp = v;
          m = fmaxf(m, __fmul_rn(fabsf(v), wsh[g]));
        }
        part[warp * lag + c] = m;
      }
      __syncthreads();
      // ---- D: merge into the selection cache -----------------------------
      for (int c = tid; c < wlen; c += kThreads) {
        float m = part[c];
        for (int q = 1; q < kWarps; ++q) m = fmaxf(m, part[q * lag + c]);
        colmax[lo + c] = m;
      }
      __syncthreads();
    }

    // ---- sweep end: a sweep that accepted nothing ends the block ----------
    if (tid == 0) {
      if (!any) done = true;
      slot[step & 1].stop = done || count >= M;
    }
    __syncthreads();
    stop = slot[step & 1].stop;
    ++step;
  }

  if (tid == 0) {
    count_out[b] = count;
    eres_out[b] = fmaxf(e_res, 0.f);
  }
}

}  // namespace

extern "C" int hsc_mp_encode(float* scores, const float* e0, const float* scale,
                             const float* inv, const float* gram_t,
                             const float* weights, int* positions, int* atoms,
                             int* codes, int* count, float* e_res, int B, int K,
                             int W, int npos, int M, int S, float maxcode,
                             int has_tol, float snr_factor, void* stream) {
  if (B == 0) return cudaSuccess;
  if (K < 1 || W < 1 || npos < 1 || M < 0 || S < 1) return cudaErrorInvalidValue;
  const int seg_len = 128 * ((npos + 128 * S - 1) / (128 * S));
  const size_t smem = sizeof(unsigned long long) * S +
                      sizeof(float) * (static_cast<size_t>(npos) + K + kWarps * (2 * W - 1));
  cudaError_t err = cudaFuncSetAttribute(
      mp_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  mp_encode_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      scores, e0, scale, inv, gram_t, weights, positions, atoms, codes, count, e_res,
      K, W, npos, M, S, seg_len, maxcode, has_tol, snr_factor);
  return cudaGetLastError();
}

extern "C" const char* hsc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
