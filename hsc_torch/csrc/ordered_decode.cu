// Ordered decode (decode_mode='ordered', format v1) on Hopper: stream-order
// overlap-add with multiply-round-add-round float32 arithmetic.
//
// Replaces: hsc_tpu/ops/decode_kernel.py :: _decode_kernel (the Pallas
// kernel behind mp_decode_pallas).  Spec (hsc_tpu/oracle/mp.py :: mp_decode):
//   for i < count, in stream order:
//     c_hat = f32(code_i * scale)
//     out[pos_i + u] = f32(out[pos_i + u] + f32(c_hat * bank[atom_i][u]))
// The plain PyTorch version is hsc_torch/ops/decode.py :: mp_decode_batch_torch.
//
// Float addition is not associative, so each sample must add its own
// contributions in stream order: no float atomics, no reordering.  What
// bounds the kernel is the serial event loop per sample, not bytes (the
// flagship top stream is <= 192 events over a 16384-sample block, 64 KB out).
// Design: samples are the parallel axis.  A CTA takes one block and a tile
// of kThreads * kRun samples; each thread owns kRun contiguous samples in
// registers and walks the events in stream order (staged in shared memory,
// kEvChunk at a time, with c_hat already rounded).  An event that does not
// overlap the thread's run costs one comparison; one that does adds to the
// samples it covers.  No barrier per event: each sample has one owner, so
// its adds happen in stream order in that thread.  The representation bank
// (96 x 96 f32 = 36 KB at the flagship) is read through L1/L2, so every
// bank shape the codec admits takes the same kernel, wider than blockDim
// included.  Every rounding is spelled (__fmul_rn, __fadd_rn, and the build
// passes -fmad=false).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 8;        // contiguous samples per thread
constexpr int kTileN = kThreads * kRun;
constexpr int kEvChunk = 512;  // events staged per round

__global__ void __launch_bounds__(kThreads)
ordered_decode_kernel(const int* __restrict__ positions,  // [B, M]
                      const int* __restrict__ atoms,      // [B, M]
                      const int* __restrict__ codes,      // [B, M]
                      const int* __restrict__ count,      // [B]
                      const float* __restrict__ scale,    // [B]
                      const float* __restrict__ bank,     // [K, W]
                      float* __restrict__ out,            // [B, N]
                      int M, int K, int W, int N) {
  __shared__ int s_pos[kEvChunk];
  __shared__ int s_atom[kEvChunk];
  __shared__ float s_chat[kEvChunk];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTileN + tid * kRun;  // this thread's run
  const size_t ev0 = static_cast<size_t>(b) * M;
  const int n_ev = min(max(count[b], 0), M);
  const float sc = scale[b];

  float acc[kRun];
#pragma unroll
  for (int j = 0; j < kRun; ++j) acc[j] = 0.0f;

  for (int c0 = 0; c0 < n_ev; c0 += kEvChunk) {
    const int n_chunk = min(kEvChunk, n_ev - c0);
    for (int i = tid; i < n_chunk; i += kThreads) {
      const int p = positions[ev0 + c0 + i];
      const int a = atoms[ev0 + c0 + i];
      // never true in a valid stream; such an event is skipped, as in the
      // plain version, rather than read or written out of bounds
      const bool ok = p >= 0 && p <= N - W && a >= 0 && a < K;
      s_pos[i] = ok ? p : -W - kRun;  // overlaps no run
      s_atom[i] = ok ? a : 0;
      s_chat[i] = __fmul_rn(static_cast<float>(codes[ev0 + c0 + i]), sc);
    }
    __syncthreads();
    for (int i = 0; i < n_chunk; ++i) {
      const int p = s_pos[i];
      if (p >= t0 + kRun || p + W <= t0) continue;
      const float c_hat = s_chat[i];
      const float* row = bank + static_cast<size_t>(s_atom[i]) * W;
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        const int u = t0 + j - p;
        if (u >= 0 && u < W) acc[j] = __fadd_rn(acc[j], __fmul_rn(c_hat, __ldg(row + u)));
      }
    }
    __syncthreads();  // the next chunk overwrites the staged events
  }

  float* o = out + static_cast<size_t>(b) * N;
#pragma unroll
  for (int j = 0; j < kRun; ++j)
    if (t0 + j < N) o[t0 + j] = acc[j];
}

}  // namespace

extern "C" int hsc_ordered_decode(const int* positions, const int* atoms, const int* codes,
                                  const int* count, const float* scale, const float* bank,
                                  float* out, int B, int M, int K, int W, int N,
                                  void* stream) {
  if (B == 0) return cudaSuccess;
  if (K < 1 || W < 1 || N < W || M < 0 || B > 65535) return cudaErrorInvalidValue;
  const dim3 grid((N + kTileN - 1) / kTileN, B);
  ordered_decode_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      positions, atoms, codes, count, scale, bank, out, M, K, W, N);
  return cudaGetLastError();
}
