// Order-free integer decode (decode_mode='integer', format v2) on Hopper:
// one CTA reconstructs one block.
//
// Replaces: hsc_tpu/ops/decode_integer_kernel.py :: _int_decode_kernel (the
// Pallas kernel behind mp_decode_integer_pallas).  Spec
// (hsc_tpu/oracle/mp.py :: mp_decode_integer):
//   out[t] = f32( sum_{i < count} code_i * rep_q[atom_i][t - pos_i]  mod 2^32 )
//            * amp_step
// The plain PyTorch version is hsc_torch/ops/decode.py ::
// mp_decode_integer_batch_torch.
//
// The TPU form (one-hot gather matmuls, log2 W sublane rolls, an int8
// digit-bucket matmul, padding around a Mosaic mis-lowering) existed to avoid
// scatter on the MXU.  Here a scatter into shared memory is the natural
// form: integer addition mod 2^32 is associative and commutative, so
// shared-memory atomicAdd on 32-bit words gives the spec's integers in any
// order, exactly.  The products and sums are taken as unsigned 32-bit words:
// their wraparound IS the spec's mod 2^32 (and there is no signed overflow).
//
// What bounds it on this card: per block, count*W shared-memory atomics
// (flagship 512 x 32) and one N-float store (64 KB); the accumulator (N int32,
// 64 KB at N = 16384) and the K x W table (8 KB) live in shared memory, so
// device memory sees only the events in and the samples out.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
int_decode_kernel(const int* __restrict__ positions,  // [B, M]
                  const int* __restrict__ atoms,      // [B, M]
                  const int* __restrict__ codes,      // [B, M]
                  const int* __restrict__ count,      // [B]
                  const float* __restrict__ amp_step, // [B]
                  const int* __restrict__ rep_q,      // [K, W]
                  float* __restrict__ out,            // [B, N]
                  int M, int K, int W, int N) {
  extern __shared__ unsigned int smem_u[];
  unsigned int* acc = smem_u;  // [N]
  unsigned int* rep = acc + N; // [K * W]
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const size_t ev0 = static_cast<size_t>(b) * M;

  for (int t = tid; t < N; t += kThreads) acc[t] = 0u;
  for (int i = tid; i < K * W; i += kThreads) rep[i] = static_cast<unsigned>(rep_q[i]);
  __syncthreads();

  const int n_ev = min(max(count[b], 0), M);
  const int total = n_ev * W;
  for (int idx = tid; idx < total; idx += kThreads) {
    const int i = idx / W;
    const int u = idx - i * W;
    const int p = positions[ev0 + i];
    const int a = atoms[ev0 + i];
    // never true in a valid stream; such an event is ignored, as in the
    // plain version, rather than written out of bounds
    if (p < 0 || p > N - W || a < 0 || a >= K) continue;
    atomicAdd(&acc[p + u], static_cast<unsigned>(codes[ev0 + i]) * rep[a * W + u]);
  }
  __syncthreads();

  const float st = amp_step[b];
  float* o = out + static_cast<size_t>(b) * N;
  for (int t = tid; t < N; t += kThreads)
    o[t] = __fmul_rn(__int2float_rn(static_cast<int>(acc[t])), st);
}

}  // namespace

extern "C" int hsc_int_decode(const int* positions, const int* atoms, const int* codes,
                              const int* count, const float* amp_step, const int* rep_q,
                              float* out, int B, int M, int K, int W, int N,
                              void* stream) {
  if (B == 0) return cudaSuccess;
  if (K < 1 || W < 1 || N < W || M < 0) return cudaErrorInvalidValue;
  const size_t smem = sizeof(unsigned int) * (static_cast<size_t>(N) + static_cast<size_t>(K) * W);
  cudaError_t err = cudaFuncSetAttribute(
      int_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int_decode_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      positions, atoms, codes, count, amp_step, rep_q, out, M, K, W, N);
  return cudaGetLastError();
}
