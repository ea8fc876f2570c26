// Order-free integer decode (decode_mode='integer', format v2) on Hopper:
// one CTA per tile of a block, events staged and listed per tile.
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
// scatter on the MXU.  Here each CTA sums the taps of its tile's listed
// events into a shared tile of 32-bit words with shared atomics
// (decode_tiles.cuh): warps take events, lanes their taps.  The products and
// sums are taken as unsigned 32-bit words: their wraparound IS the spec's mod
// 2^32 (and there is no signed overflow), and integer addition is
// order-free, so any order gives the spec's integers exactly.  (The ordered
// decode's owner walk, one test per listed event per thread, took 1.8x as
// long here: PERF.md, PR 5.)
//
// What bounds it on this card: bytes -- the events in (12 B each) and the
// rows out (64 KB per 16384-sample block, 4.2 MB per 64-block batch, 1.3 us
// at 3.35 TB/s).  At these sizes a launch is a few memory round trips
// (count and events, the table through L1, the stores), so the design keeps
// the whole batch in one wave of CTAs (1024 at the flat flagship) and gives
// each CTA only the events that meet its tile.  No shared-memory size
// depends on the block size.

#include "decode_tiles.cuh"

namespace {

struct IntOp {
  using Table = int;
  using Acc = unsigned int;
  static constexpr bool kScatter = true;  // order-free: the shared tile with atomics
  __device__ static int staged(int code, float) { return code; }
  __device__ static void scatter(unsigned int* word, int code, int tap) {
    atomicAdd(word, static_cast<unsigned int>(code) * static_cast<unsigned int>(tap));
  }
  __device__ static float finish(unsigned int acc, float amp_step) {
    return __fmul_rn(__int2float_rn(static_cast<int>(acc)), amp_step);
  }
};

}  // namespace

extern "C" int hsc_int_decode(const int* positions, const int* atoms, const int* codes,
                              const int* count, const float* amp_step, const int* rep_q,
                              float* out, int B, int M, int K, int W, int N,
                              void* stream) {
  // single-channel tables only: no surface decodes a multichannel one in
  // integer mode
  return launch_decode_tiles<IntOp>(positions, atoms, codes, count, amp_step, rep_q, out, B, M, K, W, N,
                                    1, stream);
}
