// Ordered decode (decode_mode='ordered', format v1) on Hopper: stream-order
// overlap-add with multiply-round-add-round float32 arithmetic, one CTA per
// tile of a block, events staged and listed per tile.
//
// Replaces: hsc_tpu/ops/decode_kernel.py :: _decode_kernel (the Pallas
// kernel behind mp_decode_pallas, which takes C == 1 only; the JAX package
// decodes a multichannel bank through XLA).  Spec (hsc_tpu/oracle/mp.py ::
// mp_decode):
//   for i < count, in stream order:
//     c_hat = f32(code_i * scale)
//     out[pos_i + u, c] = f32(out[pos_i + u, c] + f32(c_hat * bank[atom_i][u, c]))
// A bank of C > 1 channels is the level-space decode of a level >= 1 (its
// augmented bank, C the atoms of the level below); the walk runs on the
// flattened rows (decode_tiles.cuh), so nothing here depends on C.
// The plain PyTorch version is hsc_torch/ops/decode.py :: mp_decode_batch_torch.
//
// Float addition is not associative, so each sample must add its own
// contributions in stream order: no float atomics, no reordering.  The
// tiled walk (decode_tiles.cuh) gives each sample one owner thread, which
// adds the tile's listed events in stream order (the list is stable); c_hat
// is rounded once per event when it is staged.  Every rounding is spelled
// (__fmul_rn, __fadd_rn, and the build passes -fmad=false), and each sum
// starts at +0.0, as the plain version's does.
//
// What bounds it on this card: bytes -- the events in and the rows out (64
// KB per 16384-sample block, 4.2 MB per 64-block batch, 1.3 us at 3.35
// TB/s).  The flagship hierarchy's top stream is <= 192 events of width 96
// per block, so a 1024-sample tile lists ~13 of them and a thread's 8-sample
// run meets one or two.

#include "decode_tiles.cuh"

namespace {

struct OrderedOp {
  using Table = float;
  using Acc = float;
  static constexpr bool kScatter = false;  // stream order per sample: the owner walk
  __device__ static int staged(int code, float scale) {
    return __float_as_int(__fmul_rn(static_cast<float>(code), scale));  // c_hat
  }
  __device__ static void add(float& acc, int c_hat, float tap) {
    acc = __fadd_rn(acc, __fmul_rn(__int_as_float(c_hat), tap));
  }
  __device__ static float finish(float acc, float) { return acc; }
};

}  // namespace

extern "C" int hsc_ordered_decode(const int* positions, const int* atoms, const int* codes,
                                  const int* count, const float* scale, const float* bank,
                                  float* out, int B, int M, int K, int W, int N, int C,
                                  void* stream) {
  return launch_decode_tiles<OrderedOp>(positions, atoms, codes, count, scale, bank, out, B, M, K, W, N, C,
                                        stream);
}
