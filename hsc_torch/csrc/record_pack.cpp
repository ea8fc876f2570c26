// Batched block-record packer for fixed-entropy top-form containers
// (hsc_torch/record_pack.py; called from runtime.CorpusEncoder._emit_batched).
//
// One call writes a whole batch's block records back to back, each exactly
// the bytes of runtime._emit_record(cfg, stream, False) under
// entropy='fixed':
//
//   u8 n_streams = 1 | u8 level | u32 n (LE) | f32 scale (LE) | payload
//   payload: per event, MSB-first, position (pos_bits) | atom (atom_bits) |
//            code + amp_maxcode (amp_bits), padded with zero bits to a byte
//
// Each field is masked to its width as hsc_pack_events (csrc/bitpack.cpp)
// masks it, so out-of-range values pack to the same bytes there and here.
// An event is composed into one 64-bit value and shifted into a 64-bit
// accumulator that is stored a big-endian word at a time; only a record's
// last partial word is stored byte by byte.  Events wider than 64 bits are
// refused (the caller then packs block by block).
//
// Build: g++ -O3 -shared -fPIC -o librecordpack.so record_pack.cpp

#include <cstdint>
#include <cstring>

namespace {

inline uint64_t field(int64_t v, int w) {
  const uint64_t mask = (w >= 64) ? ~0ULL : ((1ULL << w) - 1);
  return static_cast<uint64_t>(v) & mask;
}

inline uint64_t shl(uint64_t v, int s) { return s >= 64 ? 0 : v << s; }

inline void store_be64(uint8_t* p, uint64_t v) {
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
  v = __builtin_bswap64(v);
#endif
  std::memcpy(p, &v, 8);
}

inline void store_le32(uint8_t* p, uint32_t v) {
  p[0] = static_cast<uint8_t>(v);
  p[1] = static_cast<uint8_t>(v >> 8);
  p[2] = static_cast<uint8_t>(v >> 16);
  p[3] = static_cast<uint8_t>(v >> 24);
}

}  // namespace

extern "C" {

// pos/atom/code: every block's events back to back, counts[b] of them for
// block b.  offsets[n_blocks + 1] receives each record's start in `out` and
// the end of the last; `out` holds at least
// 10 * n_blocks + (sum(counts) * event_bits + 7 * n_blocks) / 8 bytes.
// Returns the bytes written, or -1 if the event is wider than 64 bits or a
// count is negative.
int64_t hsc_pack_records(const int32_t* pos, const int32_t* atom,
                         const int32_t* code, const int32_t* counts,
                         const float* scales, int32_t n_blocks, int32_t level,
                         int32_t pos_bits, int32_t atom_bits, int32_t amp_bits,
                         int32_t amp_maxcode, int64_t* offsets, uint8_t* out) {
  const int ebits = pos_bits + atom_bits + amp_bits;
  if (pos_bits < 0 || atom_bits < 0 || amp_bits < 0 || ebits > 64) return -1;
  const int ac_bits = atom_bits + amp_bits;
  int64_t off = 0;
  int64_t ev0 = 0;
  for (int32_t b = 0; b < n_blocks; ++b) {
    const int32_t n = counts[b];
    if (n < 0) return -1;
    offsets[b] = off;
    uint8_t* p = out + off;
    uint32_t scale_bits;
    std::memcpy(&scale_bits, &scales[b], 4);
    p[0] = 1;
    p[1] = static_cast<uint8_t>(level);
    store_le32(p + 2, static_cast<uint32_t>(n));
    store_le32(p + 6, scale_bits);
    p += 10;

    uint64_t acc = 0;  // the low `nacc` bits are pending, MSB first
    int nacc = 0;      // always < 64 between events
    for (int64_t i = ev0; i < ev0 + n; ++i) {
      const uint64_t ev = shl(field(pos[i], pos_bits), ac_bits) |
                          shl(field(atom[i], atom_bits), amp_bits) |
                          field(static_cast<int64_t>(code[i]) + amp_maxcode, amp_bits);
      const int room = 64 - nacc;
      if (ebits < room) {
        acc = shl(acc, ebits) | ev;
        nacc += ebits;
      } else {
        const int rest = ebits - room;  // bits of ev left for the next word
        store_be64(p, shl(acc, room) | (ev >> rest));
        p += 8;
        acc = rest ? (ev & ((1ULL << rest) - 1)) : 0;
        nacc = rest;
      }
    }
    if (nacc) {
      const uint64_t left = acc << (64 - nacc);
      for (int k = 0; k < (nacc + 7) / 8; ++k) *p++ = static_cast<uint8_t>(left >> (56 - 8 * k));
    }
    ev0 += n;
    off = p - out;
  }
  offsets[n_blocks] = off;
  return off;
}

}  // extern "C"
