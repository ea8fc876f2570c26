// Batched block-record packer and unpacker for fixed-entropy top-form
// containers (hsc_torch/record_pack.py; called from
// runtime.CorpusEncoder._emit_batched and runtime.CorpusEncoder._decode_chunks).
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
// hsc_unpack_records is the inverse, into the decode's padded arrays: each
// block's events as io/bitstream.py::unpack_block then
// models/coder.py::pad_streams give them, with the range checks of
// bitstream._validate_stream made in the same pass.  An event of at most 57
// bits is one unaligned big-endian 64-bit window load cut by shift and mask;
// a wider one loads each field (at most 32 bits) the same way.  Loads near
// the buffer's end read the bytes that are there.  Any record the per-block
// path would not take as one valid top-level stream gives a status instead,
// and the caller unpacks that chunk block by block, which raises the
// per-block error.
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

inline uint32_t load_le32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) | (static_cast<uint32_t>(p[3]) << 24);
}

// the 8 bytes at p as a big-endian word; bytes at or past `avail` read 0
inline uint64_t window(const uint8_t* p, int64_t avail) {
  uint64_t v = 0;
  if (avail >= 8) {
    std::memcpy(&v, p, 8);
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
    v = __builtin_bswap64(v);
#endif
    return v;
  }
  for (int k = 0; k < 8; ++k) v = (v << 8) | (k < avail ? p[k] : 0);
  return v;
}

// `w` (0..57) bits at bit `bp` of `p`, MSB first; `avail` bytes readable
inline uint64_t take(const uint8_t* p, int64_t avail, int64_t bp, int w) {
  if (w == 0) return 0;
  const int64_t byte = bp >> 3;
  return (window(p + byte, avail - byte) << (bp & 7)) >> (64 - w);
}

// what struct.unpack('<f') then np.float32 makes of a stored scale: the
// float -> double -> float round trip quiets a signalling NaN
inline uint32_t quiet(uint32_t bits) {
  const bool nan = (bits & 0x7f800000u) == 0x7f800000u && (bits & 0x007fffffu);
  return nan ? bits | 0x00400000u : bits;
}

enum UnpackStatus : int32_t {
  kUnpacked = 0,
  kNotTopForm = 1,   // n_streams != 1, or a stream of another level
  kOverCap = 2,      // more events than the padded arrays hold
  kTruncated = 3,    // a header or payload past the buffer
  kOutOfRange = 4,   // a position, atom or code outside the geometry
  kUnsupported = 5,  // a field wider than 32 bits, or a bad argument
};

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

// data[len]: the container (or any buffer holding the records); offsets:
// each block's record start.  For block b writes counts[b], scales[b] and
// rows b of pos/atom/code ([n_blocks, cap] int32): the events, code less
// amp_maxcode, then zeros to cap.  Returns kUnpacked, or the status of the
// first block it stops at (the arrays are then partly written).
int32_t hsc_unpack_records(const uint8_t* data, int64_t len, const int64_t* offsets,
                           int32_t n_blocks, int32_t level, int32_t pos_bits,
                           int32_t atom_bits, int32_t amp_bits, int32_t amp_maxcode,
                           int64_t num_positions, int64_t num_atoms, int32_t cap,
                           int32_t* pos, int32_t* atom, int32_t* code,
                           int32_t* counts, float* scales) {
  const int ebits = pos_bits + atom_bits + amp_bits;
  if (pos_bits < 0 || atom_bits < 0 || amp_bits < 0 || pos_bits > 32 ||
      atom_bits > 32 || amp_bits > 32 || amp_maxcode < 0 || cap < 0)
    return kUnsupported;
  const int ac_bits = atom_bits + amp_bits;
  const uint64_t atom_mask = (1ULL << atom_bits) - 1;
  const uint64_t amp_mask = (1ULL << amp_bits) - 1;
  // a value past int32 reads as negative in the per-block path: refused here
  const auto bound = [](int64_t v) {
    return static_cast<uint64_t>(v < 0 ? 0 : (v > (1LL << 31) ? (1LL << 31) : v));
  };
  const uint64_t npos = bound(num_positions);
  const uint64_t natoms = bound(num_atoms);
  const uint64_t amp_max = 2 * static_cast<uint64_t>(amp_maxcode);
  for (int32_t b = 0; b < n_blocks; ++b) {
    const int64_t off = offsets[b];
    if (off < 0 || len < 10 || off > len - 10) return kTruncated;
    const uint8_t* rec = data + off;
    if (rec[0] != 1 || rec[1] != level) return kNotTopForm;
    const uint32_t n = load_le32(rec + 2);
    if (n > static_cast<uint32_t>(cap)) return kOverCap;
    const uint8_t* payload = rec + 10;
    const int64_t avail = len - off - 10;
    if ((static_cast<int64_t>(n) * ebits + 7) / 8 > avail) return kTruncated;

    int32_t* prow = pos + static_cast<int64_t>(b) * cap;
    int32_t* arow = atom + static_cast<int64_t>(b) * cap;
    int32_t* crow = code + static_cast<int64_t>(b) * cap;
    for (uint32_t i = 0; i < n; ++i) {
      const int64_t bp = static_cast<int64_t>(i) * ebits;
      uint64_t p, a, c;
      if (ebits <= 57) {
        const uint64_t ev = take(payload, avail, bp, ebits);
        p = ev >> ac_bits;
        a = (ev >> amp_bits) & atom_mask;
        c = ev & amp_mask;
      } else {
        p = take(payload, avail, bp, pos_bits);
        a = take(payload, avail, bp + pos_bits, atom_bits);
        c = take(payload, avail, bp + pos_bits + atom_bits, amp_bits);
      }
      if (p >= npos || a >= natoms || c > amp_max) return kOutOfRange;
      prow[i] = static_cast<int32_t>(p);
      arow[i] = static_cast<int32_t>(a);
      crow[i] = static_cast<int32_t>(static_cast<int64_t>(c) - amp_maxcode);
    }
    const size_t pad = static_cast<size_t>(cap - static_cast<int64_t>(n)) * sizeof(int32_t);
    std::memset(prow + n, 0, pad);
    std::memset(arow + n, 0, pad);
    std::memset(crow + n, 0, pad);
    counts[b] = static_cast<int32_t>(n);
    const uint32_t scale_bits = quiet(load_le32(rec + 6));
    std::memcpy(&scales[b], &scale_bits, 4);
  }
  return kUnpacked;
}

}  // extern "C"
