// Batched block-record packer and unpackers for fixed-entropy containers
// (hsc_torch/record_pack.py; called from runtime.CorpusEncoder._emit_batched
// and runtime.CorpusEncoder._chunks).
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
// hsc_unpack_level_records takes records of any levels, as the distributed
// form writes them (u8 n_streams, then each stream as above at its own
// level), into one padded array set per level: the rows of the blocks that
// hold a stream of that level, in block order, with their block indices, as
// runtime.CorpusEncoder._units groups a chunk's streams.  It shares the
// stream reader, and so the bit reading, range checks, scale and padding,
// with hsc_unpack_records.  A record whose levels are not strictly
// ascending and below the level count (which _units leaves to the
// per-block decode), and every case hsc_unpack_records refuses, give a
// status instead.
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
  kNotTopForm = 1,    // n_streams != 1, or a stream of another level
  kOverCap = 2,       // more events than the padded arrays hold
  kTruncated = 3,     // a header or payload past the buffer
  kOutOfRange = 4,    // a position, atom or code outside the geometry
  kUnsupported = 5,   // a field wider than 32 bits, or a bad argument
  kNotLevelForm = 6,  // a record's levels not strictly ascending, or past the count
};

// bytes of a stream's header: u8 level, u32 n, f32 scale
constexpr int64_t kStreamHeader = 9;

// One level's event fields and the ranges its values must lie in.
struct Fields {
  int pos_bits, atom_bits, amp_bits, ebits;
  uint64_t atom_mask, amp_mask;
  uint64_t npos, natoms, amp_max;
  int32_t amp_maxcode;
};

// false where a width is negative or past 32 bits, or amp_maxcode < 0
inline bool make_fields(int32_t pos_bits, int32_t atom_bits, int32_t amp_bits,
                        int32_t amp_maxcode, int64_t num_positions,
                        int64_t num_atoms, Fields* f) {
  if (pos_bits < 0 || atom_bits < 0 || amp_bits < 0 || pos_bits > 32 ||
      atom_bits > 32 || amp_bits > 32 || amp_maxcode < 0)
    return false;
  // a value past int32 reads as negative in the per-block path: refused here
  const auto bound = [](int64_t v) {
    return static_cast<uint64_t>(v < 0 ? 0 : (v > (1LL << 31) ? (1LL << 31) : v));
  };
  *f = Fields{pos_bits, atom_bits, amp_bits, pos_bits + atom_bits + amp_bits,
              (1ULL << atom_bits) - 1, (1ULL << amp_bits) - 1,
              bound(num_positions), bound(num_atoms),
              2 * static_cast<uint64_t>(amp_maxcode), amp_maxcode};
  return true;
}

// The stream whose header starts at data[off], into one padded row each of
// pos/atom/code (the events, code less amp_maxcode, then zeros to cap) and
// its count and scale.  *end receives the offset past its payload.
inline int32_t unpack_stream(const Fields& f, const uint8_t* data, int64_t len,
                             int64_t off, int32_t cap, int32_t* prow,
                             int32_t* arow, int32_t* crow, int32_t* count,
                             float* scale, int64_t* end) {
  if (off < 0 || len < kStreamHeader || off > len - kStreamHeader) return kTruncated;
  const uint8_t* head = data + off;
  const uint32_t n = load_le32(head + 1);
  if (n > static_cast<uint32_t>(cap)) return kOverCap;
  const uint8_t* payload = head + kStreamHeader;
  const int64_t avail = len - off - kStreamHeader;
  const int64_t nbytes = (static_cast<int64_t>(n) * f.ebits + 7) / 8;
  if (nbytes > avail) return kTruncated;

  const int ac_bits = f.atom_bits + f.amp_bits;
  for (uint32_t i = 0; i < n; ++i) {
    const int64_t bp = static_cast<int64_t>(i) * f.ebits;
    uint64_t p, a, c;
    if (f.ebits <= 57) {
      const uint64_t ev = take(payload, avail, bp, f.ebits);
      p = ev >> ac_bits;
      a = (ev >> f.amp_bits) & f.atom_mask;
      c = ev & f.amp_mask;
    } else {
      p = take(payload, avail, bp, f.pos_bits);
      a = take(payload, avail, bp + f.pos_bits, f.atom_bits);
      c = take(payload, avail, bp + f.pos_bits + f.atom_bits, f.amp_bits);
    }
    if (p >= f.npos || a >= f.natoms || c > f.amp_max) return kOutOfRange;
    prow[i] = static_cast<int32_t>(p);
    arow[i] = static_cast<int32_t>(a);
    crow[i] = static_cast<int32_t>(static_cast<int64_t>(c) - f.amp_maxcode);
  }
  const size_t pad = static_cast<size_t>(cap - static_cast<int64_t>(n)) * sizeof(int32_t);
  std::memset(prow + n, 0, pad);
  std::memset(arow + n, 0, pad);
  std::memset(crow + n, 0, pad);
  *count = static_cast<int32_t>(n);
  const uint32_t scale_bits = quiet(load_le32(head + 5));
  std::memcpy(scale, &scale_bits, 4);
  *end = off + kStreamHeader + nbytes;
  return kUnpacked;
}

}  // namespace

extern "C" {

// One level of hsc_unpack_level_records: its geometry and the capacity of
// its rows in; its rows out.  pos/atom/code hold [n_blocks, cap] int32 and
// counts/scales/ids [n_blocks]; the first `rows` of each are written, one a
// block holding a stream of the level, ids[r] that block's index.
struct LevelRows {
  int32_t pos_bits;
  int32_t atom_bits;
  int64_t num_positions;
  int64_t num_atoms;
  int32_t cap;
  int32_t rows;
  int32_t* pos;
  int32_t* atom;
  int32_t* code;
  int32_t* counts;
  float* scales;
  int32_t* ids;
};

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
  Fields f;
  if (!make_fields(pos_bits, atom_bits, amp_bits, amp_maxcode, num_positions,
                   num_atoms, &f) || cap < 0)
    return kUnsupported;
  for (int32_t b = 0; b < n_blocks; ++b) {
    const int64_t off = offsets[b];
    if (off < 0 || len < 10 || off > len - 10) return kTruncated;
    const uint8_t* rec = data + off;
    if (rec[0] != 1 || rec[1] != level) return kNotTopForm;
    const int64_t row = static_cast<int64_t>(b) * cap;
    int64_t end;
    const int32_t status = unpack_stream(f, data, len, off + 1, cap, pos + row,
                                         atom + row, code + row, &counts[b],
                                         &scales[b], &end);
    if (status) return status;
  }
  return kUnpacked;
}

// data[len] and offsets as hsc_unpack_records'; each record u8 n_streams,
// then its streams at strictly ascending levels below n_levels.  levels[k]
// (n_levels of them, at most 256) receives level k's rows, in block order
// (LevelRows).  Returns kUnpacked, or the status of the first record it
// stops at (the arrays are then partly written).
int32_t hsc_unpack_level_records(const uint8_t* data, int64_t len,
                                 const int64_t* offsets, int32_t n_blocks,
                                 int32_t amp_bits, int32_t amp_maxcode,
                                 int32_t n_levels, LevelRows* levels) {
  if (n_levels < 1 || n_levels > 256) return kUnsupported;
  Fields fields[256];
  for (int32_t k = 0; k < n_levels; ++k) {
    LevelRows& lv = levels[k];
    if (!make_fields(lv.pos_bits, lv.atom_bits, amp_bits, amp_maxcode,
                     lv.num_positions, lv.num_atoms, &fields[k]) || lv.cap < 0)
      return kUnsupported;
    lv.rows = 0;
  }
  for (int32_t b = 0; b < n_blocks; ++b) {
    int64_t off = offsets[b];
    if (off < 0 || off >= len) return kTruncated;
    const int n_streams = data[off++];
    int prev = -1;
    for (int s = 0; s < n_streams; ++s) {
      if (off >= len) return kTruncated;
      const int k = data[off];
      if (k <= prev || k >= n_levels) return kNotLevelForm;
      prev = k;
      LevelRows& lv = levels[k];
      const int64_t row = static_cast<int64_t>(lv.rows) * lv.cap;
      const int32_t status = unpack_stream(fields[k], data, len, off, lv.cap,
                                           lv.pos + row, lv.atom + row, lv.code + row,
                                           &lv.counts[lv.rows], &lv.scales[lv.rows], &off);
      if (status) return status;
      lv.ids[lv.rows++] = b;
    }
  }
  return kUnpacked;
}

}  // extern "C"
