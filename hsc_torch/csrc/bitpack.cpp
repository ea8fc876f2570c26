// Native bit-packing for the HSCT stream format (hsc_torch/io/bitstream.py).
// The port's own copy of native/bitpack.cpp (for hsc_tpu/io/bitstream.py).
//
// The reference (sbrodeur/hierarchical-sparse-coding) has no native code and
// no serializer at all — its entropy stage only *counts* bits
// (hsc/analysis.py).  This is the rebuild's host-side packer: the device
// emits fixed-width (position, atom, amplitude) event tuples; packing them
// into the MSB-first bitstream is pure byte shuffling that belongs on the
// host CPU (SURVEY.md §7 H4 — variable-length output does not fit XLA's
// static shapes).  Semantics must match _pack_bits/_unpack_bits in
// bitstream.py exactly; tests compare both byte-for-byte.
//
// Build: g++ -O3 -shared -fPIC -o libhscbitpack.so bitpack.cpp

#include <cstdint>
#include <cstring>

extern "C" {

// vals: row-major [n][nfields]; widths[nfields] bit widths (sum <= 64).
// out: preallocated (n * sum(widths) + 7) / 8 bytes, zeroed by caller.
void hsc_pack_events(const uint64_t* vals, int64_t n, const int32_t* widths,
                     int32_t nfields, uint8_t* out) {
  uint64_t acc = 0;   // bit accumulator, MSB-first
  int nacc = 0;       // bits in accumulator
  int64_t byte = 0;
  for (int64_t i = 0; i < n; ++i) {
    for (int32_t j = 0; j < nfields; ++j) {
      const int w = widths[j];
      const uint64_t v = vals[i * nfields + j] & ((w == 64) ? ~0ULL : ((1ULL << w) - 1));
      acc = (acc << w) | v;
      nacc += w;
      while (nacc >= 8) {
        nacc -= 8;
        out[byte++] = (uint8_t)(acc >> nacc);
      }
    }
  }
  if (nacc > 0) {
    out[byte++] = (uint8_t)(acc << (8 - nacc));
  }
}

// Inverse: fills vals [n][nfields] from the packed MSB-first buffer.
void hsc_unpack_events(const uint8_t* data, int64_t n, const int32_t* widths,
                       int32_t nfields, uint64_t* vals) {
  uint64_t acc = 0;
  int nacc = 0;
  int64_t byte = 0;
  for (int64_t i = 0; i < n; ++i) {
    for (int32_t j = 0; j < nfields; ++j) {
      const int w = widths[j];
      while (nacc < w) {
        acc = (acc << 8) | data[byte++];
        nacc += 8;
      }
      nacc -= w;
      vals[i * nfields + j] = (acc >> nacc) & ((w == 64) ? ~0ULL : ((1ULL << w) - 1));
      acc &= (nacc == 64) ? ~0ULL : ((1ULL << nacc) - 1);
    }
  }
}

}  // extern "C"

// ---- Rice/Golomb position-delta coding (entropy='rice') --------------------
//
// Bit-identical to _pack_rice/_unpack_rice in bitstream.py (the semantic
// definition): events pre-sorted by position; per event the position delta
// (diff with prepend=0) is Rice-coded with parameter k — quotient in unary
// (q ones then a zero), then k remainder bits; quotients >= `escape` write
// `escape` ones followed by the raw absolute position in pb bits — then the
// atom (ab bits) and offset amplitude (cb bits) as fixed-width fields.

namespace {

struct BitWriter {
  uint8_t* out;
  uint64_t acc = 0;
  int nacc = 0;
  int64_t byte = 0;
  void put(uint64_t v, int w) {
    if (!w) return;
    acc = (acc << w) | (v & ((w == 64) ? ~0ULL : ((1ULL << w) - 1)));
    nacc += w;
    while (nacc >= 8) {
      nacc -= 8;
      out[byte++] = (uint8_t)(acc >> nacc);
    }
  }
  void put_ones(int q) {
    while (q >= 32) { put(0xFFFFFFFFULL, 32); q -= 32; }
    if (q) put((1ULL << q) - 1, q);
  }
  int64_t flush() {
    if (nacc > 0) { out[byte++] = (uint8_t)(acc << (8 - nacc)); nacc = 0; }
    return byte;
  }
};

struct BitReader {
  const uint8_t* data;
  int64_t nbytes;
  int64_t i = 0;  // bit cursor
  bool overrun = false;
  int take1() {
    const int64_t b = i >> 3;
    if (b >= nbytes) { overrun = true; return 0; }
    const int bit = (data[b] >> (7 - (i & 7))) & 1;
    ++i;
    return bit;
  }
  uint64_t take(int w) {
    uint64_t v = 0;
    for (int j = 0; j < w; ++j) v = (v << 1) | (uint64_t)take1();
    return v;
  }
  int unary(int cap) {
    int q = 0;
    while (q < cap && take1() == 1) ++q;
    // Python: the terminating zero was consumed by the loop's failing read
    // only when q < cap; mirror that by rewinding nothing (take1 already
    // consumed it).  When q == cap no terminator exists.
    return q;
  }
};

}  // namespace

extern "C" {

// Events pre-sorted by position.  out: caller-allocated worst-case buffer
// ((n * (escape + pb + ab + cb) + 7) / 8 + 1 bytes).  Returns bytes written.
int64_t hsc_pack_rice(const int64_t* pos, const uint64_t* atoms,
                      const uint64_t* amps, int64_t n, int32_t k,
                      int32_t escape, int32_t pb, int32_t ab, int32_t cb,
                      uint8_t* out) {
  BitWriter w{out};
  int64_t prev = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t d = pos[i] - prev;
    prev = pos[i];
    const int64_t q = d >> k;
    if (q >= escape) {
      w.put_ones(escape);
      w.put((uint64_t)pos[i], pb);
    } else {
      w.put_ones((int)q);
      w.put(0, 1);
      if (k) w.put((uint64_t)(d & ((1LL << k) - 1)), k);
    }
    w.put(atoms[i], ab);
    w.put(amps[i], cb);
  }
  return w.flush();
}

// Inverse: fills vals [n][3] = (absolute position, atom, raw amplitude).
// Returns bytes consumed, or -1 on buffer overrun.
int64_t hsc_unpack_rice(const uint8_t* data, int64_t nbytes, int64_t n,
                        int32_t k, int32_t escape, int32_t pb, int32_t ab,
                        int32_t cb, uint64_t* vals) {
  BitReader r{data, nbytes};
  int64_t prev = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int q = r.unary(escape);
    if (q >= escape) {
      prev = (int64_t)r.take(pb);
    } else {
      prev += ((int64_t)q << k) | (int64_t)(k ? r.take(k) : 0);
    }
    vals[i * 3 + 0] = (uint64_t)prev;
    vals[i * 3 + 1] = r.take(ab);
    vals[i * 3 + 2] = r.take(cb);
    if (r.overrun) return -1;
  }
  return (r.i + 7) >> 3;
}

}  // extern "C"
