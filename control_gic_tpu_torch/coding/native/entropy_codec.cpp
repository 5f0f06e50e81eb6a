// Host-side entropy-codec hot paths for control_gic_tpu.
//
// The bitstream frame format matches the reference codec byte-for-byte
// (CGIC/tools/indices_coding.py:91-126 and
// mask_coding.py:20-55): an 8-bit pad-count header (1..8 — note a stream
// whose payload is already byte-aligned still gets 8 pad bits), followed by
// the MSB-first concatenated code bits, zero-padded.
//
// The Huffman tree/code assignment itself is built in Python (a faithful
// heapq replica — tree build is a one-time O(n log n) over 1024 symbols);
// this file only does the per-image O(bits) work: packing symbol codes into
// the frame and walking the decode structures. The reference does both in
// pure Python via string concatenation (its measured encode bottleneck).
//
// Fast paths (round 2): encode packs whole codes through a 64-bit
// accumulator (one shift+or per symbol instead of one branch per bit);
// decode uses a K-bit lookahead LUT built once per call from the trie —
// one table load resolves a whole code (first-symbol-per-lookup, the
// standard fast-Huffman scheme) with a bit-by-bit trie walk only for codes
// longer than K bits and for short streams where building the LUT would
// dominate. Output bytes/symbols are identical to the bit-by-bit reference
// walk by construction (pinned against the reference coder in
// tests/test_coding.py).
//
// Build: g++ -O3 -shared -fPIC -o libentropy_codec.so entropy_codec.cpp

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int32_t kEmpty = INT32_MIN;  // unreachable trie slot marker
constexpr int kLutBits = 12;           // 4096-entry LUT, 16 KB (L1-resident)
constexpr int64_t kLutMinPayloadBits = 1 << 14;  // below this, walk the trie

struct BitWriter {
  uint8_t* buf;
  int64_t cap;
  int64_t bitpos = 0;  // next bit index to write

  bool put_bits(const uint8_t* bytes, uint32_t nbits) {
    // `bytes` holds the code MSB-first starting at bit 0 of bytes[0].
    if ((bitpos + nbits + 7) / 8 > cap) return false;
    for (uint32_t i = 0; i < nbits; ++i) {
      uint8_t bit = (bytes[i >> 3] >> (7 - (i & 7))) & 1;
      int64_t p = bitpos + i;
      if (bit)
        buf[p >> 3] |= static_cast<uint8_t>(0x80u >> (p & 7));
    }
    bitpos += nbits;
    return true;
  }
};

inline uint64_t be_load64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_BIG_ENDIAN__
  return v;  // bytes already land MSB-first in the register
#else
  return __builtin_bswap64(v);
#endif
}

// LUT entry: (code_len << 16) | symbol when the first code in the K-bit
// window completes within K bits; -1 when it does not (slow-path marker).
// Valid because the LUT walk stops at the first leaf: every K-bit extension
// of a completed code maps to the same (len, symbol).
void build_decode_lut(const int32_t* trie, int32_t n_nodes, int32_t* lut) {
  const int32_t n = 1 << kLutBits;
  for (int32_t e = 0; e < n; ++e) {
    int32_t node = 0;
    int32_t entry = -1;
    for (int d = 0; d < kLutBits; ++d) {
      int bit = (e >> (kLutBits - 1 - d)) & 1;
      int32_t next = trie[2 * node + bit];
      if (next == kEmpty) break;  // malformed window: slow path handles it
      if (next < 0) {             // leaf: first symbol resolved
        int32_t sym = ~next;
        if (sym > 0xffff) break;  // symbol too wide for packing: slow path
        entry = ((d + 1) << 16) | sym;
        break;
      }
      if (next >= n_nodes) break;
      node = next;
    }
    lut[e] = entry;
  }
}

}  // namespace

extern "C" {

// Encode `n` symbols into the padded frame. Code table: lens[sym] in bits
// (0 < len <= 256), code_bytes[sym * 32 + k] MSB-first.
// Returns frame length in bytes, or -1 on overflow / bad symbol.
int64_t cgic_huff_encode(const int32_t* symbols, int64_t n,
                         const uint8_t* lens_u16_hack,  // actually uint16_t*
                         const uint8_t* code_bytes, int32_t n_sym,
                         uint8_t* out, int64_t out_cap) {
  const uint16_t* lens = reinterpret_cast<const uint16_t*>(lens_u16_hack);
  if (n == 0) return 0;  // reference writes an empty file for empty streams
  std::memset(out, 0, static_cast<size_t>(out_cap));

  // First count total payload bits to place the pad header.
  int64_t total_bits = 0;
  uint16_t max_len = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t s = symbols[i];
    if (s < 0 || s >= n_sym || lens[s] == 0) return -1;
    total_bits += lens[s];
    if (lens[s] > max_len) max_len = lens[s];
  }
  int64_t pad = 8 - (total_bits % 8);  // 1..8, matches the reference quirk
  int64_t frame_bytes = 1 + (total_bits + pad) / 8;
  if (frame_bytes > out_cap) return -1;
  out[0] = static_cast<uint8_t>(pad);

  if (max_len <= 57) {
    // Fast path: codes as right-aligned uint64 values, one shift+or per
    // symbol, byte-at-a-time flush (accumulator never exceeds 57+7 bits).
    std::vector<uint64_t> vals(static_cast<size_t>(n_sym), 0);
    for (int32_t s = 0; s < n_sym; ++s) {
      uint16_t len = lens[s];
      if (len == 0) continue;
      const uint8_t* cb = code_bytes + static_cast<int64_t>(s) * 32;
      uint64_t v = 0;
      int nb = (len + 7) / 8;
      for (int k = 0; k < nb; ++k) v = (v << 8) | cb[k];
      vals[s] = v >> (nb * 8 - len);
    }
    uint64_t acc = 0;
    int accbits = 0;
    uint8_t* dst = out + 1;
    for (int64_t i = 0; i < n; ++i) {
      int32_t s = symbols[i];
      acc = (acc << lens[s]) | vals[s];
      accbits += lens[s];
      while (accbits >= 8) {
        accbits -= 8;
        *dst++ = static_cast<uint8_t>(acc >> accbits);
      }
    }
    if (accbits > 0)  // zero pad bits complete the final byte
      *dst++ = static_cast<uint8_t>(acc << (8 - accbits));
    return frame_bytes;
  }

  // >57-bit codes (pathological frequency tables): bit-by-bit reference path.
  BitWriter w{out + 1, out_cap - 1, 0};
  for (int64_t i = 0; i < n; ++i) {
    int32_t s = symbols[i];
    if (!w.put_bits(code_bytes + static_cast<int64_t>(s) * 32, lens[s]))
      return -1;
  }
  return frame_bytes;
}

// Fill a caller-owned 2^kLutBits-entry decode LUT (see build_decode_lut).
// Returns the required entry count so callers can size the buffer.
int64_t cgic_huff_lut_size() { return int64_t{1} << kLutBits; }

void cgic_huff_build_lut(const int32_t* trie, int32_t n_nodes, int32_t* lut) {
  build_decode_lut(trie, n_nodes, lut);
}

// Decode a frame using a binary trie. trie[2*node + bit] is either the next
// node index (>= 0) or ~symbol (< 0) at a leaf. Node 0 is the root.
// `lut` is an optional prebuilt table from cgic_huff_build_lut (pass NULL to
// build one internally when the stream is long enough).
// Returns number of decoded symbols, or -1 on malformed input / overflow.
int64_t cgic_huff_decode(const uint8_t* data, int64_t nbytes,
                         const int32_t* trie, int32_t n_nodes,
                         const int32_t* lut_in,
                         int32_t* out, int64_t out_cap) {
  if (nbytes == 0) return 0;
  int64_t pad = data[0];
  if (pad < 1 || pad > 8) return -1;
  int64_t payload_bits = (nbytes - 1) * 8 - pad;
  if (payload_bits < 0) return -1;

  int64_t count = 0;
  if (lut_in != nullptr || payload_bits >= kLutMinPayloadBits) {
    // LUT fast path over a zero-padded copy (peek may read past the end;
    // the pad cannot fabricate symbols: len > remaining ends the stream,
    // matching the reference's dropped-incomplete-tail contract,
    // indices_coding.py:140-151).
    std::vector<int32_t> lut_own;
    const int32_t* lut = lut_in;
    if (lut == nullptr) {
      lut_own.resize(size_t{1} << kLutBits);
      build_decode_lut(trie, n_nodes, lut_own.data());
      lut = lut_own.data();
    }
    std::vector<uint8_t> buf((payload_bits + 7) / 8 + 8, 0);
    std::memcpy(buf.data(), data + 1, static_cast<size_t>((payload_bits + 7) / 8));
    const uint8_t* p = buf.data();
    int64_t pos = 0;
    while (pos < payload_bits) {
      uint64_t window = be_load64(p + (pos >> 3)) << (pos & 7);
      int32_t e = lut[window >> (64 - kLutBits)];
      if (e >= 0) {
        int32_t len = e >> 16;
        if (len > payload_bits - pos) break;  // incomplete tail: dropped
        if (count >= out_cap) return -1;
        out[count++] = e & 0xffff;
        pos += len;
      } else {
        // Code longer than K bits (or malformed window): trie walk.
        int32_t node = 0;
        int64_t q = pos;
        bool emitted = false;
        while (q < payload_bits) {
          uint8_t bit = (p[q >> 3] >> (7 - (q & 7))) & 1;
          ++q;
          int32_t next = trie[2 * node + bit];
          if (next < 0) {
            if (count >= out_cap) return -1;
            out[count++] = ~next;
            pos = q;
            emitted = true;
            break;
          }
          if (next >= n_nodes) return -1;
          node = next;
        }
        if (!emitted) break;  // incomplete tail: dropped
      }
    }
    return count;
  }

  // Short streams: plain trie walk (LUT build would dominate).
  int32_t node = 0;
  for (int64_t b = 0; b < payload_bits; ++b) {
    uint8_t bit = (data[1 + (b >> 3)] >> (7 - (b & 7))) & 1;
    int32_t next = trie[2 * node + bit];
    if (next < 0) {
      if (count >= out_cap) return -1;
      out[count++] = ~next;
      node = 0;
    } else {
      if (next >= n_nodes) return -1;
      node = next;
    }
  }
  // Trailing bits that do not complete a code are dropped, matching the
  // reference's decode_text loop (indices_coding.py:140-151).
  return count;
}

// Bitmap (1 bit per element) encode/decode with the same frame format.
int64_t cgic_bitmap_encode(const uint8_t* bits, int64_t n, uint8_t* out,
                           int64_t out_cap) {
  if (n == 0) return 0;
  int64_t pad = 8 - (n % 8);
  int64_t frame_bytes = 1 + (n + pad) / 8;
  if (frame_bytes > out_cap) return -1;
  std::memset(out, 0, static_cast<size_t>(frame_bytes));
  out[0] = static_cast<uint8_t>(pad);
  for (int64_t i = 0; i < n; ++i) {
    if (bits[i]) out[1 + (i >> 3)] |= static_cast<uint8_t>(0x80u >> (i & 7));
  }
  return frame_bytes;
}

int64_t cgic_bitmap_decode(const uint8_t* data, int64_t nbytes, uint8_t* out,
                           int64_t out_cap) {
  if (nbytes == 0) return 0;
  int64_t pad = data[0];
  if (pad < 1 || pad > 8) return -1;
  int64_t nbits = (nbytes - 1) * 8 - pad;
  if (nbits < 0 || nbits > out_cap) return -1;
  for (int64_t i = 0; i < nbits; ++i)
    out[i] = (data[1 + (i >> 3)] >> (7 - (i & 7))) & 1;
  return nbits;
}

}  // extern "C"
