// Chunk packing for the device seeding automaton: ASCII read blobs ->
// 2-bit packed code words (16 bases/word, first base in the top bits)
// plus a 1-bit-per-base ambiguity mask, the exact transfer layout
// ops/fm_jax._seed_scan_packed consumes. This replaces a chain of
// NumPy strided loops on the hot path (the relay host has one core;
// every ms of host work is wall time).
//
// Layout contract (must match ops/fm_jax.py seed_submit_blob):
// - packed[r*ps + w] bits [31-2j, 30-2j] hold min(code, 3) of base
//   16w+j of read r.
// - positions past the read's length pack as code 3 with NO mask bit:
//   every kernel read past rlen is guarded (`cur < rlens`), and the
//   seed scan never initializes within 13 bases of the end.
// - nmask[r*ns + w] bit (31-j) set iff base 32w+j is ambiguous
//   (code > 3), only within the read.
// - rlens[r*rs] = read length (int32).
// - has_n[r] = 1 iff read r contains any ambiguous base — the caller
//   reroutes such (rare) reads through the masked rerun round instead
//   of shipping a full mask with the bulk transfer.
//
// All three destinations take an element stride so the caller can lay
// them out as columns of ONE merged transfer buffer (the relay charges
// a flat ~35 ms latency per host->device array, so one buffer per
// crossing) or as separate arrays.
//
// Nucleotide codes mirror Dart's src/BWT_Index/bntseq.c:40-57
// (A=0 C=1 G=2 T=3, case-insensitive, everything else ambiguous).

#include <cstdint>
#include <cstring>

namespace {

struct Nt4 {
  uint8_t t[256];
  Nt4() {
    std::memset(t, 4, sizeof(t));
    const char* b = "ACGT";
    for (int i = 0; i < 4; ++i) {
      t[(unsigned char)b[i]] = (uint8_t)i;
      t[(unsigned char)(b[i] + 32)] = (uint8_t)i;
    }
  }
};
const Nt4 NT4;

}  // namespace

extern "C" {

// Returns the number of reads containing at least one ambiguous base.
int32_t dart_pack_reads(const uint8_t* seq_blob, const int64_t* seq_off,
                        int32_t n_reads, int32_t words,
                        uint32_t* packed, int64_t packed_stride,
                        uint32_t* nmask, int64_t nmask_stride,
                        int32_t* rlens, int64_t rlens_stride,
                        uint8_t* has_n) {
  int32_t n_with_n = 0;
  for (int32_t r = 0; r < n_reads; ++r) {
    const uint8_t* s = seq_blob + seq_off[r];
    const int32_t len = (int32_t)(seq_off[r + 1] - seq_off[r]);
    rlens[(size_t)r * rlens_stride] = len;
    uint32_t* row = packed + (size_t)r * packed_stride;
    uint32_t* nrow = nmask + (size_t)r * nmask_stride;
    uint8_t any = 0;
    int32_t j = 0;
    for (int32_t w = 0; w < words; ++w) {
      uint32_t acc = 0;
      if (j + 16 <= len) {  // full word inside the read (hot path)
        for (int k = 0; k < 16; ++k) {
          const uint8_t c = NT4.t[s[j + k]];
          acc |= (uint32_t)(c < 4 ? c : 3) << (2 * (15 - k));
          if (c > 3) {
            nrow[(j + k) >> 5] |= 0x80000000u >> ((j + k) & 31);
            any = 1;
          }
        }
      } else {
        for (int k = 0; k < 16; ++k) {
          const int32_t p = j + k;
          if (p < len) {
            const uint8_t c = NT4.t[s[p]];
            acc |= (uint32_t)(c < 4 ? c : 3) << (2 * (15 - k));
            if (c > 3) {
              nrow[p >> 5] |= 0x80000000u >> (p & 31);
              any = 1;
            }
          } else {
            acc |= 3u << (2 * (15 - k));  // pad packs as code 3
          }
        }
      }
      row[w] = acc;
      j += 16;
    }
    has_n[r] = any;
    n_with_n += any;
  }
  return n_with_n;
}

// Sequential lrand48()&3 stream for the index builder's N->random-base
// substitution (bntseq.c:144,173-174 semantics; POSIX drand48 LCG).
// state holds the 48-bit LCG register; updated in place so interleaved
// native/Python draws stay one stream.
void dart_lrand48_fill(uint64_t* state, uint8_t* out, int64_t n) {
  uint64_t x = *state;
  const uint64_t A = 0x5DEECE66DULL, C = 0xBULL,
                 MASK = (1ULL << 48) - 1;
  for (int64_t i = 0; i < n; ++i) {
    x = (A * x + C) & MASK;
    out[i] = (uint8_t)((x >> 17) & 3);
  }
  *state = x;
}

}  // extern "C"
