// Index-load / device-layout hot loops for GRCh38-scale genomes.
//
// NumPy handles these fine at toy scale, but arrays past 2^31
// elements fall off its fast paths (measured on the 1.1 Gbp build:
// ~15 min to deinterleave the .bwt payload and ~37 min to build the
// wide device layout, vs seconds here). Both are single sequential
// passes in C++.

#include <cstdint>
#include <cstring>

extern "C" {

// Split the BWA-format interleaved .bwt payload (4 occ checkpoint
// words as 2x u32 each + 8 BWT words per 128 bases; trailing partial
// block + final checkpoint) into per-base codes and (n_blocks+1, 4)
// int64 checkpoints. Mirrors index/loader.deinterleave_bwt.
void dart_deinterleave_bwt(const uint32_t* payload, int64_t seq_len,
                           uint8_t* codes, int64_t* occ) {
  const int64_t OCC = 128;
  const int64_t wpb = OCC / 16;
  const int64_t n_blocks = (seq_len + OCC - 1) / OCC;
  const int64_t n_words = (seq_len + 15) / 16;
  const int64_t n_full = seq_len / OCC;
  const uint32_t* p = payload;
  int64_t w = 0;  // global word index
  for (int64_t b = 0; b < n_full; ++b) {
    for (int c = 0; c < 4; ++c) {
      occ[b * 4 + c] =
          (int64_t)((uint64_t)p[0] | ((uint64_t)p[1] << 32));
      p += 2;
    }
    for (int64_t j = 0; j < wpb; ++j, ++w) {
      const uint32_t word = *p++;
      uint8_t* dst = codes + w * 16;
      for (int k = 0; k < 16; ++k)
        dst[k] = (uint8_t)((word >> (2 * (15 - k))) & 3);
    }
  }
  if (n_blocks > n_full) {
    for (int c = 0; c < 4; ++c) {
      occ[n_full * 4 + c] =
          (int64_t)((uint64_t)p[0] | ((uint64_t)p[1] << 32));
      p += 2;
    }
    for (; w < n_words; ++w) {
      const uint32_t word = *p++;
      uint8_t* dst = codes + w * 16;
      for (int k = 0; k < 16; ++k) {
        const int64_t pos = w * 16 + k;
        if (pos < seq_len)  // codes buffer is exactly seq_len bytes
          dst[k] = (uint8_t)((word >> (2 * (15 - k))) & 3);
      }
    }
  }
  for (int c = 0; c < 4; ++c) {
    occ[n_blocks * 4 + c] =
        (int64_t)((uint64_t)p[0] | ((uint64_t)p[1] << 32));
    p += 2;
  }
}

// Build the wide (64-bit) device layout: (n_blocks, 16) uint32 rows
// [occ_A..occ_T lo | occ_A..occ_T hi | 8 BWT words] per 128 bases,
// occ counting stored-BWT occurrences BEFORE the block. Mirrors
// ops/fm_jax_wide.build_device_layout_wide (bases past seq_len pack
// as code 0 but are never counted: occ rows hold block-START counts).
void dart_wide_layout(const uint8_t* bwt, int64_t seq_len,
                      uint32_t* out) {
  const int64_t BLOCK = 128;
  const int64_t n_blocks = (seq_len + BLOCK - 1) / BLOCK;
  uint64_t cnt[4] = {0, 0, 0, 0};
  for (int64_t b = 0; b < n_blocks; ++b) {
    uint32_t* row = out + b * 16;
    for (int c = 0; c < 4; ++c) {
      row[c] = (uint32_t)(cnt[c] & 0xFFFFFFFFu);
      row[4 + c] = (uint32_t)(cnt[c] >> 32);
    }
    const int64_t start = b * BLOCK;
    for (int j = 0; j < 8; ++j) {
      uint32_t acc = 0;
      for (int k = 0; k < 16; ++k) {
        const int64_t pos = start + j * 16 + k;
        uint8_t c = pos < seq_len ? bwt[pos] : 0;
        acc |= (uint32_t)c << (2 * (15 - k));
        if (pos < seq_len) ++cnt[c];
      }
      row[8 + j] = acc;
    }
  }
}

// Pack 2-bit codes into u32 words, 16 codes per word, first code in
// the top bits (bwt.h bwt_B00 layout); codes > 3 clamp to 3 (ambiguous
// bases force mismatches via the separate N mask). out must hold
// ceil(n/16) words; trailing pad bits are 0. Used for the wide
// engine's genome rows (ref_codes packing degrades badly in NumPy
// past 2^31 elements, like the layouts above).
void dart_pack_codes(const uint8_t* codes, int64_t n, uint32_t* out) {
  const int64_t n_words = (n + 15) / 16;
  for (int64_t w = 0; w < n_words; ++w) {
    uint32_t acc = 0;
    const int64_t start = w * 16;
    const int kmax = (int)(n - start < 16 ? n - start : 16);
    for (int k = 0; k < kmax; ++k) {
      uint8_t c = codes[start + k];
      if (c > 3) c = 3;
      acc |= (uint32_t)c << (2 * (15 - k));
    }
    out[w] = acc;
  }
}

// Derive both reference-sequence arrays straight from the packed .pac
// payload in one pass: codes = fwd ++ revcomp(fwd), ascii = the same
// as 'A'/'C'/'G'/'T' bytes. Replaces four multi-GB NumPy temporaries
// at load time (unpack, reverse, 3-x, concatenate, fancy-index) with
// two forward and two backward sequential streams — at GRCh38 scale
// (l_pac=3.1e9) that is ~12 GB of transient allocations avoided,
// which dominates load wall time whenever the host is in a degraded
// anon-fault window. Mirrors loader.load_index's ref_codes/ref_ascii.
// Codes-only variant: used when the ascii buffer comes from the
// disk-backed .refpad cache and only ref_codes must be derived.
void dart_codes_from_pac(const uint8_t* pac, int64_t l_pac,
                         uint8_t* codes) {
  const int64_t n2 = 2 * l_pac;
  for (int64_t i = 0; i < l_pac; ++i) {
    const uint8_t c =
        (uint8_t)((pac[i >> 2] >> (2 * (3 - (i & 3)))) & 3);
    codes[i] = c;
    codes[n2 - 1 - i] = (uint8_t)(3 - c);
  }
}

void dart_ref_from_pac(const uint8_t* pac, int64_t l_pac,
                       uint8_t* codes, uint8_t* ascii) {
  static const uint8_t ACGT[4] = {'A', 'C', 'G', 'T'};
  const int64_t n2 = 2 * l_pac;
  for (int64_t i = 0; i < l_pac; ++i) {
    const uint8_t c =
        (uint8_t)((pac[i >> 2] >> (2 * (3 - (i & 3)))) & 3);
    const uint8_t rc = (uint8_t)(3 - c);
    codes[i] = c;
    ascii[i] = ACGT[c];
    codes[n2 - 1 - i] = rc;
    ascii[n2 - 1 - i] = ACGT[rc];
  }
}

}  // extern "C"
