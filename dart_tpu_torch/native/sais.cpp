// Suffix-array construction via SA-IS (Nong, Zhang & Chan 2009),
// written from the published algorithm description and tuned for the
// DRAM-latency-bound regime of multi-gigabase genomes:
//   - software prefetch pipelines in every induced-sort scan (the SA
//     walks are sequential, so the dependent random T/bucket reads can
//     be issued tens of iterations ahead),
//   - the S/L type bit folded into bit 6 of the byte text (one random
//     read per induction step instead of two; substring naming becomes
//     a single byte compare),
//   - bit-packed type maps for the integer recursion levels,
//   - int32 recursion when the reduced problem fits (halves the
//     random-access footprint of every level below the root),
//   - plain 4 KB-page scratch buffers: MADV_HUGEPAGE was measured on
//     the TPU host at 10 MB/s first-touch (65x slower than 4 KB
//     pages) and ~10x slower warm sequential writes, with NO warm
//     random-read benefit (21 vs 24 ns on a 512 MB buffer) — THP is
//     actively harmful under this hypervisor, so the builder never
//     asks for it.
// Used by the dart_tpu index builder to derive the BWT/FM-index
// (the reference derives it with a block-incremental BWT-SW variant,
// Dart's src/BWT_Index/bwt_gen.c; the resulting BWT is
// identical because the BWT is unique given the text).
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <new>
#include <algorithm>
#include <sys/mman.h>

namespace {

constexpr size_t kHuge = size_t(1) << 21;

// Coarse progress notes for multi-hour builds (DART_TPU_BUILD_LOG=1).
void blog(const char* what, int64_t n) {
  static bool on = getenv("DART_TPU_BUILD_LOG") != nullptr;
  if (!on) return;
  char ts[16];
  time_t t = time(nullptr);
  strftime(ts, sizeof ts, "%H:%M:%S", localtime(&t));
  fprintf(stderr, "[sais %s] %s (n=%lld)\n", ts, what, (long long)n);
}

// Zero-initialized scratch buffer on anonymous mmap (4 KB pages; see
// the THP measurement in the header comment).
template <typename T>
struct Buf {
  T* p = nullptr;
  size_t bytes = 0;
  Buf() = default;
  explicit Buf(size_t count) { alloc(count); }
  Buf(const Buf&) = delete;
  Buf& operator=(const Buf&) = delete;
  ~Buf() { release(); }
  void alloc(size_t count) {
    release();
    bytes = (count * sizeof(T) + kHuge - 1) & ~(kHuge - 1);
    if (!bytes) bytes = kHuge;
    void* m = mmap(nullptr, bytes, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (m == MAP_FAILED) { bytes = 0; throw std::bad_alloc(); }
    p = static_cast<T*>(m);
  }
  void release() {
    if (p) munmap(p, bytes);
    p = nullptr;
    bytes = 0;
  }
};

// TChar == uint8_t means the caller folded the S-type bit into bit 6 of
// each byte (values occupy the low 6 bits); integer TChar levels carry
// a separate bit-packed type map.
// At the top level (byte text, int64 indices) every SA entry carries
// the FOLDED BYTE OF ITS PREDECESSOR character (T[v-1], char + S/L
// type bit) in bits 62..56: the induced-sort consume step then needs
// NO random text read at all — the one remaining random read (packing
// the next predecessor byte at produce time) is off the critical path
// and overlaps freely. The final packed SA also hands the BWT
// derivation its answer byte for free. Values must fit 56 bits
// (GRCh38 fwd+RC is 2^33) and K <= 63 keeps the byte in 7 bits, so
// empty slots (-1, sign bit set) stay distinguishable.
template <typename TIdx, typename TChar>
void sais_core(const TChar* T, TIdx* SA, TIdx n, TIdx K) {
  constexpr bool FOLD = sizeof(TChar) == 1;
  constexpr bool PACK = FOLD && sizeof(TIdx) == 8;
  constexpr TIdx D1 = 64, D2 = 16;  // prefetch distances: text, buckets
  if (n <= 0) return;
  if (n == 1) { SA[0] = 0; return; }

  Buf<uint64_t> tbuf;
  uint64_t* tm = nullptr;
  if constexpr (!FOLD) {
    tbuf.alloc((size_t(n) >> 6) + 2);
    tm = tbuf.p;
    bool tn = true;
    tm[uint64_t(n - 1) >> 6] |= uint64_t(1) << ((n - 1) & 63);
    for (TIdx i = n - 2; i >= 0; --i) {
      bool ti = T[i] < T[i + 1] || (T[i] == T[i + 1] && tn);
      if (ti) tm[uint64_t(i) >> 6] |= uint64_t(1) << (i & 63);
      tn = ti;
    }
  }
  auto chr = [&](TIdx i) -> TIdx {
    if constexpr (FOLD) return TIdx(T[i] & 0x3F); else return T[i];
  };
  auto tget = [&](TIdx i) -> bool {
    if constexpr (FOLD) return (T[i] >> 6) & 1;
    else return (tm[uint64_t(i) >> 6] >> (i & 63)) & 1;
  };
  auto isLMS = [&](TIdx i) -> bool { return i > 0 && tget(i) && !tget(i - 1); };
  auto pfT = [&](TIdx i) {
    __builtin_prefetch(&T[i], 0, 1);
    if constexpr (!FOLD) __builtin_prefetch(&tm[uint64_t(i) >> 6], 0, 1);
  };
  // Entry packing (PACK levels): value in bits 55..0, folded byte of
  // T[v-1] in bits 62..56. v == 0 packs byte 0, so e > 0 <=> v > 0
  // (folded chars are >= 1) and empty slots stay negative.
  auto mk = [&](TIdx v) -> TIdx {
    if constexpr (PACK)
      return v | (TIdx(v > 0 ? T[v - 1] : TChar(0)) << 56);
    else
      return v;
  };

  Buf<TIdx> Cb(size_t(K) + 2), Bb(size_t(K) + 2);
  TIdx* C = Cb.p;
  TIdx* B = Bb.p;
  for (TIdx i = 0; i < n; ++i) {
    if (i + D2 < n) __builtin_prefetch(&C[chr(i + D2)], 1, 1);
    C[chr(i)]++;
  }
  auto getStarts = [&]() {
    TIdx s = 0;
    for (TIdx c = 0; c <= K; ++c) { B[c] = s; s += C[c]; }
  };
  auto getEnds = [&]() {
    TIdx s = 0;
    for (TIdx c = 0; c <= K; ++c) { s += C[c]; B[c] = s; }
  };

  auto induceL = [&]() {
    getStarts();
    if constexpr (PACK) {
      constexpr TIdx VMASK = (TIdx(1) << 56) - 1;
      for (TIdx i = 0; i < n; ++i) {
        if (i + D2 < n) {
          TIdx eq = SA[i + D2];
          if (eq > 0) {
            int cb = int(eq >> 56);
            if (!(cb & 0x40)) {
              __builtin_prefetch(&B[cb & 0x3F], 1, 1);
              __builtin_prefetch(&T[(eq & VMASK) - 2], 0, 1);
            }
          }
        }
        TIdx e = SA[i];
        if (e <= 0) continue;               // empty slot or sentinel pos
        int cb = int(e >> 56);
        if (cb & 0x40) continue;            // predecessor is S-type
        TIdx w = (e & VMASK) - 1;
        SA[B[cb & 0x3F]++] = mk(w);
      }
    } else {
      for (TIdx i = 0; i < n; ++i) {
        if (i + D1 < n) { TIdx jp = SA[i + D1]; if (jp > 0) pfT(jp - 1); }
        if (i + D2 < n) {
          TIdx jq = SA[i + D2];
          if (jq > 0 && !tget(jq - 1)) __builtin_prefetch(&B[chr(jq - 1)], 1, 1);
        }
        TIdx j = SA[i];
        if (j > 0 && !tget(j - 1)) SA[B[chr(j - 1)]++] = j - 1;
      }
    }
  };
  auto induceS = [&]() {
    getEnds();
    if constexpr (PACK) {
      constexpr TIdx VMASK = (TIdx(1) << 56) - 1;
      for (TIdx i = n - 1; i >= 0; --i) {
        if (i >= D2) {
          TIdx eq = SA[i - D2];
          if (eq > 0) {
            int cb = int(eq >> 56);
            if (cb & 0x40) {
              __builtin_prefetch(&B[cb & 0x3F], 1, 1);
              __builtin_prefetch(&T[(eq & VMASK) - 2], 0, 1);
            }
          }
        }
        TIdx e = SA[i];
        if (e <= 0) continue;
        int cb = int(e >> 56);
        if (!(cb & 0x40)) continue;         // predecessor is L-type
        TIdx w = (e & VMASK) - 1;
        SA[--B[cb & 0x3F]] = mk(w);
      }
    } else {
      for (TIdx i = n - 1; i >= 0; --i) {
        if (i >= D1) { TIdx jp = SA[i - D1]; if (jp > 0) pfT(jp - 1); }
        if (i >= D2) {
          TIdx jq = SA[i - D2];
          if (jq > 0 && tget(jq - 1)) __builtin_prefetch(&B[chr(jq - 1)], 1, 1);
        }
        TIdx j = SA[i];
        if (j > 0 && tget(j - 1)) SA[--B[chr(j - 1)]] = j - 1;
      }
    }
  };

  blog("stage1: LMS induce", int64_t(n));
  // Stage 1: sort LMS substrings by one round of induced sorting.
  std::fill(SA, SA + n, TIdx(-1));
  getEnds();
  for (TIdx i = n - 1; i >= 1; --i) {
    if (i >= D2) __builtin_prefetch(&B[chr(i - D2)], 1, 1);
    if (isLMS(i)) SA[--B[chr(i)]] = mk(i);
  }
  induceL();
  induceS();

  // Compact the sorted LMS positions into SA[0..n1), as PLAIN values
  // (the naming phase consumes them as text positions).
  TIdx n1 = 0;
  if constexpr (PACK) {
    constexpr TIdx VMASK = (TIdx(1) << 56) - 1;
    for (TIdx i = 0; i < n; ++i) {
      if (i + D1 < n) {
        TIdx ep = SA[i + D1];
        if (ep > 0) __builtin_prefetch(&T[ep & VMASK], 0, 1);
      }
      TIdx e = SA[i];
      // isLMS(v): S-type at v (random read), L-type at v-1 (packed)
      if (e > 0 && !(int(e >> 56) & 0x40)) {
        TIdx v = e & VMASK;
        if (tget(v)) SA[n1++] = v;
      }
    }
  } else {
    for (TIdx i = 0; i < n; ++i) {
      if (i + D1 < n) { TIdx jp = SA[i + D1]; if (jp > 0) pfT(jp - 1); }
      if (isLMS(SA[i])) SA[n1++] = SA[i];
    }
  }

  blog("naming LMS substrings", int64_t(n1));
  // Name LMS substrings into the upper half of SA.
  std::fill(SA + n1, SA + n, TIdx(-1));
  TIdx name = 0, prev = -1;
  for (TIdx i = 0; i < n1; ++i) {
    if (i + D2 < n1) {
      TIdx pp = SA[i + D2];
      pfT(pp);
      __builtin_prefetch(&SA[n1 + pp / 2], 1, 1);
    }
    TIdx pos = SA[i];
    bool diff = false;
    if (prev < 0) diff = true;
    else {
      for (TIdx d = 0;; ++d) {
        if constexpr (FOLD) {
          // folded byte equality covers both char and type equality
          if (T[pos + d] != T[prev + d]) { diff = true; break; }
        } else {
          if (T[pos + d] != T[prev + d] || tget(pos + d) != tget(prev + d)) {
            diff = true;
            break;
          }
        }
        if (d > 0 && (isLMS(pos + d) || isLMS(prev + d))) break;  // types equal => both LMS
      }
    }
    if (diff) { ++name; prev = pos; }
    SA[n1 + pos / 2] = name - 1;
  }
  for (TIdx i = n - 1, j = n - 1; i >= n1; --i)
    if (SA[i] >= 0) SA[j--] = SA[i];

  // Recurse if names are not yet unique.
  TIdx* SA1 = SA;
  TIdx* s1 = SA + n - n1;
  if (name < n1) {
    bool narrow = false;
    if constexpr (sizeof(TIdx) == 8) {
      // drop to 32-bit indices when the reduced problem fits: every
      // random access below this level touches half the bytes
      if (n1 < TIdx(INT32_MAX) - 1) {
        narrow = true;
        Buf<int32_t> s1b{size_t(n1)}, sa1b{size_t(n1)};
        for (TIdx i = 0; i < n1; ++i) s1b.p[i] = int32_t(s1[i]);
        sais_core<int32_t, int32_t>(s1b.p, sa1b.p, int32_t(n1), int32_t(name - 1));
        for (TIdx i = 0; i < n1; ++i) SA1[i] = sa1b.p[i];
      }
    }
    if (!narrow) sais_core<TIdx, TIdx>(s1, SA1, n1, name - 1);
  } else {
    for (TIdx i = 0; i < n1; ++i) SA1[s1[i]] = i;
  }

  // Map reduced-string ranks back to LMS text positions.
  {
    TIdx j = 0;
    for (TIdx i = 1; i < n; ++i)
      if (isLMS(i)) s1[j++] = i;
    for (TIdx i = 0; i < n1; ++i) {
      if (i + D2 < n1) __builtin_prefetch(&s1[SA1[i + D2]], 0, 1);
      SA1[i] = s1[SA1[i]];
    }
  }

  blog("stage2: final induce", int64_t(n));
  // Stage 2: induce the full SA from the sorted LMS suffixes.
  std::fill(SA + n1, SA + n, TIdx(-1));
  getEnds();
  for (TIdx i = n1 - 1; i >= 0; --i) {
    if (i >= D1) { TIdx jp = SA[i - D1]; if (jp >= 0) pfT(jp); }
    if (i >= D2) {
      TIdx jq = SA[i - D2];
      if (jq >= 0) __builtin_prefetch(&B[chr(jq)], 1, 1);
    }
    TIdx j = SA[i];
    SA[i] = -1;
    SA[--B[chr(j)]] = mk(j);
  }
  induceL();
  induceS();
  // PACK levels return the SA with the predecessor byte still in bits
  // 62..56; the caller strips it (and harvests the BWT from it).
}

// Build the folded (+1-shifted, type-bit-tagged) text with the
// sentinel appended, run SA-IS over n+1 positions into sa_full, and
// (optionally) derive the stored BWT + primary row in one prefetched
// pass. sa_full[0] is always n (the sentinel row). Returns primary.
int64_t index_core_impl(const uint8_t* T, int64_t n, int64_t K,
                        int64_t* sa_full, uint8_t* bwt) {
  Buf<uint8_t> Tp(size_t(n) + 1);
  Tp.p[n] = 0x40;  // sentinel: char 0, S-type
  bool tn = true;
  uint8_t cn = 0;
  for (int64_t i = n - 1; i >= 0; --i) {
    uint8_t c = uint8_t(T[i] + 1);
    bool ti = (c < cn) || (c == cn && tn);
    Tp.p[i] = c | uint8_t(ti << 6);
    tn = ti;
    cn = c;
  }
  sais_core<int64_t, uint8_t>(Tp.p, sa_full, n + 1, K);
  blog("suffix array done; deriving BWT", n);
  // The packed top-level SA carries each row's predecessor byte in
  // bits 62..56 — exactly the BWT byte — so unpacking the values and
  // deriving the BWT is ONE sequential pass with zero random reads.
  // Row k of the BWT matrix holds text[sa_full[k]-1]; the row whose
  // suffix is the whole text (value 0) is `primary` and its sentinel
  // char is omitted from storage (bwt_index.cpp / bwt.h convention).
  constexpr int64_t VMASK = (int64_t(1) << 56) - 1;
  int64_t primary = -1;
  int64_t out = 0;
  for (int64_t k = 0; k <= n; ++k) {
    int64_t e = sa_full[k];
    int64_t v = e & VMASK;
    sa_full[k] = v;
    if (v == 0) { primary = k; continue; }
    if (bwt) bwt[out++] = uint8_t((int(e >> 56) & 0x3F) - 1);
  }
  blog("bwt derived", n);
  return primary;
}

}  // namespace

extern "C" {

// Suffix array of a 2-bit (or small-alphabet) text with an implicit
// smallest sentinel appended (BWA convention: "$" sorts first).
// T: n bytes with values in [0, K-1]; SA out: n entries.
// Returns 0 on success.
int64_t dart_sais_u8(const uint8_t* T, int64_t* SA, int64_t n, int64_t K) {
  if (n <= 0) return 0;
  if (K > 63) return -1;  // type-bit folding needs values in 6 bits
  if (n >= (int64_t(1) << 55)) return -1;  // entry packing needs 56-bit values
  Buf<int64_t> SAp(size_t(n) + 1);
  index_core_impl(T, n, K, SAp.p, nullptr);
  std::memcpy(SA, SAp.p + 1, sizeof(int64_t) * size_t(n));
  return 0;
}

// One-call index core for the builder: full suffix array INCLUDING the
// sentinel row (sa_full has n+1 entries, sa_full[0] == n) plus the
// stored BWT (n bytes, primary row's sentinel omitted). Returns the
// primary row index, or -1 on error. Avoids the builder's NumPy
// concatenate/delete/gather passes, which would triple peak memory at
// GRCh38 scale.
int64_t dart_index_core(const uint8_t* T, int64_t n, int64_t K,
                        int64_t* sa_full, uint8_t* bwt) {
  if (n <= 0 || K > 63) return -1;
  if (n >= (int64_t(1) << 55)) return -1;  // entry packing needs 56-bit values
  return index_core_impl(T, n, K, sa_full, bwt);
}

// Interleaved .bwt payload: per 128-base block, Occ[4] u64 checkpoints
// (little-endian u32 pairs) then the block's 16-bases-per-u32 BWT
// words, with the final cumulative Occ appended (reference layout:
// bwtindex.c:53-75, bwt.h:73-80). out must hold
// ceil(n/16) + (ceil(n/128)+1)*8 u32 entries. Single sequential pass.
void dart_bwt_payload(const uint8_t* bwt, int64_t n, uint32_t* out) {
  uint64_t occ[4] = {0, 0, 0, 0};
  size_t o = 0;
  int64_t i = 0;
  while (i < n) {
    for (int c = 0; c < 4; ++c) {
      out[o++] = uint32_t(occ[c]);
      out[o++] = uint32_t(occ[c] >> 32);
    }
    int64_t blk_end = std::min(n, i + 128);
    while (i < blk_end) {
      uint32_t w = 0;
      int64_t wstart = i;
      int64_t wend = std::min(blk_end, wstart + 16);
      for (; i < wend; ++i) {
        uint32_t c = bwt[i] & 3;
        occ[c]++;
        w |= c << (2 * (15 - (i - wstart)));
      }
      out[o++] = w;
    }
  }
  for (int c = 0; c < 4; ++c) {
    out[o++] = uint32_t(occ[c]);
    out[o++] = uint32_t(occ[c] >> 32);
  }
}

}  // extern "C"
