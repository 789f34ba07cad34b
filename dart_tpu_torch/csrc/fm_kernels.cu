// FM-index kernels of the aligner's main path, for Hopper (sm_90a).
//
// Each kernel is a template on the table layout, instantiated twice (the
// MEM walk once, narrow, as in dart_tpu):
//
//   Narrow (int state, fwd+rc text below 2^31): dart_fm_seed_scan replaces
//   dart_tpu/ops/fm_jax.py::_seed_scan_kernel, dart_fm_locate replaces
//   fm_jax.py::_locate_kernel, dart_fm_lut_build replaces
//   fm_jax.py::build_lut / _lut_extend and dart_fm_mem_walks replaces
//   fm_jax.py::_mem_walks_kernel. The merged table (built by
//   dart_tpu_torch/ops/layout.py) has 8 uint32 words per row: Occ rows
//   [occA occC occG occT | 64 BWT bases, 16 per word, top first], then the
//   2-bit packed genome from row ref_off (128 bases a row), then the SA
//   samples (int32, 8 per row) from row sad_off.
//
//   Wide (int64 state, any text, required from 2^31 on): dart_fm_*_wide
//   replace fm_jax_wide.py::_seed_scan_kernel_wide, _locate_kernel_wide and
//   build_lut_wide / _lut_extend_wide. Rows are 16 words: Occ rows
//   [occ lo x4 | occ hi x4 | 128 BWT bases], genome rows of 256 bases,
//   sample rows [lo x8 | hi x8]. The TPU form's (lo, hi) uint32 pair
//   arithmetic becomes plain int64: every position, row, count, L2 entry
//   and table offset is a long long, and so is every address computation
//   (the GRCh38 table is 7.71 GB, past 2^32 bytes).
//
// The K-mer table (LUT) holds, for each K-mer, the bidirectional interval
// after the walk from its first base has taken its other K - 1 bases, or
// zeros once the walk died: [x0 x1 x2 0] uint32 narrow, [x0 x1 x2] int64
// wide. It is built as the TPU form builds it, level by level, each
// prefix extended once into its four children: a root pass, then a warp
// to each subtree of kLutDepth levels (at lut_build_kernel). With a LUT,
// the seed scan starts each walk K bases in.
//
// What bounds them: each step of a lane is a gather of one table row whose
// address depends on the previous step. The work per row is a few
// popcounts, so the kernels are bound by the latency of those dependent
// gathers, not by bandwidth: an 8 Mbp genome's table is ~20 MB and sits in
// the 50 MB L2; a 50 Mbp one (125 MB) and GRCh38's do not, and there each
// step costs a DRAM round trip, which the LUT saves K - 1 times a walk. A
// row is read as 16-byte loads (two narrow, four wide).
//
// The locate and the MEM walk answer latency with parallelism: one thread
// per row to locate, per MEM-walk task, a plain sequential loop in each
// thread, 128 threads a block, so that tens of thousands of independent
// gathers are in flight at once. Past the first steps few walks are left,
// and each step is built for the latency of its chain (at locate_kernel
// and mem_walks_kernel).
//
// The seed scan (K1 narrow, K4 wide) was on the TPU one vectorised
// automaton over a chunk's reads: every lane took the same step, a merged
// 2R-row gather with select trees, one-hot reductions and masks for every
// mode, under an iteration cap with a rerun of the stragglers. Here one
// thread scans one read, and what bounds a launch is its longest lanes,
// not the count of reads: a read whose walks restart many times, or whose
// matches each walk an SA locate, holds its warp, each of its steps a
// dependent load plus the step's arithmetic, with ever fewer warps left to
// hide either, while a warp whose lanes are in different modes (start,
// extend, locate, compare) would run each mode's load in turn. So the scan
// is a state machine with one uniform step: every lane settles what reads
// no memory, then all issue their loads at once, then apply them, with the
// extension's arithmetic in one place; the reads sit in shared memory, the
// next walk's K-mer entry is loaded ahead, and three exact shortcuts (at
// seed_scan_kernel) take the steps the longest lanes spend on walks whose
// outcome is already known.
//
// Every read of the merged table goes through a table-access parameter
// beside the layout trait (the kernels are templates on the access, whose
// Layout is the trait):
//
//   Flat: the table is one allocation, read through one pointer (the
//   dart_fm_* entries, the single-device engine).
//
//   Sharded: the table is range-sharded by row over the cards of an
//   `index` mesh axis (dart_fm_*_sharded, the counterparts of the programs
//   that dart_tpu/parallel/mesh.py::ShardedFMIndex and
//   fm_jax_wide.py::FMIndexJaxWide(index_mesh=...) run GSPMD-partitioned).
//   Shard s holds rows [s * rows, (s + 1) * rows), a separate allocation on
//   its card; a small device array holds each shard's base address. A row
//   read divides its row number by `rows` and reads the base (an L1 hit
//   after the first) before the row itself: one more dependent load a
//   step, where GSPMD moved rows between chips with collectives. The
//   kernel runs on the first card of its group and reads the other shards
//   over peer-to-peer (dart_enable_peer_access). The three places that
//   read the table go through it: the Occ rows (load_row), the SA samples
//   (Layout::sample) and the genome words of the compare (Genome, one
//   word at a time, since the two words of a 16-base window may sit in
//   different shards).
//
// Each C entry launches on the given stream, does not synchronise, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// Host params, in this order: L2[0..4], primary, sa_intv, sad_off, ref_off,
// seq_len, max_dup; int narrow, long long wide.
template <class I>
struct FmParams {
  I L2[5];
  I primary;
  I sa_intv;
  I sad_off;
  I ref_off;
  I seq_len;
  I max_dup;
};

template <class I>
FmParams<I> make_params(const I* h) {
  FmParams<I> p;
  for (int i = 0; i < 5; ++i) p.L2[i] = h[i];
  p.primary = h[5];
  p.sa_intv = h[6];
  p.sad_off = h[7];
  p.ref_off = h[8];
  p.seq_len = h[9];
  p.max_dup = h[10];
  return p;
}

// c ? x : y, as one `selp` that the compiler keeps as it is. A plain
// select between two words of a row array may be rewritten into one load
// at a computed offset, which moves the whole array to the stack (local
// memory); the words of a row are therefore picked with selw alone. Off
// the card (a host build of this file) it is the plain select.
__device__ __forceinline__ uint32_t selw(bool c, uint32_t x, uint32_t y) {
#ifdef __CUDA_ARCH__
  uint32_t r;
  asm("{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %3, 0;\n\t"
      "selp.b32 %0, %1, %2, p;\n\t}"
      : "=r"(r)
      : "r"(x), "r"(y), "r"((uint32_t)c));
  return r;
#else
  return c ? x : y;
#endif
}

// Word i (0..3, at run time) of a 16-byte vector.
__device__ __forceinline__ uint32_t sel4(const uint4& v, int i) {
  return selw(i & 2, selw(i & 1, v.w, v.z), selw(i & 1, v.y, v.x));
}

// The Occ counts of the four bases.
template <class I>
struct Occ4 {
  I c0, c1, c2, c3;
};

struct Narrow {
  using I = int;
  static constexpr int kVecs = 2;  // 16-byte vectors per table row (4 words
                                   // each); a genome row is 16 * 4 * kVecs bases
  static constexpr int kOccShift = 6;  // log2 of the BWT bases per Occ row

  // Occ of base c (at run time) at the row start, and of all four
  __device__ static int occ(const uint4* v, int c) { return (int)sel4(v[0], c); }
  __device__ static Occ4<int> occ_all(const uint4* v) {
    return {(int)v[0].x, (int)v[0].y, (int)v[0].z, (int)v[0].w};
  }

  template <class A>
  __device__ static int sample(const A& a, int sad_off, int srow) {
    return (int)__ldg(a.row_words((size_t)sad_off + (srow >> 3)) +
                      (srow & 7));
  }

  __device__ static void lut_load(const void* lut, uint32_t key, int& x0,
                                  int& x1, int& x2) {
    const uint4 e = __ldg(static_cast<const uint4*>(lut) + key);
    x0 = (int)e.x;
    x1 = (int)e.y;
    x2 = (int)e.z;
  }

  static constexpr int kLutBytes = 16;  // a K-mer table entry

  __device__ static void lut_store(void* lut, long long key, int x0, int x1,
                                   int x2) {
    static_cast<uint4*>(lut)[key] =
        make_uint4((uint32_t)x0, (uint32_t)x1, (uint32_t)x2, 0u);
  }

  // lut_load from a table being built in shared memory, which __ldg
  // cannot read
  __device__ static void lut_get(const void* lut, long long key, int& x0,
                                 int& x1, int& x2) {
    const uint4 e = static_cast<const uint4*>(lut)[key];
    x0 = (int)e.x;
    x1 = (int)e.y;
    x2 = (int)e.z;
  }
};

struct Wide {
  using I = long long;
  static constexpr int kVecs = 4;
  static constexpr int kOccShift = 7;

  __device__ static long long occ(const uint4* v, int c) {
    return (long long)sel4(v[0], c) | ((long long)sel4(v[1], c) << 32);
  }
  __device__ static Occ4<long long> occ_all(const uint4* v) {
    return {(long long)v[0].x | ((long long)v[1].x << 32),
            (long long)v[0].y | ((long long)v[1].y << 32),
            (long long)v[0].z | ((long long)v[1].z << 32),
            (long long)v[0].w | ((long long)v[1].w << 32)};
  }

  template <class A>
  __device__ static long long sample(const A& a, long long sad_off,
                                     long long srow) {
    const uint32_t* s = a.row_words((size_t)(sad_off + (srow >> 3))) +
                        (srow & 7);
    return (long long)__ldg(s) | ((long long)__ldg(s + 8) << 32);
  }

  __device__ static void lut_load(const void* lut, uint32_t key,
                                  long long& x0, long long& x1,
                                  long long& x2) {
    const long long* e = static_cast<const long long*>(lut) + 3 * (size_t)key;
    x0 = __ldg(e);
    x1 = __ldg(e + 1);
    x2 = __ldg(e + 2);
  }

  static constexpr int kLutBytes = 24;

  __device__ static void lut_store(void* lut, long long key, long long x0,
                                   long long x1, long long x2) {
    long long* e = static_cast<long long*>(lut) + 3 * key;
    e[0] = x0;
    e[1] = x1;
    e[2] = x2;
  }

  __device__ static void lut_get(const void* lut, long long key,
                                 long long& x0, long long& x1,
                                 long long& x2) {
    const long long* e = static_cast<const long long*>(lut) + 3 * key;
    x0 = e[0];
    x1 = e[1];
    x2 = e[2];
  }
};

// The table in one allocation.
template <class L>
struct Flat {
  using Layout = L;
  const uint4* __restrict__ t4;

  // the first 16-byte vector of row r
  __device__ __forceinline__ const uint4* row(size_t r) const {
    return t4 + r * L::kVecs;
  }
  __device__ __forceinline__ const uint32_t* row_words(size_t r) const {
    return reinterpret_cast<const uint32_t*>(row(r));
  }

};

// The table range-sharded by row: `rows` rows a shard, shard s from
// base[s]. Row numbers stay below 2^32 (the host checks), so the division
// is 32-bit.
template <class L>
__device__ __forceinline__ const uint4* shard_row(
    const unsigned long long* __restrict__ base, unsigned rows, size_t r) {
  const unsigned s = (unsigned)r / rows;
  return reinterpret_cast<const uint4*>(__ldg(base + s)) +
         (size_t)((unsigned)r - s * rows) * L::kVecs;
}

template <class L>
struct Sharded {
  using Layout = L;
  const unsigned long long* __restrict__ base;
  unsigned rows;

  __device__ __forceinline__ const uint4* row(size_t r) const {
    return shard_row<L>(base, rows, r);
  }
  __device__ __forceinline__ const uint32_t* row_words(size_t r) const {
    return reinterpret_cast<const uint32_t*>(row(r));
  }

};

template <class A>
__device__ __forceinline__ void load_row(const A& a, size_t row,
                                         uint4 (&v)[A::Layout::kVecs]) {
  const uint4* r = a.row(row);
#pragma unroll
  for (int j = 0; j < A::Layout::kVecs; ++j) v[j] = __ldg(r + j);
}

// BWT word j (runtime) of a loaded Occ row
template <class L>
__device__ __forceinline__ uint32_t bwt_word(const uint4 (&v)[L::kVecs],
                                             int j) {
  if constexpr (L::kVecs == 2) {
    return sel4(v[1], j & 3);
  } else {
    // a select, not a runtime index, keeps the row in registers
    return selw(j & 4, sel4(v[3], j & 3), sel4(v[2], j & 3));
  }
}

// The even bits of BWT word j (bases 16 j .. 16 j + 15, top first) that
// stand for its bases among the row's first `take`.
__device__ __forceinline__ uint32_t word_mask(int j, int take) {
  const int tw = min(max(take - 16 * j, 0), 16);
  return tw == 0 ? 0u : (0xFFFFFFFFu << (32 - 2 * tw)) & 0x55555555u;
}

// Bases of word x = w ^ (base * 0x55555555) equal to that base, under m.
__device__ __forceinline__ int count_eq(uint32_t x, uint32_t m) {
  return __popc(~(x | (x >> 1)) & m);
}

// Bases equal to the pattern's base (pat = base * 0x55555555) among the
// first `take` (1..64 narrow, 1..128 wide) bases of the row's BWT words.
// The words are read as the vectors' members: an index known only after
// unrolling would go through sel4.
template <class L>
__device__ __forceinline__ int count_base(const uint4 (&v)[L::kVecs],
                                          int take, uint32_t pat) {
  int cnt = 0;
#pragma unroll
  for (int q = 0; q < L::kVecs / 2; ++q) {
    const uint4& b = v[L::kVecs / 2 + q];
    cnt += count_eq(b.x ^ pat, word_mask(4 * q, take)) +
           count_eq(b.y ^ pat, word_mask(4 * q + 1, take)) +
           count_eq(b.z ^ pat, word_mask(4 * q + 2, take)) +
           count_eq(b.w ^ pat, word_mask(4 * q + 3, take));
  }
  return cnt;
}

// One of four values by a runtime index, as a chain of selects: values kept
// in registers are never indexed at run time (an indexed array goes to the
// stack, and every access to it to local memory).
template <class T>
__device__ __forceinline__ T pick4(int c, T v0, T v1, T v2, T v3) {
  return c == 0 ? v0 : c == 1 ? v1 : c == 2 ? v2 : v3;
}

// L2[i], i = 0..4 at run time
template <class I>
__device__ __forceinline__ I l2(const FmParams<I>& p, int i) {
  return i == 4 ? p.L2[4] : pick4(i, p.L2[0], p.L2[1], p.L2[2], p.L2[3]);
}

// Bases 1, 2 and 3 of BWT word w under m, added to n1, n2 and n3: the
// word's high bits (w >> 1) and low bits (w) at the even positions.
__device__ __forceinline__ void count123(uint32_t w, uint32_t m, int& n1,
                                         int& n2, int& n3) {
  const uint32_t hi = w >> 1;
  n1 += __popc(~hi & w & m);
  n2 += __popc(hi & ~w & m);
  n3 += __popc(hi & w & m);
}

// Occ of all four bases in stored BWT [0, kk] (kk already primary-adjusted),
// from kk's loaded Occ row, in one pass over its BWT words; base 0 is the
// rest.
template <class L>
__device__ __forceinline__ Occ4<typename L::I> occ4_row(
    const uint4 (&v)[L::kVecs], typename L::I kk) {
  const int take = (int)(kk & ((1 << L::kOccShift) - 1)) + 1;
  int n1 = 0, n2 = 0, n3 = 0;
#pragma unroll
  for (int q = 0; q < L::kVecs / 2; ++q) {
    const uint4& b = v[L::kVecs / 2 + q];
    count123(b.x, word_mask(4 * q, take), n1, n2, n3);
    count123(b.y, word_mask(4 * q + 1, take), n1, n2, n3);
    count123(b.z, word_mask(4 * q + 2, take), n1, n2, n3);
    count123(b.w, word_mask(4 * q + 3, take), n1, n2, n3);
  }
  const Occ4<typename L::I> o = L::occ_all(v);
  return {o.c0 + take - n1 - n2 - n3, o.c1 + n1, o.c2 + n2, o.c3 + n3};
}

// The stored-BWT position of an Occ query at row q: primary-adjusted and
// clamped at 0.
template <class I>
__device__ __forceinline__ I occ_pos(const FmParams<I>& p, I q) {
  return max(q - (q >= p.primary), (I)0);
}

// One backward-search extension (BWT_Search) of the bidirectional interval
// (x0, x1, x2) by the base whose complement is ci, from the Occ rows of
// occ_pos(x1 - 1) (va) and occ_pos(x1 - 1 + x2) (vb). False, and the
// interval untouched, when the extended pattern does not occur.
template <class L>
__device__ __forceinline__ bool extend_rows(
    const FmParams<typename L::I>& p, const uint4 (&va)[L::kVecs],
    const uint4 (&vb)[L::kVecs], int ci, typename L::I& x0,
    typename L::I& x1, typename L::I& x2) {
  using I = typename L::I;
  const Occ4<I> tk = occ4_row<L>(va, occ_pos(p, x1 - 1));
  const Occ4<I> tl = occ4_row<L>(vb, occ_pos(p, x1 - 1 + x2));
  const I w1 = tl.c1 - tk.c1, w2 = tl.c2 - tk.c2, w3 = tl.c3 - tk.c3;
  const I wi = pick4(ci, tl.c0 - tk.c0, w1, w2, w3);
  if (wi <= 0) return false;
  // the new start: the old one, past the primary row, past the bases above
  x0 += (I)(x1 <= p.primary && x1 + x2 - 1 >= p.primary) +
        (ci < 1 ? w1 : (I)0) + (ci < 2 ? w2 : (I)0) + (ci < 3 ? w3 : (I)0);
  x1 = l2(p, ci) + 1 + pick4(ci, tk.c0, tk.c1, tk.c2, tk.c3);
  x2 = wi;
  return true;
}

// Bases among the first t (clamped to 0 .. 32) of BWT words u, w (16 bases
// each, top first) whose high bit is set, whose low bit is set, and both,
// added to nh, nl and nb: u's bits packed at the even positions and w's at
// the odd ones, so that one popcount counts both words.
__device__ __forceinline__ void count_pair(uint32_t u, uint32_t w, int t,
                                           int& nh, int& nl, int& nb) {
  const int c = min(max(t, 0), 32);
  // the top 2 c bits of u:w (two shifts: one by 64 would be undefined)
  const unsigned long long m = ~0ull << (32 - c) << (32 - c);
  const uint32_t even = 0x55555555u;
  const uint32_t keep = ((uint32_t)(m >> 32) & even) | ((uint32_t)m & ~even);
  const uint32_t hi = (((u >> 1) & even) | (w & ~even)) & keep;
  const uint32_t lo = ((u & even) | ((w << 1) & ~even)) & keep;
  nh += __popc(hi);
  nl += __popc(lo);
  nb += __popc(hi & lo);
}

// occ4_row with half its popcounts (count_pair): base 3 is both bits,
// base 2 the high bit alone, base 1 the low bit alone.
template <class L>
__device__ __forceinline__ Occ4<typename L::I> occ4_pairs(
    const uint4 (&v)[L::kVecs], typename L::I kk) {
  const int take = (int)(kk & ((1 << L::kOccShift) - 1)) + 1;
  int nh = 0, nl = 0, nb = 0;
#pragma unroll
  for (int q = 0; q < L::kVecs / 2; ++q) {
    const uint4& b = v[L::kVecs / 2 + q];
    count_pair(b.x, b.y, take - 64 * q, nh, nl, nb);
    count_pair(b.z, b.w, take - 64 * q - 32, nh, nl, nb);
  }
  const Occ4<typename L::I> o = L::occ_all(v);
  return {o.c0 + take - nh - nl + nb, o.c1 + nl - nb, o.c2 + nh - nb,
          o.c3 + nb};
}

// The four extensions of the live interval (x0, x1, x2) at once, from the
// same two Occ rows as extend_rows (_backward_ext in ops/fm_plain.py):
// child b, the pattern extended by base b (ci = 3 - b), in (c0[b], c1[b],
// c2[b]), or zeros where that pattern does not occur. Its start is a
// running sum over ci = 3, 2, 1, 0: s3 = x0 + adj, s2 = s3 + w3,
// s1 = s2 + w2, s0 = s1 + w1, adj counting the primary row as extend_rows
// does.
template <class L>
__device__ __forceinline__ void extend4_rows(
    const FmParams<typename L::I>& p, const uint4 (&va)[L::kVecs],
    const uint4 (&vb)[L::kVecs], typename L::I x0, typename L::I x1,
    typename L::I x2, typename L::I (&c0)[4], typename L::I (&c1)[4],
    typename L::I (&c2)[4]) {
  using I = typename L::I;
  const Occ4<I> tk = occ4_pairs<L>(va, occ_pos(p, x1 - 1));
  const Occ4<I> tl = occ4_pairs<L>(vb, occ_pos(p, x1 - 1 + x2));
  const I k[4] = {tk.c0, tk.c1, tk.c2, tk.c3};
  const I w[4] = {tl.c0 - tk.c0, tl.c1 - tk.c1, tl.c2 - tk.c2,
                  tl.c3 - tk.c3};
  I s = x0 + (I)(x1 <= p.primary && x1 + x2 - 1 >= p.primary);
#pragma unroll
  for (int ci = 3; ci >= 0; --ci) {
    const bool ok = w[ci] > 0;
    c0[3 - ci] = ok ? s : (I)0;
    c1[3 - ci] = ok ? p.L2[ci] + 1 + k[ci] : (I)0;
    c2[3 - ci] = ok ? w[ci] : (I)0;
    s += w[ci];
  }
}

// k % sa_intv and k / sa_intv of a row k >= 0; a mask and a shift when the
// interval is a power of two, as it is in every index the builder writes
// (a division by a run-time divisor is a software routine, a long one at
// 64 bits).
template <class I>
__device__ __forceinline__ I sa_rem(const FmParams<I>& p, I k) {
  if ((p.sa_intv & (p.sa_intv - 1)) == 0) return k & (p.sa_intv - 1);
  return k % p.sa_intv;
}

template <class I>
__device__ __forceinline__ I sa_div(const FmParams<I>& p, I k) {
  if ((p.sa_intv & (p.sa_intv - 1)) == 0)
    return k >> (__ffsll((long long)p.sa_intv) - 1);
  return k / p.sa_intv;
}

// One LF step of bwt_sa (bwt_invPsi) from row k != primary: the row of the
// suffix one text position earlier, from the loaded Occ row of
// k - (k > primary).
template <class L>
__device__ __forceinline__ typename L::I lf_row(
    const FmParams<typename L::I>& p, const uint4 (&v)[L::kVecs],
    typename L::I k) {
  using I = typename L::I;
  const I kk = k - (k > p.primary);
  const int lo = (int)(kk & ((1 << L::kOccShift) - 1));
  const int c = (bwt_word<L>(v, lo >> 4) >> (2 * (15 - (lo & 15)))) & 3;
  return l2(p, c) + L::occ(v, c) +
         count_base<L>(v, lo + 1, (uint32_t)c * 0x55555555u);
}

// Word w (0 .. 4 kVecs - 1, at run time) of a loaded row, by selects.
template <class L>
__device__ __forceinline__ uint32_t row_word(const uint4 (&v)[L::kVecs],
                                             int w) {
  uint32_t r = sel4(v[0], w & 3);
#pragma unroll
  for (int j = 1; j < L::kVecs; ++j)
    r = selw((w >> 2) == j, sel4(v[j], w & 3), r);
  return r;
}

// SA sample s of a loaded sample row (the row of s / 8): int32 narrow, a
// [lo x8 | hi x8] pair wide.
template <class L>
__device__ __forceinline__ typename L::I sample_in_row(
    const uint4 (&v)[L::kVecs], typename L::I s) {
  const int w = (int)(s & 7);
  if constexpr (L::kVecs == 2) {
    return (int)row_word<L>(v, w);
  } else {
    return (long long)row_word<L>(v, w) |
           ((long long)row_word<L>(v, 8 + w) << 32);
  }
}

__device__ __forceinline__ int base_at(const uint32_t* codes, int i) {
  return (codes[i >> 4] >> (2 * (15 - (i & 15)))) & 3;
}

__device__ __forceinline__ bool is_n(const uint32_t* nmask, int i) {
  return (nmask[i >> 5] >> (31 - (i & 31))) & 1;
}

// The 16 bases (2 bits each, top first) of the read from base i.
__device__ __forceinline__ uint32_t code_window(const uint32_t* codes,
                                                int words, int i) {
  const int qi = i >> 4, qa = (i & 15) * 2;
  uint32_t rw = codes[qi];
  if (qa) rw = (rw << qa) | ((qi + 1 < words ? codes[qi + 1] : 0u) >> (32 - qa));
  return rw;
}

// The 32 N bits (top first) of the read from base i.
__device__ __forceinline__ uint32_t n_window(const uint32_t* nmask,
                                             int nwords, int i) {
  const int ni = i >> 5, na = i & 31;
  uint32_t nb = nmask[ni];
  if (na) nb = (nb << na) | ((ni + 1 < nwords ? nmask[ni + 1] : 0u) >> (32 - na));
  return nb;
}

// The K-mer of the read at pos holds no N and ends inside the read.
__device__ __forceinline__ bool kmer_ok(const uint32_t* nmask, int words,
                                        int rlen, int pos, int k) {
  return (n_window(nmask, words / 2, pos) >> (32 - k)) == 0 &&
         pos + k <= rlen;
}

// The K-mer of the read at pos as a K-mer table key (first base on top).
__device__ __forceinline__ uint32_t kmer_key(const uint32_t* codes,
                                             int words, int pos, int k) {
  return code_window(codes, words, pos) >> (32 - 2 * k);
}

// Bases of the read from `cur` that equal the genome window gw (the 16
// bases from goff, top first), up to 16, capped at the ends of read and
// genome. N bases never match.
template <class I>
__device__ __forceinline__ int match16(uint32_t gw, const uint32_t* codes,
                                       const uint32_t* nmask, int words,
                                       int rlen, I seq_len, int cur,
                                       I goff) {
  const uint32_t rw = code_window(codes, words, cur);
  const uint32_t nb = n_window(nmask, words / 2, cur);
  // the window's 16 N bits, spread to 2 bits per base like the codes
  uint32_t x = nb >> 16;
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  x = (x | (x << 1)) & 0x55555555u;
  const uint32_t v = (gw ^ rw) | x | (x << 1);
  const int m16 = v ? __clz(v) >> 1 : 16;
  const I avail = min((I)min(16, rlen - cur), seq_len - goff);
  return min(m16, (int)max(avail, (I)0));
}

// Where a lane of the seed scan is: starting a walk at pos, extending it,
// locating its one occurrence, comparing the read with the genome there.
enum : int { kStart, kExtend, kLocate, kCompare, kDone };

// The walk from pos ends with `length` bases: record it when accepted and
// jump past it, else advance by one; `last` ends the scan.
template <class I>
__device__ __forceinline__ void end_walk(I* o, int S, int& n, int& pos,
                                         int& mode, int length, bool acc,
                                         I k0, I freq, bool last) {
  if (acc) {
    if (n < S) {
      o[1 + n] = pos;
      o[1 + S + n] = length;
      o[1 + 2 * S + n] = k0;
      o[1 + 3 * S + n] = freq;
    }
    ++n;
    pos += length;
  } else {
    ++pos;
  }
  mode = last ? kDone : kStart;
}

// Blocks of the seed scan an SM must hold at once: the main path's 65,536
// reads make 512 blocks, 3.9 an SM, so that every block is resident from
// the start (a second wave of blocks would add its own tail). This caps a
// thread at 128 registers.
constexpr int kScanBlocksPerSm = 4;

// The reference seeding scan (IdentifySeedPairs, AlignmentCandidates.cpp):
// from each scan position take the forward maximal exact match; accept it
// when its length is >= 16 and it occurs <= max_dup times, then jump past
// it, else advance by one. The scan stops at rlen - 13. A match whose
// interval narrows to one occurrence leaves backward search: its genome
// position is located and the match finished by comparing the read with
// the genome, 16 bases at a time; such a seed has freq -1 and its genome
// position in k0.
//
// With the LUT (kLut), a walk starts from the table entry of the K-mer at
// pos, K bases in; an entry that is dead, or a K-mer window holding an N
// or running past the read, advances pos by one: that walk would have died
// before K < 16 bases, a rejected seed.
//
// One thread per read, as a state machine (kStart .. kDone) that takes one
// step per turn of its loop. A step first settles every transition that
// reads no memory (walk ends, N bases, a K-mer entry loaded ahead), then
// issues every load the step needs at once, then applies them. Whatever
// mode each lane of a warp is in, the warp waits for one load latency a
// step, and the extension (the step's costliest arithmetic) has one place
// in the loop, which a lane extending a walk and a lane extending beside
// its locate share. Three shortcuts change no output bit:
//
// - a match narrowed to one occurrence keeps extending beside its locate,
//   one base a step: an occurrence's extension and its compare with the
//   genome agree base for base (the table's genome rows are the indexed
//   text), so a match that stops short of 16 bases is rejected at once
//   instead of after its locate, and one that outlasts the locate hands
//   the compare a later start;
// - the scan stops at rlen - 15, not rlen - 13: a walk from further on is
//   shorter than 16 bases;
// - a walk that is rejected after extending to the read's end with x2 >= 2
//   ends the scan: every later walk is a suffix of it, occurs at least x2
//   times, never narrows to one occurrence, and is rejected too.
//
// The block's reads are staged in shared memory with one coalesced copy
// (`staged`, when they fit), so that a step's only global loads are its
// table rows and K-mer entries; the K-mer entry of pos + 1 is loaded with
// a walk's first step, so that a rejected walk's successor starts without
// a load of its own.
//
// A step loads at most three table rows: `vo`, the LF row or the SA sample
// row of a locate; `ve` and `vf`, the two Occ rows of an extension or the
// two genome rows of a compare.
//
// buf row: [codes, 16 per word | N bits, 32 per word | rlen]
// out row: [n | rpos x S | len x S | k0 x S | freq x S], int narrow,
// long long wide
template <class A, bool kLut>
__global__ void __launch_bounds__(kThreads, kScanBlocksPerSm)
seed_scan_kernel(A a, FmParams<typename A::Layout::I> p,
                 const void* __restrict__ lut, int lut_k,
                 const uint32_t* __restrict__ buf, int R, int words, int S,
                 bool staged, typename A::Layout::I* __restrict__ out) {
  using L = typename A::Layout;
  using I = typename L::I;
  constexpr int kRowWords = 4 * L::kVecs;
  extern __shared__ uint32_t sreads[];
  const int stride = words + words / 2 + 1;
  const int r0 = blockIdx.x * blockDim.x;
  if (staged) {
    const int nw = min((int)blockDim.x, R - r0) * stride;
    const uint32_t* src = buf + (size_t)r0 * stride;
    for (int i = threadIdx.x; i < nw; i += blockDim.x) sreads[i] = __ldg(src + i);
    __syncthreads();
  }
  const int r = r0 + threadIdx.x;
  if (r >= R) return;
  const uint32_t* codes =
      staged ? sreads + threadIdx.x * stride : buf + (size_t)r * stride;
  const uint32_t* nmask = codes + words;
  const int rlen = (int)codes[stride - 1];
  I* o = out + (size_t)r * (1 + 4 * S);
  for (int s = 1; s <= 4 * S; ++s) o[s] = 0;

  const int end_pos = max(rlen - 15, 0);
  int n = 0, pos = 0, cur = 0, mode = kStart;
  bool ext = false;  // a located match still extends beside its locate
  I x0 = 0, x1 = 0, x2 = 0, lk = 0, steps = 0, gbase = 0;
  int npos = -1;           // the K-mer entry (nx0, nx1, nx2) is pos npos's
  bool want_next = false;  // load the entry of pos + 1 with the next step
  I nx0 = 0, nx1 = 0, nx2 = 0;

  for (;;) {
    // 1. settle the transitions that read no memory, up to this step's loads
    size_t ro = 0, re = 0, rf = 0;
    bool ldo = false, lde = false, ldf = false, ldk = false, ldn = false;
    bool sampled = false;
    uint32_t key = 0, nkey = 0;
    while (mode != kDone) {
      if (mode == kStart) {
        if (pos >= end_pos) {
          mode = kDone;
          break;
        }
        if constexpr (kLut) {
          if (npos == pos) {  // loaded ahead
            npos = -1;
            if (nx2 == 0) {
              ++pos;
              continue;
            }
            x0 = nx0;
            x1 = nx1;
            x2 = nx2;
            cur = pos + lut_k;
            want_next = true;
            mode = kExtend;
            continue;
          }
          if (!kmer_ok(nmask, words, rlen, pos, lut_k)) {
            ++pos;
            continue;
          }
          key = kmer_key(codes, words, pos, lut_k);
          ldk = true;
          break;
        } else {
          if (is_n(nmask, pos)) {
            ++pos;
            continue;
          }
          const int c = base_at(codes, pos);
          x0 = l2(p, c) + 1;
          x1 = l2(p, 3 - c) + 1;
          x2 = l2(p, c + 1) - l2(p, c);
          cur = pos + 1;
          mode = kExtend;
          continue;
        }
      }
      if (mode == kExtend) {
        if (x2 == 1 && cur < rlen) {  // one occurrence: locate it
          mode = kLocate;
          lk = x0;
          steps = 0;
          ext = true;
          continue;
        }
        if (cur < rlen && !is_n(nmask, cur)) {
          re = (size_t)(occ_pos(p, x1 - 1) >> L::kOccShift);
          rf = (size_t)(occ_pos(p, x1 - 1 + x2) >> L::kOccShift);
          lde = true;
          break;
        }
        // the walk reached the read's end or an N
        const int length = cur - pos;
        const bool acc = x2 <= p.max_dup && length >= 16;
        end_walk(o, S, n, pos, mode, length, acc, x0, x2,
                 !acc && cur == rlen && x2 >= 2);
        continue;
      }
      if (mode == kLocate) {
        // the extension side stops at the read's end or an N: the match
        // ends there, and one shorter than 16 bases is rejected now
        if (ext && !(cur < rlen && !is_n(nmask, cur))) ext = false;
        if (!ext && cur - pos < 16) {
          end_walk(o, S, n, pos, mode, cur - pos, false, (I)0, (I)0, false);
          continue;
        }
        sampled = sa_rem(p, lk) == 0 || steps > p.seq_len;
        if (!sampled && lk == p.primary) {
          lk = 0;
          ++steps;
          continue;
        }
        ro = (size_t)(sampled ? p.sad_off + (sa_div(p, lk) >> 3)
                              : (lk - (lk > p.primary)) >> L::kOccShift);
        ldo = true;
        if (ext) {
          re = (size_t)(occ_pos(p, x1 - 1) >> L::kOccShift);
          rf = (size_t)(occ_pos(p, x1 - 1 + x2) >> L::kOccShift);
          lde = true;
        }
        break;
      }
      // kCompare
      if (cur < rlen && gbase + cur < p.seq_len) {
        const I gi = (gbase + cur) >> 4;
        re = (size_t)(p.ref_off + gi / kRowWords);
        rf = (size_t)(p.ref_off + (gi + 1) / kRowWords);
        lde = true;
        break;
      }
      end_walk(o, S, n, pos, mode, cur - pos, cur - pos >= 16, gbase + pos,
               (I)-1, false);
    }
    if (mode == kDone) break;
    if constexpr (kLut) {
      // with a walk's first load, the K-mer entry of pos + 1
      if (want_next && (mode == kExtend || mode == kLocate)) {
        want_next = false;
        npos = pos + 1;
        nx2 = 0;  // dead unless loaded
        if (npos < end_pos && kmer_ok(nmask, words, rlen, npos, lut_k)) {
          nkey = kmer_key(codes, words, npos, lut_k);
          ldn = true;
        }
      }
    }
    ldf = lde && rf != re;  // a second row equal to the first is not loaded

    // 2. issue every load of the step at once
    uint4 vo[L::kVecs], ve[L::kVecs], vf[L::kVecs];
    I e0 = 0, e1 = 0, e2 = 0;
    if (ldo) load_row(a, ro, vo);
    if (lde) load_row(a, re, ve);
    if (ldf) load_row(a, rf, vf);
    if constexpr (kLut) {
      if (ldk) L::lut_load(lut, key, e0, e1, e2);
      if (ldn) L::lut_load(lut, nkey, nx0, nx1, nx2);
    }
    if (lde && !ldf) {
#pragma unroll
      for (int j = 0; j < L::kVecs; ++j) vf[j] = ve[j];
    }

    // 3. apply them
    if (mode == kStart) {  // the K-mer entry of pos (kLut)
      if (e2 == 0) {
        ++pos;
      } else {
        x0 = e0;
        x1 = e1;
        x2 = e2;
        cur = pos + lut_k;
        want_next = true;
        mode = kExtend;
      }
      continue;
    }
    if (mode == kExtend || (mode == kLocate && ext)) {  // one extension
      if (extend_rows<L>(p, ve, vf, 3 - base_at(codes, cur), x0, x1, x2)) {
        ++cur;
      } else if (mode == kExtend) {
        const int length = cur - pos;
        end_walk(o, S, n, pos, mode, length,
                 x2 <= p.max_dup && length >= 16, x0, x2, false);
      } else {
        ext = false;  // the match ends at cur
      }
    }
    if (mode == kLocate) {
      if (!sampled) {
        lk = lf_row<L>(p, vo, lk);
        ++steps;
      } else {
        gbase = steps + sample_in_row<L>(vo, sa_div(p, lk)) - pos;
        if (ext)  // compare the rest, 16 bases a step
          mode = kCompare;
        else
          end_walk(o, S, n, pos, mode, cur - pos, cur - pos >= 16,
                   gbase + pos, (I)-1, false);
      }
    } else if (mode == kCompare) {
      const I goff = gbase + cur;
      const I gi = goff >> 4;
      const int ga = (int)(goff & 15) * 2;
      uint32_t gw = row_word<L>(ve, (int)(gi % kRowWords));
      if (ga)
        gw = (gw << ga) |
             (row_word<L>(vf, (int)((gi + 1) % kRowWords)) >> (32 - ga));
      const int m =
          match16(gw, codes, nmask, words, rlen, p.seq_len, cur, goff);
      cur += m;
      if (m < 16 || cur >= rlen || gbase + cur >= p.seq_len)
        end_walk(o, S, n, pos, mode, cur - pos, cur - pos >= 16, gbase + pos,
                 (I)-1, false);
    }
  }
  o[0] = n;
}

// The SA locate (K2 narrow, K5 wide; replaces fm_jax.py::_locate_kernel
// and fm_jax_wide.py::_locate_kernel_wide): the SA position of each row
// (bwt_sa), one thread a row, LF-walking it to a sampled row and adding
// the sample.
//
// What bounds it: a walk's length is geometric with mean sa_intv - 1 (the
// samples are taken by row, as in BWA), so a launch lasts as long as its
// longest walk (85 steps among 65,536 random rows at an interval of 8), and
// each step is one dependent Occ-row load plus the arithmetic from that
// row's arrival to the next row's address. The bytes are few (one 32- or
// 64-byte row a step); after the first few steps few warps are left, and
// the card waits on that chain. So the step is built to make it short:
//
// - the interval's kind is settled once a launch (SaGrid's kPow2): a
//   power of two is tested with a mask and divided with a shift, any other
//   interval divides;
// - what depends on kk = k - (k > primary) alone (the row to load, kk's
//   place in it, the count masks) is worked out while the row is on its
//   way;
// - once it arrives, the base c at lo, then the bases equal to c among
//   the row's first lo + 1, two BWT words a popcount (count_pair's
//   packing), and L2[c] + Occ_row[c] + that count;
// - row primary (which maps to row 0) is read like any other and its
//   result dropped, so no lane branches.
//
// Rows are taken in the order given, lane i on row i: lanes walking the
// consecutive rows of one seed's interval (the main path's repeat runs)
// start in one Occ row and often stay in neighbouring ones, and their
// loads of one 32-byte sector in one instruction are served as one.

// The rows sampled in the SA: row k holds a sample when k % intv == 0, and
// that sample is number k / intv.
template <class I, bool kPow2>
struct SaGrid {
  I intv;
  int shift;  // log2(intv) when kPow2
  __device__ __forceinline__ bool sampled(I k) const {
    if constexpr (kPow2)
      return (k & (intv - 1)) == 0;
    else
      return k % intv == 0;
  }
  __device__ __forceinline__ I index(I k) const {
    if constexpr (kPow2)
      return k >> shift;
    else
      return k / intv;
  }
};

// The grid of interval intv (> 0) for either kind; kPow2 is the caller's
// test of intv.
template <class I, bool kPow2>
SaGrid<I, kPow2> sa_grid(I intv) {
  return {intv, kPow2 ? __builtin_ctzll((unsigned long long)intv) : 0};
}

template <class I>
bool is_pow2(I intv) {
  return (intv & (intv - 1)) == 0;
}

// The row of the table that holds stored-BWT position kk >= 0 (unsigned,
// so that the address is one multiply-add).
template <class L>
__device__ __forceinline__ size_t occ_row_of(typename L::I kk) {
  if constexpr (sizeof(typename L::I) == 4)
    return (unsigned)kk >> L::kOccShift;
  else
    return (unsigned long long)kk >> L::kOccShift;
}

// One LF step of bwt_sa (bwt_invPsi) from row k: the row of the suffix one
// text position earlier, L2[c] + Occ(c, kk) with c the stored BWT base at
// kk = k - (k > primary); 0 from row primary. The row of kk is a row of
// the table even at k == primary (kk <= seq_len), so it is read there too.
//
// Pair q of a row's BWT words (words 2q and 2q + 1, bases 32q .. 32q + 31)
// is packed into a plane of high bits and one of low bits, as count_pair
// packs them; flipped where base c has a 0 bit, their AND marks the bases
// equal to c, so one popcount counts two words. The pairs before kk's are
// counted whole and those after it not at all; kk's own pair keeps its
// bases up to kk, the top 2 (lo % 32 + 1) bits of its 64, one shift. The
// popcounts run at a quarter of the ALU's rate, so a step takes one a pair
// (two narrow, four wide), not three for the counts of all four bases.
template <class A, class L = typename A::Layout>
__device__ __forceinline__ typename L::I lf_next(
    const A& a, const FmParams<typename L::I>& p, typename L::I k) {
  using I = typename L::I;
  constexpr uint32_t kEven = 0x55555555u;
  const I kk = k - (I)(k > p.primary);
  uint4 v[L::kVecs];
  load_row(a, occ_row_of<L>(kk), v);
  // from kk alone, while the row is on its way
  const int lo = (int)(kk & ((1 << L::kOccShift) - 1));
  const unsigned long long m = ~0ull << (62 - 2 * (lo & 31));
  const uint32_t part =
      ((uint32_t)(m >> 32) & kEven) | ((uint32_t)m & ~kEven);
  const int sh = 2 * (15 - (lo & 15));
  // then from the row: the base, and the bases equal to it
  const int c = (int)(bwt_word<L>(v, lo >> 4) >> sh) & 3;
  const uint32_t fh = c & 2 ? 0u : ~0u, fl = c & 1 ? 0u : ~0u;
  int n = 0;
#pragma unroll
  for (int q = 0; q < L::kVecs; ++q) {  // kVecs pairs of words
    const uint4& b = v[L::kVecs / 2 + q / 2];
    const uint32_t u = q & 1 ? b.z : b.x, w = q & 1 ? b.w : b.y;
    const uint32_t keep = q < (lo >> 5) ? ~0u : q == (lo >> 5) ? part : 0u;
    const uint32_t hi = ((u >> 1) & kEven) | (w & ~kEven);
    const uint32_t lw = (u & kEven) | ((w << 1) & ~kEven);
    n += __popc((hi ^ fh) & (lw ^ fl) & keep);
  }
  const I l2c = c & 2 ? (c & 1 ? p.L2[3] : p.L2[2])
                      : (c & 1 ? p.L2[1] : p.L2[0]);
  const I next = l2c + L::occ(v, c) + n;
  return k == p.primary ? (I)0 : next;
}

// One thread a row: out[i] = SA[rows[i]]. A walk on a valid table ends
// within seq_len steps; the bound only keeps a corrupt table from spinning
// a thread forever.
template <class A, bool kPow2>
__global__ void __launch_bounds__(kThreads)
locate_kernel(A a, FmParams<typename A::Layout::I> p,
              SaGrid<typename A::Layout::I, kPow2> g,
              const typename A::Layout::I* __restrict__ rows,
              typename A::Layout::I n,
              typename A::Layout::I* __restrict__ out) {
  using L = typename A::Layout;
  using I = typename L::I;
  const I i = (I)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  I k = __ldg(rows + i), steps = 0;
  while (!g.sampled(k) && steps <= p.seq_len) {
    k = lf_next(a, p, k);
    ++steps;
  }
  out[i] = steps + L::sample(a, p.sad_off, g.index(k));
}

// The K-mer table build (K3 narrow, K6 wide; key = base-4, first base most
// significant). Entry m of level l + 1 is entry m >> 2 of level l extended
// by base m & 3, so each prefix is extended once, into its four children
// from the same two Occ rows (extend4), as the TPU form's levels do;
// extending every K-mer from its first base alone repeats each shared
// prefix's extensions, 4^K (K - 1) of them against (4^K - 4) / 3.
//
// Two launches. lut_roots_kernel walks, one thread a root, the chain of
// each (K - d)-mer, d = min(K - 1, kLutDepth), and leaves it in the table
// at its first K-mer (at K = 1 the roots are the table). lut_build_kernel
// then expands each root by d levels in one warp: level l's 4^l parents in
// rounds of 32, lane j extending parent 32 q + j of round q, the levels in
// the warp's part of shared memory, __syncwarp between rounds; a dead
// parent (x2 == 0) gives four zero children and loads no row. The last
// level goes through a staging area, 128 entries a round, to the table in
// coalesced 16-byte streaming stores: the warp writes its 4^d K-mers, 4 KB
// narrow or 6 KB wide, as one contiguous range. At K = 11: 16,384 roots of
// 6 steps, then 1.4 M extensions, against the 41.9 M of a walk per K-mer.
//
// What bounds it: the table it writes (67 MB narrow, 100 MB wide at
// K = 11) at the card's memory rate, and below that the row gathers: the
// four children of a parent lie in four buckets of the BWT, so a lane's
// rows are nowhere near its neighbours' and every extension gathers one
// or two rows of its own from the L2. A warp's levels are a chain of
// d + 1 dependent steps; with a warp, not a block, to a subtree, every
// resident warp has a chain of its own, where a block to a subtree keeps
// most of its warps waiting at a barrier while the top levels' few
// parents are extended.
constexpr int kLutDepth = 4;
constexpr int kLutWarps = kThreads / 32;
constexpr int kLutStage = 4 * 32;  // entries a round of the last level
// entries of a warp's buffer: the staging area at 0, then the levels
// 0 .. kLutDepth - 1; an even count, so that a wide buffer (24-byte
// entries) is whole 16-byte vectors
constexpr int kLutSlots =
    (kLutStage + ((1 << (2 * kLutDepth)) - 1) / 3 + 1) & ~1;

// d, the levels a warp expands for a table of K >= 1, below 4^(K - d)
// roots.
constexpr int lut_depth(int K) {
  return K - 1 < kLutDepth ? K - 1 : kLutDepth;
}

// Where level l < d of a warp's subtree starts in its buffer, in entries.
__device__ __forceinline__ int lut_slot(int l) {
  return kLutStage + ((1 << (2 * l)) - 1) / 3;
}

// The four children of the live interval (x0, x1, x2): its two Occ rows,
// one load when both counts fall in the same row, then extend4_rows.
template <class A, class L = typename A::Layout>
__device__ __forceinline__ void extend4(const A& a,
                                        const FmParams<typename L::I>& p,
                                        typename L::I x0, typename L::I x1,
                                        typename L::I x2,
                                        typename L::I (&c0)[4],
                                        typename L::I (&c1)[4],
                                        typename L::I (&c2)[4]) {
  const size_t ra = (size_t)(occ_pos(p, x1 - 1) >> L::kOccShift);
  const size_t rb = (size_t)(occ_pos(p, x1 - 1 + x2) >> L::kOccShift);
  uint4 va[L::kVecs], vb[L::kVecs];
  load_row(a, ra, va);
  if (rb != ra) {
    load_row(a, rb, vb);
  } else {
#pragma unroll
    for (int k = 0; k < L::kVecs; ++k) vb[k] = va[k];
  }
  extend4_rows<L>(p, va, vb, x0, x1, x2, c0, c1, c2);
}

// The interval of root `root`, an n-mer: the walk from its first base,
// extended by each following base, zeros once it died. At n = 1 no
// extension runs, so a base absent from the text keeps
// (L2[c] + 1, L2[3 - c] + 1, 0).
template <class A, class L = typename A::Layout>
__device__ __forceinline__ void lut_root(const A& a,
                                         const FmParams<typename L::I>& p,
                                         long long root, int n,
                                         typename L::I& x0,
                                         typename L::I& x1,
                                         typename L::I& x2) {
  using I = typename L::I;
  const int c = (int)(root >> (2 * (n - 1))) & 3;
  x0 = l2(p, c) + 1;
  x1 = l2(p, 3 - c) + 1;
  x2 = l2(p, c + 1) - l2(p, c);
  for (int i = 1; i < n; ++i) {
    if (x2 == 0) {  // dead: zeros from here on
      x0 = x1 = 0;
      return;
    }
    const int b = (int)(root >> (2 * (n - 1 - i))) & 3;
    I c0[4], c1[4], c2[4];
    extend4(a, p, x0, x1, x2, c0, c1, c2);
    x0 = pick4(b, c0[0], c0[1], c0[2], c0[3]);
    x1 = pick4(b, c1[0], c1[1], c1[2], c1[3]);
    x2 = pick4(b, c2[0], c2[1], c2[2], c2[3]);
  }
}

// Lane 0's first step: the warp's root r, left in the table by
// lut_roots_kernel, into level 0 of the warp's buffer `sh`.
template <class L>
__device__ __forceinline__ void lut_take_root(const void* out, long long r,
                                              int d, void* sh) {
  typename L::I x0, x1, x2;
  L::lut_get(out, r << (2 * d), x0, x1, x2);
  L::lut_store(sh, lut_slot(0), x0, x1, x2);
}

// The rounds of level l: 4^l parents, 32 a round.
__device__ __forceinline__ int lut_rounds(int l) {
  return ((1 << (2 * l)) + 31) / 32;
}

// Lane j's step in round q of level l < d: the four children of parent
// t = 32 q + j (child 4 t + b extends it by base b) into level l + 1, or,
// at the last level, into the staging area at 4 j + b; nothing past the
// level's last parent.
template <class A, class L = typename A::Layout>
__device__ __forceinline__ void lut_level(const A& a,
                                          const FmParams<typename L::I>& p,
                                          int l, int d, int q, int j,
                                          void* sh) {
  using I = typename L::I;
  const int t = 32 * q + j;
  if (t >= (1 << (2 * l))) return;
  I x0, x1, x2;
  L::lut_get(sh, lut_slot(l) + t, x0, x1, x2);
  I c0[4] = {0, 0, 0, 0}, c1[4] = {0, 0, 0, 0}, c2[4] = {0, 0, 0, 0};
  if (x2 != 0) extend4(a, p, x0, x1, x2, c0, c1, c2);
  const int dst = l + 1 == d ? 4 * j : lut_slot(l + 1) + 4 * t;
#pragma unroll
  for (int b = 0; b < 4; ++b) L::lut_store(sh, dst + b, c0[b], c1[b], c2[b]);
}

// Lane j's share of the copy of round q of the last level (entries
// 128 q .. of root r's 4^d) from the staging area into the table, as
// 16-byte vectors, neighbouring lanes on neighbouring vectors (an even
// count of entries, d >= 1, is whole vectors at a whole vector's offset).
// The stores stream (st.global.cs): the table is written once here, and
// should not push the FM table's rows, which the gathers read, out of
// the L2.
template <class L>
__device__ __forceinline__ void lut_copy_out(const void* sh, int d,
                                             long long r, int q, int j,
                                             void* out) {
  const int left = (1 << (2 * d)) - kLutStage * q;
  const int n = (left < kLutStage ? left : kLutStage) * L::kLutBytes / 16;
  const uint4* s = static_cast<const uint4*>(sh);
  uint4* o = static_cast<uint4*>(out) +
             ((r << (2 * d)) + (long long)kLutStage * q) * L::kLutBytes / 16;
  for (int i = j; i < n; i += 32) __stcs(o + i, s[i]);
}

// One thread a root, the (K - d)-mer r, into the table at r << 2 d.
template <class A>
__global__ void __launch_bounds__(kThreads)
lut_roots_kernel(A a, FmParams<typename A::Layout::I> p, int K, int d,
                 void* __restrict__ out) {
  using L = typename A::Layout;
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= (1LL << (2 * (K - d)))) return;
  typename L::I x0, x1, x2;
  lut_root(a, p, r, K - d, x0, x1, x2);
  L::lut_store(out, r << (2 * d), x0, x1, x2);
}

// One warp a root, r = blockIdx.x * kLutWarps + warp: d >= 1 levels below
// it.
template <class A>
__global__ void __launch_bounds__(kThreads)
lut_build_kernel(A a, FmParams<typename A::Layout::I> p, int K, int d,
                 void* __restrict__ out) {
  using L = typename A::Layout;
  constexpr int kVecs = kLutSlots * L::kLutBytes / 16;  // a warp's buffer
  __shared__ uint4 sbuf[kLutWarps * kVecs];
  const int j = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long r = (long long)blockIdx.x * kLutWarps + w;
  if (r >= (1LL << (2 * (K - d)))) return;
  uint4* sh = sbuf + w * kVecs;
  if (j == 0) lut_take_root<L>(out, r, d, sh);
  __syncwarp();
  for (int l = 0; l < d; ++l) {
    for (int q = 0; q < lut_rounds(l); ++q) {
      lut_level(a, p, l, d, q, j, sh);
      __syncwarp();
      if (l + 1 == d) {
        lut_copy_out<L>(sh, d, r, q, j, out);
        __syncwarp();
      }
    }
  }
}

// The forward MEM walks (K8, narrow only, as in dart_tpu; replaces
// fm_jax.py::_mem_walks_kernel): one (read, start) task a thread
// (BWT_Search, bwt_search.cpp:139-170), the interval of the task's first
// base extended by each following base until a base is invalid or N, or
// its extension has width 0. lens counts the bases taken (1 for the
// first); x0 and x2 are the last interval's start and width. A task that
// never starts (first base invalid or N) has length 0 and the interval of
// its clipped first base min(c, 3), as in dart_tpu.
//
// What bounds it: as in the locate, each step is one pair of dependent
// Occ-row loads (the interval's two ends) plus the arithmetic from their
// arrival to the next pair's addresses, and a launch lasts as long as its
// longest walk (a task's walk stops at its first mismatch or its end, so
// up to the task's length); the bytes are few. So the step is built to be
// short:
//
// - the tasks are staged: a block reads its tasks' chars and valid once,
//   as coalesced 16-byte loads across the block, into shared memory as
//   2-bit codes (16 a word, word q of task t at q * kThreads + t, so that
//   a warp's lanes read neighbouring words) plus each task's stop, its
//   first column that is invalid or N. The step then reads no global
//   memory but its two rows, and tests only j < stop and the width; the
//   code of column j does not depend on the chain. Tasks too long for
//   the staging budget (kWalkStageBytes) are read in place, a byte of
//   chars and valid a step, as before;
// - a row is counted for what the step uses alone (walk_step): the base's
//   own count and that of the bases above it, two BWT words a popcount
//   (count_pair's packing), four popcounts a row where extend_rows takes
//   twelve for all four counts; the masks that pick the base come from
//   its code, off the chain;
// - both rows are loaded even when the two ends fall in one Occ row (as
//   they do once the interval is narrow): the second load of that sector
//   costs less than the compare and select that would skip it (0.86-0.99x
//   the time at every task set, chip_smoke.py [redesign]);
// - the primary adjustment is a compare, no branch.
//
// Tasks are taken in the order given, lane i on task i: the seeding path's
// tasks are every start of a read, so a warp's lanes hold neighbouring
// starts whose walks end near one another.
constexpr int kWalkStageBytes = 48 * 1024;  // the default dynamic limit

// A block's staged tasks: words = ceil(Lc / 16) code words a task, then
// kThreads stops.
struct StagedTask {
  const uint32_t* s;
  int t, stop;
  __device__ __forceinline__ int code(int j) const {
    return (int)(s[(j >> 4) * kThreads + t] >> (30 - 2 * (j & 15))) & 3;
  }
  __device__ __forceinline__ bool ok(int j) const { return j < stop; }
};

// A task read in place: its row of chars and valid.
struct InPlaceTask {
  const uint8_t* __restrict__ c;
  const uint8_t* __restrict__ v;
  int Lc;
  __device__ __forceinline__ int code(int j) const {
    return min((int)__ldg(c + j), 3);
  }
  __device__ __forceinline__ bool ok(int j) const {
    return j < Lc && __ldg(v + j) && __ldg(c + j) <= 3;
  }
};

// Staging, first part (thread tid of the block): no code bits yet, every
// stop at Lc.
__device__ __forceinline__ void walks_stage_init(uint32_t* s, int words,
                                                 int Lc, int tid) {
  for (int i = tid; i < words * kThreads; i += kThreads) s[i] = 0;
  s[words * kThreads + tid] = (uint32_t)Lc;
}

// Byte i (0..15, known after unrolling) of a 16-byte vector.
__device__ __forceinline__ int byte_of(const uint4& v, int i) {
  const uint32_t w = i < 4 ? v.x : i < 8 ? v.y : i < 12 ? v.z : v.w;
  return (int)(w >> (8 * (i & 3))) & 255;
}

// The up to 16 bytes at p (fewer when `left` < 16, the rest zero) as a
// vector: one 16-byte load when aligned and whole, else byte by byte.
__device__ __forceinline__ uint4 load16(const uint8_t* p, int left,
                                        bool aligned) {
  if (aligned && left >= 16) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i < left) w[i >> 2] |= (uint32_t)__ldg(p + i) << (8 * (i & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Staging, second part: the block's n tasks are the bytes [0, n Lc) from
// chars and valid (its first task's row), one contiguous range; thread tid
// takes its 16-byte pieces g = 16 tid, 16 (tid + kThreads), ..., whose
// bytes run along a task's columns into the next task's. Each byte's code,
// min(c, 3), is ORed into its task's code word, and a task's first bad
// byte in a piece lowers its stop (shared atomics: a piece may share a
// word or a task with its neighbours).
__device__ __forceinline__ void walks_stage_fill(
    const uint8_t* __restrict__ chars, const uint8_t* __restrict__ valid,
    int Lc, int n, uint32_t* s, int words, int tid) {
  const int nbytes = n * Lc;
  const bool aligned = ((reinterpret_cast<uintptr_t>(chars) |
                         reinterpret_cast<uintptr_t>(valid)) & 15) == 0;
  int* stop = reinterpret_cast<int*>(s + words * kThreads);
  for (int g = 16 * tid; g < nbytes; g += 16 * kThreads) {
    const uint4 cv = load16(chars + g, nbytes - g, aligned);
    const uint4 vv = load16(valid + g, nbytes - g, aligned);
    int t = g / Lc, col = g - t * Lc;
    uint32_t acc = 0;
    bool bad = false;  // this piece already lowered task t's stop
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (g + i >= nbytes) break;
      const int c = byte_of(cv, i);
      if (!bad && (c > 3 || byte_of(vv, i) == 0)) {
        atomicMin(stop + t, col);
        bad = true;
      }
      acc |= (uint32_t)min(c, 3) << (30 - 2 * (col & 15));
      const int q = col >> 4;
      ++col;
      if (col == Lc || (col & 15) == 0 || i == 15 || g + i + 1 == nbytes) {
        atomicOr(s + q * kThreads + t, acc);
        acc = 0;
      }
      if (col == Lc) {
        col = 0;
        ++t;
        bad = false;
      }
    }
  }
}

// Bases among the first lo + 1 (lo = 0 .. 63) of a narrow Occ row's BWT
// words (bw) equal to base b (eq) and above it (gt), two words a popcount:
// each pair packed into a plane of high bits and one of low bits as
// count_pair packs them; (fh, fl) flip the planes where b has a 0 bit, so
// that their AND marks b; gt = (hi & (lo | ga) & gc) | (lo & gb) marks the
// bases above b (b = 0: hi | lo; 1: hi; 2: hi & lo; 3: none).
struct BaseMasks {
  uint32_t fh, fl, ga, gb, gc;
};

__device__ __forceinline__ BaseMasks base_masks(int b) {
  return {b & 2 ? 0u : ~0u, b & 1 ? 0u : ~0u, b <= 1 ? ~0u : 0u,
          b == 0 ? ~0u : 0u, b <= 2 ? ~0u : 0u};
}

__device__ __forceinline__ void row_counts(const uint4& bw, int lo,
                                           const BaseMasks& m, int& eq,
                                           int& gt) {
  constexpr uint32_t kEven = 0x55555555u;
  // the bases up to lo: pair lo / 32 keeps its top 2 (lo % 32 + 1) bits
  const unsigned long long mm = ~0ull << (62 - 2 * (lo & 31));
  const uint32_t part =
      ((uint32_t)(mm >> 32) & kEven) | ((uint32_t)mm & ~kEven);
  const uint32_t k0 = lo < 32 ? part : ~0u, k1 = lo < 32 ? 0u : part;
  const uint32_t h0 = ((bw.x >> 1) & kEven) | (bw.y & ~kEven);
  const uint32_t l0 = (bw.x & kEven) | ((bw.y << 1) & ~kEven);
  const uint32_t h1 = ((bw.z >> 1) & kEven) | (bw.w & ~kEven);
  const uint32_t l1 = (bw.z & kEven) | ((bw.w << 1) & ~kEven);
  eq = __popc((h0 ^ m.fh) & (l0 ^ m.fl) & k0) +
       __popc((h1 ^ m.fh) & (l1 ^ m.fl) & k1);
  gt = __popc(((h0 & (l0 | m.ga) & m.gc) | (l0 & m.gb)) & k0) +
       __popc(((h1 & (l1 | m.ga) & m.gc) | (l1 & m.gb)) & k1);
}

// The Occ row's own counts (its first vector) of base b and of the bases
// above it.
__device__ __forceinline__ void row_occ(const uint4& o, int b,
                                        const BaseMasks& m, uint32_t& eq,
                                        uint32_t& gt) {
  eq = sel4(o, b);
  gt = (o.y & m.gb) + (o.z & m.ga) + (o.w & m.gc);
}

// One extension of the live interval (x0, x1, x2) by the base whose
// complement is b (extend_rows on a narrow table, its result bit for bit),
// from the Occ rows of occ_pos(x1 - 1) and occ_pos(x1 - 1 + x2). False, and
// the interval untouched, when the extended pattern does not occur.
template <class A>
__device__ __forceinline__ bool walk_step(const A& a, const FmParams<int>& p,
                                          int b, const BaseMasks& m,
                                          int l2b, int& x0, int& x1,
                                          int& x2) {
  const int k = occ_pos(p, x1 - 1), l = occ_pos(p, x1 - 1 + x2);
  const size_t rk = (unsigned)k >> Narrow::kOccShift;
  const size_t rl = (unsigned)l >> Narrow::kOccShift;
  uint4 vk[Narrow::kVecs], vl[Narrow::kVecs];
  load_row(a, rk, vk);
  load_row(a, rl, vl);
  const int adj = x1 <= p.primary && x1 + x2 - 1 >= p.primary;
  int ek, gk, el, gl;
  row_counts(vk[1], k & 63, m, ek, gk);
  row_counts(vl[1], l & 63, m, el, gl);
  uint32_t ok, gok, ol, gol;
  row_occ(vk[0], b, m, ok, gok);
  row_occ(vl[0], b, m, ol, gol);
  const int tk = (int)ok + ek;
  const int wi = (int)ol + el - tk;
  if (wi <= 0) return false;
  x0 += adj + (int)(gol - gok) + gl - gk;
  x1 = l2b + tk;
  x2 = wi;
  return true;
}

// One task's walk: (len, x0, x2) as above.
template <class A, class T>
__device__ __forceinline__ void mem_walk(const A& a, const FmParams<int>& p,
                                         const T& task, int& len, int& x0,
                                         int& x2) {
  const int c0 = task.code(0);
  x0 = l2(p, c0) + 1;
  int x1 = l2(p, 3 - c0) + 1;
  x2 = l2(p, c0 + 1) - l2(p, c0);
  len = 0;
  if (!task.ok(0)) return;
  len = 1;
  for (int j = 1; task.ok(j); ++j) {
    // from the code alone, off the chain
    const int b = 3 - task.code(j);
    if (!walk_step(a, p, b, base_masks(b), l2(p, b) + 1, x0, x1, x2)) break;
    ++len;
  }
}

// Thread tid's task of the block whose first task is r0, after staging
// (s, when staged).
template <class A>
__device__ __forceinline__ void mem_walk_task(
    const A& a, const FmParams<int>& p, const uint8_t* __restrict__ chars,
    const uint8_t* __restrict__ valid, int W, int Lc, bool staged,
    const uint32_t* s, int r0, int tid, int* __restrict__ lens,
    int* __restrict__ x0o, int* __restrict__ x2o) {
  const int w = r0 + tid;
  if (w >= W) return;
  int len, x0, x2;
  if (staged) {
    const int words = (Lc + 15) >> 4;
    mem_walk(a, p, StagedTask{s, tid, (int)s[words * kThreads + tid]}, len,
             x0, x2);
  } else {
    mem_walk(a, p,
             InPlaceTask{chars + (size_t)w * Lc, valid + (size_t)w * Lc, Lc},
             len, x0, x2);
  }
  lens[w] = len;
  x0o[w] = x0;
  x2o[w] = x2;
}

template <class A>
__global__ void __launch_bounds__(kThreads)
mem_walks_kernel(A a, FmParams<int> p, const uint8_t* __restrict__ chars,
                 const uint8_t* __restrict__ valid, int W, int Lc,
                 bool staged, int* __restrict__ lens, int* __restrict__ x0o,
                 int* __restrict__ x2o) {
  extern __shared__ uint32_t swalks[];
  const int r0 = blockIdx.x * kThreads;
  if (staged) {
    const int words = (Lc + 15) >> 4;
    walks_stage_init(swalks, words, Lc, threadIdx.x);
    __syncthreads();
    walks_stage_fill(chars + (size_t)r0 * Lc, valid + (size_t)r0 * Lc, Lc,
                     min(kThreads, W - r0), swalks, words, threadIdx.x);
    __syncthreads();
  }
  mem_walk_task(a, p, chars, valid, W, Lc, staged, swalks, r0, threadIdx.x,
                lens, x0o, x2o);
}

template <class A>
int launch_seed_scan(A a, const typename A::Layout::I* params,
                     const void* lut, int lut_k, const void* buf, int R,
                     int words, int S, void* out, void* stream) {
  const int grid = (R + kThreads - 1) / kThreads;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto b = static_cast<const uint32_t*>(buf);
  const auto o = static_cast<typename A::Layout::I*>(out);
  // a block's reads go to shared memory when they fit the default 48 KB
  // (up to ~1,000 bases a read); longer ones are read in place
  const size_t smem = (size_t)kThreads * (words + words / 2 + 1) * 4;
  const bool staged = smem <= 48 * 1024;
  if (lut_k > 0)
    seed_scan_kernel<A, true><<<grid, kThreads, staged ? smem : 0, s>>>(
        a, make_params(params), lut, lut_k, b, R, words, S, staged, o);
  else
    seed_scan_kernel<A, false><<<grid, kThreads, staged ? smem : 0, s>>>(
        a, make_params(params), nullptr, 0, b, R, words, S, staged, o);
  return (int)cudaGetLastError();
}

template <class A, bool kPow2>
void launch_locate_grid(A a, const FmParams<typename A::Layout::I>& p,
                        const void* rows, typename A::Layout::I n,
                        void* out, cudaStream_t s) {
  using I = typename A::Layout::I;
  locate_kernel<A, kPow2><<<(unsigned)((n + kThreads - 1) / kThreads),
                            kThreads, 0, s>>>(
      a, p, sa_grid<I, kPow2>(p.sa_intv), static_cast<const I*>(rows), n,
      static_cast<I*>(out));
}

// The interval's kind is settled here, once a launch.
template <class A>
int launch_locate(A a, const typename A::Layout::I* params, const void* rows,
                  typename A::Layout::I n, void* out, void* stream) {
  const auto p = make_params(params);
  const auto s = static_cast<cudaStream_t>(stream);
  if (is_pow2(p.sa_intv))
    launch_locate_grid<A, true>(a, p, rows, n, out, s);
  else
    launch_locate_grid<A, false>(a, p, rows, n, out, s);
  return (int)cudaGetLastError();
}

// The root pass, then, from K = 2 on, the subtrees: two launches.
template <class A>
int launch_lut_build(A a, const typename A::Layout::I* params, int K,
                     void* out, void* stream) {
  const int d = lut_depth(K);
  const long long roots = 1LL << (2 * (K - d));
  const auto s = static_cast<cudaStream_t>(stream);
  lut_roots_kernel<A><<<(unsigned)((roots + kThreads - 1) / kThreads),
                        kThreads, 0, s>>>(a, make_params(params), K, d, out);
  if (d > 0)
    lut_build_kernel<A><<<(unsigned)((roots + kLutWarps - 1) / kLutWarps),
                          kThreads, 0, s>>>(a, make_params(params), K, d,
                                            out);
  return (int)cudaGetLastError();
}

// A block's tasks go to shared memory when they fit kWalkStageBytes (up
// to 1,520 bases a task); longer ones are read in place.
template <class A>
int launch_mem_walks(A a, const int* params, const void* chars,
                     const void* valid, int W, int Lc, void* lens, void* x0,
                     void* x2, void* stream) {
  const size_t smem = (size_t)((Lc + 15) / 16 + 1) * kThreads * 4;
  const bool staged = smem <= kWalkStageBytes;
  mem_walks_kernel<A><<<(W + kThreads - 1) / kThreads, kThreads,
                        staged ? smem : 0,
                        static_cast<cudaStream_t>(stream)>>>(
      a, make_params(params), static_cast<const uint8_t*>(chars),
      static_cast<const uint8_t*>(valid), W, Lc, staged,
      static_cast<int*>(lens), static_cast<int*>(x0),
      static_cast<int*>(x2));
  return (int)cudaGetLastError();
}

template <class L>
Flat<L> flat(const void* table) {
  return {static_cast<const uint4*>(table)};
}

template <class L>
Sharded<L> sharded(const void* bases, long long rows) {
  return {static_cast<const unsigned long long*>(bases), (unsigned)rows};
}

}  // namespace

// Flat: `table` is the merged table. Sharded: `bases` is the device array
// of the shards' addresses and `rows` the rows of a shard.

extern "C" int dart_fm_seed_scan(const void* table, const int* params,
                                 const void* lut, int lut_k, const void* buf,
                                 int R, int words, int S, void* out,
                                 void* stream) {
  return launch_seed_scan(flat<Narrow>(table), params, lut, lut_k, buf, R,
                          words, S, out, stream);
}

extern "C" int dart_fm_seed_scan_wide(const void* table,
                                      const long long* params,
                                      const void* lut, int lut_k,
                                      const void* buf, int R, int words,
                                      int S, void* out, void* stream) {
  return launch_seed_scan(flat<Wide>(table), params, lut, lut_k, buf, R,
                          words, S, out, stream);
}

extern "C" int dart_fm_locate(const void* table, const int* params,
                              const void* rows, int n, void* out,
                              void* stream) {
  return launch_locate(flat<Narrow>(table), params, rows, n, out, stream);
}

extern "C" int dart_fm_locate_wide(const void* table, const long long* params,
                                   const void* rows, long long n, void* out,
                                   void* stream) {
  return launch_locate(flat<Wide>(table), params, rows, n, out, stream);
}

extern "C" int dart_fm_lut_build(const void* table, const int* params, int K,
                                 void* out, void* stream) {
  return launch_lut_build(flat<Narrow>(table), params, K, out, stream);
}

extern "C" int dart_fm_lut_build_wide(const void* table,
                                      const long long* params, int K,
                                      void* out, void* stream) {
  return launch_lut_build(flat<Wide>(table), params, K, out, stream);
}

extern "C" int dart_fm_mem_walks(const void* table, const int* params,
                                 const void* chars, const void* valid, int W,
                                 int L, void* lens, void* x0, void* x2,
                                 void* stream) {
  return launch_mem_walks(flat<Narrow>(table), params, chars, valid, W, L,
                          lens, x0, x2, stream);
}

extern "C" int dart_fm_seed_scan_sharded(const void* bases, long long rows,
                                         const int* params, const void* lut,
                                         int lut_k, const void* buf, int R,
                                         int words, int S, void* out,
                                         void* stream) {
  return launch_seed_scan(sharded<Narrow>(bases, rows), params, lut, lut_k,
                          buf, R, words, S, out, stream);
}

extern "C" int dart_fm_seed_scan_wide_sharded(
    const void* bases, long long rows, const long long* params,
    const void* lut, int lut_k, const void* buf, int R, int words, int S,
    void* out, void* stream) {
  return launch_seed_scan(sharded<Wide>(bases, rows), params, lut, lut_k,
                          buf, R, words, S, out, stream);
}

extern "C" int dart_fm_locate_sharded(const void* bases, long long rows,
                                      const int* params, const void* rows_in,
                                      int n, void* out, void* stream) {
  return launch_locate(sharded<Narrow>(bases, rows), params, rows_in, n, out,
                       stream);
}

extern "C" int dart_fm_locate_wide_sharded(const void* bases, long long rows,
                                           const long long* params,
                                           const void* rows_in, long long n,
                                           void* out, void* stream) {
  return launch_locate(sharded<Wide>(bases, rows), params, rows_in, n, out,
                       stream);
}

extern "C" int dart_fm_lut_build_sharded(const void* bases, long long rows,
                                         const int* params, int K, void* out,
                                         void* stream) {
  return launch_lut_build(sharded<Narrow>(bases, rows), params, K, out,
                          stream);
}

extern "C" int dart_fm_lut_build_wide_sharded(const void* bases,
                                              long long rows,
                                              const long long* params, int K,
                                              void* out, void* stream) {
  return launch_lut_build(sharded<Wide>(bases, rows), params, K, out, stream);
}

extern "C" int dart_fm_mem_walks_sharded(const void* bases, long long rows,
                                         const int* params, const void* chars,
                                         const void* valid, int W, int L,
                                         void* lens, void* x0, void* x2,
                                         void* stream) {
  return launch_mem_walks(sharded<Narrow>(bases, rows), params, chars, valid,
                          W, L, lens, x0, x2, stream);
}

// Let kernels on card `device` read memory on card `peer`. Returns 0, or the
// CUDA error (cudaErrorPeerAccessUnsupported when the two cannot reach each
// other). The calling thread's current card is left as it was.
extern "C" int dart_enable_peer_access(int device, int peer) {
  int prev = 0, can = 0;
  cudaGetDevice(&prev);
  cudaError_t e = cudaDeviceCanAccessPeer(&can, device, peer);
  if (e == cudaSuccess && !can) e = cudaErrorPeerAccessUnsupported;
  if (e == cudaSuccess) e = cudaSetDevice(device);
  if (e == cudaSuccess) {
    e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();  // not sticky; clear it
      e = cudaSuccess;
    }
  }
  cudaSetDevice(prev);
  return (int)e;
}
