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
// wide. lut_build_kernel walks one K-mer per thread with the extension
// step the seed scan uses, in one launch; a walk from a given prefix is
// deterministic, so this gives the TPU form's level-by-level table. With a
// LUT, the seed scan starts each walk K bases in.
//
// What bounds them: each step of a lane is a gather of one table row whose
// address depends on the previous step. The work per row is a few
// popcounts, so the kernels are bound by the latency of those dependent
// gathers, not by bandwidth: an 8 Mbp genome's table is ~20 MB and sits in
// the 50 MB L2; a 50 Mbp one (125 MB) and GRCh38's do not, and there each
// step costs a DRAM round trip, which the LUT saves K - 1 times a walk. The
// design answers latency with parallelism: one thread per read (or per row
// to locate, per K-mer, per MEM-walk task), a plain sequential loop in
// each thread, 128 threads a block, so that tens of thousands of
// independent gathers are in flight at once. A row is read as 16-byte loads (two narrow, four wide).
// The TPU form's merged 2R-row gather, select trees, one-hot reductions and
// masks for every mode are not carried over: a thread simply branches.
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

__device__ __forceinline__ uint32_t sel4(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

struct Narrow {
  using I = int;
  static constexpr int kVecs = 2;  // 16-byte vectors per table row (4 words
                                   // each); a genome row is 16 * 4 * kVecs bases
  static constexpr int kOccShift = 6;  // log2 of the BWT bases per Occ row

  // Occ of base c at the row start
  __device__ static int occ(const uint4* v, int c) { return (int)sel4(v[0], c); }

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

  __device__ static void lut_store(void* lut, long long key, int x0, int x1,
                                   int x2) {
    static_cast<uint4*>(lut)[key] =
        make_uint4((uint32_t)x0, (uint32_t)x1, (uint32_t)x2, 0u);
  }
};

struct Wide {
  using I = long long;
  static constexpr int kVecs = 4;
  static constexpr int kOccShift = 7;

  __device__ static long long occ(const uint4* v, int c) {
    return (long long)sel4(v[0], c) | ((long long)sel4(v[1], c) << 32);
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

  __device__ static void lut_store(void* lut, long long key, long long x0,
                                   long long x1, long long x2) {
    long long* e = static_cast<long long*>(lut) + 3 * key;
    e[0] = x0;
    e[1] = x1;
    e[2] = x2;
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

  // The genome's 32-bit words (16 bases each), from row ref_off on.
  struct Genome {
    const uint32_t* __restrict__ ref;
    __device__ __forceinline__ uint32_t operator[](long long i) const {
      return __ldg(ref + i);
    }
  };
  __device__ __forceinline__ Genome genome(size_t ref_off) const {
    return {row_words(ref_off)};
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

  // Each word is routed on its own: word i and i + 1 may be in two shards.
  struct Genome {
    const unsigned long long* __restrict__ base;
    unsigned rows;
    size_t first;  // the table word where the genome starts
    __device__ __forceinline__ uint32_t operator[](long long i) const {
      constexpr unsigned kWords = 4 * L::kVecs;  // words a row
      const size_t w = first + (size_t)i;
      return __ldg(reinterpret_cast<const uint32_t*>(
                       shard_row<L>(base, rows, w / kWords)) +
                   (w % kWords));
    }
  };
  __device__ __forceinline__ Genome genome(size_t ref_off) const {
    return {base, rows, ref_off * 4 * L::kVecs};
  }
};

template <class A>
__device__ __forceinline__ void load_row(
    const A& a, typename A::Layout::I row,
    uint4 (&v)[A::Layout::kVecs]) {
  const uint4* r = a.row((size_t)row);
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
    return (j & 4) ? sel4(v[3], j & 3) : sel4(v[2], j & 3);
  }
}

// Bases equal to the pattern's base (pat = base * 0x55555555) among the
// first `take` (1..64 narrow, 1..128 wide) bases of the row's BWT words.
template <class L>
__device__ __forceinline__ int count_base(const uint4 (&v)[L::kVecs],
                                          int take, uint32_t pat) {
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < 2 * L::kVecs; ++j) {
    const int tw = min(max(take - 16 * j, 0), 16);
    const uint32_t mask = tw == 0 ? 0u : 0xFFFFFFFFu << (32 - 2 * tw);
    const uint32_t x = sel4(v[L::kVecs / 2 + (j >> 2)], j & 3) ^ pat;
    cnt += __popc(~(x | (x >> 1)) & 0x55555555u & mask);
  }
  return cnt;
}

// Occ of all four bases in stored BWT [0, kk] (kk already primary-adjusted).
template <class A, class L = typename A::Layout>
__device__ __forceinline__ void occ4(const A& a, typename L::I kk,
                                     typename L::I o[4]) {
  uint4 v[L::kVecs];
  load_row(a, kk >> L::kOccShift, v);
  const int take = (int)(kk & ((1 << L::kOccShift) - 1)) + 1;
  const int c1 = count_base<L>(v, take, 0x55555555u);
  const int c2 = count_base<L>(v, take, 0xAAAAAAAAu);
  const int c3 = count_base<L>(v, take, 0xFFFFFFFFu);
  o[0] = L::occ(v, 0) + take - c1 - c2 - c3;
  o[1] = L::occ(v, 1) + c1;
  o[2] = L::occ(v, 2) + c2;
  o[3] = L::occ(v, 3) + c3;
}

// One backward-search extension (BWT_Search) of the bidirectional interval
// (x0, x1, x2) by the base whose complement is ci. False, and the interval
// untouched, when the extended pattern does not occur.
template <class A, class L = typename A::Layout>
__device__ __forceinline__ bool extend(const A& a,
                                       const FmParams<typename L::I>& p,
                                       int ci, typename L::I& x0,
                                       typename L::I& x1, typename L::I& x2) {
  using I = typename L::I;
  const I q1 = x1 - 1, q2 = x1 - 1 + x2;
  I tk[4], tl[4];
  occ4(a, max(q1 - (q1 >= p.primary), (I)0), tk);
  occ4(a, max(q2 - (q2 >= p.primary), (I)0), tl);
  const I wi = tl[ci] - tk[ci];
  if (wi <= 0) return false;
  I start = x0 + (x1 <= p.primary && x1 + x2 - 1 >= p.primary);
  for (int b = 3; b > ci; --b) start += tl[b] - tk[b];
  x0 = start;
  x1 = p.L2[ci] + 1 + tk[ci];
  x2 = wi;
  return true;
}

// k % sa_intv and k / sa_intv; the wide kernels shift and mask when the
// interval is a power of two (64-bit division is a long software routine).
template <class I>
__device__ __forceinline__ I sa_rem(const FmParams<I>& p, I k) {
  if (sizeof(I) == 8 && (p.sa_intv & (p.sa_intv - 1)) == 0)
    return k & (p.sa_intv - 1);
  return k % p.sa_intv;
}

template <class I>
__device__ __forceinline__ I sa_div(const FmParams<I>& p, I k) {
  if (sizeof(I) == 8 && (p.sa_intv & (p.sa_intv - 1)) == 0)
    return k >> (__ffsll((long long)p.sa_intv) - 1);
  return k / p.sa_intv;
}

// One LF step of bwt_sa (bwt_invPsi): the row of the suffix one text
// position earlier. Row `primary` maps to 0.
template <class A, class L = typename A::Layout>
__device__ __forceinline__ typename L::I lf_step(
    const A& a, const FmParams<typename L::I>& p, typename L::I k) {
  using I = typename L::I;
  if (k == p.primary) return 0;
  const I kk = k - (k > p.primary);
  uint4 v[L::kVecs];
  load_row(a, kk >> L::kOccShift, v);
  const int lo = (int)(kk & ((1 << L::kOccShift) - 1));
  const int c = (bwt_word<L>(v, lo >> 4) >> (2 * (15 - (lo & 15)))) & 3;
  const I occ = L::occ(v, c) + count_base<L>(v, lo + 1,
                                              (uint32_t)c * 0x55555555u);
  return p.L2[c] + occ;
}

template <class A, class L = typename A::Layout>
__device__ __forceinline__ typename L::I sa_sample(
    const A& a, const FmParams<typename L::I>& p, typename L::I k) {
  return L::sample(a, p.sad_off, sa_div(p, k));
}

// SA position of row k: LF-walk to a sampled row, add its sample. A walk
// on a valid table ends within seq_len steps; the bound only keeps a
// corrupt table from spinning a thread forever.
template <class A, class L = typename A::Layout>
__device__ __forceinline__ typename L::I locate_row(
    const A& a, const FmParams<typename L::I>& p, typename L::I k) {
  typename L::I steps = 0;
  while (sa_rem(p, k) != 0 && steps <= p.seq_len) {
    k = lf_step(a, p, k);
    ++steps;
  }
  return steps + sa_sample(a, p, k);
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

// Bases of the read from `cur` that equal the genome from `goff`, up to 16,
// capped at the ends of read and genome. N bases never match.
template <class G, class I>
__device__ __forceinline__ int compare16(const G& ref, const uint32_t* codes,
                                         const uint32_t* nmask, int words,
                                         int rlen, I seq_len, int cur,
                                         I goff) {
  const I gi = goff >> 4;
  const int ga = (int)(goff & 15) * 2;
  uint32_t gw = ref[gi];
  if (ga) gw = (gw << ga) | (ref[gi + 1] >> (32 - ga));
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

// The reference seeding scan (IdentifySeedPairs, AlignmentCandidates.cpp):
// from each scan position take the forward maximal exact match; accept it
// when its length is >= 16 and it occurs <= max_dup times, then jump past
// it, else advance by one. The scan stops at rlen - 13. A match whose
// interval narrows to one occurrence leaves backward search: the thread
// locates that occurrence and finishes the match by comparing the read
// with the genome, 16 bases at a time; such a seed has freq -1 and its
// genome position in k0.
//
// With the LUT (kLut), a walk starts from the table entry of the K-mer at
// pos, K bases in; an entry that is dead, or a K-mer window holding an N
// or running past the read, advances pos by one: that walk would have died
// before K < 16 bases, a rejected seed.
//
// buf row: [codes, 16 per word | N bits, 32 per word | rlen]
// out row: [n | rpos x S | len x S | k0 x S | freq x S], int narrow,
// long long wide
template <class A, bool kLut>
__global__ void __launch_bounds__(kThreads)
seed_scan_kernel(A a, FmParams<typename A::Layout::I> p,
                 const void* __restrict__ lut, int lut_k,
                 const uint32_t* __restrict__ buf, int R, int words, int S,
                 typename A::Layout::I* __restrict__ out) {
  using L = typename A::Layout;
  using I = typename L::I;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int stride = words + words / 2 + 1;
  const uint32_t* codes = buf + (size_t)r * stride;
  const uint32_t* nmask = codes + words;
  const int rlen = (int)codes[stride - 1];
  const auto ref = a.genome((size_t)p.ref_off);
  I* o = out + (size_t)r * (1 + 4 * S);
  for (int s = 1; s <= 4 * S; ++s) o[s] = 0;

  const int end_pos = max(rlen - 13, 0);
  int n = 0;
  int pos = 0;
  while (pos < end_pos) {
    I x0, x1, x2;
    int cur;
    if (kLut) {
      x2 = 0;
      if ((n_window(nmask, words / 2, pos) >> (32 - lut_k)) == 0 &&
          pos + lut_k <= rlen)
        L::lut_load(lut, code_window(codes, words, pos) >> (32 - 2 * lut_k),
                    x0, x1, x2);
      if (x2 == 0) {
        ++pos;
        continue;
      }
      cur = pos + lut_k;
    } else {
      if (is_n(nmask, pos)) {
        ++pos;
        continue;
      }
      const int c = base_at(codes, pos);
      x0 = p.L2[c] + 1;
      x1 = p.L2[3 - c] + 1;
      x2 = p.L2[c + 1] - p.L2[c];
      cur = pos + 1;
    }
    int length;
    I k0, freq;
    bool acc;
    for (;;) {
      if (x2 == 1 && cur < rlen) {
        const I gbase = locate_row(a, p, x0) - pos;
        int m;
        do {
          m = compare16(ref, codes, nmask, words, rlen, p.seq_len, cur,
                        gbase + cur);
          cur += m;
        } while (m == 16 && cur < rlen && gbase + cur < p.seq_len);
        length = cur - pos;
        acc = length >= 16;
        k0 = gbase + pos;
        freq = -1;
        break;
      }
      if (cur < rlen && !is_n(nmask, cur) &&
          extend(a, p, 3 - base_at(codes, cur), x0, x1, x2)) {
        ++cur;
        continue;
      }
      length = cur - pos;
      acc = x2 <= p.max_dup && length >= 16;
      k0 = x0;
      freq = x2;
      break;
    }
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
  }
  o[0] = n;
}

template <class A>
__global__ void __launch_bounds__(kThreads)
locate_kernel(A a, FmParams<typename A::Layout::I> p,
              const typename A::Layout::I* __restrict__ rows,
              typename A::Layout::I n,
              typename A::Layout::I* __restrict__ out) {
  using I = typename A::Layout::I;
  const I i = (I)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = locate_row(a, p, rows[i]);
}

// One thread per K-mer (key = base-4, first base most significant): the
// walk from its first base, extended by each following base.
template <class A>
__global__ void __launch_bounds__(kThreads)
lut_build_kernel(A a, FmParams<typename A::Layout::I> p, int K,
                 void* __restrict__ out) {
  using L = typename A::Layout;
  using I = typename L::I;
  const long long key = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (key >= (1LL << (2 * K))) return;
  const int c = (int)(key >> (2 * (K - 1))) & 3;
  I x0 = p.L2[c] + 1, x1 = p.L2[3 - c] + 1, x2 = p.L2[c + 1] - p.L2[c];
  for (int i = 1; i < K; ++i) {
    const int b = (int)(key >> (2 * (K - 1 - i))) & 3;
    if (x2 == 0 || !extend(a, p, 3 - b, x0, x1, x2)) {
      x0 = x1 = x2 = 0;
      break;
    }
  }
  L::lut_store(out, key, x0, x1, x2);
}

// The forward MEM walk of one (read, start) task per thread (BWT_Search,
// bwt_search.cpp:139-170): the interval of the task's first base, extended
// by each following base with the seed scan's own step, until a base is
// invalid or N, or its extension has width 0. lens counts the bases taken
// (1 for the first); x0 and x2 are the last interval's start and width. A
// task that never starts (first base invalid or N) has length 0 and the
// interval of its clipped first base min(c, 3), as in dart_tpu.
//
// Memory: each thread reads its own row of chars and valid, one byte a
// step, so a warp's loads are 32 rows apart and not coalesced. The rows
// are short and cached, and the table gathers still bound the walk; a
// transposed (L, W) input, as dart_tpu's scan over chars.T has, is the
// obvious later fix.
template <class A>
__global__ void __launch_bounds__(kThreads)
mem_walks_kernel(A a, FmParams<typename A::Layout::I> p,
                 const uint8_t* __restrict__ chars,
                 const uint8_t* __restrict__ valid, int W, int Lc,
                 int* __restrict__ lens,
                 typename A::Layout::I* __restrict__ x0o,
                 typename A::Layout::I* __restrict__ x2o) {
  using L = typename A::Layout;
  using I = typename L::I;
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  const uint8_t* c = chars + (size_t)w * Lc;
  const uint8_t* v = valid + (size_t)w * Lc;
  const int c0 = min((int)c[0], 3);
  I x0 = p.L2[c0] + 1, x1 = p.L2[3 - c0] + 1, x2 = p.L2[c0 + 1] - p.L2[c0];
  int len = 0;
  if (v[0] && c[0] <= 3) {
    len = 1;
    for (int j = 1; j < Lc; ++j) {
      const int ch = c[j];
      if (!v[j] || ch > 3 || !extend(a, p, 3 - ch, x0, x1, x2)) break;
      ++len;
    }
  }
  lens[w] = len;
  x0o[w] = x0;
  x2o[w] = x2;
}

template <class A>
int launch_seed_scan(A a, const typename A::Layout::I* params,
                     const void* lut, int lut_k, const void* buf, int R,
                     int words, int S, void* out, void* stream) {
  const int grid = (R + kThreads - 1) / kThreads;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto b = static_cast<const uint32_t*>(buf);
  const auto o = static_cast<typename A::Layout::I*>(out);
  if (lut_k > 0)
    seed_scan_kernel<A, true><<<grid, kThreads, 0, s>>>(
        a, make_params(params), lut, lut_k, b, R, words, S, o);
  else
    seed_scan_kernel<A, false><<<grid, kThreads, 0, s>>>(
        a, make_params(params), nullptr, 0, b, R, words, S, o);
  return (int)cudaGetLastError();
}

template <class A>
int launch_locate(A a, const typename A::Layout::I* params, const void* rows,
                  typename A::Layout::I n, void* out, void* stream) {
  using I = typename A::Layout::I;
  locate_kernel<A><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      a, make_params(params), static_cast<const I*>(rows), n,
      static_cast<I*>(out));
  return (int)cudaGetLastError();
}

template <class A>
int launch_lut_build(A a, const typename A::Layout::I* params, int K,
                     void* out, void* stream) {
  const long long n = 1LL << (2 * K);
  lut_build_kernel<A><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads,
                        0, static_cast<cudaStream_t>(stream)>>>(
      a, make_params(params), K, out);
  return (int)cudaGetLastError();
}

template <class A>
int launch_mem_walks(A a, const typename A::Layout::I* params,
                     const void* chars, const void* valid, int W, int Lc,
                     void* lens, void* x0, void* x2, void* stream) {
  using I = typename A::Layout::I;
  mem_walks_kernel<A><<<(W + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      a, make_params(params), static_cast<const uint8_t*>(chars),
      static_cast<const uint8_t*>(valid), W, Lc, static_cast<int*>(lens),
      static_cast<I*>(x0), static_cast<I*>(x2));
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
