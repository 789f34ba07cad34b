// FM-index kernels of the aligner's main path, for Hopper (sm_90a).
//
// dart_fm_seed_scan replaces dart_tpu/ops/fm_jax.py::_seed_scan_kernel
// (plain one-character walk init, locate-and-compare extension on), and
// dart_fm_locate replaces fm_jax.py::_locate_kernel. Both read the merged
// table built by dart_tpu_torch/ops/layout.py: 8 uint32 words per row,
// Occ rows [occA occC occG occT | 64 BWT bases, 16 per word, top first],
// then the 2-bit packed genome from row ref_off, then the SA samples (int32,
// 8 per row) from row sad_off.
//
// What bounds them: each step of a lane is a gather of one 32-byte row
// whose address depends on the previous step. The work per row is a few
// popcounts, so the kernels are bound by the latency of those dependent
// gathers, not by bandwidth: an 8 Mbp genome's table is ~20 MB and sits in
// the 50 MB L2. The design answers latency with parallelism: one thread per
// read (or per row to locate), a plain sequential loop in each thread, 128
// threads a block, so that tens of thousands of independent gathers are in
// flight at once. A row is read as two 16-byte loads. The TPU form's merged
// 2R-row gather, select trees, one-hot reductions and masks for every mode
// are not carried over: a thread simply branches.
//
// Each C entry launches on the given stream, does not synchronise, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// Host params, in this order: L2[0..4], primary, sa_intv, sad_off, ref_off,
// seq_len, max_dup.
struct FmParams {
  int L2[5];
  int primary;
  int sa_intv;
  int sad_off;
  int ref_off;
  int seq_len;
  int max_dup;
};

FmParams make_params(const int* h) {
  FmParams p;
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

__device__ __forceinline__ void load_row(const uint4* __restrict__ t4,
                                         int row, uint4& occ, uint4& w) {
  occ = __ldg(t4 + 2 * (size_t)row);
  w = __ldg(t4 + 2 * (size_t)row + 1);
}

// Bases equal to the pattern's base (pat = base * 0x55555555) among the
// first `take` (1..64) bases of the row's 4 packed words.
__device__ __forceinline__ int count_base(const uint4& w, int take,
                                          uint32_t pat) {
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int tw = min(max(take - 16 * j, 0), 16);
    const uint32_t mask = tw == 0 ? 0u : 0xFFFFFFFFu << (32 - 2 * tw);
    const uint32_t x = sel4(w, j) ^ pat;
    cnt += __popc(~(x | (x >> 1)) & 0x55555555u & mask);
  }
  return cnt;
}

// Occ of all four bases in stored BWT [0, kk] (kk already primary-adjusted).
__device__ __forceinline__ void occ4(const uint4* __restrict__ t4, int kk,
                                     int o[4]) {
  uint4 oc, w;
  load_row(t4, kk >> 6, oc, w);
  const int take = (kk & 63) + 1;
  const int c1 = count_base(w, take, 0x55555555u);
  const int c2 = count_base(w, take, 0xAAAAAAAAu);
  const int c3 = count_base(w, take, 0xFFFFFFFFu);
  o[0] = (int)oc.x + take - c1 - c2 - c3;
  o[1] = (int)oc.y + c1;
  o[2] = (int)oc.z + c2;
  o[3] = (int)oc.w + c3;
}

// One LF step of bwt_sa (bwt_invPsi): the row of the suffix one text
// position earlier. Row `primary` maps to 0.
__device__ __forceinline__ int lf_step(const uint4* __restrict__ t4,
                                       const FmParams& p, int k) {
  if (k == p.primary) return 0;
  const int kk = k - (k > p.primary);
  uint4 oc, w;
  load_row(t4, kk >> 6, oc, w);
  const int c = (sel4(w, (kk >> 4) & 3) >> (2 * (15 - (kk & 15)))) & 3;
  const int occ = (int)sel4(oc, c) +
                  count_base(w, (kk & 63) + 1, (uint32_t)c * 0x55555555u);
  return p.L2[c] + occ;
}

__device__ __forceinline__ int sa_sample(const uint4* __restrict__ t4,
                                         const FmParams& p, int k) {
  const int srow = k / p.sa_intv;
  const int* s = reinterpret_cast<const int*>(t4);
  return __ldg(s + ((size_t)p.sad_off + (srow >> 3)) * 8 + (srow & 7));
}

// SA position of row k: LF-walk to a sampled row, add its sample. A walk
// on a valid table ends within seq_len steps; the bound only keeps a
// corrupt table from spinning a thread forever.
__device__ __forceinline__ int locate_row(const uint4* __restrict__ t4,
                                          const FmParams& p, int k) {
  int steps = 0;
  while (k % p.sa_intv != 0 && steps <= p.seq_len) {
    k = lf_step(t4, p, k);
    ++steps;
  }
  return steps + sa_sample(t4, p, k);
}

__device__ __forceinline__ int base_at(const uint32_t* codes, int i) {
  return (codes[i >> 4] >> (2 * (15 - (i & 15)))) & 3;
}

__device__ __forceinline__ bool is_n(const uint32_t* nmask, int i) {
  return (nmask[i >> 5] >> (31 - (i & 31))) & 1;
}

// Bases of the read from `cur` that equal the genome from `goff`, up to 16,
// capped at the ends of read and genome. N bases never match.
__device__ __forceinline__ int compare16(const uint32_t* __restrict__ ref,
                                         const uint32_t* codes,
                                         const uint32_t* nmask, int words,
                                         int rlen, int seq_len, int cur,
                                         int goff) {
  const int gi = goff >> 4, ga = (goff & 15) * 2;
  uint32_t gw = __ldg(ref + gi);
  if (ga) gw = (gw << ga) | (__ldg(ref + gi + 1) >> (32 - ga));
  const int qi = cur >> 4, qa = (cur & 15) * 2;
  uint32_t rw = codes[qi];
  if (qa) rw = (rw << qa) | ((qi + 1 < words ? codes[qi + 1] : 0u) >> (32 - qa));
  const int ni = cur >> 5, na = cur & 31;
  uint32_t nb = nmask[ni];
  if (na) nb = (nb << na) | ((ni + 1 < words / 2 ? nmask[ni + 1] : 0u) >> (32 - na));
  // the window's 16 N bits, spread to 2 bits per base like the codes
  uint32_t x = nb >> 16;
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  x = (x | (x << 1)) & 0x55555555u;
  const uint32_t v = (gw ^ rw) | x | (x << 1);
  const int m16 = v ? __clz(v) >> 1 : 16;
  const int avail = min(min(16, rlen - cur), seq_len - goff);
  return min(m16, max(avail, 0));
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
// buf row: [codes, 16 per word | N bits, 32 per word | rlen]
// out row: [n | rpos x S | len x S | k0 x S | freq x S]
__global__ void __launch_bounds__(kThreads)
seed_scan_kernel(const uint4* __restrict__ t4, FmParams p,
                 const uint32_t* __restrict__ buf, int R, int words, int S,
                 int* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int stride = words + words / 2 + 1;
  const uint32_t* codes = buf + (size_t)r * stride;
  const uint32_t* nmask = codes + words;
  const int rlen = (int)codes[stride - 1];
  const uint32_t* ref = reinterpret_cast<const uint32_t*>(t4) +
                        (size_t)p.ref_off * 8;
  int* o = out + (size_t)r * (1 + 4 * S);
  for (int s = 1; s <= 4 * S; ++s) o[s] = 0;

  const int end_pos = max(rlen - 13, 0);
  int n = 0;
  int pos = 0;
  while (pos < end_pos) {
    if (is_n(nmask, pos)) {
      ++pos;
      continue;
    }
    const int c = base_at(codes, pos);
    int x0 = p.L2[c] + 1, x1 = p.L2[3 - c] + 1, x2 = p.L2[c + 1] - p.L2[c];
    int cur = pos + 1;
    int length, k0, freq;
    bool acc;
    for (;;) {
      if (x2 == 1 && cur < rlen) {
        const int gbase = locate_row(t4, p, x0) - pos;
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
      if (cur < rlen && !is_n(nmask, cur)) {
        // backward-search extension of the bidirectional interval
        const int ci = 3 - base_at(codes, cur);
        const int q1 = x1 - 1, q2 = x1 - 1 + x2;
        int tk[4], tl[4];
        occ4(t4, max(q1 - (q1 >= p.primary), 0), tk);
        occ4(t4, max(q2 - (q2 >= p.primary), 0), tl);
        const int wi = tl[ci] - tk[ci];
        if (wi > 0) {
          int start = x0 + (x1 <= p.primary && x1 + x2 - 1 >= p.primary);
          for (int b = 3; b > ci; --b) start += tl[b] - tk[b];
          x0 = start;
          x1 = p.L2[ci] + 1 + tk[ci];
          x2 = wi;
          ++cur;
          continue;
        }
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

__global__ void __launch_bounds__(kThreads)
locate_kernel(const uint4* __restrict__ t4, FmParams p,
              const int* __restrict__ rows, int n, int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = locate_row(t4, p, rows[i]);
}

}  // namespace

extern "C" int dart_fm_seed_scan(const void* table, const int* params,
                                 const void* buf, int R, int words, int S,
                                 void* out, void* stream) {
  seed_scan_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(table), make_params(params),
      static_cast<const uint32_t*>(buf), R, words, S, static_cast<int*>(out));
  return (int)cudaGetLastError();
}

extern "C" int dart_fm_locate(const void* table, const int* params,
                              const void* rows, int n, void* out,
                              void* stream) {
  locate_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(table), make_params(params),
      static_cast<const int*>(rows), n, static_cast<int*>(out));
  return (int)cudaGetLastError();
}
