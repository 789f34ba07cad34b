// Batched gap-closing DP for Hopper (sm_90a).
//
// dart_nw_planes replaces dart_tpu/ops/nw_pallas.py::_nw_kernel (launched by
// _nw_batch_device, driven by nw_align_batch): the reference's global
// alignment (nw_alignment.cpp:18-82) of a batch of fragment pairs of up to
// 127 bases a side, returning the traceback choice of every cell; the walk
// back runs on the host (dart_tpu_torch/ops/nw_torch.py::traceback).
//
// Scoring, bit for bit: match +1.5, mismatch -1.5 (equal NT4 codes match,
// N == N included); r = max(r_left - 0.5, s_left - 1.5) and t likewise from
// above, in plain float; s = max(trunc(s_diag +- 1.5), trunc(r), trunc(t)),
// truncated toward zero. The choice is 1 if s == r, else 2 if s == t, else
// 0, against the untruncated r and t. Row 0 holds choice 1 and column 0
// choice 2 (the origin 1); the edges hold -1 - 0.5 d; cells outside the
// pair's (m+1) x (n+1) matrix hold 0. Every value is a multiple of 0.5
// below 2^17 in magnitude, so float32 is exact, FMA contraction included;
// the build does not use --use_fast_math.
//
// Design: one block of 128 threads per pair, thread i owning row i, walking
// the anti-diagonals d = i + j in order with one __syncthreads() each. A
// thread keeps its own row's s and r of the last diagonal in registers and
// reads row i - 1's s (last two diagonals) and t (last one) from rings in
// shared memory (3 and 2 diagonals deep, so one barrier a diagonal is
// enough). Only the cells of the pair's (m+1) x (n+1) matrix are computed:
// each reads only cells of the matrix, so the ring slots of the cells
// outside it may go stale, and a warp whose rows all lie outside the
// matrix on a diagonal only meets the barrier. Side 2's codes sit in shared
// memory and are read at j - 1 directly: the TPU form's reversed, padded
// c2r layout and lane roll were a lane-alignment device. Each thread ORs 8
// diagonals of 2-bit choices into a register and stores it as one int32,
// so neighbouring threads write neighbouring words. The loop stops at
// d = m + n; the planes past it are written as zeros.
//
// What bounds it: every pair's output is the TPU kernel's full 32 x 128
// int32 planes, 16 KB whatever the pair's size (1 GiB for 65,536 pairs,
// ~0.32 ms of HBM writes at 3.35 TB/s), while the pairs the pipeline sends
// are small (at most 24 x 24 on the goldens, 28 x 28 on 2,000 reads of an
// 8 Mbp set). With only the matrix's cells computed, such a batch is bound
// by writing planes (on an H100 at ~3/4 of the HBM write peak); computing
// all 128 rows of every diagonal made it instruction-bound at ~2.7x the
// time. At 127 x 127 (255 diagonals, each behind a barrier) the DP's
// instructions bound it. A compact plane format would cut the writes; the
// TPU layout is kept here so that the two compare word for word.
//
// The C entry launches on the given stream, does not synchronise, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;  // rows of a plane, threads of a block
constexpr int kMaxLen = kLanes - 1;
constexpr int kPlanes = 32;  // 256 diagonals, 8 per int32
constexpr float kExtend = -0.5f;
constexpr float kNew = -1.5f;
constexpr float kOpen = -1.0f;
constexpr float kMaxPen = -65536.0f;
constexpr float kMatch = 1.5f;

// c1, c2: (B, 128) int32 NT4 codes of the two sides, from column 0;
// mn: (B, 2) int32 lengths (clamped to 0..127); planes: (B, 32, 128) int32.
__global__ void __launch_bounds__(kLanes)
nw_kernel(const int* __restrict__ c1, const int* __restrict__ c2,
          const int* __restrict__ mn, int* __restrict__ planes) {
  __shared__ int sc2[kLanes];
  __shared__ float ss[3][kLanes];  // s of row i at diagonal d, slot d % 3
  __shared__ float st[2][kLanes];  // t of row i at diagonal d, slot d % 2
  const int i = threadIdx.x;
  const size_t pair = blockIdx.x;
  const int m = min(max(mn[2 * pair], 0), kMaxLen);
  const int n = min(max(mn[2 * pair + 1], 0), kMaxLen);
  sc2[i] = c2[pair * kLanes + i];
  const int a = i > 0 ? c1[pair * kLanes + i - 1] : 0;  // side 1 at i - 1
  ss[0][i] = ss[1][i] = ss[2][i] = kMaxPen;
  st[0][i] = st[1][i] = kMaxPen;
  float s_p = kMaxPen, r_p = kMaxPen;  // this row, last diagonal
  int* out = planes + pair * (kPlanes * kLanes) + i;
  uint32_t bits = 0;
  const int dmax = m + n;
  __syncthreads();
  for (int d = 0; d <= dmax; ++d) {
    const int j = d - i;
    int choice = 0;
    if (i <= m && j >= 0 && j <= n) {
      // row i - 1 at diagonals d - 1 and d - 2; row 0 reads MAXPEN
      const float s_p_up = i > 0 ? ss[(d + 2) % 3][i - 1] : kMaxPen;
      const float s_pp_up = i > 0 ? ss[(d + 1) % 3][i - 1] : kMaxPen;
      const float t_p_up = i > 0 ? st[(d + 1) & 1][i - 1] : kMaxPen;
      const float r_raw = fmaxf(r_p + kExtend, s_p + kNew);
      const float t_raw = fmaxf(t_p_up + kExtend, s_p_up + kNew);
      const bool hit = j >= 1 && a == sc2[j - 1];
      const float diag = truncf(s_pp_up + (hit ? kMatch : -kMatch));
      const float sv = fmaxf(diag, fmaxf(truncf(r_raw), truncf(t_raw)));
      choice = sv == r_raw ? 1 : (sv == t_raw ? 2 : 0);
      const float edge = d == 0 ? 0.0f : kOpen + (float)d * kExtend;
      const bool top = i == 0, left = i == d;  // cells (0, d) and (d, 0)
      const float s_new = (top || left) ? edge : sv;
      r_p = top ? edge : (left ? kMaxPen : r_raw);
      st[d & 1][i] = left ? edge : (top ? kMaxPen : t_raw);
      ss[d % 3][i] = s_new;
      s_p = s_new;
      if (top)
        choice = 1;
      else if (left)
        choice = 2;
    }
    bits |= (uint32_t)choice << (2 * (d & 7));
    if ((d & 7) == 7) {
      out[(d >> 3) * kLanes] = (int)bits;
      bits = 0;
    }
    __syncthreads();
  }
  if ((dmax & 7) != 7) out[(dmax >> 3) * kLanes] = (int)bits;
  for (int b = (dmax >> 3) + 1; b < kPlanes; ++b) out[b * kLanes] = 0;
}

}  // namespace

extern "C" int dart_nw_planes(const void* c1, const void* c2, const void* mn,
                              int B, void* planes, void* stream) {
  nw_kernel<<<B, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(c1), static_cast<const int*>(c2),
      static_cast<const int*>(mn), static_cast<int*>(planes));
  return (int)cudaGetLastError();
}
