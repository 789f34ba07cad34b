// Host-side hot helpers for the dart_tpu pipeline.
//
// dart_nw: global alignment with the exact scoring semantics of the
// reference gap-closing DP (Dart's src/nw_alignment.cpp:18-82):
// match +1.5 / mismatch -1.5, gap open -1, extend -0.5, new-gap -1.5.
// Overload-resolution quirk (verified against the compiled reference):
// the r/t updates resolve to std::max<float> (exact float max, no
// truncation) because structure.h brings std::max into scope, while
// the 3-argument s update uses the custom max(short, short, short)
// (nw_alignment.cpp:13-16), so each of its arguments is truncated
// toward zero before comparison and the stored s value is an integer.
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// A..T -> 0..3, N -> 4, '-' -> 5 (bntseq.c:40-57 semantics)
static uint8_t NT4[256];
static bool nt4_init_done = false;
static void nt4_init() {
  if (nt4_init_done) return;
  for (int i = 0; i < 256; ++i) NT4[i] = 4;
  const char* b = "ACGT";
  for (int i = 0; i < 4; ++i) {
    NT4[(uint8_t)b[i]] = (uint8_t)i;
    NT4[(uint8_t)(b[i] + 32)] = (uint8_t)i;
  }
  NT4[(uint8_t)'-'] = 5;
  nt4_init_done = true;
}

constexpr float MAXPEN = -65536.0f;
constexpr float OPEN_GAP = -1.0f;
constexpr float EXTEND_GAP = -0.5f;
constexpr float NEW_GAP = -1.5f;

thread_local std::vector<float> g_r, g_t, g_s;

}  // namespace

extern "C" {

// Align s1 (len m) vs s2 (len n); write aligned strings (with '-')
// into out1/out2 (caller buffers of size >= m+n). Returns aligned length.
int64_t dart_nw(const char* s1, int64_t m, const char* s2, int64_t n,
                char* out1, char* out2) {
  nt4_init();
  const int64_t M = m + 1, N = n + 1;
  g_r.resize((size_t)(M * N));
  g_t.resize((size_t)(M * N));
  g_s.resize((size_t)(M * N));
  float* r = g_r.data();
  float* t = g_t.data();
  float* s = g_s.data();
#define AT(a, i, j) a[(size_t)(i)*N + (j)]

  AT(r, 0, 0) = AT(t, 0, 0) = AT(s, 0, 0) = 0.0f;
  for (int64_t i = 1; i < M; ++i) {
    AT(r, i, 0) = MAXPEN;
    AT(s, i, 0) = AT(t, i, 0) = OPEN_GAP + i * EXTEND_GAP;
  }
  for (int64_t j = 1; j < N; ++j) {
    AT(t, 0, j) = MAXPEN;
    AT(s, 0, j) = AT(r, 0, j) = OPEN_GAP + j * EXTEND_GAP;
  }
  for (int64_t i = 1; i < M; ++i) {
    const uint8_t c1 = NT4[(uint8_t)s1[i - 1]];
    for (int64_t j = 1; j < N; ++j) {
      // r/t: plain float max (std::max<float> in the reference)
      float a = AT(r, i, j - 1) + EXTEND_GAP;
      float b = AT(s, i, j - 1) + NEW_GAP;
      float rv = a > b ? a : b;
      AT(r, i, j) = rv;
      a = AT(t, i - 1, j) + EXTEND_GAP;
      b = AT(s, i - 1, j) + NEW_GAP;
      float tv = a > b ? a : b;
      AT(t, i, j) = tv;
      // s: custom max(short,short,short) — args truncated toward zero
      int32_t diag = (int32_t)(AT(s, i - 1, j - 1) +
                               (c1 == NT4[(uint8_t)s2[j - 1]] ? 1.5f : -1.5f));
      int32_t rs = (int32_t)rv;
      int32_t ts = (int32_t)tv;
      int32_t sv = diag > rs ? diag : rs;
      if (ts > sv) sv = ts;
      AT(s, i, j) = (float)sv;
    }
  }

  // Traceback (nw_alignment.cpp:61-74 rule order: r first, then t).
  int64_t i = m, j = n, k = 0;
  char* b1 = out1;
  char* b2 = out2;
  while (i > 0 || j > 0) {
    float sv = AT(s, i, j);
    if (sv == AT(r, i, j)) {
      b1[k] = '-';
      b2[k] = s2[j - 1];
      --j;
    } else if (sv == AT(t, i, j)) {
      b1[k] = s1[i - 1];
      b2[k] = '-';
      --i;
    } else {
      b1[k] = s1[i - 1];
      b2[k] = s2[j - 1];
      --i;
      --j;
    }
    ++k;
  }
  // reverse in place
  for (int64_t a2 = 0, b3 = k - 1; a2 < b3; ++a2, --b3) {
    char tmp = b1[a2]; b1[a2] = b1[b3]; b1[b3] = tmp;
    tmp = b2[a2]; b2[a2] = b2[b3]; b2[b3] = tmp;
  }
  return k;
#undef AT
}

}  // extern "C"
