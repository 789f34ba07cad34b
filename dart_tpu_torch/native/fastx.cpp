// FASTA/FASTQ input for io/fastx_fast.py: one pass over a file's bytes
// indexes its records, and one copy loop a chunk writes the chunk's
// sequence, quality and header blobs (the BlobChunk layout the native
// pipeline and the read packer take).
//
// Semantics (those of io/fastx.py and the reference GetData.cpp):
// - lines end at '\n' or at the end of the buffer; '\r' is kept;
// - a header is its line past the leading marker and up to two more
//   '>'/'@', cut at the first space, '/' or tab;
// - FASTQ is four lines a record; the quality is cut to the sequence's
//   length; lines past the last whole record are ignored;
// - FASTA: a record is a '>' line and the lines up to the next one,
//   joined; lines before the first '>' are ignored;
// - the second mate of paired input is reverse-complemented (A/C/G/T
//   in either case to the upper-case complement, any other byte to N)
//   and its quality reversed (GetData.cpp:157-168).
//
// A record's row holds NF int64: its header span [HB, HE), its sequence
// extent [SB, SE) (one line in FASTQ; the lines after the header in
// FASTA, newlines included), SL the sequence's length once joined, and
// its quality span [QB, QE) (empty in FASTA).

#include <algorithm>
#include <cstdint>
#include <cstring>

namespace {

enum { HB, HE, SB, SE, SL, QB, QE, NF };

struct Comp {
  uint8_t t[256];
  Comp() {
    std::memset(t, 'N', sizeof(t));
    const char* a = "ACGTacgt";
    const char* b = "TGCATGCA";
    for (int i = 0; i < 8; ++i) t[(unsigned char)a[i]] = (uint8_t)b[i];
  }
};
const Comp COMP;

// The end of the line that starts at p: its newline, or len.
inline int64_t eol(const uint8_t* buf, int64_t p, int64_t len) {
  if (p >= len) return len;
  const void* q = std::memchr(buf + p, '\n', len - p);
  return q ? static_cast<const uint8_t*>(q) - buf : len;
}

inline void header(const uint8_t* buf, int64_t s, int64_t e, int64_t* row) {
  int64_t b = std::min(s + 1, e);
  for (int k = 0; k < 2 && b < e && (buf[b] == '>' || buf[b] == '@'); ++k)
    ++b;
  int64_t c = b;
  while (c < e && buf[c] != ' ' && buf[c] != '/' && buf[c] != '\t') ++c;
  row[HB] = b;
  row[HE] = c;
}

// Copies buf[b, e) to out without its newlines.
inline void join(const uint8_t* buf, int64_t b, int64_t e, uint8_t* out) {
  while (b < e) {
    const int64_t k = eol(buf, b, e);
    std::memcpy(out, buf + b, k - b);
    out += k - b;
    b = k + 1;
  }
}

// The row of chunk record j: record a + j of one file, or, given a
// second file, mate 1 and mate 2 of pair a + j / 2 in turn.
inline const int64_t* row_of(const int64_t* rows1, const int64_t* rows2,
                             int64_t a, int64_t j, int* which) {
  *which = rows2 ? int(j & 1) : 0;
  const int64_t r = rows2 ? a + j / 2 : a + j;
  return (*which ? rows2 : rows1) + r * NF;
}

}  // namespace

extern "C" {

// The number of records in buf: whole four-line records in FASTQ, '>'
// lines in FASTA.
int64_t dart_fastx_count(const uint8_t* buf, int64_t len, int32_t fastq) {
  int64_t n = 0;
  if (fastq) {
    for (int64_t i = 0; i < len; ++i) n += buf[i] == '\n';
    if (len && buf[len - 1] != '\n') ++n;
    return n / 4;
  }
  for (int64_t p = 0; p < len; p = eol(buf, p, len) + 1) n += buf[p] == '>';
  return n;
}

// Writes the rows (n x NF) of buf's n records, n from dart_fastx_count.
void dart_fastx_index(const uint8_t* buf, int64_t len, int32_t fastq,
                      int64_t n, int64_t* rows) {
  int64_t p = 0;
  if (fastq) {
    for (int64_t i = 0; i < n; ++i) {
      int64_t* row = rows + i * NF;
      int64_t e = eol(buf, p, len);
      header(buf, p, e, row);
      row[SB] = e + 1;
      row[SE] = eol(buf, e + 1, len);
      row[SL] = row[SE] - row[SB];
      row[QB] = eol(buf, row[SE] + 1, len) + 1;  // past the '+' line
      e = eol(buf, row[QB], len);
      row[QE] = std::min(row[QB] + row[SL], e);
      p = e + 1;
    }
    return;
  }
  int64_t* row = nullptr;
  for (int64_t i = 0; p < len; p = eol(buf, p, len) + 1) {
    const int64_t e = eol(buf, p, len);
    if (buf[p] == '>' && i < n) {
      if (row) row[SE] = p;
      row = rows + (i++) * NF;
      header(buf, p, e, row);
      row[SB] = std::min(e + 1, len);
      row[SL] = row[QB] = row[QE] = 0;
    } else if (row) {
      row[SL] += e - p;
    }
  }
  if (row) row[SE] = len;
}

// The offsets (n + 1 each, from 0) of the n records of a chunk in its
// three blobs; rows2 is null for one file (see row_of).
void dart_fastx_offsets(const int64_t* rows1, const int64_t* rows2,
                        int64_t a, int64_t n, int64_t* seq_off,
                        int64_t* qual_off, int64_t* hdr_off) {
  seq_off[0] = qual_off[0] = hdr_off[0] = 0;
  int which;
  for (int64_t j = 0; j < n; ++j) {
    const int64_t* r = row_of(rows1, rows2, a, j, &which);
    seq_off[j + 1] = seq_off[j] + r[SL];
    qual_off[j + 1] = qual_off[j] + (r[QE] - r[QB]);
    hdr_off[j + 1] = hdr_off[j] + (r[HE] - r[HB]);
  }
}

// Fills the chunk's blobs at the offsets of dart_fastx_offsets; with
// revcomp, every odd record of the chunk is a second mate.
void dart_fastx_fill(const uint8_t* buf1, const int64_t* rows1,
                     const uint8_t* buf2, const int64_t* rows2, int64_t a,
                     int64_t n, int32_t revcomp, const int64_t* seq_off,
                     const int64_t* qual_off, const int64_t* hdr_off,
                     uint8_t* seq, uint8_t* qual, uint8_t* hdr) {
  int which;
  for (int64_t j = 0; j < n; ++j) {
    const int64_t* r = row_of(rows1, rows2, a, j, &which);
    const uint8_t* buf = which ? buf2 : buf1;
    std::memcpy(hdr + hdr_off[j], buf + r[HB], r[HE] - r[HB]);
    uint8_t* s = seq + seq_off[j];
    uint8_t* q = qual + qual_off[j];
    const int64_t ql = r[QE] - r[QB];
    join(buf, r[SB], r[SE], s);
    if (revcomp && (j & 1)) {
      std::reverse(s, s + r[SL]);
      for (int64_t k = 0; k < r[SL]; ++k) s[k] = COMP.t[s[k]];
      std::reverse_copy(buf + r[QB], buf + r[QB] + ql, q);
    } else {
      std::memcpy(q, buf + r[QB], ql);
    }
  }
}

}  // extern "C"
