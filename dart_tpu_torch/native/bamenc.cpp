// SAM-text -> BAM-record encoding (the BGZF framing is native/bgzf.cpp,
// with io/bam.py as its twin). The
// reference produces BAM by round-tripping SAM through htslib
// (Mapping.cpp:655-663); we encode directly, and this native encoder
// replaces a per-record Python loop that dominated paired-end BAM
// output time (~66 us/record -> ~1 us/record).
//
// Record layout and field semantics mirror io/bam.py BamWriter
// .write_record exactly (that Python path remains the readable twin
// and serves records outside the chunk hot path).

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Tables {
  uint8_t nt16[256];
  int8_t cig[256];
  Tables() {
    std::memset(nt16, 15, sizeof(nt16));
    const char* order = "=ACMGRSVTWYHKDBN";
    for (int i = 0; i < 16; ++i) {
      nt16[(unsigned char)order[i]] = (uint8_t)i;
      nt16[(unsigned char)std::tolower(order[i])] = (uint8_t)i;
    }
    std::memset(cig, -1, sizeof(cig));
    const char* ops = "MIDNSHP=X";
    for (int i = 0; i < 9; ++i) cig[(unsigned char)ops[i]] = (int8_t)i;
  }
};
const Tables T;

int reg2bin(int64_t beg, int64_t end) {
  --end;
  if (beg >> 14 == end >> 14) return (int)(((1 << 15) - 1) / 7 + (beg >> 14));
  if (beg >> 17 == end >> 17) return (int)(((1 << 12) - 1) / 7 + (beg >> 17));
  if (beg >> 20 == end >> 20) return (int)(((1 << 9) - 1) / 7 + (beg >> 20));
  if (beg >> 23 == end >> 23) return (int)(((1 << 6) - 1) / 7 + (beg >> 23));
  if (beg >> 26 == end >> 26) return (int)(((1 << 3) - 1) / 7 + (beg >> 26));
  return 0;
}

struct Out {
  uint8_t* p;
  uint8_t* end;
  void u8(uint8_t v) {
    if (p < end) *p = v;
    ++p;
  }
  void i32(int32_t v) {
    if (p + 4 <= end) std::memcpy(p, &v, 4);
    p += 4;
  }
  void u16(uint16_t v) {
    if (p + 2 <= end) std::memcpy(p, &v, 2);
    p += 2;
  }
  void u32(uint32_t v) {
    if (p + 4 <= end) std::memcpy(p, &v, 4);
    p += 4;
  }
  void bytes(const char* s, size_t n) {
    if (p + n <= end) std::memcpy(p, s, n);
    p += n;
  }
};

// encode one integer tag with the smallest-width value type, mirroring
// io/bam.py _encode_int_tag
void int_tag(Out& o, const char* name, long v) {
  o.bytes(name, 2);
  if (v >= 0 && v <= 0xFF) {
    o.u8('C');
    o.u8((uint8_t)v);
  } else if (v >= -128 && v < 0) {
    o.u8('c');
    o.u8((uint8_t)(int8_t)v);
  } else if (v >= 0 && v <= 0xFFFF) {
    o.u8('S');
    o.u16((uint16_t)v);
  } else if (v >= -32768 && v < 0) {
    o.u8('s');
    o.u16((uint16_t)(int16_t)v);
  } else {
    o.u8('i');
    o.i32((int32_t)v);
  }
}

using Refs = std::unordered_map<std::string, int32_t>;

// ref_names: '\n'-separated reference names in @SQ order
Refs parse_refs(const char* ref_names) {
  Refs refs;
  int32_t id = 0;
  const char* s = ref_names;
  while (*s) {
    const char* e = s;
    while (*e && *e != '\n') ++e;
    refs.emplace(std::string(s, e - s), id++);
    s = *e ? e + 1 : e;
  }
  return refs;
}

// The records of the SAM text [p, send) ('@' lines skipped) into
// [out, out_end); returns the bytes written, or -1 if they do not fit.
int64_t encode(const char* p, const char* send, const Refs& refs,
               uint8_t* out, uint8_t* out_end) {
  Out o{out, out_end};
  std::vector<std::pair<const char*, const char*>> f;
  std::vector<uint32_t> cigbuf;  // reused across records; no op cap
  cigbuf.reserve(4096);
  while (p < send) {
    const char* eol = (const char*)std::memchr(p, '\n', send - p);
    if (!eol) eol = send;
    if (p == eol || *p == '@') {
      p = eol + 1;
      continue;
    }
    f.clear();
    {
      const char* a = p;
      for (const char* c = p; c <= eol; ++c) {
        if (c == eol || *c == '\t') {
          f.emplace_back(a, c);
          a = c + 1;
        }
      }
    }
    if (f.size() < 11) {
      p = eol + 1;
      continue;
    }
    auto sv = [&](int i) { return f[(size_t)i]; };
    auto text = [&](int i) {
      return std::string(sv(i).first, sv(i).second - sv(i).first);
    };
    auto num = [&](int i) { return strtol(sv(i).first, nullptr, 10); };

    long flag = num(1), pos = num(3), mapq = num(4);
    long pnext = num(7), tlen = num(8);
    std::string rname = text(2), rnext = text(6);
    const char* cg = sv(5).first;
    const char* cge = sv(5).second;
    const char* sq = sv(9).first;
    int64_t sqlen = sv(9).second - sv(9).first;
    const char* ql = sv(10).first;
    int64_t qllen = sv(10).second - sv(10).first;
    bool has_seq = !(sqlen == 1 && *sq == '*');
    if (!has_seq) sqlen = 0;

    int32_t ref_id = -1;
    {
      auto it = refs.find(rname);
      if (it != refs.end()) ref_id = it->second;
    }
    // parse cigar
    int64_t ref_len = 0;
    cigbuf.clear();
    if (!(cge - cg == 1 && *cg == '*')) {
      long n = 0;
      for (const char* c = cg; c < cge; ++c) {
        if (*c >= '0' && *c <= '9') {
          n = n * 10 + (*c - '0');
        } else {
          int op = T.cig[(unsigned char)*c];
          if (op < 0) op = 0;
          cigbuf.push_back((uint32_t)((n << 4) | op));
          if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
            ref_len += n;
          n = 0;
        }
      }
    }
    size_t ncig = cigbuf.size();
    if (ref_len == 0) ref_len = 1;
    long p0 = pos - 1;
    int bin = reg2bin(p0 >= 0 ? p0 : 0, p0 >= 0 ? p0 + ref_len : 1);
    int32_t next_ref;
    if (rnext == "=")
      next_ref = ref_id;
    else if (rnext == "*")
      next_ref = -1;
    else {
      auto it = refs.find(rnext);
      next_ref = it != refs.end() ? it->second : -1;
    }
    int64_t name_len = sv(0).second - sv(0).first;

    uint8_t* rec_start = o.p;
    o.i32(0);  // block_size placeholder
    o.i32(ref_id);
    o.i32((int32_t)p0);
    o.u8((uint8_t)(name_len + 1));
    o.u8((uint8_t)mapq);
    o.u16((uint16_t)bin);
    o.u16((uint16_t)ncig);
    o.u16((uint16_t)flag);
    o.i32((int32_t)sqlen);
    o.i32(next_ref);
    o.i32((int32_t)(pnext - 1));
    o.i32((int32_t)tlen);
    o.bytes(sv(0).first, (size_t)name_len);
    o.u8(0);
    for (size_t i = 0; i < ncig; ++i) o.u32(cigbuf[i]);
    if (has_seq) {
      int64_t half = (sqlen + 1) / 2;
      if (o.p + half <= o.end) {
        std::memset(o.p, 0, (size_t)half);
        for (int64_t i = 0; i < sqlen; ++i)
          o.p[i >> 1] |= T.nt16[(unsigned char)sq[i]]
                         << ((i & 1) ? 0 : 4);
      }
      o.p += half;
      if (qllen == 1 && *ql == '*') {
        if (o.p + sqlen <= o.end) std::memset(o.p, 0xFF, (size_t)sqlen);
        o.p += sqlen;
      } else {
        for (int64_t i = 0; i < sqlen && i < qllen; ++i)
          o.u8((uint8_t)((ql[i] - 33) & 0xFF));
      }
    }
    // tags; a field may contain a space-joined trailing XS:A
    // (reference quirk preserved by the SAM writers)
    for (size_t ti = 11; ti < f.size(); ++ti) {
      const char* a = f[ti].first;
      const char* e = f[ti].second;
      while (a < e) {
        const char* sp = a;
        while (sp < e && *sp != ' ') ++sp;
        if (sp - a >= 5 && a[2] == ':' && a[4] == ':') {
          char typ = a[3];
          if (typ == 'i') {
            int_tag(o, a, strtol(a + 5, nullptr, 10));
          } else if (typ == 'A') {
            o.bytes(a, 2);
            o.u8('A');
            o.u8((uint8_t)a[5]);
          } else {
            o.bytes(a, 2);
            o.u8('Z');
            o.bytes(a + 5, (size_t)(sp - a - 5));
            o.u8(0);
          }
        }
        a = sp < e ? sp + 1 : e;
      }
    }
    int32_t bs = (int32_t)(o.p - rec_start - 4);
    if (rec_start + 4 <= o.end) std::memcpy(rec_start, &bs, 4);
    if (o.p > o.end) return -1;
    p = eol + 1;
  }
  return o.p > o.end ? -1 : (int64_t)(o.p - out);
}

}  // namespace

extern "C" {

// sam: SAM text ('@' header lines are skipped). ref_names:
// '\n'-separated reference names in @SQ order. Writes BAM records
// (each prefixed by its int32 block_size) into out. Returns bytes
// written, or -1 if out_cap was too small (caller retries bigger).
int64_t dart_sam_to_bam(const char* sam, int64_t sam_len,
                        const char* ref_names, uint8_t* out,
                        int64_t out_cap) {
  return encode(sam, sam + sam_len, parse_refs(ref_names), out,
                out + out_cap);
}

// dart_sam_to_bam on up to n_threads threads: the text is cut at line
// starts into ranges of about equal bytes, range r is encoded into the
// share of out that its share of the text is, and the ranges' records
// are then closed up in order, so the bytes are dart_sam_to_bam's. -1
// if a range's records do not fit its share (caller retries bigger).
int64_t dart_sam_to_bam_mt(const char* sam, int64_t sam_len,
                           const char* ref_names, uint8_t* out,
                           int64_t out_cap, int n_threads) {
  const Refs refs = parse_refs(ref_names);
  int64_t nt = n_threads > 1 ? n_threads : 1;
  unsigned hw = std::thread::hardware_concurrency();
  if (hw && nt > (int64_t)hw) nt = hw;
  if (nt == 1 || sam_len == 0)
    return encode(sam, sam + sam_len, refs, out, out + out_cap);
  std::vector<int64_t> cut((size_t)nt + 1, sam_len);
  cut[0] = 0;
  for (int64_t r = 1; r < nt; ++r) {
    // the first line start at or past r / nt of the text
    int64_t at = std::max(sam_len * r / nt, cut[(size_t)r - 1]);
    while (at > 0 && at < sam_len && sam[at - 1] != '\n') ++at;
    cut[(size_t)r] = at;
  }
  auto share = [&](int64_t r) { return out_cap * cut[(size_t)r] / sam_len; };
  std::vector<int64_t> n((size_t)nt, -1);
  auto run = [&](int64_t r) {
    n[(size_t)r] = encode(sam + cut[(size_t)r], sam + cut[(size_t)r + 1],
                          refs, out + share(r), out + share(r + 1));
  };
  std::vector<std::thread> pool;
  for (int64_t r = 1; r < nt; ++r) pool.emplace_back(run, r);
  run(0);
  for (auto& th : pool) th.join();
  int64_t at = 0;
  for (int64_t r = 0; r < nt; ++r) {
    if (n[(size_t)r] < 0) return -1;
    if (at != share(r))
      std::memmove(out + at, out + share(r), (size_t)n[(size_t)r]);
    at += n[(size_t)r];
  }
  return at;
}

}  // extern "C"
