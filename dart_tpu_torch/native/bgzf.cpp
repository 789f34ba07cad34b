// BGZF framing of the BAM output: the full blocks of one write, deflated
// on the -t threads. io/bam.py's _deflate_block is the readable twin and
// still frames the short blocks (flush_boundary, close); every member
// here is byte for byte what it writes: raw deflate (wbits -15, memLevel
// 8, the default strategy) at the writer's level, the BGZF header with
// its BC extra field, then CRC32 and ISIZE.
//
// build.py compiles this file only where zlib's header and library are
// found, so that a machine without them keeps the rest of the library;
// io/bam.py uses it only where zlibVersion() is the runtime version of
// Python's zlib module, whose output the bytes have to equal.

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kBlock = 65280;  // io/bam.py BgzfWriter.MAX_BLOCK
constexpr int64_t kSlot = 65536;   // BgzfWriter.MAX_MEMBER: BSIZE is 16 bits
constexpr int64_t kScratch = 4 * 65536;  // the room member() hands zlib
constexpr int kHeader = 18, kFooter = 8;

void put16(uint8_t* p, uint32_t v) {
  p[0] = (uint8_t)v;
  p[1] = (uint8_t)(v >> 8);
}

void put32(uint8_t* p, uint32_t v) {
  put16(p, v);
  put16(p + 2, v >> 16);
}

// One member for raw[0, kBlock) into out[0, kSlot), deflated in
// scratch[0, kScratch); returns its size, or -1 if zlib failed. The
// deflate calls are those of _deflate_block: compressobj.compress
// (Z_NO_FLUSH) then flush (Z_FINISH), each handed output room as
// CPython hands it, 32 KiB and then 64 KiB blocks; at level 0 the
// stored blocks' lengths follow that room.
int64_t member(z_stream& z, const uint8_t* raw, uint8_t* scratch,
               uint8_t* out) {
  if (deflateReset(&z) != Z_OK) return -1;
  z.next_in = const_cast<Bytef*>(raw);
  z.avail_in = (uInt)kBlock;
  z.next_out = scratch;
  for (int flush : {Z_NO_FLUSH, Z_FINISH}) {
    uInt room = 32768;
    int rc;
    do {
      if (z.next_out + room > scratch + kScratch) return -1;
      z.avail_out = room;
      rc = deflate(&z, flush);
      if (rc != Z_OK && rc != Z_STREAM_END && rc != Z_BUF_ERROR) return -1;
      room = 65536;
    } while (z.avail_out == 0);
    if (flush == Z_FINISH && rc != Z_STREAM_END) return -1;
  }
  const int64_t comp = z.next_out - scratch;
  const int64_t size = kHeader + comp + kFooter;
  if (size > kSlot) return -1;
  static const uint8_t head[16] = {0x1F, 0x8B, 8, 4, 0, 0, 0, 0,
                                   0,    0xFF, 6, 0, 66, 67, 2, 0};
  std::memcpy(out, head, sizeof(head));
  put16(out + 16, (uint32_t)(size - 1));
  std::memcpy(out + kHeader, scratch, (size_t)comp);
  uint8_t* tail = out + kHeader + comp;
  put32(tail, (uint32_t)crc32(crc32(0L, Z_NULL, 0), raw, (uInt)kBlock));
  put32(tail + 4, (uint32_t)kBlock);
  return size;
}

}  // namespace

extern "C" {

const char* dart_bgzf_zlib_version() { return zlibVersion(); }

// src holds n_blocks full blocks of kBlock bytes. Writes their members
// in order into out (out_cap >= n_blocks * kSlot) on up to n_threads
// threads, one block at a time from a shared counter; returns the bytes
// written, -1 if out_cap is too small, -2 if zlib failed.
int64_t dart_bgzf_deflate(const uint8_t* src, int64_t n_blocks, int level,
                          int n_threads, uint8_t* out, int64_t out_cap) {
  if (n_blocks <= 0) return 0;
  if (out_cap < n_blocks * kSlot) return -1;
  std::vector<int64_t> size((size_t)n_blocks, -1);
  std::atomic<int64_t> next{0};
  auto worker = [&]() {
    z_stream z;
    std::memset(&z, 0, sizeof(z));
    if (deflateInit2(&z, level, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY) !=
        Z_OK)
      return;
    std::vector<uint8_t> scratch((size_t)kScratch);
    for (int64_t j; (j = next.fetch_add(1)) < n_blocks;)
      size[(size_t)j] =
          member(z, src + j * kBlock, scratch.data(), out + j * kSlot);
    deflateEnd(&z);
  };
  int64_t nt = std::min<int64_t>(n_threads > 1 ? n_threads : 1, n_blocks);
  unsigned hw = std::thread::hardware_concurrency();
  if (hw && nt > (int64_t)hw) nt = hw;
  std::vector<std::thread> pool;
  for (int64_t t = 1; t < nt; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  // each member sits at the start of its slot: close the gaps in order
  int64_t at = 0;
  for (int64_t j = 0; j < n_blocks; ++j) {
    if (size[(size_t)j] < 0) return -2;
    if (at != j * kSlot)
      std::memmove(out + at, out + j * kSlot, (size_t)size[(size_t)j]);
    at += size[(size_t)j];
  }
  return at;
}

}  // extern "C"
