"""The seed-scan kernel's own source, run on the CPU.

``seed_scan_kernel`` in ``dart_tpu_torch/csrc/fm_kernels.cu`` is device
code, which only ``nvcc`` and a card run. Its arithmetic and control flow
are plain C++ all the same, so here the part of the file above the host
launch functions is compiled with g++ against a header of stand-ins for
the CUDA built-ins it uses (``__ldg``, ``__popc``, ``__clz``,
``__ffsll``, ``uint4``, ``min``/``max``, the thread indices), and each
(block, thread) of a launch runs one after another. The block's reads
are read in place (``staged`` false): staging them in shared memory
needs the block's threads at once. The result is held equal, read for
read, to the plain version (``fm_plain.seed_scan_plain``) on the toy
reads with mismatches, N bases and short reads, and on repeat reads
(the telomeric repeat, a mismatch in its last base, a tandem repeat, a
repeat into unique sequence, an N in the middle) at ``max_dup`` 0, 1 and
100, narrow and wide, with a K-mer table of K = 8 and without; the
plain scan runs once for each index, width and ``max_dup``, without the
table, which gives the same seeds. Reads of 2,000 and 34,000 bases
(narrow, K = 8) take the branch the card takes for reads past ~1,000
bases, which reads them in place, with seeds past read position 32,768.
The card (``chip_smoke.py``, ``tests/test_torch_cuda.py``) holds the
kernel itself to the plain version.
"""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from dart_tpu_torch.index import build_index, load_index
from dart_tpu_torch.ops.fm_torch import FMIndexTorch, pack_codes

from test_torch_scan_schedule import repeat_reads, toy_reads

SOURCE = (pathlib.Path(__file__).resolve().parents[1] / "dart_tpu_torch"
          / "csrc" / "fm_kernels.cu")

SHIM = r"""
#include <stdint.h>
#include <stddef.h>
#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __shared__
struct uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return {a, b, c, d};
}
template <class T> inline T __ldg(const T* p) { return *p; }
template <class T> inline void __stcs(T* p, T v) { *p = v; }
inline int __popc(uint32_t x) { return __builtin_popcount(x); }
inline int __clz(uint32_t x) { return x ? __builtin_clz(x) : 32; }
inline int __ffsll(long long x) { return __builtin_ffsll(x); }
template <class T> inline T min(T a, T b) { return a < b ? a : b; }
template <class T> inline T max(T a, T b) { return a > b ? a : b; }
struct Dim { unsigned x; };
static Dim blockIdx, threadIdx, blockDim;
inline void __syncthreads() {}
inline void __syncwarp() {}
inline unsigned atomicOr(unsigned* a, unsigned v) {
  const unsigned o = *a;
  *a = o | v;
  return o;
}
inline int atomicMin(int* a, int v) {
  const int o = *a;
  if (v < o) *a = v;
  return o;
}
"""

SCAN_LOOP = r"""
template <class L, bool kLut>
void scan_all(const void* table, const typename L::I* params,
              const void* lut, int lut_k, const void* buf, int R, int words,
              int S, void* out) {
  const FmParams<typename L::I> p = make_params(params);
  const Flat<L> a{static_cast<const uint4*>(table)};
  blockDim.x = kThreads;
  for (unsigned b = 0; b < (unsigned)((R + kThreads - 1) / kThreads); ++b)
    for (unsigned t = 0; t < (unsigned)kThreads; ++t) {
      blockIdx.x = b;
      threadIdx.x = t;
      seed_scan_kernel<Flat<L>, kLut>(
          a, p, lut, lut_k, static_cast<const uint32_t*>(buf), R, words, S,
          false, static_cast<typename L::I*>(out));
    }
}
}  // namespace

extern "C" void cpu_seed_scan(const void* table, const void* params,
                              const void* lut, int lut_k, const void* buf,
                              int R, int words, int S, void* out, int wide) {
  if (wide) {
    const auto* q = static_cast<const long long*>(params);
    if (lut_k) scan_all<Wide, true>(table, q, lut, lut_k, buf, R, words, S, out);
    else scan_all<Wide, false>(table, q, lut, 0, buf, R, words, S, out);
  } else {
    const auto* q = static_cast<const int*>(params);
    if (lut_k) scan_all<Narrow, true>(table, q, lut, lut_k, buf, R, words, S, out);
    else scan_all<Narrow, false>(table, q, lut, 0, buf, R, words, S, out);
  }
}
"""


def host_source(text: str, loop: str = SCAN_LOOP) -> str:
    """The kernel file's device part, with the shim and ``loop``, host
    code that calls it (by default the seed scan's)."""
    cut = text.index("template <class A>\nint launch_seed_scan")
    dev = text[:cut]
    for cuda, cpu in (("#include <cuda_runtime.h>", SHIM),
                      ("extern __shared__ uint32_t sreads[];",
                       "uint32_t* sreads = nullptr;"),
                      ("extern __shared__ uint32_t swalks[];",
                       "uint32_t* swalks = nullptr;")):
        assert dev.count(cuda) == 1, cuda
        dev = dev.replace(cuda, cpu)
    return dev + loop


def build_host_lib(tmp_path_factory, name: str, loop: str) -> ctypes.CDLL:
    """``host_source`` with ``loop``, built with g++ into a library of
    its own."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel source for the CPU")
    d = tmp_path_factory.mktemp(name)
    (d / f"{name}.cpp").write_text(host_source(SOURCE.read_text(), loop))
    cc = subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-w",
                         "-o", str(d / f"lib{name}.so"),
                         str(d / f"{name}.cpp")],
                        capture_output=True, text=True)
    assert cc.returncode == 0, cc.stderr
    return ctypes.CDLL(str(d / f"lib{name}.so"))


@pytest.fixture(scope="module")
def scan_lib(tmp_path_factory):
    lib = build_host_lib(tmp_path_factory, "scan", SCAN_LOOP)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cpu_seed_scan.argtypes = [vp, vp, vp, i32, vp, i32, i32, i32, vp,
                                  i32]
    lib.cpu_seed_scan.restype = None
    return lib


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def plain():
    """The plain scans of this module, by (index, width, max_dup)."""
    return {}


def source_scan(lib, plain, idx, codes, rlens, wide, lut_k, max_dup=100):
    """(the kernel source's output, the plain version's) on these reads;
    the plain one is computed once for each index, width, ``max_dup``
    and read shape (the key of ``plain``)."""
    buf, nmask, Lp = pack_codes(codes, rlens)
    words = Lp // 16
    S = FMIndexTorch.seed_slots(Lp, int(rlens.max()))
    host = np.ascontiguousarray(
        np.concatenate([buf[:, :words], nmask, buf[:, words:]], axis=1))
    key = (idx.prefix, wide, max_dup, codes.shape)
    if key not in plain:
        plain[key] = FMIndexTorch(
            idx, "cpu", max_dup_num=max_dup, wide=wide).plain_seed_scan(
                torch.from_numpy(host.view(np.int32)), words, S).numpy()
    want = plain[key]
    eng = FMIndexTorch(idx, "cpu", max_dup_num=max_dup, lut_k=lut_k,
                       wide=wide)
    got = np.zeros_like(want)
    params = np.ascontiguousarray(eng._params)
    table = eng.table.contiguous()
    lut = eng.lut.contiguous() if eng.lut is not None else None
    lib.cpu_seed_scan(table.data_ptr(), params.ctypes.data,
                      lut.data_ptr() if lut is not None else None,
                      eng.lut_k, host.ctypes.data, len(rlens), words, S,
                      got.ctypes.data, int(eng.wide))
    return got, want


@pytest.fixture(scope="module")
def toy(golden_dir):
    return load_index(str(golden_dir / "index" / "toy"))


@pytest.fixture(scope="module")
def repeat_index(tmp_path_factory):
    """The telomeric repeat, then unique sequence from a seed."""
    d = tmp_path_factory.mktemp("srcrep")
    rng = np.random.default_rng(7)
    seq = ("TTAGGG" * 2000)[:12000] + "".join(rng.choice(list("ACGT"),
                                                         12000))
    (d / "rep.fa").write_text(">rep\n" + "\n".join(
        seq[i:i + 70] for i in range(0, len(seq), 70)) + "\n")
    build_index(str(d / "rep.fa"), str(d / "rep"))
    return load_index(str(d / "rep"))


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("lut_k", [0, 8])
def test_kernel_source_equals_plain_on_toy_reads(scan_lib, plain, toy, wide,
                                                 lut_k):
    codes, rlens = toy_reads(toy, n=300, seed=11)
    got, want = source_scan(scan_lib, plain, toy, codes, rlens, wide, lut_k)
    assert (want[:, 0] > 0).sum() > 200  # most reads seed
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("max_dup", [0, 1, 100])
@pytest.mark.parametrize("lut_k", [0, 8])
def test_kernel_source_equals_plain_on_repeat_reads(scan_lib, plain,
                                                    repeat_index, wide,
                                                    max_dup, lut_k):
    got, want = source_scan(scan_lib, plain, repeat_index,
                            *repeat_reads(repeat_index), wide, lut_k,
                            max_dup)
    np.testing.assert_array_equal(got, want)


def long_reads(idx, lens=(2000, 34000), seed=41, rate=0.01):
    """Genome reads of these lengths with ``rate`` substitutions (N
    among them)."""
    rng = np.random.default_rng(seed)
    L = max(lens)
    codes = np.full((len(lens), L), 4, np.uint8)
    for i, n in enumerate(lens):
        p = int(rng.integers(0, idx.seq_len - n))
        read = idx.ref_codes[p:p + n].copy()
        mut = rng.random(n) < rate
        read[mut] = rng.integers(0, 5, int(mut.sum()))
        codes[i, :n] = read
    return codes, np.array(lens, np.int32)


def test_kernel_source_equals_plain_on_long_reads(scan_lib, plain, toy):
    codes, rlens = long_reads(toy)
    got, want = source_scan(scan_lib, plain, toy, codes, rlens, False, 8)
    S = (want.shape[1] - 1) // 4
    assert want[1, 1:1 + S].max() > 32768  # seeds past position 32,768
    assert want[0, 0] > 10 and want[1, 0] > 150
    np.testing.assert_array_equal(got, want)
