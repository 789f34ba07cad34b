"""The MEM-walk kernel's own source, run on the CPU.

``mem_walks_kernel`` in ``dart_tpu_torch/csrc/fm_kernels.cu`` (K8) is
compiled with g++ through the shim of ``test_torch_scan_source.py``. The
shim runs threads one after another, so a block's staging, which needs
the whole block at once, runs as the kernel's own parts: every thread's
``walks_stage_init``, then every thread's ``walks_stage_fill``, then every
thread's ``mem_walk_task``; the in-place branch calls ``mem_walk_task``
alone. Both branches run on every case, on one table (``Flat``) and on
the table cut into two range shards in host memory (``Sharded``), and
are held equal, task for task, to the plain version
(``fm_plain.mem_walks_plain``) and to ``FMIndexJax.mem_walks``, on the
tasks of ``test_torch_memwalks.walk_tasks`` (N bases, invalid tails,
tasks that never start) at L = 64 (W = 1,500), L = 1, L = 33 (odd) and
W = 257 (not a whole block), and with chars and valid one byte off a
16-byte boundary (the byte-wise staging loads). The card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``) holds the kernel itself
to the plain version.
"""

import ctypes

import numpy as np
import pytest
import torch

from dart_tpu.ops.fm_jax import FMIndexJax
from dart_tpu_torch.ops.fm_torch import FMIndexTorch

from test_torch_memwalks import walk_tasks
from test_torch_scan_source import build_host_lib

WALKS_LOOP = r"""
template <class A>
void walks_all(const A& a, const int* params, const uint8_t* chars,
               const uint8_t* valid, int W, int Lc, bool staged, int* lens,
               int* x0, int* x2) {
  const FmParams<int> p = make_params(params);
  const int words = (Lc + 15) >> 4;
  uint32_t* s = new uint32_t[(size_t)(words + 1) * kThreads]();
  for (int r0 = 0; r0 < W; r0 += kThreads) {
    if (staged) {
      for (int t = 0; t < kThreads; ++t) walks_stage_init(s, words, Lc, t);
      for (int t = 0; t < kThreads; ++t)
        walks_stage_fill(chars + (size_t)r0 * Lc, valid + (size_t)r0 * Lc,
                         Lc, min(kThreads, W - r0), s, words, t);
    }
    for (int t = 0; t < kThreads; ++t)
      mem_walk_task(a, p, chars, valid, W, Lc, staged, s, r0, t, lens, x0,
                    x2);
  }
  delete[] s;
}
}  // namespace

// bases: null for one table at `table`, else the shards' addresses (rows
// rows each)
extern "C" void cpu_mem_walks(const void* table, const void* bases,
                              long long rows, const int* params,
                              const uint8_t* chars, const uint8_t* valid,
                              int W, int Lc, int staged, int* lens, int* x0,
                              int* x2) {
  if (bases)
    walks_all(Sharded<Narrow>{static_cast<const unsigned long long*>(bases),
                              (unsigned)rows},
              params, chars, valid, W, Lc, staged, lens, x0, x2);
  else
    walks_all(Flat<Narrow>{static_cast<const uint4*>(table)}, params, chars,
              valid, W, Lc, staged, lens, x0, x2);
}
"""

# name -> (seed, W, L)
CASES = {"l64": (11, 1500, 64), "l1": (21, 300, 1), "l33": (22, 300, 33),
         "w257": (23, 257, 64)}


@pytest.fixture(scope="module")
def walks_lib(tmp_path_factory):
    lib = build_host_lib(tmp_path_factory, "walks", WALKS_LOOP)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.cpu_mem_walks.argtypes = [vp, vp, i64, vp, vp, vp, i32, i32, i32, vp,
                                  vp, vp]
    lib.cpu_mem_walks.restype = None
    return lib


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port(toy_index):
    return FMIndexTorch(toy_index, "cpu")


@pytest.fixture(scope="module")
def jax_walks(toy_index):
    """FMIndexJax.mem_walks of each case, computed once."""
    eng = FMIndexJax(toy_index, lut_k=0)
    return {name: eng.mem_walks(*walk_tasks(toy_index, seed, W=W, L=L))
            for name, (seed, W, L) in CASES.items()}


def off_by_one(a: np.ndarray) -> np.ndarray:
    """A copy of ``a`` whose data starts one byte past a 16-byte
    boundary."""
    buf = np.zeros(a.nbytes + 32, np.uint8)
    at = (-buf.ctypes.data) % 16 + 1
    out = buf[at:at + a.nbytes].view(a.dtype).reshape(a.shape)
    out[...] = a
    assert out.ctypes.data % 16 == 1
    return out


def source_walks(lib, eng, chars, valid, staged: bool, shards: int = 1):
    """The kernel source's (lens, x0, x2) on these tasks, int32."""
    W, L = chars.shape
    out = [np.zeros(W, np.int32) for _ in range(3)]
    table = eng.table.contiguous()
    params = np.ascontiguousarray(eng._params, dtype=np.int32)
    bases, rows, keep = None, 0, []
    if shards > 1:
        rows = -(-table.shape[0] // shards)
        keep = [table[i * rows:(i + 1) * rows].contiguous()
                for i in range(shards)]
        bases = np.array([t.data_ptr() for t in keep], np.uint64)
    lib.cpu_mem_walks(table.data_ptr(),
                      None if bases is None else bases.ctypes.data, rows,
                      params.ctypes.data, chars.ctypes.data,
                      valid.ctypes.data, W, L, int(staged),
                      *(o.ctypes.data for o in out))
    return out


@pytest.mark.parametrize("staged", [True, False], ids=["staged", "inplace"])
@pytest.mark.parametrize("case", list(CASES))
def test_source_equals_plain_and_jax(walks_lib, port, toy_index, jax_walks,
                                     case, staged):
    seed, W, L = CASES[case]
    chars, valid = walk_tasks(toy_index, seed, W=W, L=L)
    got = source_walks(walks_lib, port, chars, valid, staged)
    want = port.plain_mem_walks(torch.from_numpy(chars),
                                torch.from_numpy(valid))
    for name, g, w, j in zip(("lens", "x0", "x2"), got, want, jax_walks[case]):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
        np.testing.assert_array_equal(g, j, err_msg=name)
    lens = got[0]
    assert (lens == 0).sum() >= W // 17  # tasks that never start
    if L > 1:
        assert (lens == L).any() and ((lens > 1) & (lens < L)).any()


@pytest.mark.parametrize("staged", [True, False], ids=["staged", "inplace"])
def test_source_off_a_vector_boundary(walks_lib, port, toy_index, staged):
    """chars and valid one byte past a 16-byte boundary: the staging
    loads byte by byte, with the same result."""
    chars, valid = walk_tasks(toy_index, 24, W=400, L=48)
    want = source_walks(walks_lib, port, chars, valid, staged)
    got = source_walks(walks_lib, port, off_by_one(chars), off_by_one(valid),
                       staged)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("staged", [True, False], ids=["staged", "inplace"])
def test_source_sharded_equals_flat(walks_lib, port, toy_index, staged):
    """The table range-sharded in two (host memory), read through the
    Sharded access: the same result as one table."""
    chars, valid = walk_tasks(toy_index, 25, W=600, L=64)
    want = source_walks(walks_lib, port, chars, valid, staged)
    got = source_walks(walks_lib, port, chars, valid, staged, shards=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_plain_counts_steps(port, toy_index):
    """``steps`` of the plain version: no step for a task that never
    starts, one a base taken after the first, and one more where the walk
    stopped on width 0 (before the task's end and its first bad base)."""
    chars, valid = walk_tasks(toy_index, 26, W=800, L=64)
    c, v = torch.from_numpy(chars), torch.from_numpy(valid)
    steps = torch.full((len(chars),), -1, dtype=torch.int64)
    lens = port.plain_mem_walks(c, v, steps=steps)[0].long()
    ok = v & (c <= 3)
    stop = torch.where(ok.all(1), chars.shape[1],
                       (~ok).int().argmax(1)).long()
    died = (lens > 0) & (lens < stop)
    want = torch.where(lens > 0, lens - 1 + died.long(), 0)
    torch.testing.assert_close(steps, want, rtol=0, atol=0)
    assert died.any() and (steps == 0).any()
