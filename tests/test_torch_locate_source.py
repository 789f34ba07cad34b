"""The SA locate kernel's own source, run on the CPU.

``locate_kernel`` in ``dart_tpu_torch/csrc/fm_kernels.cu`` (K2 narrow, K5
wide) is compiled with g++ through the shim of ``test_torch_scan_source.py``
and run one thread after another over the rows, with the grid the launch
would choose (``is_pow2``), or forced to divide. Its output is held equal to
the plain version (``fm_plain.locate_plain``), to ``FMIndexNumpy.locate``
and, where the JAX engines can serve, to ``FMIndexJax.locate`` (narrow) and
``FMIndexJaxWide.locate`` (wide):

- the toy index samples every 32 rows, a power of two: the mask-and-shift
  grid;
- the toy genome indexed with samples every 12 rows (``test_torch_wide``'s
  ``built_index``): the division grid. The JAX locates test a mask
  (``fm_jax.py:1167``, ``fm_jax_wide.py:746``), so they serve the power of
  two only; ``FMIndexNumpy`` reads the ``.sa`` samples (every 32), an
  independent reference at 12.

Rows: every row of the index; rows 0, primary, primary - 1, primary + 1
and seq_len; runs of consecutive rows k0 .. k0 + freq - 1 (freq 2 .. 100),
as the main path's occurrence expansion hands them to the locate. The card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``) holds the kernel itself to
the plain version.
"""

import ctypes

import numpy as np
import pytest
import torch

from dart_tpu.ops.fm_jax import FMIndexJax
from dart_tpu.ops.fm_jax_wide import FMIndexJaxWide
from dart_tpu.ops.fm_numpy import FMIndexNumpy
from dart_tpu_torch.ops.fm_torch import FMIndexTorch

from test_torch_scan_source import build_host_lib, toy  # noqa: F401
from test_torch_wide import built_index  # noqa: F401

LOCATE_LOOP = r"""
template <class L, bool kPow2>
void locate_grid(const void* table, const FmParams<typename L::I>& p,
                 const void* rows, long long n, void* out) {
  using I = typename L::I;
  const Flat<L> a{static_cast<const uint4*>(table)};
  const SaGrid<I, kPow2> g = sa_grid<I, kPow2>(p.sa_intv);
  blockDim.x = kThreads;
  for (unsigned b = 0; b < (unsigned)((n + kThreads - 1) / kThreads); ++b)
    for (unsigned t = 0; t < (unsigned)kThreads; ++t) {
      blockIdx.x = b;
      threadIdx.x = t;
      locate_kernel<Flat<L>, kPow2>(a, p, g, static_cast<const I*>(rows),
                                    (I)n, static_cast<I*>(out));
    }
}

template <class L>
void locate_all(const void* table, const typename L::I* params,
                const void* rows, long long n, void* out, int divide) {
  const FmParams<typename L::I> p = make_params(params);
  if (is_pow2(p.sa_intv) && !divide)
    locate_grid<L, true>(table, p, rows, n, out);
  else
    locate_grid<L, false>(table, p, rows, n, out);
}
}  // namespace

extern "C" void cpu_locate(const void* table, const void* params,
                           const void* rows, long long n, void* out,
                           int wide, int divide) {
  if (wide)
    locate_all<Wide>(table, static_cast<const long long*>(params), rows, n,
                     out, divide);
  else
    locate_all<Narrow>(table, static_cast<const int*>(params), rows, n, out,
                       divide);
}
"""

ROWS = ("all", "edges", "runs")


@pytest.fixture(scope="module")
def locate_lib(tmp_path_factory):
    lib = build_host_lib(tmp_path_factory, "locate", LOCATE_LOOP)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.cpu_locate.argtypes = [vp, vp, vp, i64, vp, i32, i32]
    lib.cpu_locate.restype = None
    return lib


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def indexes(toy, built_index):  # noqa: F811
    return {"toy": toy, "every12": built_index}


@pytest.fixture(scope="module")
def references():
    """Each reference's SA positions of every row, by (index, width),
    computed once."""
    return {}


def rows_of(idx, kind: str) -> np.ndarray:
    n = idx.seq_len + 1  # rows 0 .. seq_len
    if kind == "all":
        return np.arange(n, dtype=np.int64)
    p = idx.primary
    if kind == "edges":
        return np.array([0, p, max(p - 1, 0), min(p + 1, n - 1), n - 1],
                        dtype=np.int64)
    rng = np.random.default_rng(31)
    runs = []
    for freq in (2, 3, 5, 10, 20, 50, 100, 100):
        k0 = int(rng.integers(0, n - freq))
        runs.append(np.arange(k0, k0 + freq))
    runs.append(np.arange(p - 3, p + 4))  # a run across the primary row
    return np.concatenate(runs).astype(np.int64)


def reference(references, name, idx, wide):
    """{name of the reference: SA positions of every row}."""
    if (name, wide) not in references:
        rows = rows_of(idx, "all")
        ref = {"numpy": FMIndexNumpy(idx).locate(rows)}
        if name == "toy":
            eng = FMIndexJaxWide(idx) if wide else FMIndexJax(idx, lut_k=0)
            ref["jax"] = np.asarray(eng.locate(rows), dtype=np.int64)
        references[(name, wide)] = ref
    return references[(name, wide)]


def source_locate(lib, eng, rows: np.ndarray, divide: bool) -> np.ndarray:
    table = eng.table.contiguous()
    params = np.ascontiguousarray(eng._params)
    r = np.ascontiguousarray(rows.astype(np.int64 if eng.wide else np.int32))
    out = np.zeros_like(r)
    lib.cpu_locate(table.data_ptr(), params.ctypes.data, r.ctypes.data,
                   len(r), out.ctypes.data, int(eng.wide), int(divide))
    return out


@pytest.mark.parametrize("kind", ROWS)
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("which", ["toy", "every12"])
def test_locate_source_equals_references(locate_lib, indexes, references,
                                         which, wide, kind):
    idx = indexes[which]
    eng = FMIndexTorch(idx, "cpu", wide=wide)
    assert eng.sa_intv == (32 if which == "toy" else 12)
    rows = rows_of(idx, kind)
    got = source_locate(locate_lib, eng, rows, divide=False)
    assert got.dtype == (np.int64 if wide else np.int32)
    want = eng.plain_locate(torch.from_numpy(rows.astype(got.dtype))).numpy()
    np.testing.assert_array_equal(got, want)
    refs = reference(references, which, idx, wide)
    assert set(refs) == ({"numpy", "jax"} if which == "toy" else {"numpy"})
    for ref in refs.values():
        np.testing.assert_array_equal(got.astype(np.int64), ref[rows])
    if kind == "all":  # every SA position once (row 0's as -1, BWA's way)
        np.testing.assert_array_equal(np.sort(got),
                                      np.arange(-1, len(rows) - 1))


@pytest.mark.parametrize("kind", ROWS)
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_division_grid_equals_mask_grid(locate_lib, toy, wide,  # noqa: F811
                                        kind):
    """The division grid, forced on the power-of-two index, gives what
    the mask-and-shift grid gives."""
    eng = FMIndexTorch(toy, "cpu", wide=wide)
    rows = rows_of(toy, kind)
    np.testing.assert_array_equal(
        source_locate(locate_lib, eng, rows, divide=True),
        source_locate(locate_lib, eng, rows, divide=False))


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_plain_counts_lf_steps(toy, wide):  # noqa: F811
    """``lf_steps`` of the plain version: 0 on a sampled row, and on
    any other row one more than on the row its LF step leads to (the
    walk of row k, one step on, is the walk of that row)."""
    eng = FMIndexTorch(toy, "cpu", wide=wide)
    rows = torch.arange(toy.seq_len + 1)
    rows = rows.to(eng.idx_dtype)
    steps = torch.full((len(rows),), -1, dtype=torch.int64)
    pos = eng.plain_locate(rows, lf_steps=steps).long()
    assert (steps >= 0).all()
    sampled = rows.long() % eng.sa_intv == 0
    assert (steps[sampled] == 0).all() and (steps[~sampled] > 0).all()
    # SA[LF(k)] = SA[k] - 1 (mod seq_len + 1; row 0's -1 is seq_len), so
    # the walk's row after one step is the row whose position is one less
    n = len(pos)
    row_of = torch.empty_like(pos)
    row_of[pos % n] = torch.arange(n)
    nxt = row_of[(pos[~sampled] - 1) % n]
    np.testing.assert_array_equal(steps[~sampled].numpy(),
                                  steps[nxt].numpy() + 1)
