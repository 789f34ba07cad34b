"""The K-mer table build's own source, run on the CPU.

``dart_tpu_torch/csrc/fm_kernels.cu`` builds the table in two launches:
``lut_roots_kernel`` walks each subtree's root, one thread a root, and
``lut_build_kernel`` expands each root in one warp, level by level in
rounds of 32 parents between ``__syncwarp()``s. Their steps are
``__device__`` functions of one thread (``lut_root``, a root's chain;
``lut_take_root``; ``lut_level``, one parent's four children;
``lut_copy_out``, a lane's share of the stores), so here the file's
device part is compiled with g++ through the shim of
``test_torch_scan_source.py`` and a host loop runs both kernels' bodies:
every root, then each warp's rounds for every lane in turn (which is
what the barrier between rounds guarantees), over a shared buffer
filled with garbage before each warp. The table is held byte-equal to
``fm_jax.build_lut`` and ``fm_jax_wide.build_lut_wide`` (their level
loop, run once to K = 11 for each index and width, and checked against
the functions themselves at K = 4) at K = 1 (the root pass alone), 3
and 4 (fewer levels than a warp's ``kLutDepth`` = 4: four one-base
roots), 5 (one-base roots, all four levels), 6, 8 (dead entries) and
11, on the toy index and on the repeat index. The card
(``chip_smoke.py``) holds the kernels themselves to the plain version.
"""

import ctypes
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dart_tpu.ops import fm_jax, fm_jax_wide
from dart_tpu_torch.ops.fm_torch import FMIndexTorch

from test_torch_scan_source import build_host_lib, repeat_index, toy  # noqa: F401

LUT_LOOP = r"""
template <class L>
void lut_all(const void* table, const typename L::I* params, int K,
             void* out) {
  const FmParams<typename L::I> p = make_params(params);
  const Flat<L> a{static_cast<const uint4*>(table)};
  const int d = lut_depth(K);
  const long long roots = 1LL << (2 * (K - d));
  for (long long r = 0; r < roots; ++r) {  // lut_roots_kernel
    typename L::I x0, x1, x2;
    lut_root(a, p, r, K - d, x0, x1, x2);
    L::lut_store(out, r << (2 * d), x0, x1, x2);
  }
  if (d == 0) return;
  static uint4 sh[kLutSlots * L::kLutBytes / 16];
  for (long long r = 0; r < roots; ++r) {  // lut_build_kernel, a warp
    unsigned char* junk = reinterpret_cast<unsigned char*>(sh);
    for (size_t i = 0; i < sizeof(sh); ++i)
      junk[i] = (unsigned char)(i * 37 + 11);
    lut_take_root<L>(out, r, d, sh);
    for (int l = 0; l < d; ++l)
      for (int q = 0; q < lut_rounds(l); ++q) {
        for (int j = 0; j < 32; ++j) lut_level(a, p, l, d, q, j, sh);
        if (l + 1 == d)
          for (int j = 0; j < 32; ++j) lut_copy_out<L>(sh, d, r, q, j, out);
      }
  }
}
}  // namespace

extern "C" void cpu_lut_build(const void* table, const void* params, int K,
                              void* out, int wide) {
  if (wide)
    lut_all<Wide>(table, static_cast<const long long*>(params), K, out);
  else
    lut_all<Narrow>(table, static_cast<const int*>(params), K, out);
}
"""

KS = (1, 3, 4, 5, 6, 8, 11)


@pytest.fixture(scope="module")
def lut_lib(tmp_path_factory):
    lib = build_host_lib(tmp_path_factory, "lut", LUT_LOOP)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cpu_lut_build.argtypes = [vp, vp, i32, vp, i32]
    lib.cpu_lut_build.restype = None
    return lib


def jax_tables(idx, wide: bool) -> dict:
    """{K: the bytes of build_lut(K) (narrow) or build_lut_wide(K)} for
    every K of KS, from one run of their level loop: the table of K is
    the walk state after K - 1 levels, stacked as they stack it."""
    out = {}
    if not wide:
        jx = fm_jax.FMIndexJax(idx, lut_k=0)
        ext = jax.jit(functools.partial(fm_jax._lut_extend,
                                        primary=jx.primary))
        c = jnp.arange(4, dtype=jnp.int32)
        x = (jx.L2[c] + 1, jx.L2[3 - c] + 1, jx.L2[c + 1] - jx.L2[c])
        for k in range(1, max(KS) + 1):
            if k in KS:
                rows = np.stack([np.asarray(v) for v in x]
                                + [np.zeros(4**k, np.int32)], axis=1)
                out[k] = rows.astype(np.uint32).tobytes()
            if k < max(KS):
                x = ext(jx.table, jx.L2, *x)
        return out
    jw = fm_jax_wide.FMIndexJaxWide(idx)
    ext = jax.jit(functools.partial(fm_jax_wide._lut_extend_wide,
                                    primary=jw.primary))
    c = np.arange(4, dtype=np.int32)
    l2 = np.asarray(jw.L2lo).astype(np.uint64) | (
        np.asarray(jw.L2hi).astype(np.uint64) << 32)
    x = tuple(tuple(map(jnp.asarray, fm_jax_wide._split64(v.view(np.int64))))
              for v in (l2[c] + 1, l2[3 - c] + 1, l2[c + 1] - l2[c]))
    for k in range(1, max(KS) + 1):
        if k in KS:
            out[k] = np.stack([np.asarray(h) for v in x for h in v],
                              axis=1).tobytes()
        if k < max(KS):
            x = ext(jw.blocks, jw.L2lo, jw.L2hi, *x)
    return out


@pytest.fixture(scope="module")
def want():
    """The JAX tables, by (index name, wide), computed once each."""
    return {}


def reference(want, name, idx, wide):
    if (name, wide) not in want:
        want[(name, wide)] = jax_tables(idx, wide)
    return want[(name, wide)]


def source_lut(lib, idx, wide: bool, K: int) -> bytes:
    eng = FMIndexTorch(idx, "cpu", wide=wide)
    table = eng.table.contiguous()
    params = np.ascontiguousarray(eng._params)
    out = np.zeros((4**K, 3) if wide else (4**K, 4),
                   np.int64 if wide else np.uint32)
    lib.cpu_lut_build(table.data_ptr(), params.ctypes.data, K,
                      out.ctypes.data, int(wide))
    return out.tobytes()


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_level_loop_is_build_lut(toy, want, wide):
    """The reference's level loop gives what the JAX functions return."""
    k = 4
    if wide:
        jw = fm_jax_wide.FMIndexJaxWide(toy)
        direct = fm_jax_wide.build_lut_wide(jw.blocks, jw.L2lo, jw.L2hi,
                                            jw.primary, k)
    else:
        jx = fm_jax.FMIndexJax(toy, lut_k=0)
        direct = fm_jax.build_lut(jx.table, jx.L2, jx.primary, k)
    assert np.asarray(direct).tobytes() == reference(want, "toy", toy,
                                                     wide)[k]


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("which", ["toy", "repeat"])
def test_kernel_source_equals_build_lut(lut_lib, want, toy, repeat_index,
                                        which, wide, K):
    idx = toy if which == "toy" else repeat_index
    got = source_lut(lut_lib, idx, wide, K)
    ref = reference(want, which, idx, wide)[K]
    assert got == ref
    if K == 8 and which == "toy":  # dead entries among them
        x2 = np.frombuffer(ref, np.int64 if wide else np.uint32).reshape(
            4**K, -1)[:, 2]
        assert 0.01 < (x2 == 0).mean() < 0.5
