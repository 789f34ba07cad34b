"""The port's engine (dart_tpu_torch.ops.fm_torch.FMIndexTorch) on the
CPU, where it runs the plain PyTorch versions of its two kernels, held
exactly (integers, bit for bit) against the JAX engine
(FMIndexJax, plain one-character walk init, on JAX's CPU backend), the
NumPy engine and brute force."""

import numpy as np
import pytest
import torch

from dart_tpu.ops.fm_jax import FMIndexJax
from dart_tpu.ops.fm_numpy import FMIndexNumpy
from dart_tpu_torch.ops.fm_torch import FMIndexTorch, pack_codes


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain kernels run many small ops; with the test workers
    sharing the cores, more intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines(toy_index):
    return (FMIndexTorch(toy_index, device="cpu"),
            FMIndexJax(toy_index, lut_k=0))


def _assert_same_seeds(got, want):
    names = ("n", "rpos", "len", "k0", "freq")
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def _genome_reads(idx, rng, R, L, p_mut=0.0):
    codes = np.empty((R, L), dtype=np.uint8)
    for i in range(R):
        p = int(rng.integers(0, idx.seq_len - L))
        codes[i] = idx.ref_codes[p:p + L]
    if p_mut:
        # substitutions, and N bases (code 4) among them
        mut = rng.random((R, L)) < p_mut
        codes = np.where(mut, rng.integers(0, 5, (R, L)), codes)
    return codes.astype(np.uint8), np.full(R, L, dtype=np.int32)


def _six_seed_reads(idx, rng, n=48):
    """Six 16-mers from distant genome positions per read: each seeds,
    and the joins stop extension (tests/test_seed_overflow.py)."""
    codes = np.zeros((n, 96), np.uint8)
    for i in range(n):
        parts = [idx.ref_codes[p:p + 16] for p in
                 rng.integers(0, idx.genome_size - 20, 6)]
        codes[i] = np.concatenate(parts)
    return np.minimum(codes, 3), np.full(n, 96, np.int32)


def _reads(kind, idx):
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "mismatch_and_n":
        codes, rlens = _genome_reads(idx, rng, 96, 100, p_mut=0.03)
        assert (codes == 4).any()
    elif kind == "short":
        codes, rlens = _genome_reads(idx, rng, 64, 100, p_mut=0.01)
        rlens[1:] = rng.integers(0, 14, 63)
    elif kind == "six_seeds":
        codes, rlens = _six_seed_reads(idx, rng)
    elif kind == "300mers":
        codes, rlens = _genome_reads(idx, rng, 16, 300, p_mut=0.01)
    return codes, rlens


@pytest.mark.parametrize("kind", ["mismatch_and_n", "short", "six_seeds",
                                  "300mers"])
def test_seed_reads_matches_jax(kind, toy_index, engines):
    port, jx = engines
    codes, rlens = _reads(kind, toy_index)
    got = port.seed_reads(codes, rlens)
    _assert_same_seeds(got, jx.seed_reads(codes, rlens))
    n, freq = got[0], got[4]
    if kind == "six_seeds":
        assert int(n.max()) == 6
    if kind == "short":
        assert (n[1:] == 0).all() and n[0] > 0
    # both kinds of seed occur: by SA interval, and by locate-and-compare
    if kind == "mismatch_and_n":
        valid = np.arange(freq.shape[1])[None, :] < n[:, None]
        assert (freq[valid] == -1).any()


def test_seed_submit_packed_from_native_packer(toy_index, engines):
    """The chunk path: reads packed by the native packer, as
    seeding.submit_chunk packs them, through seed_submit_packed and
    seed_finish."""
    from dart_tpu.pipeline.native_chunk import pack_reads_strided

    port, jx = engines
    codes, rlens = _reads("mismatch_and_n", toy_index)
    rlens[::7] -= 5
    ascii_ = np.frombuffer(b"ACGTN", dtype=np.uint8)[codes]
    blob = b"".join(ascii_[i, :n].tobytes() for i, n in enumerate(rlens))
    off = np.zeros(len(rlens) + 1, dtype=np.int64)
    np.cumsum(rlens, out=off[1:])
    Lp = 128
    words = Lp // 16
    R = len(rlens)
    buf = np.zeros((R, words + 1), dtype=np.uint32)
    nmask = np.zeros((R, words // 2), dtype=np.uint32)
    has_n = np.zeros(R, dtype=np.uint8)
    n_with_n = pack_reads_strided(blob, off, R, words, buf[:, :words], nmask,
                                  buf.view(np.int32)[:, words], has_n)
    assert n_with_n > 0
    ref_buf, ref_nmask, _ = pack_codes(codes, rlens)
    np.testing.assert_array_equal(buf, ref_buf)
    np.testing.assert_array_equal(nmask, ref_nmask)
    job = port.seed_submit_packed(buf, nmask, has_n, n_with_n, R, Lp,
                                  int(rlens.max()))
    _assert_same_seeds(port.seed_finish(job), jx.seed_reads(codes, rlens))


def test_locate_matches_jax_and_numpy(toy_index, engines):
    """Every row of the toy index, so the primary row and rows that
    already sit on a sample are in; more than 512 rows, so the JAX
    engine runs its device kernel rather than its host walk."""
    port, jx = engines
    rows = np.arange(toy_index.seq_len, dtype=np.int64)
    assert (rows == toy_index.primary).any()
    assert ((rows % toy_index.sa_intv) == 0).sum() > 1000
    got = port.locate(rows)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, jx.locate(rows))
    np.testing.assert_array_equal(got, FMIndexNumpy(toy_index).locate(rows))
    assert port.locate(np.empty(0, dtype=np.int64)).shape == (0,)


def test_locate_vs_bruteforce(toy_index, engines):
    port, _ = engines
    fm = FMIndexNumpy(toy_index)
    text = toy_index.ref_codes.tobytes()
    rng = np.random.default_rng(12)
    for _ in range(10):
        pos = int(rng.integers(0, toy_index.seq_len - 40))
        q = text[pos:pos + 24]
        chars = np.frombuffer(q, dtype=np.uint8)[None, :]
        lens, k0, freq = fm.mem_walk_batch(chars, np.ones_like(chars, bool))
        rows = np.arange(int(k0[0]), int(k0[0]) + int(freq[0]))
        want, s = [], 0
        pat = q[:int(lens[0])]
        while (i := text.find(pat, s)) >= 0:
            want.append(i)
            s = i + 1
        assert sorted(port.locate(rows).tolist()) == want


def test_engine_surface(engines):
    """What the shared seeding code reads off an engine: no seed_drain
    (that path imports JAX), no padding of chunks."""
    port, _ = engines
    assert not hasattr(port, "seed_drain")
    assert port._pad_up(100000, port._min_bucket) == 100000
    assert port.locate_submit(np.empty(0, dtype=np.int64)) is None
    assert port.n_seed_launches == port.n_locate_launches == 0
    with pytest.raises(ValueError):
        port.seed_reads(np.zeros((1, 65536), np.uint8),
                        np.array([65536], np.int32))


@pytest.fixture(scope="module")
def repeat_index(tmp_path_factory):
    """A telomeric-repeat genome (tests/test_seed_convergence.py)."""
    from dart_tpu.index import build_index, load_index

    d = tmp_path_factory.mktemp("repidx")
    seq = ("TTAGGG" * 10000)[:30000]
    (d / "rep.fa").write_text(">telo\n" + "\n".join(
        seq[i:i + 70] for i in range(0, len(seq), 70)) + "\n")
    build_index(str(d / "rep.fa"), str(d / "rep"))
    return load_index(str(d / "rep"))


def test_seed_scan_repetitive_read(repeat_index):
    """The worst case of the scan: every walk runs to the read end and
    is rejected by max_dup, so the scan restarts at every position."""
    telo = np.array([3, 3, 0, 2, 2, 2], dtype=np.uint8)
    codes = np.tile(telo, 16)[None, :].copy()
    rlens = np.array([96], dtype=np.int32)
    got = FMIndexTorch(repeat_index, device="cpu").seed_reads(codes, rlens)
    _assert_same_seeds(got, FMIndexJax(repeat_index, lut_k=0)
                       .seed_reads(codes, rlens))
    assert got[0][0] == 0
