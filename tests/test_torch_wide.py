"""The port's wide (int64) engine on the CPU, where it runs the plain
PyTorch versions of its kernels on the wide table layout, held exactly
against ``dart_tpu``'s wide JAX engine (``FMIndexJaxWide`` on JAX's CPU
backend), the NumPy engine and the port's narrow engine; a 64-bit guard
that needs no genome past 2^31; three golden configs; and the CLI's
choice of engine at the 2^31 threshold."""

import numpy as np
import pytest
import torch

from dart_tpu.config import DartConfig
from dart_tpu.ops.fm_jax_wide import FMIndexJaxWide
from dart_tpu.ops.fm_numpy import FMIndexNumpy
from dart_tpu_torch import aligner, cli
from dart_tpu_torch.ops import fm_torch
from dart_tpu_torch.ops.fm_torch import FMIndexTorch

from test_torch_cuda import shift_samples
from test_torch_lut import GOLDEN3, assert_same_seeds, assert_golden, read_mix


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain kernels run many small ops; with the test workers
    sharing the cores, more intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def wide(toy_index):
    return FMIndexTorch(toy_index, "cpu", wide=True)


@pytest.fixture(scope="module")
def built_index(tmp_path_factory, data_dir):
    """The toy genome indexed by dart_tpu.index.build_index with dense
    samples every 12 rows: not a power of two, so the wide JAX engine
    leaves out its locate-and-compare path there."""
    from dart_tpu.index import build_index, load_index

    prefix = str(tmp_path_factory.mktemp("built12") / "toy")
    build_index(str(data_dir / "toy.fa"), prefix, sad_intv=12)
    return load_index(prefix)


def test_wide_engine_is_int64(toy_index, wide):
    assert wide.wide and wide.idx_dtype == torch.int64
    assert wide.table.shape[1] == 16 and wide.L2.dtype == torch.int64
    assert wide._params.dtype == np.int64
    assert set(wide.launches) == {"seed_scan_wide", "locate_wide",
                                  "lut_build_wide"}
    assert not FMIndexTorch(toy_index, "cpu").wide


def test_wide_locate_matches_jax_and_numpy(toy_index, wide):
    """Every third row of the toy index, sampled rows among them, and
    the rows around the primary one."""
    p = toy_index.primary
    rows = np.concatenate([np.arange(0, toy_index.seq_len, 3),
                           [p - 1, p, p + 1]]).astype(np.int64)
    got = wide.locate(rows)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, FMIndexNumpy(toy_index).locate(rows))
    np.testing.assert_array_equal(got, FMIndexJaxWide(toy_index).locate(rows))


@pytest.mark.parametrize("kind", ["ops", "wide"])
def test_wide_seed_scan_matches_jax(kind, toy_index, wide):
    """The wide scan equals FMIndexJaxWide's (the toy index samples
    every 32 rows, so both take the locate-and-compare path) and the
    port's narrow scan."""
    codes, rlens = read_mix(kind, toy_index)
    got = wide.seed_reads(codes, rlens)
    assert_same_seeds(got, FMIndexJaxWide(toy_index).seed_reads(codes,
                                                                 rlens))
    assert_same_seeds(got, FMIndexTorch(toy_index, "cpu").seed_reads(
        codes, rlens))


def test_wide_seed_scan_sample_interval_not_power_of_two(built_index):
    """With samples every 12 rows the wide JAX engine reports a seed of
    one occurrence as (row, freq 1) where the port locates it in the
    scan (freq -1, the genome position): held equal once that row is
    located; everything else exactly."""
    codes, rlens = read_mix("wide", built_index)
    port = FMIndexTorch(built_index, "cpu", wide=True)
    assert port.sa_intv == 12
    got = port.seed_reads(codes, rlens)
    want = FMIndexJaxWide(built_index).seed_reads(codes, rlens)
    np.testing.assert_array_equal(got[0], want[0])
    valid = np.arange(got[1].shape[1])[None, :] < got[0][:, None]
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_array_equal(g[valid], w[valid])
    direct = valid & (got[4] == -1)
    assert direct.any() and (want[4][direct] == 1).all()
    np.testing.assert_array_equal(got[3][direct],
                                  port.locate(want[3][direct]))
    rest = valid & ~direct
    np.testing.assert_array_equal(got[3][rest], want[3][rest])
    np.testing.assert_array_equal(got[4][rest], want[4][rest])
    rows = np.arange(0, built_index.seq_len, 7, dtype=np.int64)
    np.testing.assert_array_equal(port.locate(rows),
                                  FMIndexNumpy(built_index).locate(rows))


def test_wide_seed_scan_repetitive_read(tmp_path):
    """The scan's worst case (tests/test_seed_convergence.py): every
    walk runs to the read end and is rejected by max_dup."""
    from dart_tpu.index import build_index, load_index

    seq = ("TTAGGG" * 10000)[:30000]
    (tmp_path / "rep.fa").write_text(">telo\n" + "\n".join(
        seq[i:i + 70] for i in range(0, len(seq), 70)) + "\n")
    build_index(str(tmp_path / "rep.fa"), str(tmp_path / "rep"))
    idx = load_index(str(tmp_path / "rep"))
    codes = np.tile(np.array([3, 3, 0, 2, 2, 2], np.uint8), 16)[None, :]
    rlens = np.array([96], dtype=np.int32)
    got = FMIndexTorch(idx, "cpu", wide=True, lut_k=4).seed_reads(codes,
                                                                  rlens)
    assert_same_seeds(got, FMIndexTorch(idx, "cpu").seed_reads(codes, rlens))
    assert got[0][0] == 0


def test_wide_locate_carries_64_bits(toy_index):
    """2^33 added to every SA sample of a copy of the wide table: every
    located position comes back shifted by exactly 2^33, so no step
    from the sample to the result cuts it to 32 bits."""
    eng = FMIndexTorch(toy_index, "cpu", wide=True)
    rows = torch.cat([torch.arange(0, toy_index.seq_len, 5),
                      torch.tensor([toy_index.primary])])
    base = eng.locate_rows(rows)
    got = shift_samples(eng, 2**33).locate_rows(rows)
    assert got.dtype == torch.int64
    torch.testing.assert_close(got, base + 2**33, rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(GOLDEN3))
def test_golden_on_wide_engine(name, toy_index, data_dir, golden_dir,
                               tmp_path, capsys):
    """The wide engine with a K = 8 table, as the card runs it past
    2^31 (with K = 11)."""
    engine = aligner.make_engine(toy_index, DartConfig(), "cpu", lut_k=8,
                                 wide=True)
    assert engine.wide and engine.lut.dtype == torch.int64
    assert_golden(name, toy_index, engine, data_dir, golden_dir, tmp_path)


def test_cli_takes_wide_engine_past_threshold(toy_index, data_dir,
                                              golden_dir, tmp_path,
                                              monkeypatch, capsys):
    """With the 2^31 threshold moved to 0, ``dart-tpu-torch`` aligns the
    toy genome on the wide engine and still writes the golden SAM."""
    made = []

    class Recording(FMIndexTorch):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(fm_torch, "WIDE_MIN_SEQ", 0)
    monkeypatch.setattr(aligner, "FMIndexTorch", Recording)
    sam, tab = tmp_path / "o.sam", tmp_path / "o.tab"
    rc = cli.main(["-i", str(golden_dir / "index" / "toy"), "-f",
                   str(data_dir / "spliced.fa"), "-o", str(sam), "-j",
                   str(tab), "-silent", "--device", "cpu"])
    assert rc == 0 and len(made) == 1
    assert made[0].wide and made[0].lut_k == 0
    assert made[0].n_seed_launches == 0  # the CPU runs no kernel
    assert sam.read_bytes() == (golden_dir / "c3_spliced.sam").read_bytes()
    assert tab.read_bytes() == \
        (golden_dir / "c3_spliced.junctions.tab").read_bytes()
    with pytest.raises(ValueError, match="wide"):
        FMIndexTorch(toy_index, "cpu", wide=False)
