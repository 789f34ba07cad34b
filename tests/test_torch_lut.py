"""The port's K-mer walk-state table (LUT) on the CPU, where the engine
runs the plain PyTorch versions of its kernels, held exactly against
the JAX engines: the table against ``fm_jax.build_lut`` and
``fm_jax_wide.build_lut_wide``, seed walks started from it against
``FMIndexJax(lut_k=4)`` and ``FMIndexJaxWide(lut_k=4)`` (pre-gathered
LUT states, their default) and against the port's own ``lut_k=0``
scan, three golden configs aligned with it by the port's own
``DartAligner``, and K chosen as ``dart_tpu`` chooses it
(``DART_TPU_LUT``)."""

import numpy as np
import pytest
import torch

from dart_tpu.ops import fm_jax, fm_jax_wide
from dart_tpu_torch.aligner import DartAligner, default_lut_k, make_engine, run
from dart_tpu_torch.config import DartConfig
from dart_tpu_torch.index import load_index
from dart_tpu_torch.ops.fm_torch import FMIndexTorch

K = 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain kernels run many small ops; with the test workers
    sharing the cores, more intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_toy(golden_dir):
    """The toy index as the port's own loader reads it."""
    return load_index(str(golden_dir / "index" / "toy"))


@pytest.fixture(scope="module")
def ports(toy_index):
    return {(wide, k): FMIndexTorch(toy_index, "cpu", lut_k=k, wide=wide)
            for wide, k in ((False, 0), (False, K), (True, K))}


@pytest.mark.parametrize("k", [1, K, 8])
def test_lut_equals_build_lut(k, toy_index):
    """K = 8 leaves some of the 65,536 entries dead on the toy genome
    (200,000 text positions); K = 1 is the walk's first base alone."""
    jx = fm_jax.FMIndexJax(toy_index, lut_k=0)
    want = np.asarray(fm_jax.build_lut(jx.table, jx.L2, jx.primary, k))
    got = FMIndexTorch(toy_index, "cpu", lut_k=k).lut
    assert got.dtype == torch.int32 and got.shape == (4**k, 4)
    assert got.numpy().view(np.uint32).tobytes() == want.tobytes()
    dead = want[:, 2] == 0
    if k == 8:
        assert 0.01 < dead.mean() < 0.5
        assert not want[dead].any()  # a dead entry is all zeros


@pytest.mark.parametrize("k", [K, 8])
def test_wide_lut_equals_build_lut_wide(k, toy_index):
    """The wide table's (4^K, 3) int64 rows are the bytes of
    build_lut_wide's (4^K, 6) uint32 [lo, hi] rows (K = 4), and hold
    the narrow table's intervals, dead entries included (K = 8)."""
    got = FMIndexTorch(toy_index, "cpu", lut_k=k, wide=True).lut
    assert got.dtype == torch.int64 and got.shape == (4**k, 3)
    narrow = FMIndexTorch(toy_index, "cpu", lut_k=k).lut.numpy().view(
        np.uint32)
    np.testing.assert_array_equal(got.numpy(), narrow[:, :3])
    if k == K:
        jw = fm_jax_wide.FMIndexJaxWide(toy_index)
        want = np.asarray(fm_jax_wide.build_lut_wide(
            jw.blocks, jw.L2lo, jw.L2hi, jw.primary, k))
        assert got.numpy().view(np.uint32).tobytes() == want.tobytes()


def _genome_reads(idx, rng, R, L, mut):
    codes = np.empty((R, L), dtype=np.uint8)
    for i in range(R):
        p = int(rng.integers(0, idx.genome_size - L))
        codes[i] = idx.ref_codes[p:p + L]
    m = rng.random((R, L)) < mut
    codes = np.where(m, rng.integers(0, 5, (R, L)).astype(np.uint8), codes)
    return codes, np.full(R, L, dtype=np.int32)


def read_mix(kind, idx):
    """The read mixes of tests/test_ops.py (LUT equivalence) and
    tests/test_fm_wide.py (wide seed scans, with and without LUT)."""
    if kind == "ops":
        return _genome_reads(idx, np.random.default_rng(11), 64, 100, 0.03)
    if kind == "wide":
        codes, rlens = _genome_reads(idx, np.random.default_rng(21), 48, 100,
                                     0.03)
        rlens[:6] = [17, 30, 16, 15, 99, 64]
        codes[3] = 4
        return codes, rlens
    codes, rlens = _genome_reads(idx, np.random.default_rng(27), 32, 100,
                                 0.03)
    rlens[:3] = [17, 31, 64]
    codes[5, 40:44] = 4
    return codes, rlens


def assert_same_seeds(got, want):
    for name, g, w in zip(("n", "rpos", "len", "k0", "freq"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.fixture(scope="module")
def jax_lut_engines(toy_index):
    return (fm_jax.FMIndexJax(toy_index, lut_k=K),
            fm_jax_wide.FMIndexJaxWide(toy_index, lut_k=K))


@pytest.mark.parametrize("kind", ["ops", "wide", "wide_lut"])
def test_seed_scan_with_lut_matches_jax(kind, toy_index, ports,
                                        jax_lut_engines):
    """Narrow and wide scans started from the K = 4 table equal the
    JAX engines' with the same table, and the port's scans without
    one (the toy index samples every 32 rows, a power of two, so the
    wide JAX engine takes the locate-and-compare path too)."""
    codes, rlens = read_mix(kind, toy_index)
    narrow = ports[(False, K)].seed_reads(codes, rlens)
    jx, jw = jax_lut_engines
    assert_same_seeds(narrow, jx.seed_reads(codes, rlens))
    assert_same_seeds(ports[(True, K)].seed_reads(codes, rlens),
                       jw.seed_reads(codes, rlens))
    assert_same_seeds(narrow, ports[(False, 0)].seed_reads(codes, rlens))
    n, freq = narrow[0], narrow[4]
    valid = np.arange(freq.shape[1])[None, :] < n[:, None]
    assert (freq[valid] == -1).any()


def test_lut_dead_entries_and_n_windows(toy_index, ports):
    """Reads whose K-mers are absent from the genome (dead entries) or
    hold N bases (dead windows) scan as they do without the table."""
    rng = np.random.default_rng(6)
    codes = rng.integers(0, 4, (40, 90)).astype(np.uint8)  # random: K=8 dies
    codes[::3, rng.integers(0, 90, 14)] = 4
    codes[:20, 10:60] = toy_index.ref_codes[5000:5050]
    rlens = np.full(40, 90, dtype=np.int32)
    rlens[1::5] = [13, 14, 15, 20, 22, 8, 25, 30]
    port8 = FMIndexTorch(toy_index, "cpu", lut_k=8)
    got = port8.seed_reads(codes, rlens)
    assert_same_seeds(got, ports[(False, 0)].seed_reads(codes, rlens))
    assert 0 < (got[0] > 0).sum() < 40


GOLDEN3 = {  # three of tests/test_parity.py's configs
    "c3_spliced": dict(r1=["spliced.fa"]),
    "c5_pe": dict(r1=["pe_1.fq"], r2=["pe_2.fq"], mis=5),
    "c9_unique": dict(r1=["se_mm.fq"], unique=True, mis=5),
}


def golden_cfg(name, data_dir, tmp_path) -> DartConfig:
    spec = GOLDEN3[name]
    cfg = DartConfig()
    cfg.read_files_1 = [str(data_dir / f) for f in spec["r1"]]
    cfg.read_files_2 = [str(data_dir / f) for f in spec.get("r2", [])]
    cfg.max_mismatch = spec.get("mis", 0)
    cfg.unique_only = spec.get("unique", False)
    cfg.sj_file = str(tmp_path / "o.tab")
    cfg.output_file = str(tmp_path / "o.sam")
    cfg.silent = True
    return cfg


def assert_golden_files(name, cfg, golden_dir):
    assert open(cfg.output_file).read() == \
        (golden_dir / f"{name}.sam").read_text()
    assert open(cfg.sj_file).read() == \
        (golden_dir / f"{name}.junctions.tab").read_text()


def assert_golden(name, idx, engine, data_dir, golden_dir, tmp_path):
    """Golden config ``name`` aligned by the port's DartAligner on
    ``engine`` gives the golden SAM and junctions.tab."""
    cfg = golden_cfg(name, data_dir, tmp_path)
    DartAligner(idx, cfg, engine=engine).run()
    assert_golden_files(name, cfg, golden_dir)


@pytest.mark.parametrize("name", sorted(GOLDEN3))
def test_golden_with_lut(name, port_toy, data_dir, golden_dir, tmp_path,
                         capsys):
    """The narrow engine with a K = 8 table (dead entries among them)."""
    engine = make_engine(port_toy, DartConfig(), "cpu", lut_k=8)
    assert engine.lut_k == 8 and not engine.wide
    assert_golden(name, port_toy, engine, data_dir, golden_dir, tmp_path)


def test_golden_with_env_lut(port_toy, data_dir, golden_dir, tmp_path,
                             monkeypatch, capsys):
    """``DART_TPU_LUT=4`` gives ``aligner.run`` on the CPU a K = 4 table,
    and golden c3 its golden bytes."""
    monkeypatch.setenv("DART_TPU_LUT", "4")
    cfg = golden_cfg("c3_spliced", data_dir, tmp_path)
    assert run(port_toy, cfg, "cpu").engine.lut_k == 4
    assert_golden_files("c3_spliced", cfg, golden_dir)


def test_env_lut_sets_k(toy_index, monkeypatch):
    """An int of 0 or more in ``DART_TPU_LUT`` is the table's K on any
    device, as in dart_tpu's make_engine; 0 means no table."""
    monkeypatch.setenv("DART_TPU_LUT", "4")
    assert make_engine(toy_index, DartConfig(), "cpu").lut_k == 4
    assert default_lut_k("cuda") == 4
    monkeypatch.setenv("DART_TPU_LUT", "16")  # past MAX_LUT_K
    with pytest.raises(ValueError):
        make_engine(toy_index, DartConfig(), "cpu")


def test_env_lut_zero_and_negative(monkeypatch):
    """``DART_TPU_LUT=0`` turns the table off on a card; a negative
    value leaves the default (11 on a card, none on the CPU)."""
    monkeypatch.setenv("DART_TPU_LUT", "0")
    assert default_lut_k("cuda") == 0
    monkeypatch.setenv("DART_TPU_LUT", "-1")
    assert default_lut_k("cuda") == 11 and default_lut_k("cpu") == 0


def test_make_engine_lut_choice(toy_index, monkeypatch):
    """K = 11 on a card, as dart_tpu on an accelerator; none on the CPU,
    where the plain build would cost more than it saves."""
    monkeypatch.delenv("DART_TPU_LUT", raising=False)
    assert default_lut_k("cuda") == default_lut_k("cuda:0") == 11
    assert default_lut_k("cpu") == 0
    eng = make_engine(toy_index, DartConfig(), "cpu")
    assert eng.lut_k == 0 and eng.lut is None and not eng.wide
    assert make_engine(toy_index, DartConfig(), "cpu", lut_k=3).lut.shape \
        == (64, 4)
    with pytest.raises(ValueError):
        FMIndexTorch(toy_index, "cpu", lut_k=16)
