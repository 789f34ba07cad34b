"""The port's engine tables through the layout cache (``ops.layout.
tables_from_index`` with ``index.layout_cache``), on a copy of the toy
index with the cache's threshold ``CACHE_MIN_SEQ`` patched to 0 in both
packages: the port writes ``.ntab``, ``.wtab`` and ``.wtab2`` byte-equal
to ``dart_tpu``'s engines, each package reads the other's files, a hit
gives the same seeds and locates without reading the ``.bwt``, a stale or
truncated file is a miss that is rewritten, ``.wtab2`` is repacked from
``.wtab``, and a golden config gives the same SAM cold and warm."""

import os
import shutil

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import dart_tpu.index.layout_cache as jax_cache
from dart_tpu.index import load_index as jax_load
from dart_tpu.ops import fm_jax, fm_jax_wide
from dart_tpu.ops.fm_jax import FMIndexJax
from dart_tpu.ops.fm_jax_wide import FMIndexJaxWide
from dart_tpu_torch import cli
from dart_tpu_torch.index import layout_cache, load_index
from dart_tpu_torch.ops import layout
from dart_tpu_torch.ops.fm_torch import FMIndexTorch

# kind -> (wide, index shards)
KINDS = {"ntab": (False, 1), "wtab": (True, 1), "wtab2": (True, 2)}


@pytest.fixture(autouse=True)
def eligible(monkeypatch):
    """Every text is eligible for the cache, in both packages."""
    monkeypatch.setattr(layout_cache, "CACHE_MIN_SEQ", 0)
    monkeypatch.setattr(jax_cache, "CACHE_MIN_SEQ", 0)


def copy_index(golden_dir, d) -> str:
    """The toy index files copied into d: the sidecars go there."""
    d.mkdir(exist_ok=True)
    for f in (golden_dir / "index").iterdir():
        if f.name.startswith("toy."):
            shutil.copy(f, d / f.name)
    return str(d / "toy")


def port_engine(prefix: str, kind: str, idx=None) -> FMIndexTorch:
    wide, n = KINDS[kind]
    return FMIndexTorch(idx or load_index(prefix), "cpu", wide=wide,
                        shard_devices=["cpu"] * n if n > 1 else None)


def jax_engine(prefix: str, kind: str):
    idx = jax_load(prefix)
    if kind == "ntab":
        return FMIndexJax(idx, lut_k=0)
    if kind == "wtab":
        return FMIndexJaxWide(idx)
    mesh = Mesh(np.array(jax.devices("cpu")[:2]), ("index",))
    return FMIndexJaxWide(idx, index_mesh=mesh)


def jax_table(eng) -> np.ndarray:
    return np.asarray(eng.table if isinstance(eng, FMIndexJax)
                      else eng.blocks)


def host_table(eng: FMIndexTorch) -> np.ndarray:
    t = eng.table
    if eng.sharded:
        t = torch.cat(t.shards)
    return t.numpy().view(np.uint32)


def read_cache(prefix: str, kind: str):
    arr, h = layout_cache.load_array(prefix, kind, {})
    return np.array(arr), h


def sample_reads(idx, n: int = 16, L: int = 64):
    rng = np.random.default_rng(3)
    codes = np.empty((n, L), np.uint8)
    for i in range(n):
        p = int(rng.integers(0, idx.seq_len - L - 1))
        codes[i] = np.minimum(idx.ref_codes[p:p + L], 3)
    codes[::3, 20] = 4  # an N in some
    return codes, np.full(n, L, np.int32)


@pytest.mark.parametrize("kind", list(KINDS))
def test_miss_writes_dart_tpus_bytes(kind, golden_dir, tmp_path):
    """On a miss the port writes the sidecar, header and array bytes
    equal to the one dart_tpu's engine writes on its own copy (``.wtab2``
    built whole, with no ``.wtab`` to repack from)."""
    port = copy_index(golden_dir, tmp_path / "port")
    ref = copy_index(golden_dir, tmp_path / "jax")
    eng = port_engine(port, kind)
    assert eng.cache == "miss"
    jax_engine(ref, kind)
    if kind == "wtab2":
        assert not os.path.exists(port + ".wtab")
    got = open(f"{port}.{kind}", "rb").read()
    assert got == open(f"{ref}.{kind}", "rb").read()
    _, h = read_cache(port, kind)
    assert (h["ref_off"], h["sad_off"]) == (eng.ref_off, eng.sad_off)
    assert type(h["ref_off"]) is int and h["seq_len"] == eng.seq_len


@pytest.mark.parametrize("kind", list(KINDS))
def test_each_package_reads_the_others_file(kind, golden_dir, tmp_path,
                                            monkeypatch):
    """The port hits a sidecar dart_tpu wrote, and dart_tpu loads one
    the port wrote (its table builders made to raise), with the same
    (ref_off, sad_off) and table as a build."""
    want = port_engine(copy_index(golden_dir, tmp_path / "plain"), kind)
    assert want.cache == "miss"
    by_jax = copy_index(golden_dir, tmp_path / "by_jax")
    jax_engine(by_jax, kind)
    eng = port_engine(by_jax, kind)
    assert eng.cache == "hit"
    assert (eng.ref_off, eng.sad_off) == (want.ref_off, want.sad_off)
    np.testing.assert_array_equal(host_table(eng), host_table(want))

    by_port = copy_index(golden_dir, tmp_path / "by_port")
    port_engine(by_port, kind)

    def refuse(*a, **kw):
        raise AssertionError("dart_tpu rebuilt a table the cache holds")

    monkeypatch.setattr(fm_jax, "build_merged_table", refuse)
    monkeypatch.setattr(fm_jax_wide, "build_merged_table_wide", refuse)
    j = jax_engine(by_port, kind)
    assert (j.ref_off, j.sad_off) == (want.ref_off, want.sad_off)
    np.testing.assert_array_equal(jax_table(j), host_table(want))


@pytest.mark.filterwarnings("error::UserWarning")
@pytest.mark.parametrize("kind", list(KINDS))
def test_hit_gives_the_same_results_and_reads_no_bwt(kind, golden_dir,
                                                     tmp_path):
    """A second engine hits the sidecar the first wrote: the index's
    ``.bwt`` and samples stay unread, the read-only memmap is copied
    without a warning, and its seed scan and the locate of every row
    equal the first engine's."""
    prefix = copy_index(golden_dir, tmp_path)
    first = port_engine(prefix, kind)
    idx = load_index(prefix)
    eng = port_engine(prefix, kind, idx)
    assert eng.cache == "hit"
    assert idx._bwt is None and "bwt" in idx._lazy
    assert idx._sa_samples is None and "sa_samples" in idx._lazy
    assert isinstance(layout_cache.load_array(prefix, kind, {})[0],
                      np.memmap)
    codes, rlens = sample_reads(idx)
    for a, b in zip(eng.seed_reads(codes, rlens),
                    first.seed_reads(codes, rlens)):
        np.testing.assert_array_equal(a, b)
    rows = np.arange(1, idx.seq_len, 7, dtype=np.int64)
    np.testing.assert_array_equal(eng.locate(rows), first.locate(rows))


def _stale_intv(prefix, kind):
    arr, h = read_cache(prefix, kind)
    meta = {k: h[k] for k in ("seq_len", "ref_off", "sad_off")}
    layout_cache.save_array(prefix, kind, arr, dict(meta, sa_intv=12))


def _other_seq_len(prefix, kind):
    arr, h = read_cache(prefix, kind)
    meta = {k: h[k] for k in ("sa_intv", "ref_off", "sad_off")}
    layout_cache.save_array(prefix, kind, arr,
                            dict(meta, seq_len=h["seq_len"] + 2))


def _truncated(prefix, kind):
    path = f"{prefix}.{kind}"
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 4)


@pytest.mark.parametrize("spoil", [_stale_intv, _other_seq_len, _truncated],
                         ids=["stale_sa_intv", "changed_seq_len",
                              "truncated"])
def test_spoiled_sidecar_is_a_miss_and_rewritten(spoil, golden_dir,
                                                 tmp_path):
    """A sidecar of another sampling interval or text length, or one cut
    short, is a miss: the table is built again, equal to the first, and
    the file is written again, byte-equal to the first."""
    prefix = copy_index(golden_dir, tmp_path)
    first = port_engine(prefix, "wtab")
    good = open(prefix + ".wtab", "rb").read()
    spoil(prefix, "wtab")
    assert open(prefix + ".wtab", "rb").read() != good
    eng = port_engine(prefix, "wtab")
    assert eng.cache == "miss"
    np.testing.assert_array_equal(host_table(eng), host_table(first))
    assert open(prefix + ".wtab", "rb").read() == good
    assert port_engine(prefix, "wtab").cache == "hit"


def test_wtab2_is_repacked_from_wtab(golden_dir, tmp_path):
    """With only ``.wtab`` there, the index=2 table is repacked from it,
    reading no ``.bwt``: rows and offsets equal to a build for two
    shards, and ``.wtab2`` saved byte-equal to dart_tpu's repack."""
    prefix = copy_index(golden_dir, tmp_path / "port")
    port_engine(prefix, "wtab")
    idx = load_index(prefix)
    tabs = layout.tables_from_index(idx, wide=True, index_shards=2)
    assert tabs["cache"] == "repack" and idx._bwt is None
    want, ref_off, sad_off = layout.build_merged_table_wide(idx, 2)
    assert (tabs["ref_off"], tabs["sad_off"]) == (ref_off, sad_off)
    np.testing.assert_array_equal(tabs["table"], want)
    ref = copy_index(golden_dir, tmp_path / "jax")
    jax_engine(ref, "wtab")
    jax_engine(ref, "wtab2")
    assert open(prefix + ".wtab2", "rb").read() == \
        open(ref + ".wtab2", "rb").read()
    assert port_engine(prefix, "wtab2").cache == "hit"


def test_golden_cold_and_warm(golden_dir, data_dir, tmp_path):
    """Golden c3 through ``dart-tpu-torch --device cpu``: the first run
    writes ``.ntab``, the second reads it; both SAMs and junction tables
    equal the golden."""
    prefix = copy_index(golden_dir, tmp_path)
    for run in ("cold", "warm"):
        assert os.path.exists(prefix + ".ntab") == (run == "warm")
        sam, tab = tmp_path / f"{run}.sam", tmp_path / f"{run}.tab"
        assert cli.main(["-i", prefix, "-f", str(data_dir / "spliced.fa"),
                         "-o", str(sam), "-j", str(tab), "-t", "1",
                         "-silent", "--device", "cpu"]) == 0
        assert sam.read_bytes() == (golden_dir / "c3_spliced.sam").read_bytes()
        assert tab.read_bytes() == \
            (golden_dir / "c3_spliced.junctions.tab").read_bytes()
