"""The CUDA kernels of dart_tpu_torch on the card, held exactly against
their plain PyTorch versions on the same device tensors (narrow and
wide, with and without the K-mer table; the MEM walk, staged and in
place; the gap DP; and each of them again through the range-sharded
table access of
``--mesh ...,index=N``), and a golden config aligned on the card by the
port's ``DartAligner``, on one engine and on a device grid. Marked ``cuda``: they skip without a CUDA device. On a
machine with one: ``pytest -m cuda tests/test_torch_cuda.py``.
"""

import copy
import io
import random

import numpy as np
import pytest
import torch

from dart_tpu.ops.nw_numpy import nw_align
from dart_tpu_torch.aligner import DartAligner
from dart_tpu_torch.config import DartConfig
from dart_tpu_torch.ops import nw_torch
from dart_tpu_torch.ops.fm_torch import FMIndexTorch, pack_codes
from dart_tpu_torch.ops.layout import ShardedTable
from dart_tpu_torch.ops.nw_plain import nw_plain

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def gpu_engine(toy_index):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return FMIndexTorch(toy_index, device="cuda")


def test_locate_kernel_equals_plain(gpu_engine, toy_index):
    rows = torch.arange(toy_index.seq_len, dtype=torch.int32, device="cuda")
    got = gpu_engine.locate_rows(rows)
    torch.testing.assert_close(got, gpu_engine.plain_locate(rows),
                               rtol=0, atol=0)
    assert gpu_engine.n_locate_launches == 1


def _packed_reads(toy_index):
    rng = np.random.default_rng(4)
    R, L = 512, 100
    starts = rng.integers(0, toy_index.seq_len - L, R)
    codes = np.stack([toy_index.ref_codes[p:p + L] for p in starts])
    mut = rng.random((R, L)) < 0.03
    codes = np.where(mut, rng.integers(0, 5, (R, L)), codes).astype(np.uint8)
    rlens = np.full(R, L, dtype=np.int32)
    rlens[::9] = rng.integers(0, 14, len(rlens[::9]))
    buf, nmask, Lp = pack_codes(codes, rlens)
    words = Lp // 16
    t = torch.from_numpy(np.concatenate(
        [buf[:, :words], nmask, buf[:, words:]], axis=1).view(np.int32)).cuda()
    return t, words, FMIndexTorch.seed_slots(Lp, L)


def test_seed_scan_kernel_equals_plain(gpu_engine, toy_index):
    t, words, S = _packed_reads(toy_index)
    got = gpu_engine.seed_scan(t, words, S)
    torch.testing.assert_close(got, gpu_engine.plain_seed_scan(t, words, S),
                               rtol=0, atol=0)
    assert gpu_engine.n_seed_launches == 1


def test_golden_on_card(gpu_engine, toy_index, data_dir, golden_dir,
                        tmp_path, capsys):
    cfg = DartConfig()
    cfg.read_files_1 = [str(data_dir / "spliced_mm.fq")]
    cfg.max_mismatch = 5
    cfg.find_all_junction = True
    cfg.sj_file = str(tmp_path / "o.tab")
    cfg.output_file = str(tmp_path / "o.sam")
    cfg.silent = True
    engine = FMIndexTorch(toy_index, device="cuda")
    out = io.StringIO()
    DartAligner(toy_index, cfg, engine=engine).run(out_stream=out)
    assert out.getvalue() == (golden_dir / "c4_spliced_mm.sam").read_text()
    assert (tmp_path / "o.tab").read_text() == \
        (golden_dir / "c4_spliced_mm.junctions.tab").read_text()
    # every seed of this set is found by locate-and-compare inside the
    # scan, so no SA rows are left for the locate kernel
    assert engine.n_seed_launches == 1 and engine.n_locate_launches == 0


@pytest.fixture(scope="module")
def gpu_engines(gpu_engine, toy_index):
    """Narrow and wide engines with the K = 11 table (built on the card
    at construction), and a wide one without."""
    return {"narrow_lut": FMIndexTorch(toy_index, "cuda", lut_k=11),
            "wide_lut": FMIndexTorch(toy_index, "cuda", lut_k=11, wide=True),
            "wide": FMIndexTorch(toy_index, "cuda", wide=True)}


@pytest.mark.parametrize("which", ["narrow_lut", "wide_lut"])
def test_lut_build_kernel_equals_plain(which, gpu_engines):
    """K3 (narrow) and K6 (wide): the whole K = 11 table, exactly, in two
    launches (the subtrees' roots, then the subtrees)."""
    eng = gpu_engines[which]
    assert eng.n_lut_launches == 2
    torch.testing.assert_close(eng.lut, eng.plain_build_lut(), rtol=0,
                               atol=0)
    assert eng.lut.dtype == (torch.int64 if eng.wide else torch.int32)


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("k", [1, 4, 5, 8, 12])
def test_lut_build_kernel_at_other_k(k, wide, gpu_engine, toy_index):
    """K3 / K6 at K = 1 (the roots alone, one launch), fewer levels than
    a warp expands (4), one-base roots (5), dead entries (8) and a
    table past K = 11 (12), exactly."""
    eng = FMIndexTorch(toy_index, "cuda", lut_k=k, wide=wide)
    assert eng.n_lut_launches == (2 if k > 1 else 1)
    torch.testing.assert_close(eng.lut, eng.plain_build_lut(), rtol=0,
                               atol=0)


@pytest.mark.parametrize("which", ["narrow_lut", "wide_lut", "wide"])
def test_seed_scan_kernels_equal_plain(which, gpu_engines, gpu_engine,
                                       toy_index):
    """K1 with the table, and K4 with and without it."""
    eng = gpu_engines[which]
    t, words, S = _packed_reads(toy_index)
    got = eng.seed_scan(t, words, S)
    torch.testing.assert_close(got, eng.plain_seed_scan(t, words, S),
                               rtol=0, atol=0)
    narrow = gpu_engine.plain_seed_scan(t, words, S)
    torch.testing.assert_close(got.long(), narrow.long(), rtol=0, atol=0)


def shift_samples(eng, delta: int) -> FMIndexTorch:
    """A shallow copy of ``eng`` whose table's SA samples are all
    ``delta`` larger ([lo x8 | hi x8] rows from sad_off on), sharded as
    ``eng``'s is."""
    out = copy.copy(eng)
    tab = (torch.cat([t.cpu() for t in eng.table.shards]) if eng.sharded
           else eng.table.cpu().clone())
    s = tab[eng.sad_off:].numpy().view(np.uint32)
    v = (s[:, :8].astype(np.uint64) | (s[:, 8:].astype(np.uint64) << 32))
    v += np.uint64(delta)
    s[:, :8] = (v & 0xFFFFFFFF).astype(np.uint32)
    s[:, 8:] = (v >> np.uint64(32)).astype(np.uint32)
    if eng.sharded:
        n = eng.table.rows
        out.table = ShardedTable([tab[i * n:(i + 1) * n].to(t.device)
                                  for i, t in enumerate(eng.table.shards)])
    else:
        out.table = tab.to(eng.table.device)
    return out


def test_wide_locate_kernel_carries_64_bits(gpu_engines, toy_index):
    """K5 on every row, then on a copy of the table with 2^33 added to
    every SA sample: the kernel, like its plain version, returns every
    position shifted by exactly 2^33."""
    eng = gpu_engines["wide"]
    rows = torch.arange(toy_index.seq_len, dtype=torch.int64, device="cuda")
    base = eng.locate_rows(rows)
    torch.testing.assert_close(base, eng.plain_locate(rows), rtol=0, atol=0)
    shifted = shift_samples(eng, 2**33)
    got = shifted.locate_rows(rows)
    torch.testing.assert_close(got, base + 2**33, rtol=0, atol=0)
    torch.testing.assert_close(got, shifted.plain_locate(rows), rtol=0,
                               atol=0)


@pytest.fixture(scope="module")
def every12_index(tmp_path_factory, data_dir):
    """The toy genome indexed by the port's builder with SA samples every
    12 rows: not a power of two, so the locate walks on the division
    grid."""
    from dart_tpu_torch.index import build_index, load_index

    prefix = str(tmp_path_factory.mktemp("every12") / "toy")
    build_index(str(data_dir / "toy.fa"), prefix, sad_intv=12)
    return load_index(prefix)


def locate_row_set(idx, kind: str) -> np.ndarray:
    """65,536 random rows, or runs of consecutive rows k0 .. k0 + freq - 1
    (freq 2 .. 100, one across the primary row) as the main path's
    occurrence expansion hands them to the locate."""
    rng = np.random.default_rng(8)
    if kind == "random":
        return rng.integers(0, idx.seq_len + 1, 65536)
    runs = [np.arange(idx.primary - 3, idx.primary + 4)]
    for f in (2, 3, 5, 10, 20, 50, 100) * 4:
        k0 = int(rng.integers(0, idx.seq_len + 1 - f))
        runs.append(np.arange(k0, k0 + f))
    return np.concatenate(runs)


@pytest.mark.parametrize("kind", ["random", "runs"])
@pytest.mark.parametrize("which", ["toy", "every12"])
@pytest.mark.parametrize("shards", [1, 3], ids=["flat", "index3"])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_locate_kernel_rows_and_grids(wide, shards, which, kind, gpu_engine,
                                      toy_index, every12_index):
    """K2 / K5, Flat and Sharded, on 65,536 random rows and on repeat
    runs, on the toy index (samples every 32 rows: the mask-and-shift
    grid) and every 12 rows (the division grid): equal to the plain
    version, one launch counting its rows."""
    idx = toy_index if which == "toy" else every12_index
    eng = (FMIndexTorch(idx, "cuda", wide=wide) if shards == 1
           else sharded_engine(idx, shards, wide=wide))
    assert eng.sa_intv == (32 if which == "toy" else 12)
    rows = locate_row_set(idx, kind)
    t = torch.from_numpy(rows.astype(np.int64 if wide else np.int32)).cuda()
    got = eng.locate_rows(t)
    torch.testing.assert_close(got, eng.plain_locate(t), rtol=0, atol=0)
    assert eng.n_locate_launches == 1 and eng.n_locate_rows == len(rows)


WALK_CASES = {"l64": (11, 1500, 64), "l1": (21, 300, 1),
              "l33": (22, 300, 33), "w257": (23, 257, 64)}


def padded_walks(c, v, Lc: int = 1536):
    """The tasks padded with invalid columns past the kernel's staging
    budget (1,520 bases): the same walks, read in place."""
    cp = torch.full((c.shape[0], Lc), 4, dtype=torch.uint8, device=c.device)
    vp = torch.zeros((c.shape[0], Lc), dtype=torch.bool, device=c.device)
    cp[:, :c.shape[1]] = c
    vp[:, :c.shape[1]] = v
    return cp, vp


@pytest.mark.parametrize("shards", [1, 2, 3], ids=["flat", "index2",
                                                   "index3"])
@pytest.mark.parametrize("branch", ["staged", "inplace"])
@pytest.mark.parametrize("case", list(WALK_CASES))
def test_mem_walks_kernel_branches_and_edges(case, branch, shards,
                                             gpu_engine, toy_index):
    """K8 on the tasks of ``test_torch_memwalks.walk_tasks`` (N bases,
    invalid tails, a first base invalid or N) at L = 64, 1 and 33 (odd)
    and W = 257 (not a whole block), staged in shared memory or, padded
    past the staging budget, read in place; Flat and Sharded at index=2
    and 3: equal to the plain version, one launch."""
    from test_torch_memwalks import walk_tasks

    seed, W, L = WALK_CASES[case]
    chars, valid = walk_tasks(toy_index, seed, W=W, L=L)
    c, v = torch.from_numpy(chars).cuda(), torch.from_numpy(valid).cuda()
    want = gpu_engine.plain_mem_walks(c, v)
    if branch == "inplace":
        c, v = padded_walks(c, v)
    eng = (FMIndexTorch(toy_index, "cuda") if shards == 1
           else sharded_engine(toy_index, shards))
    for g, w in zip(eng.mem_walk_rows(c, v), want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    sfx = "" if shards == 1 else "_sharded"
    assert eng.launches[f"mem_walks{sfx}"] == 1


def test_seed_scan_kernels_read_long_reads_in_place(gpu_engines, toy_index):
    """K1 with and without the K = 11 table and K4 with it on reads of
    1,000 to 65,535 bases (0.2% substitutions), past the size at which
    a block's reads fit its shared memory, so read in place: equal to
    the plain scan (run on the CPU, which the card runs no faster), with
    seeds past read position 32,768."""
    from test_torch_scan_source import long_reads

    codes, rlens = long_reads(toy_index, lens=(1000, 4000, 65535),
                              rate=0.002)
    buf, nmask, Lp = pack_codes(codes, rlens)
    words = Lp // 16
    t = torch.from_numpy(np.concatenate(
        [buf[:, :words], nmask, buf[:, words:]], axis=1).view(np.int32))
    S = FMIndexTorch.seed_slots(Lp, int(rlens.max()))
    want = FMIndexTorch(toy_index, "cpu").plain_seed_scan(t, words, S)
    assert int(want[2, 1:1 + S].max()) > 32768
    t = t.cuda()
    nolut = copy.copy(gpu_engines["narrow_lut"])
    nolut.lut, nolut.lut_k = None, 0
    for eng in (gpu_engines["narrow_lut"], nolut, gpu_engines["wide_lut"]):
        got = eng.seed_scan(t, words, S).cpu()
        torch.testing.assert_close(got.long(), want.long(), rtol=0, atol=0)


def test_mem_walks_kernel_equals_plain(gpu_engine, toy_index):
    """K8 on a task from every genome position, 64 bases, with 1%
    substitutions and N bases and the genome's end as invalid tails."""
    G, L = toy_index.genome_size, 64
    codes = np.concatenate([toy_index.ref_codes[:G], np.full(L, 4, np.uint8)])
    chars = np.lib.stride_tricks.sliding_window_view(codes, L)[:G]
    rng = np.random.default_rng(5)
    mut = rng.random(chars.shape) < 0.01
    chars = np.where(mut, rng.integers(0, 5, chars.shape), chars)
    valid = np.arange(L)[None, :] < (G - np.arange(G))[:, None]
    c = torch.from_numpy(chars.astype(np.uint8)).cuda()
    v = torch.from_numpy(valid).cuda()
    n0 = gpu_engine.n_mem_walks_launches
    got = gpu_engine.mem_walk_rows(c, v)
    for g, w in zip(got, gpu_engine.plain_mem_walks(c, v)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert gpu_engine.n_mem_walks_launches == n0 + 1


def test_nw_kernel_equals_plain(gpu_engine):
    """K7 on pairs of 0..127 bases a side (127 x 127 among them), N and
    lower case: planes word for word, and the aligned strings equal the
    host C++ DP."""
    rng = random.Random(9)
    pairs = [(b"", b"ACG"), (b"A" * 127, b"ACGTN" * 25 + b"ac")]
    for _ in range(254):
        m, k = rng.randrange(128), rng.randrange(128)
        s1 = "".join(rng.choice("ACGTNacgt") for _ in range(m)).encode()
        s2 = "".join(rng.choice("ACGTNacgt") for _ in range(k)).encode()
        pairs.append((s1, s2))
    c1, c2, mn = (torch.from_numpy(a).cuda()
                  for a in nw_torch.pack_pairs(pairs))
    n0 = nw_torch.launches["nw"]
    got = nw_torch.nw_planes(c1, c2, mn)
    torch.testing.assert_close(got, nw_plain(c1, c2, mn), rtol=0, atol=0)
    assert nw_torch.launches["nw"] == n0 + 1
    assert nw_torch.nw_align_batch(pairs, "cuda") == \
        [nw_align(s1, s2) for s1, s2 in pairs]


# ---- the Sharded table access (--mesh ...,index=N) ----


def sharded_engine(idx, n: int, **kw) -> FMIndexTorch:
    """An engine whose table is range-sharded over n slots of the card
    (separate allocations), read by the ``*_sharded`` kernels."""
    eng = FMIndexTorch(idx, "cuda", shard_devices=["cuda"] * n, **kw)
    assert eng.sharded and len(eng.table.shards) == n
    return eng


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("n", [2, 3])
def test_sharded_locate_kernels_equal_plain(n, wide, gpu_engine, toy_index):
    """K2 / K5 through the sharded access, on every toy row: equal to
    the plain version over the same ``ShardedTable`` and to the flat
    kernel."""
    eng = sharded_engine(toy_index, n, wide=wide)
    dt = torch.int64 if wide else torch.int32
    rows = torch.arange(toy_index.seq_len, dtype=dt, device="cuda")
    got = eng.locate_rows(rows)
    torch.testing.assert_close(got, eng.plain_locate(rows), rtol=0, atol=0)
    flat = FMIndexTorch(toy_index, "cuda", wide=wide)
    torch.testing.assert_close(got, flat.locate_rows(rows), rtol=0, atol=0)
    sfx = "_wide" if wide else ""
    assert eng.launches[f"locate{sfx}_sharded"] == 1


@pytest.mark.parametrize("wide", [False, True])
def test_sharded_seed_scan_and_lut_kernels_equal_plain(wide, gpu_engine,
                                                       toy_index):
    """K1 / K4 with the K = 11 table and K3 / K6 through the sharded
    access at index=3 (boundaries in the Occ and genome rows): equal to
    the plain versions and to the flat kernels."""
    eng = sharded_engine(toy_index, 3, lut_k=11, wide=wide)
    flat = FMIndexTorch(toy_index, "cuda", lut_k=11, wide=wide)
    torch.testing.assert_close(eng.lut, eng.plain_build_lut(), rtol=0,
                               atol=0)
    torch.testing.assert_close(eng.lut, flat.lut, rtol=0, atol=0)
    t, words, S = _packed_reads(toy_index)
    got = eng.seed_scan(t, words, S)
    torch.testing.assert_close(got, eng.plain_seed_scan(t, words, S),
                               rtol=0, atol=0)
    torch.testing.assert_close(got, flat.seed_scan(t, words, S), rtol=0,
                               atol=0)
    sfx = "_wide" if wide else ""
    assert eng.launches == {f"seed_scan{sfx}_sharded": 1,
                            f"locate{sfx}_sharded": 0,
                            f"lut_build{sfx}_sharded": 2,
                            **({} if wide else {"mem_walks_sharded": 0})}


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_mem_walks_kernel_equals_plain(n, gpu_engine, toy_index):
    """K8 through the sharded access at index=2 and 3, on a 64-base task
    from every genome position."""
    eng = sharded_engine(toy_index, n)
    G, L = toy_index.genome_size, 64
    codes = np.concatenate([toy_index.ref_codes[:G], np.full(L, 4, np.uint8)])
    chars = torch.from_numpy(
        np.lib.stride_tricks.sliding_window_view(codes, L)[:G].copy()).cuda()
    valid = torch.from_numpy(
        np.arange(L)[None, :] < (G - np.arange(G))[:, None]).cuda()
    got = eng.mem_walk_rows(chars, valid)
    for g, p, f in zip(got, eng.plain_mem_walks(chars, valid),
                       gpu_engine.mem_walk_rows(chars, valid)):
        torch.testing.assert_close(g, p, rtol=0, atol=0)
        torch.testing.assert_close(g, f, rtol=0, atol=0)
    assert eng.launches["mem_walks_sharded"] == 1


def test_sharded_locate_kernel_reads_a_swapped_table(gpu_engine, toy_index):
    """K5 through the sharded access at index=3, launched once, then on
    a copy of the table with 2^33 added to every SA sample: the copy's
    launch reads the copy's shards (every position shifted by exactly
    2^33), and the first engine still reads its own."""
    eng = sharded_engine(toy_index, 3, wide=True)
    rows = torch.arange(toy_index.seq_len, dtype=torch.int64, device="cuda")
    base = eng.locate_rows(rows)
    shifted = shift_samples(eng, 2**33)
    got = shifted.locate_rows(rows)
    torch.testing.assert_close(got, base + 2**33, rtol=0, atol=0)
    torch.testing.assert_close(got, shifted.plain_locate(rows), rtol=0,
                               atol=0)
    torch.testing.assert_close(eng.locate_rows(rows), base, rtol=0, atol=0)


def test_golden_on_card_mesh(gpu_engine, toy_index, data_dir, golden_dir,
                             tmp_path):
    """A golden config through the (data=2, index=2) grid on the card,
    both data groups launching the sharded kernels."""
    from dart_tpu_torch.parallel.mesh import ShardedFMIndexTorch, make_mesh

    cfg = DartConfig()
    cfg.read_files_1 = [str(data_dir / "spliced_mm.fq")]
    cfg.max_mismatch = 5
    cfg.find_all_junction = True
    cfg.sj_file = str(tmp_path / "o.tab")
    cfg.output_file = str(tmp_path / "o.sam")
    cfg.silent = True
    engine = ShardedFMIndexTorch(toy_index, make_mesh(4, 2, "cuda"),
                                 lut_k=11)
    out = io.StringIO()
    DartAligner(toy_index, cfg, engine=engine).run(out_stream=out)
    assert out.getvalue() == (golden_dir / "c4_spliced_mm.sam").read_text()
    assert (tmp_path / "o.tab").read_text() == \
        (golden_dir / "c4_spliced_mm.junctions.tab").read_text()
    assert all(s["seed_scan_sharded"] >= 1 and s["lut_build_sharded"] == 2
               for s in engine.slot_launches)
