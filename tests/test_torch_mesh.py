"""The port's device grid (``dart_tpu_torch.parallel.mesh``) on the CPU,
where every slot is the CPU and the engines run the plain PyTorch
versions over a range-sharded table (``layout.ShardedTable``): held
exactly against the single-device engine ``FMIndexTorch`` and against
``dart_tpu``'s GSPMD engines on the 8 virtual CPU devices of
``conftest.py`` (``ShardedFMIndex``, ``FMIndexJaxWide(index_mesh=...)``);
the shard-padded tables byte-equal to ``dart_tpu``'s; and the toy-scale
part of ``dryrun_multichip``."""

import ctypes

import numpy as np
import pytest
import torch

from dart_tpu.config import DartConfig
from dart_tpu.ops import fm_jax, fm_jax_wide
from dart_tpu_torch.aligner import make_engine
from dart_tpu_torch.ops import layout
from dart_tpu_torch.ops.fm_torch import FMIndexTorch
from dart_tpu_torch.parallel.mesh import (ShardedFMIndexTorch, make_mesh,
                                          parse_mesh)

from test_torch_lut import assert_same_seeds, read_mix

# (data, index) grids of the checks against dart_tpu; index=3 does not
# divide the toy table's rows, so its last shard ends in padding
GRIDS = [(2, 1), (2, 2), (1, 3)]
# shard counts whose boundaries, together, fall inside the Occ rows,
# the genome rows and the sample rows of the toy table
REGION_SHARDS = {False: (2, 3, 7), True: (2, 3, 4)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain kernels run many small ops; with the test workers
    sharing the cores, more intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_mesh(data: int, index: int):
    import jax

    from dart_tpu.parallel.mesh import make_mesh as jax_make_mesh

    if len(jax.devices("cpu")) < data * index:
        pytest.skip("needs the virtual CPU devices of conftest.py")
    return jax_make_mesh(data * index, index_shards=index, backend="cpu")


def region(tabs, row: int) -> str:
    if row < tabs["ref_off"]:
        return "occ"
    return "genome" if row < tabs["sad_off"] else "samples"


def boundary_reads(idx, n_shards: int, wide: bool):
    """Exact 100-base reads across the text positions where a shard
    boundary splits the genome rows: their compare windows read genome
    words from both sides of it."""
    tabs = layout.tables_from_index(idx, wide=wide, index_shards=n_shards)
    rows = tabs["table"].shape[0] // n_shards
    per_row = 256 if wide else 128
    codes = []
    for s in range(1, n_shards):
        if region(tabs, s * rows) == "genome":
            g = (s * rows - tabs["ref_off"]) * per_row
            for back in (40, 57, 90):
                lo = min(max(g - back, 0), idx.seq_len - 100)
                codes.append(idx.ref_codes[lo:lo + 100])
    return np.array(codes, dtype=np.uint8).reshape(-1, 100)


def test_parse_and_make_mesh():
    assert parse_mesh("") == (1, 1)
    assert parse_mesh("data=4") == (4, 1)
    assert parse_mesh("data=2,index=3") == (2, 3)
    cpu = torch.device("cpu")
    assert make_mesh(4, 2, "cpu") == [[cpu, cpu], [cpu, cpu]]
    assert make_mesh(3, 3, "cpu") == [[cpu, cpu, cpu]]
    with pytest.raises(ValueError):
        make_mesh(3, 2, "cpu")


@pytest.mark.parametrize("wide", [False, True])
def test_shard_tables_equal_dart_tpu(wide, toy_index):
    """The shard-padded tables, narrow and wide, byte-equal to
    ``build_merged_table(..., index_shards)`` and
    ``build_merged_table_wide(idx, n)`` with the same offsets; the
    engine's shards are those tables cut in equal row ranges; and the
    boundaries fall inside every region of the table."""
    idx = toy_index
    regions = set()
    for n in (1, *REGION_SHARDS[wide]):
        tabs = layout.tables_from_index(idx, wide=wide, index_shards=n)
        if wide:
            want = fm_jax_wide.build_merged_table_wide(idx, n)
        else:
            samples = (idx.sad_samples if idx.sad_intv
                       else idx.sa_samples).astype(np.int32)
            want = fm_jax.build_merged_table(
                idx, fm_jax.build_device_layout(idx), samples, n)
        assert tabs["table"].tobytes() == want[0].tobytes()
        assert (tabs["ref_off"], tabs["sad_off"]) == want[1:]
        assert tabs["table"].shape[0] % n == 0
        if n == 1:
            continue
        eng = FMIndexTorch(idx, "cpu", wide=wide, shard_devices=["cpu"] * n)
        shards = eng.table.shards
        assert len(shards) == n and eng.table.shape == tabs["table"].shape
        assert len({t.data_ptr() for t in shards}) == n
        assert b"".join(t.numpy().tobytes() for t in shards) == \
            want[0].tobytes()
        rows = tabs["table"].shape[0] // n
        regions |= {region(tabs, s * rows) for s in range(1, n)}
    assert regions == {"occ", "genome", "samples"}


def test_sharded_table_gathers_rows(toy_index):
    """``ShardedTable[rows]`` returns the flat table's rows in order,
    rows on both sides of each boundary among them, and refuses rows
    outside the table."""
    tabs = layout.tables_from_index(toy_index, index_shards=3)
    flat = torch.from_numpy(tabs["table"].view(np.int32))
    sharded = layout.to_device(tabs, "cpu", ["cpu"] * 3)["table"]
    n = flat.shape[0]
    rng = np.random.default_rng(7)
    rows = torch.from_numpy(np.concatenate(
        [rng.integers(0, n, 500), [0, n // 3 - 1, n // 3, 2 * n // 3,
                                   n - 1]]))
    assert torch.equal(sharded[rows], flat[rows])
    assert sharded[rows[:0]].shape == (0, 8)
    for bad in (-1, n):
        with pytest.raises(IndexError):
            sharded[torch.tensor([bad])]


def test_sharded_addresses_follow_the_table(toy_index):
    """The address array that the sharded kernels are given names the
    shards the engine holds at that launch: after the table is swapped
    for a copy, the copy's shards, not the old ones."""
    eng = FMIndexTorch(toy_index, "cpu", shard_devices=["cpu"] * 3)

    def bases() -> list:
        ptr, rows = eng._tab
        assert rows == eng.table.rows
        return list((ctypes.c_int64 * 3).from_address(ptr))

    assert bases() == [t.data_ptr() for t in eng.table.shards]
    eng.table = layout.ShardedTable([t.clone() for t in eng.table.shards])
    assert bases() == [t.data_ptr() for t in eng.table.shards]


def locate_rows(idx):
    """Every sampled row (each SA sample read once, no LF step), 300
    random rows and the rows around the primary one."""
    rng = np.random.default_rng(2)
    p = idx.primary
    return np.concatenate([np.arange(0, idx.seq_len, idx.sa_intv),
                           rng.integers(1, idx.seq_len, 300),
                           [0, p - 1, p, p + 1]]).astype(np.int64)


def scan_reads(idx, wide: bool):
    """The read mix of the wide or the narrow checks, and exact reads
    across every genome-row boundary of ``REGION_SHARDS``."""
    codes, rlens = read_mix("wide" if wide else "ops", idx)
    codes, rlens = codes[:32], rlens[:32]
    b = np.concatenate([boundary_reads(idx, n, wide)
                        for n in REGION_SHARDS[wide]])
    return (np.concatenate([codes, b]),
            np.concatenate([rlens, np.full(len(b), 100, np.int32)]))


def single_results(idx, wide: bool) -> dict:
    """The single-device engine's results on the shared inputs, by
    lut_k (0 and 4): seeds; and with lut_k 0, locates and (narrow) MEM
    walks."""
    codes, rlens = scan_reads(idx, wide)
    out = {k: {"seeds": FMIndexTorch(idx, "cpu", lut_k=k, wide=wide)
               .seed_reads(codes, rlens)} for k in (0, 4)}
    eng = FMIndexTorch(idx, "cpu", wide=wide)
    out[0]["locate"] = eng.locate(locate_rows(idx))
    if not wide:
        out[0]["walks"] = eng.mem_walks(*walk_tasks(idx))
    return out


@pytest.fixture(scope="module")
def single(toy_index):
    return single_results(toy_index, wide=False)


def walk_tasks(idx):
    codes, _ = read_mix("ops", idx)
    chars = codes[:, :48].copy()
    valid = np.ones_like(chars, dtype=bool)
    valid[::5, 30:] = False
    chars[::7, 0] = 4
    return chars, valid


@pytest.mark.parametrize("data,index", GRIDS)
def test_sharded_engine_equals_single_and_dart_tpu(data, index, toy_index,
                                                   single):
    """Seed scans (no K-mer table, and K = 4), locates and MEM walks on
    the grid equal ``FMIndexTorch``'s and ``dart_tpu``'s
    ``ShardedFMIndex``'s on the same grid (with K = 4 at data=2,
    index=2, where the table is built from a sharded table)."""
    from dart_tpu.parallel.mesh import ShardedFMIndex

    idx = toy_index
    jmesh = jax_mesh(data, index)
    codes, rlens = scan_reads(idx, False)
    rows = locate_rows(idx)
    chars, valid = walk_tasks(idx)
    for k in (0, 4):
        eng = ShardedFMIndexTorch(idx, make_mesh(data * index, index, "cpu"),
                                  lut_k=k)
        assert eng.shape == {"data": data, "index": index}
        assert len(eng.groups) == data
        assert eng.groups[0].sharded == (index > 1)
        got = eng.seed_reads(codes, rlens)
        assert_same_seeds(got, single[k]["seeds"])
        if k and index == 1:
            continue
        jx = ShardedFMIndex(idx, jmesh, lut_k=k)
        assert_same_seeds(got, jx.seed_reads(codes, rlens))
        if k:
            continue
        loc = eng.locate(rows)
        assert loc.dtype == np.int64
        np.testing.assert_array_equal(loc, single[0]["locate"])
        np.testing.assert_array_equal(loc, jx.locate(rows))
        walks = eng.mem_walks(chars, valid)
        for g, s, j in zip(walks, single[0]["walks"],
                           jx.mem_walks(chars, valid)):
            np.testing.assert_array_equal(g, s)
            np.testing.assert_array_equal(g, np.asarray(j))


def test_boundaries_in_every_region(toy_index, single):
    """At 7 index shards, whose boundaries cut the Occ, genome and
    sample rows, the sharded engine's seed scans (reads across every
    genome boundary of ``REGION_SHARDS`` among them) and locates equal
    the single engine's."""
    idx = toy_index
    n = REGION_SHARDS[False][-1]
    eng = ShardedFMIndexTorch(idx, make_mesh(n, n, "cpu"))
    np.testing.assert_array_equal(eng.locate(locate_rows(idx)),
                                  single[0]["locate"])
    assert_same_seeds(eng.seed_reads(*scan_reads(idx, False)),
                      single[0]["seeds"])


def test_data_split_keeps_order_and_empty_slices(toy_index, single):
    """A chunk of fewer reads than data groups leaves slices empty; the
    joined output keeps the single engine's order and shapes (a read's
    seeds do not depend on the other reads of its chunk)."""
    idx = toy_index
    eng = ShardedFMIndexTorch(idx, make_mesh(3, 1, "cpu"))
    codes, rlens = scan_reads(idx, False)
    want = single[0]
    assert_same_seeds(eng.seed_reads(codes[:0], rlens[:0]),
                      FMIndexTorch(idx, "cpu").seed_reads(codes[:0],
                                                          rlens[:0]))
    for R in (1, 5):  # the same seed slots as the whole chunk's
        got = eng.seed_reads(codes[:R], rlens[:R])
        assert_same_seeds(got, [w[:R] for w in want["seeds"]])
    rows = locate_rows(idx)
    for n in (0, 1, 2, 7):
        got = eng.locate(rows[:n])
        assert got.shape == (n,) and got.dtype == np.int64
        np.testing.assert_array_equal(got, want["locate"][:n])
    chars, valid = walk_tasks(idx)
    for W in (1, 2):
        for g, w in zip(eng.mem_walks(chars[:W], valid[:W]), want["walks"]):
            np.testing.assert_array_equal(g, w[:W])
    assert eng.launches == {"seed_scan": 0, "locate": 0, "lut_build": 0,
                            "mem_walks": 0}


def test_make_engine_takes_the_mesh(toy_index):
    """``--mesh`` above 1 on either axis makes ``make_engine`` build the
    sharded engine, narrow or wide as the index asks; no mesh, or a
    1 x 1 one, the single engine."""
    cfg = DartConfig()
    assert isinstance(make_engine(toy_index, cfg, "cpu"), FMIndexTorch)
    cfg.mesh = "data=1,index=1"
    assert isinstance(make_engine(toy_index, cfg, "cpu"), FMIndexTorch)
    cfg.mesh = "data=2,index=2"
    eng = make_engine(toy_index, cfg, "cpu")
    assert isinstance(eng, ShardedFMIndexTorch) and not eng.wide
    assert eng.shape == {"data": 2, "index": 2}
    assert not hasattr(eng, "seed_drain")
    cfg.mesh = "index=2"
    eng = make_engine(toy_index, cfg, "cpu", wide=True)
    assert eng.wide and eng.shape == {"data": 1, "index": 2}


def test_cuda_mesh_without_a_card_raises(toy_index):
    """``--mesh`` on ``cuda`` never places slots on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(2, 1, "cuda")
    cfg = DartConfig()
    cfg.mesh = "data=2"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine(toy_index, cfg, "cuda")


def test_dryrun_toy_part_on_cpu(capsys):
    """``dryrun_multichip``'s toy-scale part over four CPU slots."""
    from dart_tpu_torch.entry import dryrun_toy

    res = dryrun_toy(4, "cpu")
    assert res["mesh"] == {"data": 2, "index": 2}
    assert res["seeds"] >= 32 and res["accepted"] > 0
    assert set(res["launches"]) == {"seed_scan_sharded", "locate_sharded",
                                    "lut_build_sharded", "mem_walks_sharded"}
    assert "dryrun_multichip ok" in capsys.readouterr().out
