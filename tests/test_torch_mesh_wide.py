"""The port's device grid with the wide (int64) engine on the CPU: held
exactly against ``dart_tpu``'s ``FMIndexJaxWide(index_mesh=...)`` on the
8 virtual CPU devices of ``conftest.py`` and against the port's single
wide engine, at shard counts whose boundaries fall inside every region
of the wide table (``test_torch_mesh`` has the narrow engine)."""

import numpy as np
import pytest

from dart_tpu.ops import fm_jax_wide
from dart_tpu_torch.ops import layout
from dart_tpu_torch.parallel.mesh import ShardedFMIndexTorch, make_mesh

from test_torch_lut import assert_same_seeds
from test_torch_mesh import (REGION_SHARDS, jax_mesh, locate_rows,
                             scan_reads, single_results)
from test_torch_mesh import one_torch_thread  # noqa: F401 (autouse here too)


@pytest.fixture(scope="module")
def single(toy_index):
    return single_results(toy_index, wide=True)


@pytest.mark.parametrize("k", [0, 4])
def test_wide_sharded_engine_equals_dart_tpu(k, toy_index, single):
    """The wide engine at data=2, index=2 equals ``FMIndexJaxWide`` on
    the same grid (K-mer table of K = 0 and 4) and the port's single
    wide engine."""
    idx = toy_index
    jx = fm_jax_wide.FMIndexJaxWide(idx, index_mesh=jax_mesh(2, 2), lut_k=k)
    eng = ShardedFMIndexTorch(idx, make_mesh(4, 2, "cpu"), lut_k=k,
                              wide=True)
    assert eng.wide and eng.groups[1].table.shards[0].shape[1] == 16
    assert set(eng.launches) == {"seed_scan_wide_sharded",
                                 "locate_wide_sharded",
                                 "lut_build_wide_sharded"}
    codes, rlens = scan_reads(idx, True)
    got = eng.seed_reads(codes, rlens)
    assert_same_seeds(got, jx.seed_reads(codes, rlens))
    assert_same_seeds(got, single[k]["seeds"])
    if k == 0:
        rows = locate_rows(idx)
        loc = eng.locate(rows)
        np.testing.assert_array_equal(loc, jx.locate(rows))
        np.testing.assert_array_equal(loc, single[0]["locate"])


def test_wide_boundaries_in_every_region(toy_index, single):
    """At 4 index shards, whose boundaries cut the wide table's Occ,
    genome and sample rows (its padding moves ``ref_off`` and
    ``sad_off``), seed scans across every genome boundary and locates
    equal the single wide engine's."""
    idx = toy_index
    n = REGION_SHARDS[True][-1]
    eng = ShardedFMIndexTorch(idx, make_mesh(n, n, "cpu"), wide=True)
    flat = layout.tables_from_index(idx, wide=True)
    g = eng.groups[0]
    assert g.ref_off == flat["ref_off"] + 1
    assert g.sad_off == flat["sad_off"] + 1
    np.testing.assert_array_equal(eng.locate(locate_rows(idx)),
                                  single[0]["locate"])
    assert_same_seeds(eng.seed_reads(*scan_reads(idx, True)),
                      single[0]["seeds"])
