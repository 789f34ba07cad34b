"""A toy configuration, mixes, cells and a metric added to a temporary
copy as files and entries, found by name and run end to end on the
CPU (the harness's look for a card skipped)."""

import json

import pytest

import benchtoy
from benchmark import harness

SEED = 2**31 + 101


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return benchtoy.make_root(str(tmp_path_factory.mktemp("toy")))


@pytest.mark.parametrize("cell", list(benchtoy.CELLS))
def test_a_toy_cell_runs_correct(root, cell):
    res = harness.run_cell(root, cell, SEED, 0.5, False, "cpu")
    assert res["correct"], res["checks"]
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "builds", "checks"]
    assert set(res["builds"]) <= set(harness.BUILDS)
    assert set(res["metrics"]) == {"reads_per_s", "placed_pct", "setup_s"}
    assert res["attempted"] % (2 * 1024) == 0 and res["failed"] == 0
    assert 80 < res["metrics"]["placed_pct"]["value"] <= 100
    assert res["device"]["platform"] == "cpu"
    json.dumps(res)


def test_the_traced_run_reads_the_toy_metric(root):
    res = harness.run_cell(root, "toy_pe_bam", SEED + 1, 0.5, True, "cpu")
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert got["toy_chunks"]["value"] >= 2
    # every per-layer metric that names the toy cell, but those the CPU
    # cannot give: no card, no device operation in the trace
    bench = harness.Cell(root, "toy_pe_bam").bench
    assert "output_us_per_read" not in got  # names chr21_pe_bam alone
    assert "kernel_ms_per_mread" not in got
    assert list(res)[-1] == "checks" and "breakdown" in res
    assert {m["name"] for m in bench["per_layer"]} >= set(got)


def test_the_same_seed_gives_the_same_work(root):
    a = harness.run_cell(root, "toy_pe_sam", SEED + 2, 0.5, False, "cpu")
    b = harness.run_cell(root, "toy_pe_sam", SEED + 2, 0.5, False, "cpu")
    assert a["metrics"]["placed_pct"] == b["metrics"]["placed_pct"]


def test_a_cell_that_is_not_there(root):
    with pytest.raises(SystemExit):
        harness.Cell(root, "no_such_cell")
