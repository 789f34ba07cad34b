"""The reference against the timed path broken underneath: each fault
planted where the output is produced, and the control, make ``correct``
false on a toy run; a sound run of the same seed is correct."""

import pytest

import benchtoy
from benchmark import faults, harness

SEED = 2**33 + 7
# which of the compared numbers each fault must move
MOVES = {
    "ungapped": ("nm_off_ppm", "sj_rows_off"),
    "moved": ("nm_off_ppm", "mates_wrong"),
    "cigar": ("nm_off_ppm",),
    "seq": ("records_wrong",),
    "half": ("reads_missing",),
    "unmapped": ("unplaced_pct", "sj_rows_off"),
    "nm0": ("nm_off_ppm",),
    "row": ("sj_rows_off",),
    "table": ("sj_rows_off",),
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return benchtoy.make_root(str(tmp_path_factory.mktemp("faults")))


def values(res):
    return {k: c["value"] for k, c in res["checks"].items()}


@pytest.fixture(scope="module")
def sound(root):
    res = harness.run_cell(root, "toy_pe_sam", SEED, 0.5, False, "cpu")
    assert res["correct"], res["checks"]
    return values(res)


@pytest.mark.parametrize("fault", faults.NAMES)
def test_a_fault_makes_the_run_incorrect(root, sound, fault):
    res = harness.run_cell(root, "toy_pe_sam", SEED, 0.5, False, "cpu",
                           fault)
    assert not res["correct"]
    got = values(res)
    for k in MOVES[fault]:
        assert got[k] > res["checks"][k]["limit"] >= sound[k], (fault, k)


@pytest.mark.parametrize("fault", ["moved", "ungapped", "unmapped"])
def test_bam_output_is_judged_too(root, fault):
    res = harness.run_cell(root, "toy_pe_bam", SEED, 0.5, False, "cpu",
                           fault)
    assert not res["correct"]
    k = MOVES[fault][0]
    assert values(res)[k] > res["checks"][k]["limit"]


def test_the_control_on_single_reads(root):
    res = harness.run_cell(root, "toy_se_gz", SEED, 0.5, False, "cpu",
                           "ungapped")
    assert not res["correct"]
