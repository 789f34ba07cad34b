"""The checks of ``chip_smoke.py --big`` (``dart_tpu_torch.crossing``),
which the card runs once on a genome whose fwd+rc text passes 2^31
positions, run here on a copy of the toy index with the wide engine on
the CPU, the layout cache's threshold patched to 0 and the halves of
the text standing in for the two sides of 2^31; and each check shown to
fail on a wrong answer."""

import shutil

import numpy as np
import pytest
import torch

from dart_tpu_torch import crossing
from dart_tpu_torch.index import layout_cache, load_index
from dart_tpu_torch.ops.fm_torch import FMIndexTorch


@pytest.fixture(scope="module")
def big(golden_dir, tmp_path_factory):
    """(prefix, index, engine that hit the cache, CPU oracle) after
    ``check_cache`` on a copy of the toy index."""
    d = tmp_path_factory.mktemp("crossing")
    for f in (golden_dir / "index").iterdir():
        if f.name.startswith("toy."):
            shutil.copy(f, d / f.name)
    prefix = str(d / "toy")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layout_cache, "CACHE_MIN_SEQ", 0)
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        idx = load_index(prefix)
        eng, info = crossing.check_cache(idx, "cpu", lut_k=4)
        oracle = FMIndexTorch(idx, "cpu", wide=True)
        yield prefix, idx, eng, oracle, info
        torch.set_num_threads(n)


def test_cache_misses_then_hits(big):
    prefix, idx, eng, _, info = big
    assert eng.cache == "hit" and eng.wide and eng.lut_k == 4
    assert info["wtab_bytes"] > info["table_bytes"]
    assert set(info["miss_s"]) == set(info["hit_s"]) == {"table", "lut"}


def test_locate_on_both_sides(big):
    _, idx, eng, oracle, _ = big
    res = crossing.check_locate(eng, oracle, idx, 512, seed=7,
                                split=idx.seq_len // 2)
    assert res["rows_above"] == 256 and res["on_grid"] >= 128
    assert res["positions_above"] > 0


def test_seed_scan_on_both_strands(big):
    _, idx, eng, oracle, _ = big
    res = crossing.check_seed_scan(eng, oracle, idx, 256, 64, seed=8,
                                   split=idx.seq_len // 2)
    assert res["seeds"] > 256 and res["positions_above"] > 0


def test_aligner_pairs_bam(big, data_dir, tmp_path):
    prefix = big[0]
    res = crossing.check_aligner(prefix, str(data_dir / "pe_1.fq"),
                                 str(data_dir / "pe_2.fq"), str(tmp_path),
                                 "cpu")
    assert res["bam_bytes"] > 0 and set(res["wall_s"]) == {"device", "cpu"}
    # [stats] gives the mapping wall to 0.01 s, inside the run's wall
    assert all(0 <= res["mapping_s"][k] <= res["wall_s"][k] + 0.01
               for k in ("device", "cpu")), res


def test_sharded_repacks_from_wtab(big):
    res = crossing.check_sharded(big[0], "cpu", min_gib=0)
    assert res["cache"] == "repack" and res["single_cache"] == "hit"
    assert res["seeds"] > 0


class _Off:
    """An engine whose locate is one position off."""

    def __init__(self, eng):
        self.eng = eng

    def locate(self, rows):
        return self.eng.locate(rows) + 1

    def seed_reads(self, codes, rlens):
        n, rpos, slen, k0, freq = self.eng.seed_reads(codes, rlens)
        return n, rpos, slen, np.where(freq < 0, k0 + 1, k0), freq

    def __getattr__(self, name):
        return getattr(self.eng, name)


@pytest.mark.parametrize("wrong", ["engine", "oracle"])
def test_checks_catch_a_wrong_position(wrong, big):
    """A locate or a seed scan one position off, on the checked engine or
    on the oracle, fails the check."""
    _, idx, eng, oracle, _ = big
    if wrong == "engine":
        eng = _Off(eng)
    else:
        oracle = _Off(oracle)
    with pytest.raises(AssertionError, match="differs"):
        crossing.check_locate(eng, oracle, idx, 64, seed=9,
                              split=idx.seq_len // 2)
    with pytest.raises(AssertionError, match="differs|is not its bases"):
        crossing.check_seed_scan(eng, oracle, idx, 32, 32, seed=10,
                                 split=idx.seq_len // 2)
