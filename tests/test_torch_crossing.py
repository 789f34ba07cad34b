"""The checks of ``chip_smoke.py --big`` (``dart_tpu_torch.crossing``),
which the card runs once on a genome whose fwd+rc text passes 2^31
positions, run here on a copy of the toy index with the wide engine on
the CPU, the layout cache's threshold patched to 0 and the halves of
the text standing in for the two sides of 2^31; and each check shown to
fail on a wrong answer. Then BASELINE config 5's shape at toy scale:
``write_spliced_genome``'s genome, and the config-5 checks (whole set,
stream, crash and resume, two processes, ``-max_intron``) on a 1.5 Mbp
long-intron index with the wide engine forced and the layout cache hit,
each shown to fail on a wrong output."""

import os
import random
import shutil
import sys

import numpy as np
import pytest
import torch

from dart_tpu_torch import benchdata, crossing
from dart_tpu_torch.index import build_index, layout_cache, load_index
from dart_tpu_torch.ops.fm_torch import FMIndexTorch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


# ---- BASELINE config 5's shape (crossing.write_spliced_genome and the
# config-5 checks) at toy scale: a 1.5 Mbp long-intron genome, 300
# spliced pairs, the wide engine forced and the layout cache hit

LI_BANDS = ((0.75, 60, 8_000), (0.20, 120_000, 450_000),
            (0.05, 520_000, 900_000))
N_LI_PAIRS = 300
N_HEAD = 60  # the head pairs: held to the CPU path, and the stream's file
STREAM = ("--batch", "64")  # two chunks a file of the head pairs
N_FILES = 4  # the crash is in the fourth file


def test_spliced_genome(tmp_path):
    """Deterministic; GT..AG at every intron's ends; genes inside their
    chromosomes; introns in all three bands; chrDup its source span."""
    sys.path.insert(0, REPO)
    import chip_smoke

    outs = []
    for k in range(2):
        fa, txt = str(tmp_path / f"g{k}.fa"), str(tmp_path / f"g{k}.txt")
        info = crossing.write_spliced_genome(fa, txt, 0.004, n_chrom=2,
                                             dup_bp=300_000)
        outs.append((open(fa, "rb").read(), open(txt, "rb").read(), info))
    assert outs[0] == outs[1]
    assert all(n > 0 for n in info["introns"]), info
    seqs = chip_smoke.read_genome(str(tmp_path / "g0.fa"))
    genes = chip_smoke.read_genes(str(tmp_path / "g0.txt"))
    assert len(genes) == info["genes"] and set(seqs) == {"chr1", "chr2",
                                                         "chrDup"}
    assert crossing.intron_bands(genes) == info["introns"]
    for chrom, exs in genes:
        assert 0 < exs[0][0] and exs[-1][1] <= len(seqs[chrom])
        assert all(a < b for a, b in exs)
        for (_, a), (b, _) in zip(exs, exs[1:]):
            assert seqs[chrom][a:a + 2] == "GT" and seqs[chrom][b - 2:b] == "AG"
    assert seqs["chrDup"] == seqs["chr1"][:300_000]
    # the bases are write_genome's where no motif was stamped
    crossing.write_genome(str(tmp_path / "plain.fa"), 0.004)
    plain = chip_smoke.read_genome(str(tmp_path / "plain.fa"))
    diff = sum(a != b for a, b in zip(plain["chr1"], seqs["chr1"]))
    assert 0 < diff <= 4 * sum(len(e) - 1 for c, e in genes if c == "chr1")


@pytest.fixture(scope="module")
def li(tmp_path_factory):
    """The toy long-intron index (its layout cache hit by the wide
    engine, CACHE_MIN_SEQ patched to 0), its pairs and (a)'s run."""
    sys.path.insert(0, REPO)
    import chip_smoke

    d = tmp_path_factory.mktemp("config5")
    fa, prefix = str(d / "genome.fa"), str(d / "idx")
    crossing.write_spliced_genome(fa, str(d / "genes.txt"), 0.0015,
                                  n_chrom=1, dup_bp=200_000,
                                  genes_per_mbp=10, bands=LI_BANDS)
    build_index(fa, prefix)
    r1, r2 = chip_smoke.spliced_pair_set(
        random.Random(11), chip_smoke.read_genome(fa, skip="chrDup"),
        chip_smoke.read_genes(str(d / "genes.txt")), N_LI_PAIRS, 100)
    mf = benchdata
    fqs = (str(d / "r1.fq"), str(d / "r2.fq"))
    mf.write_reads_fastq(fqs[0], r1)
    mf.write_reads_fastq(fqs[1], r2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layout_cache, "CACHE_MIN_SEQ", 0)
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        idx = load_index(prefix)
        crossing.check_cache(idx, "cpu", lut_k=0)  # writes .wtab
        out = str(d / "out")
        a = crossing.check_config5(idx, prefix, *fqs, out, "cpu", N_HEAD,
                                   wide=True, split=idx.seq_len // 2)
        yield {"idx": idx, "prefix": prefix, "fqs": fqs, "out": out, "a": a,
               "dir": d}
        torch.set_num_threads(n)


def test_config5_whole_set(li):
    a = li["a"]["whole"]
    assert a["cache"] == "hit" and a["wide"] and a["reads"] == 2 * N_LI_PAIRS
    c = a["counts"]
    assert c["spliced"] > 0 and c["rc_past"] > 0 and c["rows"] > 0
    heads = li["a"]["heads"]
    assert heads["cpu"]["reads"] == 2 * N_HEAD


def test_config5_stream_and_resume(li):
    """The head pairs (the plain CPU path costs ~0.6 s a chunk) as
    N_FILES pairs of files, held to their one-file run in (a)."""
    idx, out = li["idx"], li["out"]
    heads = crossing.head_pairs(*li["fqs"], N_HEAD, out)
    one = li["a"]["heads"]["device"]["files"]
    b = crossing.check_config5_stream(idx, li["prefix"], *heads, out, "cpu",
                                      N_FILES, one, wide=True, extra=STREAM)
    assert b["chunks"] == 2 * N_FILES and b["stream_reads"] == \
        2 * N_HEAD * N_FILES
    c = crossing.check_config5_resume(
        idx, li["prefix"], *heads, out, "cpu", N_FILES, b["engine"],
        b["reads_per_file"], b["files"], extra=STREAM, lag_batch=32)
    assert c["c0"]["file"] == 3 and c["c0"]["redone"] == 0
    assert c["c2"]["redone"] >= 2


def test_config5_two_processes(li):
    res = crossing.check_two_processes(li["prefix"], *li["fqs"], li["out"],
                                       "cpu", li["a"]["whole"]["files"],
                                       threads=1)
    assert len(res["engines"]) == 2


def test_config5_max_intron(li):
    a = li["a"]["whole"]
    heads = crossing.head_pairs(*li["fqs"], N_HEAD, li["out"])
    e = crossing.check_max_intron(li["idx"], li["prefix"], *li["fqs"],
                                  li["out"], "cpu", heads, a["files"],
                                  wide=True)
    bands = crossing.check_bands({0: a["counts"],
                                  **{mi: r["counts"] for mi, r in e.items()}})
    assert bands[0]["100k_500k"] > 0 and bands[1_000_000]["gt500k"] > 0


def _wrong_tab(files, d) -> tuple:
    """files with one junction row's count changed, copied under d."""
    bam, tab = (str(d / f"wrong.{ext}") for ext in ("bam", "tab"))
    shutil.copy(files[0], bam)
    rows = open(files[1]).read().splitlines()
    c, a, b, n = rows[0].split("\t")
    rows[0] = "\t".join((c, a, b, str(int(n) + 1)))
    with open(tab, "w") as f:
        f.write("\n".join(rows) + "\n")
    return bam, tab


@pytest.mark.parametrize("check", ["heads", "stream", "resume", "two",
                                   "max_intron", "bands"])
def test_config5_checks_catch_a_wrong_output(check, li, tmp_path):
    """A wrong output (a junction count changed, a CPU head's row, a
    flag that changes nothing, an N past what -max_intron allows) makes
    each config-5 check raise."""
    idx, prefix, fqs = li["idx"], li["prefix"], li["fqs"]
    a = li["a"]["whole"]["files"]
    out = str(tmp_path)
    heads = crossing.head_pairs(*fqs, N_HEAD, out)
    one = li["a"]["heads"]["device"]["files"]
    wrong = _wrong_tab(one if check in ("stream", "resume") else a, tmp_path)
    with pytest.raises(AssertionError):
        if check == "heads":
            real = crossing.align_pairs

            def off(*args, **kw):  # the CPU path's head, one count off
                r = real(*args, **kw)
                if args[5].endswith("_head_cpu"):
                    _wrong_tab(r["files"], tmp_path)
                    shutil.copy(tmp_path / "wrong.tab", r["files"][1])
                return r

            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(crossing, "align_pairs", off)
                crossing.held_to_cpu(idx, prefix, heads, out, "w", "cpu",
                                     wide=True)
        elif check == "stream":
            crossing.check_config5_stream(idx, prefix, *heads, out, "cpu", 1,
                                          wrong, wide=True, extra=STREAM)
        elif check == "resume":
            b = crossing.check_config5_stream(idx, prefix, *heads, out, "cpu",
                                              1, one, wide=True, extra=STREAM)
            crossing.check_config5_resume(
                idx, prefix, *heads, out, "cpu", 1, b["engine"],
                b["reads_per_file"], wrong, extra=STREAM, lag_batch=32,
                at=(0, 2))
        elif check == "two":
            crossing.check_two_processes(prefix, *fqs, out, "cpu", wrong,
                                         threads=1)
        elif check == "max_intron":  # the base is the flag's own output
            first = crossing.check_max_intron(idx, prefix, *fqs, out, "cpu",
                                              heads, a, (100_000,), wide=True)
            crossing.check_max_intron(idx, prefix, *fqs, out, "cpu", heads,
                                      first[100_000]["files"], (100_000,),
                                      wide=True)
        else:
            c = crossing.aln_counts(*a)
            crossing.check_bands({100_000: c})
