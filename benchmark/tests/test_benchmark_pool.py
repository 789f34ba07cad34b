"""The pool of reads: decided by ``--seed`` alone, each read where its
name and origin say."""

import numpy as np
import pytest

import benchtoy  # noqa: F401  (puts the repo on the path)
from benchmark import genomes, reads

GENOME = genomes.make_genome(benchtoy.TOY["genome"])
MIX = dict(benchtoy.MIX, file_fragments=256)


def files_bytes(tmp_path, seed, mix=MIX):
    pool = reads.make_pool(GENOME, mix, seed)
    out = []
    for pair in reads.write_files(pool, mix, str(tmp_path)):
        for p in pair:
            if p:
                with open(p, "rb") as f:
                    out.append(f.read())
    return pool, out


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 2**40 + 3])
def test_the_same_seed_gives_the_same_files(tmp_path, seed):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    _, a = files_bytes(tmp_path / "a", seed)
    _, b = files_bytes(tmp_path / "b", seed)
    assert a == b
    _, c = files_bytes(tmp_path / "a", seed + 1)
    assert a != c


def test_the_genome_is_the_configurations_own():
    again = genomes.make_genome(benchtoy.TOY["genome"])
    for name in GENOME.names:
        assert np.array_equal(GENOME.seqs[name], again.seqs[name])
    assert again.genes == GENOME.genes and again.digest == GENOME.digest
    dup = GENOME.seqs["chrDup"]
    assert np.array_equal(dup, GENOME.seqs["chrT"][:dup.shape[0]])
    for chrom, exs in GENOME.genes:
        seq = GENOME.seqs[chrom]
        for (_, a), (b, _) in zip(exs, exs[1:]):
            assert bytes(seq[a:a + 2]) == b"GT" and bytes(seq[b - 2:b]) \
                == b"AG"


def test_reads_lie_at_their_origin(tmp_path):
    pool, _ = files_bytes(tmp_path, 11)
    comp = reads.COMP
    assert pool.spliced.sum() == round(pool.n * MIX["spliced_share"])
    names = pool.names()
    assert names.shape == (pool.n, reads.NAME_LEN)
    for i in range(pool.n):
        name = bytes(names[i]).decode()
        assert name.startswith(f"r{i:09d}_")
        a, b = (int(x) for x in name.split("_")[1:])
        assert (a, b) == tuple(pool.frag[i])
        if pool.spliced[i]:
            continue
        seq = GENOME.seqs[GENOME.names[pool.chrom[i]]]
        for m in range(2):
            lo, hi = pool.left[i, m], pool.right[i, m]
            assert hi - lo + 1 == MIX["read_len"]
            ref = seq[lo - 1:hi]
            got = pool.seq[m][i]
            diffs = min((got != ref).sum(), (got != comp[ref[::-1]]).sum())
            assert diffs <= 6


def test_spliced_reads_cross_their_genes_introns(tmp_path):
    pool, _ = files_bytes(tmp_path, 12)
    s = np.flatnonzero(pool.spliced)
    span = pool.right[s] - pool.left[s] + 1
    assert (span >= MIX["read_len"]).all()
    assert (span > MIX["read_len"]).any()


def test_fasta_and_gzip_files(tmp_path):
    mix = dict(MIX, paired=False, format="fasta", gzip=True, gzip_level=1)
    pool, data = files_bytes(tmp_path, 13, mix)
    import gzip

    text = gzip.decompress(data[0])
    lines = text.split(b"\n")
    assert lines[0][:1] == b">" and len(lines[1]) == mix["read_len"]
    assert len(lines) - 1 == 2 * mix["file_fragments"]


def test_intron_lengths_follow_their_law():
    law = {"median": 1023, "mean": 3365, "least": 60, "most": 499999}
    x = genomes.intron_lengths(np.random.default_rng(3), 100000, law)
    assert x.min() >= law["least"] and x.max() <= law["most"]
    # truncation below 60 raises the median and mean a little
    assert 1000 < np.median(x) < 1200 and 3200 < x.mean() < 3700
