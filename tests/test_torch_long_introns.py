"""Long introns, where ``-max_intron`` bites, through the port's main path
on the CPU: its ``DartAligner`` on ``FMIndexTorch(idx, "cpu")`` held
byte-equal (SAM, BAM and ``junctions.tab``, tolerance zero) to
``dart_tpu``'s aligner on its NumPy engine in every case, and on its JAX
engine (JAX on the CPU) in the default and ``-max_intron 100000`` cases.

The genome is ``crossing.write_spliced_genome`` at 1.5 Mbp, one
chromosome whose genes have introns of 60-8,000 bases, 120,000-450,000
bases and 520,000-900,000 bases, plus ``chrDup``, a copy of its first
200,000 bases (so that ``-all_sj`` and ``-m`` change the outputs),
indexed with the port's builder. The reads are 300 pairs of
``chip_smoke.spliced_pair_set`` (70% genomic, 30% cut from transcripts,
0.5% mismatches) and 300 single-end reads of the same mix, ``-mis 5``.
Each flag must change the output, and the CIGARs' ``N`` lengths must
keep to what ``-max_intron`` allows (``crossing.check_bands``): none
past 500,000 bases at the default, some at 1,000,000, none past 100,000
at 100,000."""

import contextlib
import io
import os
import random
import sys

import pytest
import torch

import dart_tpu.aligner
import dart_tpu.cli
import dart_tpu.index
from dart_tpu_torch import benchdata, cli, crossing
from dart_tpu_torch.aligner import DartAligner
from dart_tpu_torch.index import build_index, load_index
from dart_tpu_torch.ops.fm_torch import FMIndexTorch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (its generators; it refuses JAX only when run)

GBP = 0.0015
GENES_PER_MBP = 10
DUP_BP = 200_000
BANDS = ((0.75, 60, 8_000), (0.20, 120_000, 450_000),
         (0.05, 520_000, 900_000))
N_PAIRS = N_SE = 300
SEED = 20261018
MIS = ["-mis", "5"]

# case -> (input, flags, the dart_tpu engines it is held to, -max_intron)
CASES = {
    "default": ("pe", [], ("numpy", "jax"), 0),
    "max_intron_100k": ("pe", ["-max_intron", "100000"], ("numpy", "jax"),
                        100_000),
    "max_intron_1m": ("pe", ["-max_intron", "1000000"], ("numpy",),
                      1_000_000),
    "all_sj_m": ("pe", ["-all_sj", "-m"], ("numpy",), 0),
    "wide": ("pe", [], ("numpy",), 0),
    "bam": ("pe", [], ("numpy",), 0),
    "no_native": ("pe", ["--no-native"], ("numpy",), 0),
    "stream": ("pe3", ["--batch", "64", "--checkpoint"], ("numpy",), 0),
    "se_default": ("se", [], ("numpy",), 0),
    "se_max_intron_100k": ("se", ["-max_intron", "100000"], ("numpy",),
                           100_000),
    "se_max_intron_1m": ("se", ["-max_intron", "1000000"], ("numpy",),
                         1_000_000),
}
# a flag's case, and the case without the flag its output must differ from
DIFFERS = {"max_intron_100k": "default", "max_intron_1m": "default",
           "all_sj_m": "default", "se_max_intron_100k": "se_default",
           "se_max_intron_1m": "se_default"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """The long-intron genome: its FASTA, genes, index prefix, what
    write_spliced_genome returned, the index as the port and dart_tpu
    load it, and the directory."""
    d = tmp_path_factory.mktemp("long_introns")
    fa, genes_txt, prefix = str(d / "genome.fa"), str(d / "genes.txt"), \
        str(d / "idx")
    info = crossing.write_spliced_genome(
        fa, genes_txt, GBP, n_chrom=1, dup_bp=DUP_BP,
        genes_per_mbp=GENES_PER_MBP, bands=BANDS)
    build_index(fa, prefix)
    return {"fa": fa, "genes": chip_smoke.read_genes(genes_txt),
            "prefix": prefix, "info": info, "port": load_index(prefix),
            "ref": dart_tpu.index.load_index(prefix), "dir": d}


@pytest.fixture(scope="module")
def inputs(genome):
    """Each input's read flags: the pairs, the pairs as three pairs of
    files, the single-end reads."""
    genes, d = genome["genes"], genome["dir"]
    mf = benchdata
    seqs = chip_smoke.read_genome(genome["fa"], skip="chrDup")
    rng = random.Random(SEED)
    r1, r2 = chip_smoke.spliced_pair_set(rng, seqs, genes, N_PAIRS, 100)
    n_sp = N_SE * 3 // 10
    se = mf.sim_reads_genomic(rng, seqs, N_SE - n_sp, 100, 0.005, tag="g")
    se += mf.sim_reads_spliced(rng, "chr1", seqs["chr1"],
                               [exs for _, exs in genes], n_sp, 100, 0.005,
                               tag="s")
    rng.shuffle(se)
    p = {k: str(d / k) for k in ("r1.fq", "r2.fq", "se.fq")}
    mf.write_reads_fastq(p["r1.fq"], r1)
    mf.write_reads_fastq(p["r2.fq"], r2)
    mf.write_reads_fastq(p["se.fq"], se)
    thirds = []
    for i in range(3):
        cut = slice(i * N_PAIRS // 3, (i + 1) * N_PAIRS // 3)
        for mates, m in ((r1, 1), (r2, 2)):
            mf.write_reads_fastq(str(d / f"part{i}_{m}.fq"), mates[cut])
        thirds += ["-f", str(d / f"part{i}_1.fq"), "-f2",
                   str(d / f"part{i}_2.fq")]
    return {"pe": ["-f", p["r1.fq"], "-f2", p["r2.fq"]], "pe3": thirds,
            "se": ["-f", p["se.fq"]]}


@pytest.fixture(scope="module")
def runs(genome, inputs):
    """run(case, who) -> (alignment bytes, junction table bytes, path of
    the alignments), each aligned once: who is "port" (the port on the
    CPU), "numpy" or "jax" (dart_tpu's engines)."""
    prefix, port_idx, ref_idx, d = (genome[k] for k in ("prefix", "port",
                                                         "ref", "dir"))
    done = {}

    def run(case, who):
        if (case, who) in done:
            return done[case, who]
        reads, flags = CASES[case][:2]
        out = d / f"{case}.{who}"
        aln = f"{out}.{'bam' if case == 'bam' else 'sam'}"
        argv = ["-i", prefix, *inputs[reads], *MIS, *flags,
                "-bo" if case == "bam" else "-o", aln, "-j", f"{out}.tab",
                "-silent"]
        with contextlib.redirect_stdout(io.StringIO()):
            if who == "port":
                aligner = DartAligner(port_idx, cli.parse_args(argv),
                                      engine=FMIndexTorch(
                                          port_idx, "cpu",
                                          wide=case == "wide"))
            else:
                cfg = dart_tpu.cli.parse_args(argv)
                cfg.engine = who
                aligner = dart_tpu.aligner.DartAligner(ref_idx, cfg)
            aligner.run()
        done[case, who] = (open(aln, "rb").read(),
                           open(f"{out}.tab", "rb").read(), aln)
        return done[case, who]

    return run


def test_genome_has_long_introns(genome):
    """The genes, their motifs and chrDup are as the runs need them."""
    genes, info = genome["genes"], genome["info"]
    assert info["introns"][1] >= 3 and info["introns"][2] >= 1, info
    assert {c for c, _ in genes} == {"chr1"}
    seqs = chip_smoke.read_genome(genome["fa"])
    assert seqs["chrDup"] == seqs["chr1"][:DUP_BP]
    for _, exs in genes:
        for (_, a), (b, _) in zip(exs, exs[1:]):
            assert seqs["chr1"][a:a + 2] + seqs["chr1"][b - 2:b] == "GTAG"


@pytest.mark.parametrize("case", list(CASES))
def test_port_equals_dart_tpu_on_long_introns(case, runs):
    port = runs(case, "port")
    for who in CASES[case][2]:
        ref = runs(case, who)
        assert port[0] == ref[0], f"{case}: alignments differ from {who}"
        assert port[1] == ref[1], f"{case}: junction table differs from {who}"
    if case in ("wide", "stream"):  # the same run as the default's
        assert port[:2] == runs("default", "port")[:2]
    counts = crossing.aln_counts(port[2], port[2].rsplit(".", 1)[0] + ".tab")
    assert counts["spliced"] > 0 and counts["unmapped"] < counts["records"]
    crossing.check_bands({CASES[case][3]: counts})
    if case in DIFFERS:
        assert port[0] != runs(DIFFERS[case], "port")[0], \
            f"{case} changed nothing"


@pytest.mark.parametrize("reads", ["pe", "se"])
def test_max_intron_bites_on_planted_introns(reads, runs, genome):
    """-max_intron 100000 drops the junctions of the 120-450 kb introns,
    the default finds them and none past 500,000, 1,000,000 finds those
    too; the N bands of the three runs keep to the flag."""
    genes = genome["genes"]
    pre = "" if reads == "pe" else "se_"
    tags = {0: f"{pre}default", 100_000: f"{pre}max_intron_100k",
            1_000_000: f"{pre}max_intron_1m"}
    found, counts = {}, {}
    for mi, case in tags.items():
        aln = runs(case, "port")[2]
        tab = aln.rsplit(".", 1)[0] + ".tab"
        found[mi] = crossing.planted_found(tab, genes, BANDS)
        counts[mi] = crossing.aln_counts(aln, tab)
    crossing.check_bands(counts)
    assert found[0][1] > 0 and found[0][2] == 0, found
    assert found[100_000][1] == found[100_000][2] == 0, found
    assert found[1_000_000][1] > 0 and found[1_000_000][2] > 0, found
