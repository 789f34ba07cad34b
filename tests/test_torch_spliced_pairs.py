"""Spliced paired-end reads, mates that cross an intron, through the
port's main path on the CPU: its ``DartAligner`` on ``FMIndexTorch(idx,
"cpu")`` held byte-equal (SAM, BAM and ``junctions.tab``, tolerance
zero) to ``dart_tpu``'s aligner on its NumPy engine in every case, and
on its JAX engine (JAX on the CPU) in the default, ``-mis 5`` and
``--no-native`` cases.

The input is ``chip_smoke.spliced_pair_set``, the generator the card's
``[spliced]`` phase runs at 50,000 pairs: here 200 pairs on the toy
genome and its planted genes (``tests/data/toy_genes.txt``), 70% genomic
and 30% cut from transcripts, 0.5% mismatches. ``-all_sj`` and ``-m``
run on a second index built with the port's builder: the toy genome
plus chrA from its start to past its third gene as a third chromosome,
so that the pairs from those genes map twice and the flags change the
outputs. ``-max_dup 10000`` runs for parity only: the flag is clamped
to 100-10,000 and changes only seeds that occur more than 100 times,
and no seed of these genomes does. A flag's case asserts that its
output differs from the ``-mis 5`` run on the same index, so that a
flag that tests nothing shows. The stage timers of ``DartAligner`` are
held to its wall on the pairs and on a multi-file single-end stream."""

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
from dart_tpu_torch import benchdata, cli, spans
from dart_tpu_torch.aligner import DartAligner
from dart_tpu_torch.index import build_index, load_index
from dart_tpu_torch.ops.fm_torch import FMIndexTorch
from test_torch_distributed import run_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (its generators; it refuses JAX only when run)

N_PAIRS = 200
SEED = 20261017
DUP_GENES = 3  # chrA's first genes, copied into chrDup
BATCH = 128  # the -mis 5 run's chunk: four chunks, two through the prefetch
STAGE_SLACK_S = 0.05  # timer calls outside the four stages
# the main thread's stages (the finalize worker's native_finalize_s is
# held to the wall on its own)
STAGES = ("input_parse_s", "device_seed_locate_s", "finalize_wait_s",
          "output_s")

# case -> (index, input, flags, the dart_tpu engines it is held to)
CASES = {
    "default": ("toy", "pe", [], ("numpy", "jax")),
    "mis5": ("toy", "pe", ["-mis", "5"], ("numpy", "jax")),
    "dup_mis5": ("dup", "pe", ["-mis", "5"], ("numpy",)),
    "all_sj": ("dup", "pe", ["-mis", "5", "-all_sj"], ("numpy",)),
    "multi": ("dup", "pe", ["-mis", "5", "-m"], ("numpy",)),
    "min_intron": ("toy", "pe", ["-mis", "5", "-min_intron", "1000"],
                   ("numpy",)),
    "max_dup": ("toy", "pe", ["-mis", "5", "-max_dup", "10000"],
                ("numpy",)),
    "no_native": ("toy", "pe", ["-mis", "5", "--no-native"],
                  ("numpy", "jax")),
    "bam": ("toy", "pe", ["-mis", "5"], ("numpy",)),
    "interleaved": ("toy", "inter", ["-mis", "5"], ("numpy",)),
    "gzip": ("toy", "gz", ["-mis", "5"], ("numpy",)),
}
# a flag's case, and the case on the same index its output must differ
# from; the part that must differ (0: alignments, 1: junction table)
DIFFERS = {"default": ("mis5", 0), "all_sj": ("dup_mis5", 1),
           "multi": ("dup_mis5", 0), "min_intron": ("mis5", None)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain kernels run many small ops; with the test workers
    sharing the cores, more intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("spliced_pairs")


@pytest.fixture(scope="module")
def inputs(work, data_dir):
    """The pairs as two FASTQ files, the same gzipped, and interleaved:
    each input's flags."""
    mf = benchdata
    genome = chip_smoke.read_genome(str(data_dir / "toy.fa"))
    genes = chip_smoke.read_genes(str(data_dir / "toy_genes.txt"))
    r1, r2 = chip_smoke.spliced_pair_set(random.Random(SEED), genome, genes,
                                         N_PAIRS, 100)
    p = {k: str(work / k) for k in ("r1.fq", "r2.fq", "r1.fq.gz",
                                    "r2.fq.gz", "inter.fq")}
    for mates, name in ((r1, "r1"), (r2, "r2")):
        mf.write_reads_fastq(p[f"{name}.fq"], mates)
        mf.write_reads_fastq(p[f"{name}.fq.gz"], mates, gz=True)
    mf.write_reads_fastq(p["inter.fq"], [r for ab in zip(r1, r2) for r in ab])
    return {"pe": ["-f", p["r1.fq"], "-f2", p["r2.fq"]],
            "gz": ["-f", p["r1.fq.gz"], "-f2", p["r2.fq.gz"]],
            "inter": ["-f", p["inter.fq"], "-p"],
            "se": [p["r1.fq"]]}


@pytest.fixture(scope="module")
def indexes(work, data_dir, golden_dir):
    """Each index's prefix and its loads by the port and by dart_tpu:
    the toy index, and the toy genome with chrA's first DUP_GENES genes
    copied into chrDup (built with the port's builder)."""
    mf = benchdata
    genome = chip_smoke.read_genome(str(data_dir / "toy.fa"))
    genes = chip_smoke.read_genes(str(data_dir / "toy_genes.txt"))
    genome["chrDup"] = genome["chrA"][:genes[DUP_GENES - 1][1][-1][1] + 1000]
    mf.write_fasta(str(work / "dup.fa"), sorted(genome.items()))
    build_index(str(work / "dup.fa"), str(work / "dup"))
    out = {}
    for name, prefix in (("toy", str(golden_dir / "index" / "toy")),
                         ("dup", str(work / "dup"))):
        out[name] = (prefix, load_index(prefix),
                     dart_tpu.index.load_index(prefix))
    return out


@pytest.fixture(scope="module")
def runs(work, inputs, indexes):
    """run(case, who) -> (alignment bytes, junction table bytes,
    DartAligner.stats), each aligned once: who is "port" (the port on
    the CPU), "numpy" or "jax" (dart_tpu's engines)."""
    done = {}

    def run(case, who):
        """... and, for the port, each span's stage with the stages open
        around it (``Nesting.seen``)."""
        if (case, who) in done:
            return done[case, who]
        index, reads, flags = CASES[case][:3]
        prefix, port_idx, ref_idx = indexes[index]
        out = work / f"{case}.{who}"
        extra = ["--batch", str(BATCH)] if (case, who) == ("mis5",
                                                           "port") else []
        argv = ["-i", prefix, *inputs[reads], *flags,
                "-bo" if case == "bam" else "-o", f"{out}.aln", "-j",
                f"{out}.tab", "-silent", *extra]
        with contextlib.redirect_stdout(io.StringIO()):
            if who == "port":
                aligner = DartAligner(port_idx, cli.parse_args(argv),
                                      engine=FMIndexTorch(port_idx, "cpu"))
                aligner.spans = Nesting(aligner.stats)
            else:
                cfg = dart_tpu.cli.parse_args(argv)
                cfg.engine = who
                aligner = dart_tpu.aligner.DartAligner(ref_idx, cfg)
            aligner.run()
        done[case, who] = (open(f"{out}.aln", "rb").read(),
                           open(f"{out}.tab", "rb").read(), aligner.stats,
                           aligner.spans.seen if who == "port" else None)
        return done[case, who]

    return run


class Nesting(spans.Spans):
    """Spans that note each span's stage with the stages open around it,
    outermost first."""

    def __init__(self, stats):
        super().__init__(stats)
        self.seen = []

    def __call__(self, stage, k=None):
        self.seen.append((stage, [e[0] for e in self._open]))
        return super().__call__(stage, k)


def records(sam: bytes) -> list:
    return [ln.split(b"\t") for ln in sam.splitlines()
            if not ln.startswith(b"@")]


@pytest.mark.parametrize("case", list(CASES))
def test_port_equals_dart_tpu_on_spliced_pairs(case, runs):
    port = runs(case, "port")
    for who in CASES[case][3]:
        ref = runs(case, who)
        assert port[0] == ref[0], f"{case}: alignments differ from {who}"
        assert port[1] == ref[1], f"{case}: junction table differs from {who}"
    if case == "bam":
        assert port[0][:4] == b"\x1f\x8b\x08\x04"  # BGZF
        return
    recs = records(port[0])
    assert len(recs) >= 2 * N_PAIRS  # every mate has a record
    if case != "default":
        # mates cross introns and pair: the input tests what it should
        assert sum(b"N" in r[5] for r in recs) > 0
        assert sum(int(r[1]) & 2 != 0 for r in recs) > N_PAIRS
        assert port[1].count(b"\n") > 0
    if case in DIFFERS:
        base, part = DIFFERS[case]
        other = runs(base, "numpy")
        if part is None:
            assert port[:2] != other[:2], f"{case} changed nothing"
        else:
            assert port[part] != other[part], f"{case} changed nothing"


def test_two_processes_equal_one_on_spliced_pairs(runs, inputs, indexes,
                                                  tmp_path):
    """``--dist-nprocs 2`` over gloo: the merged outputs of two processes,
    several chunks each, equal one process's."""
    out, sj = tmp_path / "two.sam", tmp_path / "two.tab"
    rcs, errs = run_pair(["-i", indexes["toy"][0], *inputs["pe"], "-mis",
                          "5", "-o", str(out), "-j", str(sj), "-silent",
                          "--batch", "64"])
    assert rcs == [0, 0], errs[0][-2000:] + errs[1][-2000:]
    one = runs("mis5", "port")
    assert out.read_bytes() == one[0]
    assert sj.read_bytes() == one[1]


@pytest.mark.parametrize("stream", ["se_files", "spliced_pairs"])
def test_stage_times_count_each_second_once(stream, runs, inputs, indexes,
                                            work):
    """Over runs of several chunks, where the hook inside each chunk's
    wait parses and submits the next, the main thread's four stage
    times add up to no more than the run's wall plus STAGE_SLACK_S, and
    the finalize worker's time to no more than the wall; the wait
    without the hook is a part of the device stage, and the hook's
    parses ran inside a chunk's span."""
    if stream == "spliced_pairs":
        stats, seen = runs("mis5", "port")[2:]  # BATCH reads a chunk
    else:  # mate 1 as a single-end stream of two files
        prefix, port_idx, _ = indexes["toy"]
        cfg = cli.parse_args(["-i", prefix, "-f", *inputs["se"] * 2, "-o",
                              str(work / "se.sam"), "-j", str(work / "se.tab"),
                              "-silent", "--batch", str(BATCH)])
        aligner = DartAligner(port_idx, cfg,
                              engine=FMIndexTorch(port_idx, "cpu"))
        aligner.spans = Nesting(aligner.stats)
        with contextlib.redirect_stdout(io.StringIO()):
            aligner.run()
        stats, seen = aligner.stats, aligner.spans.seen
    assert stats["chunks"] >= 4
    assert sum(stats[k] for k in STAGES) <= stats["wall_s"] + STAGE_SLACK_S
    assert stats["native_finalize_s"] <= stats["wall_s"]
    assert 0 <= stats["device_only_wait_s"] <= stats["device_seed_locate_s"]
    prefetched = [around for stage, around in seen
                  if stage == "dart.input" and "dart.prefetch" in around]
    assert len(prefetched) >= 2
    assert all(around[-1] == "dart.prefetch" and "dart.chunk" in around
               for around in prefetched)
