"""The port's bench line (``dart_tpu_torch.bench``, its data sets in
``dart_tpu_torch.benchdata``) held to what it copies, on the CPU:

- the generators against ``tools/make_fixtures.py``'s and the root
  ``bench.ensure_dataset``'s files at a small spec (a 200 kbp genome,
  2,000 reads), byte for byte; the spliced-pair and long-intron mixes
  against the SHA-256 of the files ``chip_smoke.py``'s own generators
  wrote at that spec before they moved into the package;
- ``_norm_flags_pairwise``, ``parity_check`` and ``junction_parity`` of
  both modules on ``tests/test_bench_parity.py``'s cases, and each
  counting a changed record or junction count short;
- ``_converged`` and the pass loop on a stand-in timer, and
  ``trace_summary`` on a synthetic trace;
- the whole bench with ``--device cpu`` on the toy index and the first
  40 reads of ``tests/data/se_mm.fq`` (golden c2's flags): every key of
  the line, parity N/N, SAM equal to the golden's records; and its exit
  1, line printed, for a missing index and for an oracle with one
  record changed; ``prep``; the default device raising without a card.

The test may import the root ``bench.py`` and ``dart_tpu``; the port
may not (``tests/test_torch_nojax.py``)."""

import contextlib
import gzip
import hashlib
import io
import json
import os
import random
import shutil
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench as root_bench  # noqa: E402  (puts tools/ on sys.path)
import make_fixtures as mf  # noqa: E402

from dart_tpu_torch import bench as port_bench  # noqa: E402
from dart_tpu_torch import benchdata  # noqa: E402

SMALL = {"chr1": 120_000, "chr2": 80_000}  # 200 kbp
N_SMALL = 2000
N_TOY = 40  # the toy bench's reads: se_mm.fq's first records
# chip_smoke.py's generators before the move, at the small spec:
# spliced_pair_set(Random(SEED + 2)) of 1,000 pairs on bench_genome(SMALL)
SP_SHA = ("2eb51c9bd4a2c38b1b9c363ff9b15e643e366f50a667975b559b4d286ce79d83",
          "bd3462209c79d82c0a3e351f0b6917a88521973ba65f7a7476a2bd0c029cbf95")
# write_spliced_genome(0.003 Gbp, 3 chromosomes, chrDup of 100,000), then
# spliced_pair_set(Random(SEED + 3)) of 1,000 pairs without chrDup
LI_SPEC = {"gbp": 0.003, "n_chrom": 3, "dup_bp": 100_000,
           "seed": benchdata.SEED + 3, "n_reads": N_SMALL, "paired": True}
LI_SHA = {
    "genome.fa":
        "6609f3ece6f0c5dbee732a3845dc87600a8add91dcb20ba1d4e4f3bc13c11c04",
    "genes.txt":
        "6b5565cd31acf188aad95263f2cca85622b22a145ab9281ccf92e88c8dcf89e3",
    "pairs_1000_1.fq":
        "7532a529952811345b6154788a0087d3483831d8642d8a8d6ea1af5181235e13",
    "pairs_1000_2.fq":
        "042ae779a6f7c1cf0c784df8d436f62c33c8d10aab1cd6a92bc9951e0c325444",
}
BOTH = [pytest.param(root_bench, id="bench"),
        pytest.param(port_bench, id="dart_tpu_torch.bench")]
LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "host_fault_mbps",
             "device", "configs"}
CONFIG_KEYS = {
    "reads_per_sec", "median_reads_per_sec", "vs_baseline", "ours_passes_s",
    "passes", "spread", "wall_s", "stage_split", "setup_s", "setup_split",
    "launches", "launches_timed", "parity", "sj_parity", "parity_oracle",
    "parity_reads", "oracle_s", "index_build_s", "kernel_ms", "kernels_ms",
    "idle_share", "window_s", "top_ops", "idle_gaps", "n_reads", "flags"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sha(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def small_spec(paired: bool) -> dict:
    return {"genome": SMALL, "n_reads": N_SMALL, "paired": paired,
            "bam": paired, "passes": 3}


def test_single_end_set_equals_make_fixtures_and_bench(tmp_path, monkeypatch):
    """The single-end set's genome, genes and reads: byte-equal to
    make_fixtures' generators in bench.ensure_dataset's steps, and to
    bench.ensure_dataset's own files; the port's index is built and its
    seconds stored in meta.json."""
    ds = benchdata.make_dataset("se", str(tmp_path / "port"), small_spec(False))
    d = ds["dir"]
    rng = random.Random(benchdata.SEED)
    genome = mf.make_genome(rng, SMALL, n_runs=4)
    genome["chr1"], genes = mf.plant_genes(rng, genome["chr1"], n_genes=50)
    want = tmp_path / "want"
    want.mkdir()
    mf.write_fasta(str(want / "genome.fa"), sorted(genome.items()))
    rng = random.Random(benchdata.SEED + 1)
    reads = mf.sim_reads_genomic(rng, genome, N_SMALL - 600, 100, 0.005,
                                 tag="g")
    reads += mf.sim_reads_spliced(rng, "chr1", genome["chr1"], genes, 600, 100,
                                  0.005, tag="s")
    rng.shuffle(reads)
    mf.write_reads_fastq(str(want / "reads.fq"), reads)
    assert sha(os.path.join(d, "genome.fa")) == sha(want / "genome.fa")
    assert sha(ds["fq"][0]) == sha(want / "reads.fq")
    assert ds["fq"] == (os.path.join(d, f"reads_{N_SMALL}.fq"), None)
    assert [exs for _, exs in benchdata.read_genes(
        os.path.join(d, "genes.txt"))] == genes
    assert benchdata.read_meta(d)["index_build_s"] > 0
    for ext in benchdata.INDEX_EXTS:
        assert os.path.exists(ds["prefix"] + ext)

    monkeypatch.setattr(root_bench, "WORK", str(tmp_path / "bench"))
    with contextlib.redirect_stderr(io.StringIO()):
        ref = root_bench.ensure_dataset("se", small_spec(False))
    for name in ("genome.fa", "genes.txt", f"reads_{N_SMALL}.fq"):
        assert sha(os.path.join(ref["dir"], name)) == \
            sha(os.path.join(d, name)), name


def test_paired_set_equals_bench(tmp_path, monkeypatch):
    """The paired set's mates: byte-equal to bench.ensure_dataset's, as
    sim_reads_paired writes them; files that exist are kept."""
    ds = benchdata.make_dataset("pe", str(tmp_path / "port"), small_spec(True))
    monkeypatch.setattr(root_bench, "WORK", str(tmp_path / "bench"))
    with contextlib.redirect_stderr(io.StringIO()):
        ref = root_bench.ensure_dataset("pe", small_spec(True))
    for got, want in zip(ds["fq"], ref["fq"]):
        assert os.path.basename(got) == os.path.basename(want)
        assert sha(got) == sha(want)
    before = os.stat(ds["fq"][0]).st_mtime_ns
    assert benchdata.make_dataset("pe", str(tmp_path / "port"),
                                  small_spec(True)) == ds
    assert os.stat(ds["fq"][0]).st_mtime_ns == before


def test_spliced_pairs_equal_the_moved_generator(tmp_path, monkeypatch):
    """The spliced-pair mix, from the genome's files and, before they
    exist, from its seed in memory: the bytes chip_smoke.py wrote."""
    monkeypatch.setattr(benchdata, "build_timed", lambda fa, prefix: 0.0)
    monkeypatch.setitem(benchdata.CONFIGS, "se_small", small_spec(False))
    spec = {"genome_of": "se_small", "seed": benchdata.SEED + 2,
            "n_reads": N_SMALL, "paired": True}
    work = str(tmp_path)
    in_memory = benchdata.make_dataset("sp_first", work, spec)
    benchdata.make_dataset("se_small", work)
    from_files = benchdata.make_dataset("sp", work, spec)
    for ds in (in_memory, from_files):
        assert tuple(sha(p) for p in ds["fq"]) == SP_SHA
        assert ds["prefix"] == os.path.join(work, "se_small", "idx")


def test_long_introns_equal_the_moved_generator(tmp_path, monkeypatch):
    monkeypatch.setattr(benchdata, "build_timed", lambda fa, prefix: 0.0)
    ds = benchdata.make_dataset("li", str(tmp_path), LI_SPEC)
    assert {n: sha(os.path.join(ds["dir"], n)) for n in LI_SHA} == LI_SHA
    assert len(ds["genes"]) == 73


def test_configs_keep_the_bench_and_smoke_specs():
    """The shared configs are bench.py's (genome, reads, pairing, BAM),
    in its order, with the port's additions after them."""
    names = list(benchdata.CONFIGS)
    assert names[:4] == list(root_bench.CONFIGS)
    assert names[4:] == ["big_sp", "8mbp_sp", "12mbp_li"]
    for name, spec in root_bench.CONFIGS.items():
        port = benchdata.CONFIGS[name]
        for key in ("genome", "paired", "bam", "passes", "prebuilt"):
            assert port.get(key) == spec.get(key), (name, key)
    assert benchdata.CONFIGS["8mbp_sp"]["n_reads"] == 100_000
    assert (root_bench.SEED, root_bench.READ_LEN) == (benchdata.SEED,
                                                      benchdata.READ_LEN)


# ---- parity, on tests/test_bench_parity.py's cases ----

NORM_CASES = [
    ([("r1", 0, "chr1"), ("r2", 16, "*"), ("r3", 16, "chr1")], [0, 4, 16]),
    ([("pA", 147, "chr1"), ("pA", 99, "*"), ("pB", 67, "chr2"),
      ("pB", 131, "*")],
     [1 | 8 | 16 | 128, 1 | 4 | 32 | (99 & 0xC0), 1 | 8 | 32 | (67 & 0xC0),
      1 | 4 | 16 | (131 & 0xC0)]),
    ([("p102", 105, "chrA"), ("p102", 149, "*")], [105, 149]),
    ([("q", 99, "chr1"), ("q", 147, "chr1"), ("u", 77, "*"), ("u", 141, "*")],
     [99, 147, 77, 141]),
    ([("s", 83, "*"), ("s", 163, "*")], [77, 141]),
    ([("x", 99, "chr1"), ("y", 0, "chr2")], [99, 0]),
]


@pytest.mark.parametrize("mod", BOTH)
@pytest.mark.parametrize("case", range(len(NORM_CASES)))
def test_norm_flags_pairwise(mod, case):
    recs, want = NORM_CASES[case]
    assert mod._norm_flags_pairwise(recs) == want


@pytest.mark.parametrize("mod,report", [
    pytest.param(root_bench, "dart_tpu.pipeline.report", id="bench"),
    pytest.param(port_bench, "dart_tpu_torch.pipeline.report",
                 id="dart_tpu_torch.bench")])
def test_normalizer_round_trips_emitter_half_mapped(mod, report):
    """For every half-mapped geometry, normalizing any stale flag pair
    gives exactly the flags the package's report module emits."""
    import importlib

    rep = importlib.import_module(report)

    def read(score, bdir):
        r = type("Read", (), {})()
        c = type("Rep", (), {})()
        c.coor = type("Coor", (), {})()
        c.coor.bDir, c.AlnScore, c.PairedAlnCanIdx, c.iFrag = bdir, score, \
            -1, 0
        r.score, r.sub_score, r.best_idx, r.reports = score, 0, 0, [c]
        return r

    for mapped_first in (True, False):
        for bdir in (True, False):
            m, u = read(60, bdir), read(0, True)
            rep.set_paired_alignment_flag(*((m, u) if mapped_first
                                            else (u, m)))
            want_m, want_u = m.reports[0].iFrag, u.reports[0].iFrag
            for stale in (0x2, 0x20, 0x2 | 0x20, 0):
                mf_ = (want_m & (0xC0 | 0x10)) | 1 | stale
                uf = (want_u & 0xC0) | 1 | (stale & 0x2)
                recs = [("p", mf_, "chr1"), ("p", uf, "*")]
                want = [want_m, want_u]
                if not mapped_first:
                    recs, want = recs[::-1], want[::-1]
                assert mod._norm_flags_pairwise(recs) == want


@pytest.fixture(scope="module")
def toy_outputs(tmp_path_factory, data_dir, golden_dir):
    """c5's pairs through the port on the CPU, as SAM and as BAM, and a
    reference-style SAM of them: its half-mapped pairs given stale
    flags (99/147) the normalizer must take back."""
    from dart_tpu_torch.cli import main

    d = tmp_path_factory.mktemp("parity")
    args = ["-i", str(golden_dir / "index" / "toy"), "-f",
            str(data_dir / "pe_1.fq"), "-f2", str(data_dir / "pe_2.fq"),
            "-mis", "5", "-silent", "--device", "cpu"]
    (d / "bam").mkdir()
    with contextlib.redirect_stdout(io.StringIO()):
        assert main([*args, "-o", str(d / "tpu.sam"), "-j",
                     str(d / "tpu.junctions.tab")]) == 0
        assert main([*args, "-bo", str(d / "bam" / "tpu.bam"), "-j",
                     str(d / "bam" / "tpu.junctions.tab")]) == 0
    lines = (d / "tpu.sam").read_text().splitlines(keepends=True)
    stale, n_stale = [], 0
    recs = [ln.split("\t") for ln in lines if not ln.startswith("@")]
    for i, p in enumerate(recs):
        mate = recs[i + 1] if i % 2 == 0 else recs[i - 1]
        if (p[2] == "*") != (mate[2] == "*"):
            # the stale proper-pair and mate-strand bits the reference
            # leaves; the mate bits and the mapped end's strand kept
            f = int(p[1])
            f = (f & 0xC0) | 3 if p[2] == "*" else (f & 0xD0) | 0x23
            p = [p[0], str(f), *p[2:]]
            n_stale += 1
        stale.append("\t".join(p))
    assert n_stale > 0
    (d / "ref.sam").write_text("".join(ln for ln in lines if ln[0] == "@")
                               + "".join(stale))
    return d


@pytest.mark.parametrize("mod", BOTH)
def test_parity_check_sam_and_bam(mod, toy_outputs, tmp_path):
    """The card's SAM and BAM against a reference SAM with stale flags:
    N/N; one record changed: one short."""
    n = sum(1 for ln in open(toy_outputs / "tpu.sam") if ln[0] != "@")
    ref = str(toy_outputs / "ref.sam")
    spec = {"bam": False}
    ds = {"dir": str(toy_outputs)}
    assert mod.parity_check("toy", spec, ds, ref) == \
        f"{n}/{n} identical SAM records (in order)"
    assert mod.parity_check("toy", {"bam": True},
                            {"dir": str(toy_outputs / "bam")}, ref) == \
        f"{n}/{n} records (BAM core fields, in order)"
    lines = open(ref).read().splitlines(keepends=True)
    i = next(k for k, ln in enumerate(lines) if "\t100M\t" in ln)
    lines[i] = lines[i].replace("\t100M\t", "\t99M1S\t")
    bad = tmp_path / "bad.sam"
    bad.write_text("".join(lines))
    assert mod.parity_check("toy", spec, ds, str(bad)).startswith(
        f"{n - 1}/{n} ")
    assert mod.parity_check("toy", {"bam": True},
                            {"dir": str(toy_outputs / "bam")},
                            str(bad)).startswith(f"{n - 1}/{n} ")
    assert mod.parity_check("toy", spec, ds, None) == "n/a"


@pytest.mark.parametrize("mod", BOTH)
def test_junction_parity(mod, golden_dir, tmp_path):
    rows = (golden_dir / "c4_spliced_mm.junctions.tab").read_text()
    n = len(rows.splitlines())
    assert n > 1
    (tmp_path / "tpu.junctions.tab").write_text(rows)
    ds = {"dir": str(tmp_path)}
    assert mod.junction_parity(ds) == "n/a"
    (tmp_path / "ref.junctions.tab").write_text(rows)
    assert mod.junction_parity(ds) == \
        f"{n}/{n} identical junction records (ours {n}, ref {n})"
    first, rest = rows.split("\n", 1)
    f = first.split("\t")
    f[3] = str(int(f[3]) + 1)
    (tmp_path / "ref.junctions.tab").write_text("\t".join(f) + "\n" + rest)
    got = mod.junction_parity(ds)
    assert got.startswith(f"{n - 1}/{n} ")
    assert port_bench.short(got) and not port_bench.short(
        f"{n}/{n} identical junction records")


def test_port_cpu_parity_reads_bam_and_rows(toy_outputs, tmp_path):
    """The port_cpu comparisons: BAM records decompressed, one changed
    record short; the BAM's core fields as tests/test_bam reads them."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_bam import decode_bam

    bam = str(toy_outputs / "bam" / "tpu.bam")
    recs = port_bench.bam_records(bam)
    core = [(r["name"], r["flag"], r["pos"], r["cigar"])
            for r in decode_bam(bam)[2]]
    assert [port_bench.bam_core(r) for r in recs] == core
    n = len(recs)
    assert port_bench.records_parity(bam, bam) == \
        f"{n}/{n} identical BAM records (decompressed, in order)"
    with gzip.open(bam, "rb") as f:
        data = bytearray(f.read())
    at = data.index(recs[3])
    data[at + 12] ^= 1  # a byte of record 3's MAPQ/name-length word
    bad = tmp_path / "bad.bam"
    bad.write_bytes(gzip.compress(bytes(data)))
    assert port_bench.records_parity(bam, str(bad)).startswith(f"{n - 1}/{n} ")
    sam = str(toy_outputs / "tpu.sam")
    m = sum(1 for ln in open(sam) if ln[0] != "@")
    assert port_bench.records_parity(sam, sam) == \
        f"{m}/{m} identical SAM records (in order)"
    tab = str(toy_outputs / "tpu.junctions.tab")
    k = len(open(tab).read().splitlines())
    assert port_bench.rows_parity(tab, tab) == \
        f"{k}/{k} identical junction records (ours {k}, port_cpu {k})"


# ---- the pass loop and the trace ----


@pytest.mark.parametrize("mod", BOTH)
def test_converged(mod):
    assert not mod._converged([])
    assert not mod._converged([1.0])
    assert mod._converged([1.0, 1.08])
    assert not mod._converged([1.0, 1.09])
    assert mod._converged([2.0, 1.0, 1.05])


class Clock:
    """A stand-in timer: passes take the given seconds, and the clock
    moves by them."""

    def __init__(self, times):
        self.times, self.now, self.calls = list(times), 0.0, 0

    def __call__(self):
        return self.now

    def run(self):
        t = self.times[self.calls]
        self.calls += 1
        self.now += t
        return t


@pytest.mark.parametrize("times,passes,want", [
    ([1.0, 1.5, 1.05, 9.0], 10, [1.0, 1.5, 1.05]),  # 3 passes, two within 8%
    ([1.0, 1.2, 1.4, 1.6, 1.3, 1.07, 5.0], 6, [1.0, 1.2, 1.4, 1.6, 1.3,
                                               1.07]),
    ([1.1 ** k for k in range(20)], 6,  # never converges: passes + 4
     [1.1 ** k for k in range(10)]),
])
def test_pass_loop_stops_by_bench_rule(times, passes, want):
    clock = Clock(times)
    ours, ref = port_bench.pass_loop("t", {"passes": passes}, clock.run,
                                     clock=clock)
    assert ours == want and ref == []


def test_pass_loop_interleaves_reference_and_keeps_the_budget():
    ours_clock = Clock([1.0, 1.01, 1.02, 1.0])
    ref_clock = Clock([3.0, 3.1, 9.0])
    order = []

    def ours():
        order.append("ours")
        return ours_clock.run()

    def ref():
        order.append("ref")
        return ref_clock.run()

    got = port_bench.pass_loop("t", {"passes": 3}, ours, ref,
                               clock=lambda: 0.0)
    assert got == ([1.0, 1.01, 1.02], [3.0, 3.1])
    assert order == ["ref", "ours", "ref", "ours", "ours"]
    slow = Clock([100.0] * 10)
    ours_b, _ = port_bench.pass_loop("t", {"passes": 6, "wall_budget_s": 150},
                                     slow.run, clock=slow)
    assert ours_b == [100.0, 100.0]


def write_trace(d, events):
    d.mkdir()
    with gzip.open(d / "host.pt.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)


def test_trace_summary_on_a_synthetic_trace(tmp_path):
    """Busy 0-10 and 30-40 µs on the card (two kernels overlapping a
    copy), idle 10-30 and 40-100 in a 0-100 µs window: idle share 0.8;
    each gap named by the CPU events that cover it, precede it and start
    in it, never by the profiler's span over the whole window."""
    x = "X"
    events = [
        {"ph": x, "cat": "cpu_op", "name": "aten::copy_", "ts": 0, "dur": 5},
        {"ph": x, "cat": "user_annotation", "name": "PyTorch Profiler (0)",
         "ts": 0, "dur": 100},  # the session's own span names no gap
        {"ph": x, "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "ts": 12, "dur": 17},
        {"ph": x, "cat": "cpu_op", "name": "aten::empty", "ts": 42, "dur": 2},
        {"ph": x, "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 40, "dur": 60},
        {"ph": x, "cat": "kernel", "ts": 0, "dur": 6,
         "name": "void dart::seed_scan_kernel<A<Narrow>, true>(P, int)"},
        {"ph": x, "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 4,
         "dur": 6},
        {"ph": x, "cat": "kernel", "ts": 30, "dur": 10,
         "name": "void dart::locate_kernel<A<Narrow>, true>(P, long)"},
        {"ph": x, "cat": "kernel", "ts": 31, "dur": 2,
         "name": "void dart::locate_kernel<A<Narrow>, true>(P, long)"},
        {"ph": "i", "cat": "cpu_op", "name": "instant", "ts": 500},
    ]
    write_trace(tmp_path / "t", events)
    res = port_bench.trace_summary(str(tmp_path / "t"))
    assert res["window_s"] == pytest.approx(100e-6)
    assert res["idle_share"] == pytest.approx(0.8)
    assert res["kernel_ms"] == pytest.approx(0.018)
    assert res["kernels_ms"] == pytest.approx({
        "seed_scan_kernel<A<Narrow>, true>": 0.006,
        "locate_kernel<A<Narrow>, true>": 0.012})
    assert [(o["name"], o["count"]) for o in res["top_ops"]] == [
        ("locate_kernel<A<Narrow>, true>", 2), ("seed_scan_kernel<A<Narrow>, "
                                                "true>", 1),
        ("Memcpy HtoD", 1)]
    gaps = res["idle_gaps"]
    assert [(g["at_ms"], g["ms"]) for g in gaps] == pytest.approx(
        [(0.040, 0.060), (0.010, 0.020)])

    def named(gap):
        return gap["cpu_event"], gap["after"], gap["next"], gap["covered"]

    assert named(gaps[0]) == ("cudaLaunchKernel", "cudaStreamSynchronize",
                              "cudaLaunchKernel", 1.0)
    assert named(gaps[1]) == pytest.approx(
        (None, "aten::copy_", "cudaStreamSynchronize", 17 / 20))
    events[4]["dur"] = 1  # cudaLaunchKernel: 40-41 µs
    write_trace(tmp_path / "t2", events)
    gaps = port_bench.trace_summary(str(tmp_path / "t2"))["idle_gaps"]
    assert named(gaps[0]) == pytest.approx(
        (None, "cudaStreamSynchronize", "cudaLaunchKernel", 3 / 60))
    events[3]["ts"], events[4]["ts"] = 5, 30  # both inside busy spans:
    # no CPU event but the session's span overlaps 40-100 µs
    write_trace(tmp_path / "t3", events)
    gaps = port_bench.trace_summary(str(tmp_path / "t3"))["idle_gaps"]
    assert named(gaps[0]) == (None, "cudaLaunchKernel", None, 0.0)
    write_trace(tmp_path / "none", events[:5])
    with pytest.raises(AssertionError, match="no kernel"):
        port_bench.trace_summary(str(tmp_path / "none"))


# ---- the whole bench on the CPU ----


@pytest.fixture(scope="module")
def toy_config(tmp_path_factory, data_dir, golden_dir):
    """A config of the toy index and se_mm.fq's first N_TOY reads."""
    d = tmp_path_factory.mktemp("toy_reads")
    fq = port_bench.head_fastq(str(data_dir / "se_mm.fq"), N_TOY, str(d))
    return {"prefix": str(golden_dir / "index" / "toy"), "reads": (fq, None),
            "n_reads": N_TOY, "paired": False, "bam": False, "passes": 3,
            "flags": ["-mis", "5"]}


def run_bench(argv, configs: dict, work, monkeypatch, capsys):
    for name, spec in configs.items():
        monkeypatch.setitem(port_bench.CONFIGS, name, spec)
    monkeypatch.setenv("DART_TPU_BENCH_DIR", str(work))
    capsys.readouterr()
    rc = port_bench.main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1])


@pytest.fixture(scope="module")
def toy_run(toy_config, tmp_path_factory):
    work = tmp_path_factory.mktemp("bench")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(port_bench.CONFIGS, "toy", toy_config)
        mp.setenv("DART_TPU_BENCH_DIR", str(work))
        out = io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = port_bench.main(["--configs", "toy", "--device", "cpu"])
    return rc, json.loads(out.getvalue().strip().splitlines()[-1]), work


def test_bench_on_the_cpu(toy_run, golden_dir):
    rc, line, work = toy_run
    assert rc == 0
    assert set(line) == LINE_KEYS
    assert line["metric"] == "rna_seq_align_throughput"
    assert line["unit"] == "reads/s" and line["device"] == "cpu"
    assert line["value"] is None  # 8mbp_se was not run
    r = line["configs"]["toy"]
    assert CONFIG_KEYS <= set(r)
    assert r["parity"] == f"{N_TOY}/{N_TOY} identical SAM records (in order)"
    assert r["sj_parity"].startswith("0/0 ")  # se_mm's reads splice nothing
    assert (r["parity_oracle"], r["parity_reads"]) == ("port_cpu", N_TOY)
    assert 3 <= r["passes"] == len(r["ours_passes_s"]) <= 7
    assert r["wall_s"] == min(r["ours_passes_s"])
    assert r["reads_per_sec"] == pytest.approx(N_TOY / r["wall_s"])
    st = r["stage_split"]
    assert st["wall_s"] <= r["wall_s"]
    # the main thread's stages, and the finalize worker's, each within
    # the wall
    assert sum(st[k] for k in ("input_parse_s", "device_seed_locate_s",
                               "finalize_wait_s", "output_s")) \
        <= st["wall_s"] + 1e-6
    assert st["native_finalize_s"] <= st["wall_s"] + 1e-6
    assert r["idle_share"] is None and r["profile"].startswith("not measured")
    assert set(r["launches"]) == {"seed_scan", "locate", "lut_build"}
    sam = (work / "toy" / "tpu.sam").read_text().splitlines()
    gold = (golden_dir / "c2_se_mm.sam").read_text().splitlines()
    head = [ln for ln in gold if ln.startswith("@")]
    assert sam == head + [ln for ln in gold if not ln.startswith("@")][:N_TOY]


def test_changed_oracle_record_exits_1(toy_run, toy_config, tmp_path,
                                      monkeypatch, capsys):
    """The cached oracle with one record changed: the line is printed
    with the short count and the run exits 1."""
    _, _, work = toy_run
    shutil.copytree(work, tmp_path / "w")
    oracle = tmp_path / "w" / "toy" / f"port_cpu_{N_TOY}.sam"
    lines = oracle.read_text().splitlines(keepends=True)
    i = next(k for k, ln in enumerate(lines) if not ln.startswith("@"))
    lines[i] = lines[i].replace("\t", "\tx", 1)
    oracle.write_text("".join(lines))
    rc, line = run_bench(["--configs", "toy", "--device", "cpu"],
                         {"toy": toy_config}, tmp_path / "w", monkeypatch,
                         capsys)
    assert rc == 1
    assert line["configs"]["toy"]["parity"].startswith(f"{N_TOY - 1}/{N_TOY} ")


def test_missing_index_exits_1(toy_config, tmp_path, monkeypatch, capsys):
    """A config whose index is missing is an error, not a skip; a
    prebuilt config without its data set is a skip with its reason."""
    rc, line = run_bench(
        ["--configs", "nope,big_sp", "--device", "cpu"],
        {"nope": dict(toy_config, prefix=str(tmp_path / "none" / "idx"))},
        tmp_path, monkeypatch, capsys)
    assert rc == 1
    assert line["configs"]["nope"]["error"].startswith("FileNotFoundError")
    assert "idx.bwt" in line["configs"]["nope"]["error"]
    skip = line["configs"]["big_sp"]["skipped"]
    assert "missing idx.bwt" in skip and "chip_smoke.py --big" in skip


def test_prebuilt_gate(tmp_path):
    spec = port_bench.CONFIGS["grch38_pe_bam"]
    d = tmp_path / spec["dir"]
    d.mkdir()
    for ext in benchdata.INDEX_EXTS:
        (d / f"idx{ext}").write_bytes(b"")
    for r in spec["reads"]:
        (d / r).write_text("@r\nA\n+\nI\n")
    with pytest.raises(port_bench.Skip, match="lacks ready=true"):
        port_bench.ensure_dataset("grch38_pe_bam", spec, str(tmp_path))
    benchdata.write_meta(str(d), {"ready": True, "index_build_s": 7.0})
    with pytest.raises(port_bench.Skip, match="hold 2 records"):
        port_bench.ensure_dataset("grch38_pe_bam", spec, str(tmp_path))
    ds = port_bench.ensure_dataset("grch38_pe_bam", dict(spec, n_reads=2),
                                   str(tmp_path))
    assert ds["index_build_s"] == 7.0
    assert ds["dir"] == str(tmp_path / "grch38_pe_bam")


def test_prep_writes_the_oracle_and_times_nothing(toy_config, tmp_path,
                                                 monkeypatch, capsys):
    monkeypatch.setitem(port_bench.CONFIGS, "toy", toy_config)
    monkeypatch.setenv("DART_TPU_BENCH_DIR", str(tmp_path))
    with contextlib.redirect_stderr(io.StringIO()):
        assert port_bench.main(["prep", "--configs", "toy"]) == 0
    files = sorted(p.name for p in (tmp_path / "toy").iterdir())
    assert files == [f"port_cpu_{N_TOY}.junctions.tab",
                     f"port_cpu_{N_TOY}.sam", f"port_cpu_{N_TOY}.sam.json"]


def test_reads_and_configs_options():
    args = port_bench.parse(["--configs", "8mbp_se,8mbp_sp,big_sp",
                             "--reads", "1001", "--device", "cpu"])
    specs = port_bench.specs(args)
    assert list(specs) == ["8mbp_se", "8mbp_sp", "big_sp"]
    assert specs["8mbp_se"]["n_reads"] == 1001
    assert specs["8mbp_sp"]["n_reads"] == 1000
    assert specs["big_sp"]["n_reads"] == 200_000
    with pytest.raises(SystemExit), \
            contextlib.redirect_stderr(io.StringIO()):
        port_bench.parse(["--configs", "8mbp_se,nope"])


def test_default_device_raises_without_a_card(toy_config, tmp_path,
                                              monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    monkeypatch.setitem(port_bench.CONFIGS, "toy", toy_config)
    monkeypatch.setenv("DART_TPU_BENCH_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_bench.main(["--configs", "toy"])
    assert not (tmp_path / "toy").exists()
