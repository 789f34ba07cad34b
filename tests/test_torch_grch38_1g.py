"""The ``grch38_1g`` configuration's shape at toy scale, on the CPU.

``benchmark/configs/grch38_1g.json`` is six chromosomes at GRCh38's
lengths and chrDup copied from chr1's start: its fwd+rc text passes
2^31 positions, so ``make_engine`` takes the wide engine, whose table
comes from the layout cache. Here the same chromosomes at a thousandth
of their lengths, the configuration's gene law, a larger chrDup (so
that genes are copied and spliced reads map twice), its flags
(``-all_sj`` included) and the ``pe_sam`` mix's reads, fewer of them,
through ``DartAligner.run``. The wide engine is forced on the normal
path by lowering ``fm_torch.WIDE_MIN_SEQ`` and the layout cache by
lowering ``layout_cache.CACHE_MIN_SEQ``: from a cache hit it writes the
narrow engine's SAM and ``junctions.tab``, byte for byte, and the
benchmark's plain reference (``benchmark/refcheck.py``) finds nothing
wrong in them. Then the benchmark's reader of
``seed_scan_ms_per_mread`` on a toy trace."""

import importlib.util
import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark import devtrace, genomes, reads, refcheck  # noqa: E402
from dart_tpu_torch.aligner import DartAligner, make_engine  # noqa: E402
from dart_tpu_torch.cli import parse_args  # noqa: E402
from dart_tpu_torch.index import build_index, layout_cache, \
    load_index  # noqa: E402
from dart_tpu_torch.ops import fm_torch  # noqa: E402


def load(rel: str) -> dict:
    with open(os.path.join(REPO, rel)) as f:
        return json.load(f)


CONFIG = load("benchmark/configs/grch38_1g.json")
MIX = dict(load("benchmark/traffic/pe_sam.json"), files=2,
           file_fragments=1024)
# a thousandth of each chromosome; 100 kbp of chr1's 249 copied, so
# that some of its genes map twice
SCALE = 1000
COPY_BP = 100_000
SEED = 2**31 + 38


def toy_spec() -> dict:
    spec = json.loads(json.dumps(CONFIG["genome"]))
    spec["chromosomes"] = {c: n // SCALE
                           for c, n in spec["chromosomes"].items()}
    spec["copy"]["bases"] = COPY_BP
    return spec


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The toy genome, its index, the pool's files, and the runs: the
    narrow engine, the wide engine twice (a cache miss, then a hit),
    and the narrow engine without ``-all_sj``."""
    d = tmp_path_factory.mktemp("grch38_1g")
    genome = genomes.make_genome(toy_spec())
    genomes.write_fasta(genome, str(d / "genome.fa"))
    build_index(str(d / "genome.fa"), str(d / "idx"))
    prefix = str(d / "idx")
    idx = load_index(prefix)
    pool = reads.make_pool(genome, MIX, SEED)
    files = reads.write_files(pool, MIX, str(d))

    def align(tag: str, flags) -> dict:
        argv = ["-i", prefix]
        for f1, f2 in files:
            argv += ["-f", f1, "-f2", f2]
        out = {"sam": str(d / f"{tag}.sam"), "tab": str(d / f"{tag}.tab")}
        cfg = parse_args(argv + list(flags) + [
            "--batch", "1024", "-o", out["sam"], "-j", out["tab"],
            "-silent"])
        engine = make_engine(idx, cfg, "cpu")
        DartAligner(idx, cfg, engine).run()
        for k in ("sam", "tab"):
            with open(out[k], "rb") as f:
                out[k] = f.read()
        out["wide"], out["cache"] = engine.wide, engine.cache
        return out

    flags = CONFIG["flags"]
    runs = {"narrow": align("narrow", flags),
            "no_all_sj": align("no_all_sj",
                               [f for f in flags if f != "-all_sj"])}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fm_torch, "WIDE_MIN_SEQ", idx.seq_len)
        mp.setattr(layout_cache, "CACHE_MIN_SEQ", 0)
        runs["wide_miss"] = align("wide_miss", flags)
        runs["wide"] = align("wide", flags)
    return {"genome": genome, "pool": pool, "idx": idx, "runs": runs}


def judge(toy, run: dict, all_sj: bool) -> dict:
    ref = refcheck.Reference(toy["genome"], toy["pool"],
                             MIX["file_fragments"], True, all_sj=all_sj)
    ref.judge(refcheck.parse_sam(run["sam"], ref.chrom_ix, MIX["read_len"]),
              1)
    tab = [(c, int(a), int(b), int(n)) for c, a, b, n, *_ in
           (line.split() for line in run["tab"].decode().splitlines())]
    return ref.finish([1] * MIX["files"], tab)


def test_the_configuration_passes_2_31():
    g = CONFIG["genome"]
    total = sum(g["chromosomes"].values()) + g["copy"]["bases"]
    seq_len = 2 * total  # the forward text and its reverse complement
    assert seq_len >= 2**31 and seq_len >= fm_torch.WIDE_MIN_SEQ
    assert seq_len >= layout_cache.CACHE_MIN_SEQ
    # chr1 comes first, so the reverse strand of its first
    # seq_len - 2^31 bases lies past 2^31: chrDup's source among them
    assert list(g["chromosomes"])[0] == g["copy"]["of"] == "chr1"
    assert g["copy"]["bases"] <= seq_len - 2**31
    assert "-all_sj" in CONFIG["flags"] and "-m" not in CONFIG["flags"]


def test_the_toy_has_the_configurations_shape(toy):
    genome = toy["genome"]
    assert genome.names == list(CONFIG["genome"]["chromosomes"]) + [
        "chrDup"]
    assert (genome.seqs["chrDup"] == genome.seqs["chr1"][:COPY_BP]).all()
    genes = {c for c, _ in genome.genes}
    assert len(genes) >= 5 and "chrDup" not in genes
    assert any(c == "chr1" and exs[-1][1] <= COPY_BP
               for c, exs in genome.genes)


def test_the_wide_engine_from_a_cache_hit_writes_the_narrow_bytes(toy):
    runs = toy["runs"]
    assert not runs["narrow"]["wide"] and runs["narrow"]["cache"] is None
    assert runs["wide_miss"]["wide"] and runs["wide_miss"]["cache"] == "miss"
    assert runs["wide"]["wide"] and runs["wide"]["cache"] == "hit"
    for run in ("wide_miss", "wide"):
        assert runs[run]["sam"] == runs["narrow"]["sam"], run
        assert runs[run]["tab"] == runs["narrow"]["tab"], run
    assert runs["wide"]["sam"].count(b"\n") > 4 * MIX["file_fragments"]


@pytest.mark.parametrize("run", ["wide", "narrow"])
def test_the_plain_reference_finds_nothing_wrong(toy, run):
    got = judge(toy, toy["runs"][run], all_sj=True)
    for k in ("reads_missing", "records_wrong", "mates_wrong",
              "sj_rows_off"):
        assert got[k] == 0, (k, got)
    # chrDup holds 9% of the toy's bases: its reads map twice (MAPQ 0)
    assert got["unplaced_pct"] < 40, got


def test_all_sj_changes_junctions_tab(toy):
    runs = toy["runs"]
    assert runs["no_all_sj"]["tab"] != runs["wide"]["tab"]
    assert runs["no_all_sj"]["sam"] == runs["wide"]["sam"]
    # each table is sound under its own flags, and the -all_sj table is
    # not under the default's rule: the reference reads the flag
    assert judge(toy, runs["no_all_sj"], all_sj=False)["sj_rows_off"] == 0
    assert judge(toy, runs["wide"], all_sj=False)["sj_rows_off"] > 0


def metric(name: str):
    spec = importlib.util.spec_from_file_location(
        "metric_" + name, os.path.join(REPO, "benchmark", "metrics",
                                       name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_seed_scan_metric_reads_a_toy_trace(tmp_path):
    # a Chrome trace as torch.profiler exports it: the narrow and the
    # wide seed scan, a locate and a copy on the card, a host range
    def ev(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}

    events = [
        ev("dart.seed.submit#0", "user_annotation", 0, 10_000),
        ev("void seed_scan_kernel<A<Wide>, true>(Args)", "kernel", 100,
           3_000),
        ev("void seed_scan_kernel<A<Narrow>, true>(Args)", "kernel", 4_000,
           1_000),
        ev("void locate_kernel<A<Wide>, true>(Args)", "kernel", 5_500, 500),
        ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 6_500, 2_000),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    summary = devtrace.summary(str(path))
    read = metric("seed_scan_ms_per_mread")
    # 4 ms of seed scans over 2 M reads
    got = read({"reads": 2_000_000, "trace": summary})
    assert got == pytest.approx(2.0)
    assert read({"reads": 2_000_000, "trace": None}) is None
    no_scan = dict(summary, device_ops=[op for op in summary["device_ops"]
                                        if "seed_scan" not in op[0]])
    assert read({"reads": 2_000_000, "trace": no_scan}) is None


def test_the_cell_is_in_the_benchmark():
    bench = load("BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}["grch38_1g_pe_sam"]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "grch38_1g", "pe_sam", 1)
    for m in bench["per_layer"]:
        # every per-layer metric but the BAM output's reads this cell
        assert ("grch38_1g_pe_sam" in m["workloads"]) == (
            not m["name"].startswith("output_")), m["name"]
    limits = load("benchmark/limits/grch38_1g_pe_sam.json")
    assert set(limits) == set(refcheck.NUMBERS)
