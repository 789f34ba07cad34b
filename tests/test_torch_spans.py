"""The stream loop's spans and counters (``dart_tpu_torch.spans``,
``DartAligner.stats``) on the CPU.

The recorder's self-time rule on a fake clock; runs of the toy golden
index and reads (single-end as two files, paired-end to BAM) whose
sub-stage times sum within their stages and those within the wall; the
first file's reader timed; a ``torch.profiler`` trace with one
``dart.chunk#k`` range a chunk, every range inside its parent and each
stage's summed ranges equal to its ``stats`` self time (within
``TRACE_TOL_S`` a range and ``TRACE_TOL_SHARE``); no
``record_function`` without a profiler; the engine's row and byte
counters kept per run when two aligners share it (on a toy index with a
duplicated stretch, so that seeds are located), 0 bytes on the CPU and,
on a card, one chunk's bytes as the shapes give them; the native
finalize's phase times at ``-t 1`` and ``-t 4`` with the golden output;
and the benchmark's ten readers of these keys.

The engine is ``FMIndexTorch`` on the CPU with its plain scans and
locates kept by their input (``MemoEngine``), so that a run repeated on
the same reads computes no plain kernel and the trace holds the spans
rather than the plain kernels' operations. The card's test is marked
``cuda``; it skips without a card."""

import contextlib
import importlib.util
import io
import json
import os
import types

import numpy as np
import pytest
import torch

from dart_tpu_torch import cli, spans
from dart_tpu_torch.aligner import DartAligner, all_threads
from dart_tpu_torch.index import build_index, load_index
from dart_tpu_torch.ops.fm_torch import FMIndexTorch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
DATA = os.path.join(HERE, "data")
GOLD = os.path.join(HERE, "golden")
TOY = os.path.join(GOLD, "index", "toy")
BATCH = 128  # chunks of the paired run: five, three through the prefetch
SE_READS = 256  # reads of each single-end file: two chunks of BATCH
SLACK_S = 1e-6  # float sums of the same charges in another order
TRACE_TOL_S = 5e-4  # a range's profiler overhead against its span's clock
TRACE_TOL_SHARE = 0.05

# stage -> the stages its range may lie directly inside
PARENTS = {
    "dart.stream": (None,),
    "dart.tail": (None,),
    "dart.chunk": ("dart.stream",),
    "dart.prefetch": ("dart.seed.finish",),
    "dart.input": ("dart.stream", "dart.prefetch"),
    "dart.input.open": ("dart.input",),
    "dart.seed.submit": ("dart.stream", "dart.prefetch"),
    "dart.seed.pack": ("dart.seed.submit",),
    "dart.seed.sync": ("dart.seed.submit", "dart.seed.finish"),
    "dart.seed.expand": ("dart.seed.finish",),
    "dart.seed.finish": ("dart.chunk",),
    "dart.finalize": (None,),  # on the finalize worker's thread
    "dart.finalize.wait": ("dart.chunk",),
    "dart.output": ("dart.chunk",),
    "dart.output.encode": ("dart.output",),
    "dart.output.deflate": ("dart.output",),
}
# stats key -> the stage whose ranges sum to it (less those of the second)
SELF_TIMES = {
    "input_parse_s": ("dart.input", None),
    "input_open_s": ("dart.input.open", None),
    "seed_pack_s": ("dart.seed.pack", None),
    "device_sync_s": ("dart.seed.sync", None),
    "seed_expand_s": ("dart.seed.expand", None),
    "device_only_wait_s": ("dart.seed.finish", "dart.prefetch"),
    "native_finalize_s": ("dart.finalize", None),
    "finalize_wait_s": ("dart.finalize.wait", None),
    "output_s": ("dart.output", None),
    "output_encode_s": ("dart.output.encode", None),
    "output_deflate_s": ("dart.output.deflate", None),
}
# the benchmark's readers: metric -> (stats key, scale)
READERS = {
    "input_open_us_per_read": ("input_open_s", 1e6),
    "seed_pack_us_per_read": ("seed_pack_s", 1e6),
    "device_sync_us_per_read": ("device_sync_s", 1e6),
    "seed_expand_us_per_read": ("seed_expand_s", 1e6),
    "finalize_parallel_us_per_read": ("finalize_parallel_s", 1e6),
    "finalize_serial_us_per_read": ("finalize_serial_s", 1e6),
    "finalize_wait_us_per_read": ("finalize_wait_s", 1e6),
    "output_encode_us_per_read": ("output_encode_s", 1e6),
    "output_deflate_us_per_read": ("output_deflate_s", 1e6),
    "dtoh_bytes_per_read": ("dtoh_bytes", 1),
    "locate_rows_per_read": ("locate_rows", 1),
}


class MemoEngine(FMIndexTorch):
    """``FMIndexTorch`` whose plain seed scans and locates are kept by
    their input and given again as copies."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self._memo = {}

    def _kept(self, key, make):
        if key not in self._memo:
            self._memo[key] = make()
        return self._memo[key].clone()

    def plain_seed_scan(self, buf, words, S, loads=None):
        return self._kept(("scan", buf.numpy().tobytes(), words, S),
                          lambda: super(MemoEngine, self).plain_seed_scan(
                              buf, words, S, loads))

    def plain_locate(self, rows, lf_steps=None):
        return self._kept(("locate", rows.numpy().tobytes()),
                          lambda: super(MemoEngine, self).plain_locate(
                              rows, lf_steps))


def read_fasta(path):
    out, name = {}, None
    for line in open(path):
        line = line.strip()
        if line.startswith(">"):
            name = line[1:].split()[0]
            out[name] = []
        elif line:
            out[name].append(line)
    return {k: "".join(v) for k, v in out.items()}


def write_fasta(path, records):
    with open(path, "w") as f:
        for name, seq in records:
            f.write(f">{name}\n{seq}\n")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The inputs: the first 2 * SE_READS reads of spliced.fa as two
    FASTA files, and a toy index with chrA's first 20,000 bases copied
    into a third chromosome (its prefix)."""
    d = tmp_path_factory.mktemp("spans")
    reads = list(read_fasta(os.path.join(DATA, "spliced.fa")).items())
    for i in range(2):
        write_fasta(str(d / f"se{i}.fa"),
                    reads[i * SE_READS:(i + 1) * SE_READS])
    genome = read_fasta(os.path.join(DATA, "toy.fa"))
    genome["chrDup"] = genome["chrA"][:20000]
    write_fasta(str(d / "dup.fa"), sorted(genome.items()))
    build_index(str(d / "dup.fa"), str(d / "dup"))
    return d


@pytest.fixture(scope="module")
def toy():
    idx = load_index(TOY)
    return idx, MemoEngine(idx, "cpu")


def align(idx, engine, argv):
    aligner = DartAligner(idx, cli.parse_args(argv), engine=engine)
    with contextlib.redirect_stdout(io.StringIO()):
        aligner.run()
    return aligner


def se_argv(work, out, files=2):
    return ["-i", TOY, *[a for i in range(files)
                         for a in ("-f", str(work / f"se{i}.fa"))],
            "-o", str(work / f"{out}.sam"), "-j", str(work / f"{out}.tab"),
            "-silent", "--batch", str(BATCH)]


def pe_bam_argv(work, out):
    return ["-i", TOY, "-f", os.path.join(DATA, "pe_1.fq"),
            "-f2", os.path.join(DATA, "pe_2.fq"), "-mis", "5",
            "-bo", str(work / f"{out}.bam"), "-j", str(work / f"{out}.tab"),
            "-silent", "--batch", str(BATCH)]


@pytest.fixture(scope="module")
def runs(work, toy):
    """Each run's aligner, aligned once: "se" and "pe_bam"."""
    idx, engine = toy
    return {"se": align(idx, engine, se_argv(work, "se")),
            "pe_bam": align(idx, engine, pe_bam_argv(work, "pe_bam"))}


@pytest.fixture(scope="module")
def traced(work, toy, runs):
    """``pe_bam`` again under a CPU ``torch.profiler`` of all threads
    (the plain kernels' results kept from ``runs``): (its stats, each
    dart. range as (stage, k, start, end in seconds, thread))."""
    from torch.profiler import ProfilerActivity, profile

    idx, engine = toy
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=all_threads()) as prof:
        aligner = align(idx, engine, pe_bam_argv(work, "traced"))
    path = str(work / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = []
    for e in events:
        if e.get("ph") == "X" and str(e.get("name", "")).startswith("dart."):
            stage, _, k = e["name"].partition("#")
            ranges.append((stage, int(k) if k else None, e["ts"] * 1e-6,
                           (e["ts"] + e["dur"]) * 1e-6, e["tid"]))
    assert (work / "traced.bam").read_bytes() == \
        (work / "pe_bam.bam").read_bytes()
    return aligner.stats, ranges


def parent_of(r, ranges):
    """The smallest range other than ``r`` on its thread that holds it."""
    eps = 1e-6
    holders = [p for p in ranges if p is not r and p[4] == r[4]
               and p[2] <= r[2] + eps
               and r[3] <= p[3] + eps and p[3] - p[2] >= r[3] - r[2]]
    return min(holders, key=lambda p: p[3] - p[2], default=None)


def test_spans_charge_self_time_by_layer(monkeypatch):
    """On a clock that ticks a second a reading: a same-layer span counts
    inside its parents' keys, and a span of another layer or of none
    (the prefetch) is left out of every key around it."""
    ticks = iter(range(0, 10**12, 10**9))
    monkeypatch.setattr(spans, "time", types.SimpleNamespace(
        perf_counter_ns=lambda: next(ticks)))
    stats = dict.fromkeys(spans.KEYS, 0.0)
    rec = spans.Spans(stats)
    with rec.active(), rec("dart.chunk", 0):                 # 0 .. 19
        with rec("dart.seed.finish"):                          # 1 .. 16
            with spans.span("dart.seed.sync"):                 # 2 .. 3
                pass
            with rec("dart.prefetch", 2):                      # 4 .. 13
                with rec("dart.input", 2):                     # 5 .. 8
                    with spans.span("dart.input.open"):        # 6 .. 7
                        pass
                with rec("dart.seed.submit", 2):               # 9 .. 12
                    with spans.span("dart.seed.pack"):         # 10 .. 11
                        pass
            with spans.span("dart.seed.expand"):               # 14 .. 15
                pass
        with rec("dart.finalize"):                             # 17 .. 18
            pass
    want = dict.fromkeys(spans.KEYS, 0.0)
    want.update(device_sync_s=1.0, input_open_s=1.0, input_parse_s=3.0,
                seed_pack_s=1.0, seed_expand_s=1.0, native_finalize_s=1.0,
                device_only_wait_s=15.0 - 9.0,
                device_seed_locate_s=15.0 - 9.0 + 3.0)
    assert stats == want
    assert rec._open == []


def test_span_without_a_recorder_does_nothing():
    with spans.span("dart.seed.sync") as s:
        assert s is None
    with pytest.raises(KeyError):
        with spans.Spans({})("dart.no_such_stage"):
            pass


@pytest.mark.parametrize("run", ["se", "pe_bam"])
def test_substages_sum_within_their_stages(run, runs):
    s = runs[run].stats
    assert s["chunks"] >= 4
    assert all(s[k] >= 0 for k in spans.KEYS)
    assert 0 < s["input_open_s"] <= s["input_parse_s"] + SLACK_S
    assert s["seed_pack_s"] + s["device_sync_s"] + s["seed_expand_s"] \
        <= s["device_seed_locate_s"] + SLACK_S
    assert 0 < s["device_only_wait_s"] <= s["device_seed_locate_s"]
    assert 0 < s["finalize_parallel_s"] and 0 < s["finalize_serial_s"]
    assert s["finalize_parallel_s"] + s["finalize_serial_s"] \
        <= s["native_finalize_s"] + SLACK_S
    if run == "pe_bam":
        assert 0 < s["output_encode_s"] and 0 < s["output_deflate_s"]
        assert s["output_encode_s"] + s["output_deflate_s"] \
            <= s["output_s"] + SLACK_S
    else:
        assert s["output_encode_s"] == s["output_deflate_s"] == 0
    # each thread's stages within the wall: the main thread's, and the
    # finalize worker's
    main = ("input_parse_s", "device_seed_locate_s", "finalize_wait_s",
            "output_s")
    assert sum(s[k] for k in main) <= s["wall_s"]
    assert s["native_finalize_s"] <= s["wall_s"]


def test_first_file_reader_is_timed(work, toy):
    """A one-file run makes its only reader inside the input span."""
    s = align(*toy, se_argv(work, "one", files=1)).stats
    assert 0 < s["input_open_s"] <= s["input_parse_s"]


def test_trace_has_a_chunk_range_a_chunk_and_ranges_nest(traced):
    stats, ranges = traced
    chunk_ks = sorted(k for stage, k, *_ in ranges if stage == "dart.chunk")
    assert chunk_ks == list(range(stats["chunks"]))
    assert {r[0] for r in ranges} == set(PARENTS)
    for r in ranges:
        p = parent_of(r, ranges)
        assert (p[0] if p else None) in PARENTS[r[0]], (r, p)
        if p is None or p[1] is None or r[0] == "dart.prefetch":
            continue
        if r[0] in ("dart.finalize.wait", "dart.output"):
            # chunk k's drain writes chunk k - 1, and the last its own
            assert r[1] == p[1] - 1 or r[1] == p[1] == stats["chunks"] - 1, \
                (r, p)
            continue
        assert r[1] == p[1], (r, p)  # a chunk's spans carry its ordinal
    # each chunk is finalized once, on a thread of its own, and waited
    # for and written once, in order, on the main thread
    main = {r[4] for r in ranges if r[0] == "dart.chunk"}
    for stage, thread in (("dart.finalize", False),
                          ("dart.finalize.wait", True),
                          ("dart.output", True)):
        mine = sorted((r for r in ranges if r[0] == stage),
                      key=lambda r: r[2])
        assert [r[1] for r in mine] == list(range(stats["chunks"])), stage
        assert all((r[4] in main) == thread for r in mine), stage
    # the prefetch parses and submits chunk k + 2 inside chunk k's drain
    prefetched = [r for r in ranges if r[0] == "dart.input"
                  and parent_of(r, ranges)[0] == "dart.prefetch"]
    assert len(prefetched) >= 2
    for r in prefetched:
        chunk = [c for c in ranges if c[0] == "dart.chunk"
                 and c[2] <= r[2] and r[3] <= c[3]]
        assert len(chunk) == 1 and chunk[0][1] == r[1] - 2


@pytest.mark.parametrize("key", list(SELF_TIMES))
def test_trace_ranges_sum_to_the_stats_self_time(key, traced):
    """One clock serves both: each stage's summed ranges equal its stats
    key, within TRACE_TOL_S a range and TRACE_TOL_SHARE."""
    stats, ranges = traced
    stage, less = SELF_TIMES[key]
    mine = [r for r in ranges if r[0] == stage]
    got = sum(r[3] - r[2] for r in mine) - sum(
        r[3] - r[2] for r in ranges if r[0] == less)
    assert mine and stats[key] > 0
    assert abs(got - stats[key]) <= (TRACE_TOL_S * len(mine)
                                     + TRACE_TOL_SHARE * stats[key]), \
        (key, got, stats[key])


def test_no_record_function_without_a_profiler(work, toy, runs,
                                               monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    s = align(*toy, pe_bam_argv(work, "off")).stats
    assert s["chunks"] == runs["pe_bam"].stats["chunks"]
    assert (work / "off.bam").read_bytes() == \
        (work / "pe_bam.bam").read_bytes()


def test_shared_engine_counts_each_run_apart(work):
    """Two aligners on one engine each keep their own located rows; the
    engine's count holds both and a third caller's rows."""
    prefix = str(work / "dup")
    idx = load_index(prefix)
    engine = MemoEngine(idx, "cpu")
    argv = ["-i", prefix, "-f", os.path.join(DATA, "spliced.fa"), "-o",
            str(work / "dup.sam"), "-j", str(work / "dup.tab"), "-silent",
            "--batch", "600"]
    first = align(idx, engine, argv).stats["locate_rows"]
    engine.locate(np.arange(7))
    second = align(idx, engine, argv).stats["locate_rows"]
    alone = align(idx, MemoEngine(idx, "cpu"), argv).stats["locate_rows"]
    assert first > 0
    assert first == second == alone
    assert engine.n_locate_rows == first + second + 7


def test_cpu_engine_copies_no_bytes(runs, toy):
    for aligner in runs.values():
        assert aligner.stats["dtoh_bytes"] == aligner.stats["htod_bytes"] == 0
    assert toy[1].dtoh_bytes == toy[1].htod_bytes == 0


@pytest.mark.parametrize("threads", [1, 4])
def test_native_phase_times_keep_the_output(threads, work, toy):
    out = work / f"t{threads}"
    s = align(*toy, ["-i", TOY, "-f", os.path.join(DATA, "spliced.fa"),
                     "-t", str(threads), "-o", f"{out}.sam", "-j",
                     f"{out}.tab", "-silent", "--batch", "600"]).stats
    assert 0 < s["finalize_parallel_s"] and 0 < s["finalize_serial_s"]
    assert s["finalize_parallel_s"] + s["finalize_serial_s"] \
        <= s["native_finalize_s"] + SLACK_S
    with open(os.path.join(GOLD, "c3_spliced.sam"), "rb") as f:
        assert open(f"{out}.sam", "rb").read() == f.read()
    with open(os.path.join(GOLD, "c3_spliced.junctions.tab"), "rb") as f:
        assert open(f"{out}.tab", "rb").read() == f.read()


@pytest.mark.parametrize("metric", list(READERS))
def test_benchmark_reader(metric):
    """Each new reader gives its key a read, and nothing where the
    program has no such key; BENCHMARK.json lists it."""
    key, scale = READERS[metric]
    path = os.path.join(REPO, "benchmark", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location("reader_" + metric, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.read({"reads": 4000, "stats": {key: 2}}) == \
        pytest.approx(2 * scale / 4000)
    assert mod.read({"reads": 4000, "stats": {"input_parse_s": 1.0}}) is None
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        entry = {m["name"]: m for m in json.load(f)["per_layer"]}[metric]
    assert entry["moves"] == "reads_per_s"
    assert entry["source"] == ("program_counter" if scale == 1
                               else "program_span")


@pytest.mark.cuda
def test_one_chunk_copies_on_the_card(work):
    """On a card, a chunk's bytes to the host are its scan table (R rows
    of 1 + 4S int32) and its located positions (4 B a row), and to the
    card its packed reads ([codes | N bits | rlen] int32) and rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prefix = str(work / "dup")
    idx = load_index(prefix)
    reads = read_fasta(os.path.join(DATA, "spliced.fa"))
    R, L = len(reads), max(len(s) for s in reads.values())
    Lp = max(32, -(-L // 32) * 32)
    S = FMIndexTorch.seed_slots(Lp, L)
    words = Lp // 16
    s = align(idx, FMIndexTorch(idx, "cuda"),
              ["-i", prefix, "-f", os.path.join(DATA, "spliced.fa"), "-o",
               str(work / "card.sam"), "-j", str(work / "card.tab"),
               "-silent", "--batch", str(R)]).stats
    assert s["chunks"] == 1 and s["locate_rows"] > 0
    assert s["dtoh_bytes"] == R * (1 + 4 * S) * 4 + s["locate_rows"] * 4
    assert s["htod_bytes"] == R * (words + words // 2 + 1) * 4 \
        + s["locate_rows"] * 4
