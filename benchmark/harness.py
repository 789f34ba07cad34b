"""One run of one cell of ``BENCHMARK.json``, as ``run.py`` starts it:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1> [--fault <name>]

Everything a cell needs is found by name: its configuration in the
file ``BENCHMARK.json`` gives it (``benchmark/configs/<name>.json``),
its traffic mix in ``benchmark/traffic/<name>.json``, the limits of its
check in ``benchmark/limits/<workload>.json`` and each metric's reader
in ``benchmark/metrics/<metric>.py``. Adding a cell, a mix, a
configuration or a metric adds files and entries; no code changes.

Set-up (``setup_s``: from the process's start to the window's, less
the builds that only a checkout's first run makes, which the result
line reports apart under ``builds``) makes the configuration's genome
from its own seed, builds the port's index of it once into
``benchmark/cache/<config>/`` under a lock (later runs load it),
writes the pool of reads that ``--seed`` draws into a directory under
``TMPDIR``, loads the index, builds the engine (``make_engine``) and
runs the aligner twice on one chunk of the cell's shape. The second of
those runs gives the rate from which the window's length is set: the
window is one ``DartAligner(...).run()`` over the pool's files, listed
over and over (the multi-file path, ``-f``/``-f2``) as many times as
fill ``--seconds`` at that rate. SAM goes to a sink that keeps the
bytes; BAM and ``junctions.tab`` go to files in the run's directory.
With ``--trace 1`` the window runs under ``torch.profiler``.

After the window the card's peak is read and the program's state is
freed; then ``refcheck`` judges every record and the junction table,
and the result line is printed: the cell's end-to-end metrics
(``--trace 0``) or its per-layer ones (``--trace 1``), ``correct``,
``attempted`` (reads run), ``failed`` (reads without a sound primary
record), ``device``, ``builds`` and, last, ``checks``: each number
compared, with its limit. The same numbers end standard error.
"""

from __future__ import annotations

import argparse
import contextlib
import fcntl
import gc
import hashlib
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time

from . import devtrace, faults, genomes, reads, refcheck

HERE = os.path.dirname(os.path.abspath(__file__))
SUBDIR = os.path.basename(HERE)
REFUSED = ("jax", "jaxlib", "flax", "dart_tpu")


def process_start() -> float:
    """The process's start on the wall clock (``time.time()``), from
    ``/proc``; None where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(x.split()[1]) for x in f if x.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return None


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of ``BENCHMARK.json`` under ``root`` and everything it
    names, found by name."""

    def __init__(self, root: str, name: str):
        self.root = root
        self.bench = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_name = self.entry["config"]
        self.config = load_json(os.path.join(
            root, configs[self.config_name]["file"]))
        self.mix = load_json(os.path.join(root, SUBDIR, "traffic",
                                          self.entry["traffic"] + ".json"))
        self.limits = load_json(os.path.join(root, SUBDIR, "limits",
                                             name + ".json"))

    def metrics(self, traced: bool) -> list:
        """The cell's per-layer metrics with ``traced`` (those whose
        ``workloads`` name it), else its end-to-end ones (all of them,
        but one that lists other cells under ``workloads``)."""
        if traced:
            return [m for m in self.bench["per_layer"]
                    if self.name in m["workloads"]]
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def reader(self, metric: str):
        path = os.path.join(self.root, SUBDIR, "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


class Sink:
    """Where the window's SAM goes: the bytes of each write, kept."""

    def __init__(self):
        self.parts: list = []

    def write(self, b) -> int:
        self.parts.append(b if isinstance(b, bytes) else bytes(b))
        return len(b)

    def flush(self) -> None:
        pass


def ensure_index(cell: Cell, genome, setup: dict) -> str:
    """The port's index of the configuration's genome, built once into
    ``benchmark/cache/<config>/`` and loaded from there afterwards. The
    build runs under a lock of the configuration's, so that two runs of
    one checkout never build it at once."""
    cache = os.path.join(cell.root, SUBDIR, "cache")
    os.makedirs(cache, exist_ok=True)
    with open(os.path.join(cache, cell.config_name + ".lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        return _ensure_index(os.path.join(cache, cell.config_name), cell,
                             genome, setup)


def _ensure_index(d: str, cell: Cell, genome, setup: dict) -> str:
    from dart_tpu_torch.index import build_index

    prefix = os.path.join(d, "idx")
    stamp = os.path.join(d, "stamp.json")
    if os.path.exists(stamp) and load_json(stamp).get("digest") == \
            genome.digest:
        return prefix
    work = d + ".build"
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    genomes.write_fasta(genome, os.path.join(work, "genome.fa"))
    with contextlib.redirect_stdout(sys.stderr):
        build_index(os.path.join(work, "genome.fa"), os.path.join(work, "idx"))
    setup["index_build_s"] = time.perf_counter() - t0
    with open(os.path.join(work, "stamp.json"), "w") as f:
        json.dump({"digest": genome.digest,
                   "index_build_s": setup["index_build_s"]}, f)
    shutil.rmtree(d, ignore_errors=True)
    os.replace(work, d)
    log(f"built the index of {cell.config_name} in "
        f"{setup['index_build_s']:.1f} s")
    return prefix


def flag_value(flags: list, name: str, default):
    return type(default)(flags[flags.index(name) + 1]) if name in flags \
        else default


def run_cell(root: str, workload: str, seed: int, seconds: float,
             traced: bool, device: str = "cuda", fault: str | None = None,
             t_start: float | None = None) -> dict:
    """One run of the cell; returns the result line as a dict."""
    import torch

    from dart_tpu_torch.native import build as native_build

    t_start = time.time() if t_start is None else t_start
    cell = Cell(root, workload)
    setup: dict = {}
    t = time.perf_counter()
    native_build.build()
    setup["native_build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    genome = genomes.make_genome(cell.config["genome"])
    setup["genome_s"] = time.perf_counter() - t
    prefix = ensure_index(cell, genome, setup)
    tmp = tempfile.mkdtemp(prefix=f"dart_bench_{workload}_")
    try:
        return _run(cell, genome, prefix, tmp, seed, seconds, traced,
                    device, fault, t_start, setup, torch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _cfg(prefix: str, files: list, flags: list, out: str, bam: bool,
         tab: str):
    from dart_tpu_torch.cli import parse_args

    argv = ["-i", prefix]
    for f1, f2 in files:
        argv += ["-f", f1] + (["-f2", f2] if f2 else [])
    return parse_args(argv + list(flags) + ["-bo" if bam else "-o", out,
                                            "-j", tab, "-silent"])


def _align(aligner, out_stream, chunk_fault) -> None:
    if chunk_fault is not None:
        native = aligner.native
        produce = native.process_chunk
        native.process_chunk = lambda *a, **k: chunk_fault(produce(*a, **k))
    with contextlib.redirect_stdout(sys.stderr):
        aligner.run(out_stream=out_stream)


def _run(cell, genome, prefix, tmp, seed, seconds, traced, device, fault,
         t_start, setup, torch) -> dict:
    mix = cell.mix
    flags = list(cell.config["flags"])
    bam = mix["output"] == "bam"
    mates = 2 if mix["paired"] else 1
    t = time.perf_counter()
    pool = reads.make_pool(genome, mix, seed)
    files = reads.write_files(pool, mix, tmp)
    chunk = _cfg(prefix, [("reads", None)], flags, "out", bam,
                 "tab").batch_reads
    warm = reads.write_files(pool, dict(mix, file_fragments=chunk // mates),
                             tmp, tag="warm", n_files=1)
    setup["pool_s"] = time.perf_counter() - t

    from dart_tpu_torch.aligner import DartAligner, make_engine
    from dart_tpu_torch.index import load_index

    on_card = torch.device(device).type == "cuda"
    if on_card:
        from dart_tpu_torch.ops import build

        setup["kernel_build_s"] = build.build()[1]
    t = time.perf_counter()
    idx = load_index(prefix)
    setup["index_load_s"] = time.perf_counter() - t
    ext = "bam" if bam else "sam"
    cfg = _cfg(prefix, warm, flags, os.path.join(tmp, f"warm.{ext}"), bam,
               os.path.join(tmp, "warm.tab"))
    engine = make_engine(idx, cfg, device)
    setup["table_s"] = engine.setup_s["table"]
    setup["lut_s"] = engine.setup_s["lut"]
    warm_s = []
    for _ in range(2):
        t = time.perf_counter()
        _align(DartAligner(idx, cfg, engine), None if bam else Sink(), None)
        if on_card:
            torch.cuda.synchronize()
        warm_s.append(time.perf_counter() - t)
    setup["warm_s"] = sum(warm_s)
    rate = chunk / warm_s[-1]
    per_file = int(mix["file_fragments"]) * mates
    n_listed = max(1, math.ceil(seconds * rate / per_file))
    listed = [files[k % len(files)] for k in range(n_listed)]
    copies = [sum(1 for k in range(n_listed) if k % len(files) == j)
              for j in range(len(files))]
    out = os.path.join(tmp, f"window.{ext}")
    tab = os.path.join(tmp, "window.tab")
    cfg = _cfg(prefix, listed, flags, out, bam, tab)
    aligner = DartAligner(idx, cfg, engine)
    sink = None if bam else Sink()
    chunk_fault = faults.chunk_fault(fault) if fault else None
    gc.collect()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_card else [])
        prof = profile(activities=acts)
    builds = {k: setup[k] for k in BUILDS if k in setup}
    t0 = time.time()
    # the builds that only a checkout's first run makes are kept apart
    setup_s = t0 - t_start - sum(builds.values())
    with prof if prof is not None else contextlib.nullcontext():
        _align(aligner, sink, chunk_fault)
        if on_card:
            torch.cuda.synchronize()
        window_s = time.time() - t0
    n_reads = n_listed * per_file
    stats = dict(aligner.stats)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    trace = None
    if prof is not None:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        trace = devtrace.summary(path)
        os.remove(path)
    del aligner, engine, idx
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    log(f"{cell.name}: {n_reads} reads ({n_listed} files) in {window_s:.3f} s"
        f", set-up {setup_s:.3f} s")
    log("window stages, s: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                         stats.items()
                                         if isinstance(v, float)))
    log("set-up parts, s: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                        setup.items()))
    table_fault = faults.table_fault(fault) if fault else None
    if table_fault is not None:
        table_fault(tab)

    t = time.perf_counter()
    check = judge(cell, genome, pool, sink, out, tab, copies, flags)
    check_s = time.perf_counter() - t
    log(f"{cell.name}: the reference took {check_s:.2f} s")
    for rec in check["nm_off_seen"]:
        log(f"NM is not the replayed edits: {rec}")
    run = {"reads": n_reads, "window_s": window_s, "setup_s": setup_s,
           "setup": setup, "stats": stats, "check": check, "trace": trace}
    metrics = {}
    for m in cell.metrics(traced):
        v = cell.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = {k: {"value": check[k], "limit": cell.limits[k]}
              for k in refcheck.NUMBERS}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": int(cell.entry["chips"]), "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": n_reads,
              "failed": check["reads_missing"] + check["records_wrong"],
              "metrics": metrics, "device": dev}
    if trace is not None:
        dev["busy_s"] = trace.get("busy_s", 0.0)
        dev["window_s"] = trace.get("window_s", window_s)
        result["breakdown"] = {"device_ops": trace.get("device_ops", []),
                               "idle_gaps": trace.get("idle_gaps", [])}
    result["builds"] = builds
    result["checks"] = checks
    return result


BUILDS = ("native_build_s", "index_build_s", "kernel_build_s")


def judge(cell, genome, pool, sink, out, tab, copies, flags) -> dict:
    """``refcheck``'s numbers for the window's outputs."""
    mix = cell.mix
    ref = refcheck.Reference(
        genome, pool, mix["file_fragments"], bool(mix["paired"]),
        min_intron=flag_value(flags, "-min_intron", 5),
        all_sj="-all_sj" in flags)
    rl = int(mix["read_len"])
    if sink is not None:
        seen: dict = {}
        for part in sink.parts:
            seen[part] = seen.get(part, 0) + 1
        del sink.parts[:]
        for part, mult in seen.items():
            ref.judge(refcheck.parse_sam(part, ref.chrom_ix, rl), mult)
    else:
        data, names, off = refcheck.bam_blob(out)
        offs = refcheck.bam_offsets(data, off)
        per = int(mix["file_fragments"]) * ref.mates
        n_files = sum(copies)
        if len(offs) - 1 == per * n_files:
            # one block a listed file, each judged once per distinct bytes
            seen = {}
            view = memoryview(data)
            for k in range(n_files):
                lo, hi = offs[k * per], offs[(k + 1) * per]
                key = hashlib.blake2b(view[lo:hi]).digest()
                if key in seen:
                    seen[key][1] += 1
                else:
                    seen[key] = [offs[k * per:(k + 1) * per + 1], 1]
            for key, (o, mult) in seen.items():
                ref.judge(refcheck.parse_bam(data, o, names, ref.chrom_ix,
                                             rl), mult)
        else:
            ref.judge(refcheck.parse_bam(data, offs, names, ref.chrom_ix,
                                         rl), 1)
    return ref.finish(copies, refcheck.read_tab(tab))


def refused_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", choices=faults.NAMES, default=None,
                   help="plant a fault under the timed path (ungapped: "
                        "the control); never in the benchmark's own runs")
    return p.parse_args(argv)


def main(argv, root: str, t_start: float | None) -> int:
    args = parse(argv)
    cell = Cell(root, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell.entry["chips"]):
        print(f"{args.workload} needs {cell.entry['chips']} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(root, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", args.fault, t_start)
    bad = refused_modules()
    if bad:
        print(f"refused modules were loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
