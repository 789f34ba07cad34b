"""A configuration with ``"processes": N`` run as N processes, one a card,
over gloo: the program's multi-host path (``--dist-nprocs N``,
``dart_tpu_torch.parallel.distributed``) as a deployment of N hosts
runs it, laid onto the cards of one host.

``run_cell`` is ``harness.run_cell``'s counterpart for such a
configuration. ``run.py`` does not reach it yet: ``harness.run_cell``
runs every cell of ``BENCHMARK.json`` as one process, so a cell of N
processes enters ``BENCHMARK.json`` only with a hand-over there.
``run_cell`` refuses a cell whose ``chips`` is not its ``processes``,
takes the genome of the configuration that ``"genome_of"`` names (and
shares its index in ``cache/``), makes what every cell needs (the
native library, the genome, the index) as ``harness.run_cell`` does and
hands over to ``run`` in its own process, the parent, which touches no
card. The parent writes the pool
of reads and a warm-up file of one chunk a process, builds the CUDA
kernels, holds a port (``distributed.held_port``), starts N workers (``python -m
benchmark.dist <spec> <k>``) and watches them: as soon as one exits
with another code than 0 it kills the rest and raises, so that no run
waits out gloo's ``TIMEOUT_S`` and none prints a result.

Worker k joins gloo at ``tcp://127.0.0.1:<port>``, loads the index,
builds its engine on ``rank_device(device, k)`` (card k mod the card
count) and warms up with one pass of the shard path over the warm-up
file with the other workers. Process 0's rate over that pass, its merge
included, sets how many files the window lists to fill ``--seconds``,
and process 0 broadcasts the count. The window opens at a barrier, on
process 0's clock, runs the shard path over the listed files, and
closes on process 0 at a barrier after each worker's
``torch.cuda.synchronize()``. Each worker then writes its ``stats``,
its card's peak and, with ``--trace 1``, the summary of its own
profiler's trace to ``worker<k>.json``.

The shard path is the program's own ``distributed._run``, the body of
each process of ``run_distributed`` (``shard_pass``): the shard
readers, the stream, the shard files, the gathers and process 0's
merge. ``combine`` joins the workers' files for the metric readers, and
``judge`` holds what the deployment leaves, process 0's merged SAM and
``junctions.tab``, to the reference.
"""

from __future__ import annotations

import contextlib
import copy
import datetime
import gc
import hashlib
import json
import math
import mmap
import os
import shutil
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np

from . import devtrace, faults, genomes, harness, reads, refcheck

WORKERS_S = 300  # the workers of a run end by then, or the run fails
STDERR = 2  # the workers' standard output goes to the parent's errors
STEP = 1 << 26  # bytes of the merged SAM scanned for line ends at a time
# the engine's counters, under their stats keys (DartAligner.run keeps
# their change over a run; the shard path does not)
COUNTERS = (("dtoh_bytes", "dtoh_bytes"), ("htod_bytes", "htod_bytes"),
            ("locate_rows", "n_locate_rows"))


def run_cell(root: str, workload: str, seed: int, seconds: float,
             traced: bool, device: str = "cuda", fault: str | None = None,
             t_start: float | None = None) -> dict:
    """One run of a cell of N processes; returns the result line as a
    dict, as ``harness.run_cell`` does for a cell of one."""
    import torch

    from dart_tpu_torch.native import build as native_build

    t_start = time.time() if t_start is None else t_start
    cell = harness.Cell(root, workload)
    procs = cell.config.get("processes")
    if procs is None or int(procs) != int(cell.entry["chips"]):
        raise ValueError(f"{workload} runs {procs} processes, a card each, "
                         f"but asks for {cell.entry['chips']} card(s)")
    # a configuration that names another's genome ("genome_of") runs
    # that genome, from that configuration's index cache
    index_of = copy.copy(cell)
    if "genome_of" in cell.config:
        index_of.config_name = cell.config["genome_of"]
        files = {c["name"]: c["file"] for c in cell.bench["configs"]}
        cell.config["genome"] = harness.load_json(os.path.join(
            root, files[index_of.config_name]))["genome"]
    setup: dict = {}
    t = time.perf_counter()
    native_build.build()
    setup["native_build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    genome = genomes.make_genome(cell.config["genome"])
    setup["genome_s"] = time.perf_counter() - t
    prefix = harness.ensure_index(index_of, genome, setup)
    tmp = tempfile.mkdtemp(prefix=f"dart_bench_{workload}_")
    try:
        return run(cell, genome, prefix, tmp, seed, seconds, traced, device,
                   fault, t_start, setup, torch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run(cell, genome, prefix, tmp, seed, seconds, traced, device, fault,
        t_start, setup, torch) -> dict:
    """``harness._run``'s counterpart for N processes: the result line."""
    mix = cell.mix
    flags = list(cell.config["flags"])
    if mix["output"] != "sam":
        # judge reads the merged output as SAM text
        raise ValueError(f"{cell.name}: a multi-process cell writes SAM")
    mates = 2 if mix["paired"] else 1
    n = int(cell.config["processes"])
    t = time.perf_counter()
    pool = reads.make_pool(genome, mix, seed)
    files = reads.write_files(pool, mix, tmp)
    chunk = harness._cfg(prefix, [("reads", None)], flags, "out", False,
                         "tab").batch_reads
    # the warm-up: one chunk for each process
    warm_fragments = min(n * chunk // mates, pool.n)
    warm = reads.write_files(pool, dict(mix, file_fragments=warm_fragments),
                             tmp, tag="warm", n_files=1)
    setup["pool_s"] = time.perf_counter() - t

    # the program's multi-host path: a program without it fails here,
    # before any worker starts
    from dart_tpu_torch.parallel.distributed import held_port

    on_card = torch.device(device).type == "cuda"
    if on_card:
        from dart_tpu_torch.ops import build

        setup["kernel_build_s"] = build.build()[1]
    spec = {"prefix": prefix, "tmp": tmp, "files": files, "warm": warm,
            "warm_reads": warm_fragments * mates,
            "per_file": int(mix["file_fragments"]) * mates,
            "flags": flags, "processes": n, "seconds": seconds,
            "traced": traced, "device": device, "fault": fault}
    port, sock = held_port()
    with sock:
        spec["port"] = port
        path = os.path.join(tmp, "spec.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        start(cell.root, path, n)
    workers = [harness.load_json(os.path.join(tmp, f"worker{k}.json"))
               for k in range(n)]

    t0 = workers[0]["t0"]
    window_s = workers[0]["t1"] - t0
    n_listed = workers[0]["n_listed"]
    per_file = int(mix["file_fragments"]) * mates
    n_reads = n_listed * per_file
    builds = {k: setup[k] for k in harness.BUILDS if k in setup}
    # the builds that only a checkout's first run makes are kept apart
    setup_s = t0 - t_start - sum(builds.values())
    joined = combine(workers)
    setup.update(joined["setup"])
    harness.log(f"{cell.name}: {n_reads} reads ({n_listed} files) on {n} "
                f"processes in {window_s:.3f} s, set-up {setup_s:.3f} s")
    harness.log("window stages summed over the processes, s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in joined["stats"].items()
        if isinstance(v, float)))
    harness.log("set-up parts, s: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                                setup.items()))
    out = os.path.join(tmp, "window.sam")
    tab = os.path.join(tmp, "window.tab")
    table_fault = faults.table_fault(fault) if fault else None
    if table_fault is not None:
        table_fault(tab)

    copies = [sum(1 for k in range(n_listed) if k % len(files) == j)
              for j in range(len(files))]
    t = time.perf_counter()
    check = judge(cell, genome, pool, out, tab, copies, flags)
    harness.log(f"{cell.name}: the reference took "
                f"{time.perf_counter() - t:.2f} s")
    for rec in check["nm_off_seen"]:
        harness.log(f"NM is not the replayed edits: {rec}")
    trace = joined["trace"]
    run = {"reads": n_reads, "window_s": window_s, "setup_s": setup_s,
           "setup": setup, "stats": joined["stats"], "check": check,
           "trace": trace}
    metrics = {}
    for m in cell.metrics(traced):
        v = cell.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = {k: {"value": check[k], "limit": cell.limits[k]}
              for k in refcheck.NUMBERS}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": workers[0]["kind"], "count": int(cell.entry["chips"]),
           "memory_peak_bytes": max(w["peak"] for w in workers)}
    result = {"correct": correct, "attempted": n_reads,
              "failed": check["reads_missing"] + check["records_wrong"],
              "metrics": metrics, "device": dev}
    if trace is not None:
        # the device's times, averaged over the processes' cards
        dev["busy_s"] = trace["busy_s"] / n
        dev["window_s"] = trace["window_s"] / n
        result["breakdown"] = {"device_ops": trace["device_ops"],
                               "idle_gaps": trace["idle_gaps"]}
    result["builds"] = builds
    result["checks"] = checks
    return result


def start(root: str, spec_path: str, n: int) -> None:
    """Start the N workers from ``root`` and wait for them (``watch``);
    whatever is still running when that ends is killed and waited
    for."""
    import dart_tpu_torch

    env = dict(os.environ)
    paths = [root, os.path.dirname(os.path.dirname(
        os.path.abspath(dart_tpu_torch.__file__)))]
    if env.get("PYTHONPATH"):
        paths.append(env["PYTHONPATH"])
    env["PYTHONPATH"] = os.pathsep.join(paths)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "benchmark.dist", spec_path, str(k)],
        cwd=root, env=env, stdout=STDERR) for k in range(n)]
    try:
        watch(procs, time.time() + WORKERS_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()


def watch(procs: list, deadline: float) -> None:
    """Return once every worker has exited with 0; raise as soon as one
    exits with another code, or at ``deadline``."""
    while True:
        codes = [p.poll() for p in procs]
        failed = {k: c for k, c in enumerate(codes) if c not in (None, 0)}
        if failed:
            raise RuntimeError(f"worker(s) failed, exit codes {failed}: "
                               "the others are stopped")
        if all(c == 0 for c in codes):
            return
        if time.time() > deadline:
            raise RuntimeError(f"the workers ran past {WORKERS_S} s")
        time.sleep(0.05)


def shard_pass(idx, engine, cfg, n: int, k: int, dev, chunk_fault=None):
    """One call of the program's shard path, ``distributed._run(cfg, n,
    k, dev)``, on this worker's loaded index and built engine. Returns
    the aligner that ``_run`` built, with its ``stats``.

    ``_run`` loads the index and builds an engine of its own, which the
    window must not time. It looks ``load_index``, ``make_engine`` and
    ``DartAligner`` up in their modules at each call, so for the call
    these hand it this worker's index and engine, and keep the aligner
    (with ``chunk_fault`` planted where its native pipeline hands on a
    chunk's SAM, as ``harness._align`` plants it). All else is ``_run``'s
    own. Each replacement counts its calls: a ``_run`` that reached any
    of the three another way (and so timed its own set-up) raises."""
    from dart_tpu_torch import aligner as aligner_mod
    from dart_tpu_torch import index as index_mod
    from dart_tpu_torch.parallel import distributed

    make = aligner_mod.DartAligner
    built, calls = [], {"load_index": 0, "make_engine": 0}

    def given(name, value):
        def call(*args, **kwargs):
            calls[name] += 1
            return value
        return call

    def aligner(*args, **kwargs):
        a = make(*args, **kwargs)
        if chunk_fault is not None:
            produce = a.native.process_chunk
            a.native.process_chunk = \
                lambda *x, **y: chunk_fault(produce(*x, **y))
        built.append(a)
        return a

    with contextlib.ExitStack() as stack:
        for mod, name, value in (
                (index_mod, "load_index", given("load_index", idx)),
                (aligner_mod, "make_engine", given("make_engine", engine)),
                (aligner_mod, "DartAligner", aligner)):
            stack.enter_context(mock.patch.object(mod, name, value))
        stack.enter_context(contextlib.redirect_stdout(sys.stderr))
        distributed._run(cfg, n, k, dev)
    if calls != {"load_index": 1, "make_engine": 1} or len(built) != 1:
        raise RuntimeError(
            "distributed._run no longer loads its index, builds its engine "
            "and its aligner through the names shard_pass replaces "
            f"({calls}, {len(built)} aligner(s)): it would time its own "
            "set-up")
    return built[0]


def worker(spec: dict, k: int) -> dict:
    """Process k of the run: joins the group, warms up, runs the window
    and returns what ``worker<k>.json`` holds."""
    import torch.distributed as tdist

    from dart_tpu_torch.parallel.distributed import TIMEOUT_S

    tdist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{spec['port']}",
        world_size=spec["processes"], rank=k,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        return _worker(spec, k, tdist)
    finally:
        tdist.destroy_process_group()


def _worker(spec, k, tdist) -> dict:
    import torch

    from dart_tpu_torch.aligner import make_engine
    from dart_tpu_torch.index import load_index
    from dart_tpu_torch.parallel.distributed import rank_device

    n, tmp = spec["processes"], spec["tmp"]
    # the host's cores shared out, as N hosts would each have their own:
    # on a host of four cards and 32 cores, the 8 of a one-card machine
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    dev = rank_device(spec["device"], k)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(dev)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def cfg(files, name):
        return harness._cfg(spec["prefix"], files, spec["flags"],
                            os.path.join(tmp, f"{name}.sam"), False,
                            os.path.join(tmp, f"{name}.tab"))

    setup = {}
    t = time.perf_counter()
    idx = load_index(spec["prefix"])
    setup["index_load_s"] = time.perf_counter() - t
    warm = cfg(spec["warm"], "warm")
    engine = make_engine(idx, warm, dev)
    setup["table_s"] = engine.setup_s["table"]
    setup["lut_s"] = engine.setup_s["lut"]
    # the one warm-up: a pass of the shard path, a chunk each process
    tdist.barrier()
    t = time.perf_counter()
    shard_pass(idx, engine, warm, n, k, dev)
    sync()
    setup["warm_s"] = time.perf_counter() - t
    rate = spec["warm_reads"] / setup["warm_s"]
    count = torch.tensor([max(1, math.ceil(
        spec["seconds"] * rate / spec["per_file"]))])
    tdist.broadcast(count, 0)  # process 0's pass sets the window
    n_listed = int(count[0])
    files = spec["files"]
    window = cfg([files[j % len(files)] for j in range(n_listed)], "window")
    fault = spec["fault"]
    chunk_fault = faults.chunk_fault(fault) if fault else None
    counts0 = {key: getattr(engine, attr, 0) for key, attr in COUNTERS}
    gc.collect()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    prof = None
    if spec["traced"]:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_card else [])
        prof = profile(activities=acts)
    with prof if prof is not None else contextlib.nullcontext():
        tdist.barrier()
        t0 = time.time()
        aligner = shard_pass(idx, engine, window, n, k, dev, chunk_fault)
        sync()
        tdist.barrier()
        t1 = time.time()
    stats = dict(aligner.stats)
    for key, attr in COUNTERS:
        stats[key] = getattr(engine, attr, 0) - counts0[key]
    trace = None
    if prof is not None:
        path = os.path.join(tmp, f"trace{k}.json")
        prof.export_chrome_trace(path)
        del prof
        trace = devtrace.summary(path)
        os.remove(path)
    return {"n_listed": n_listed, "t0": t0, "t1": t1,
            "stats": stats, "setup": setup,
            "card": dev.index if on_card else k,
            "peak": torch.cuda.max_memory_allocated(dev) if on_card else 0,
            "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "trace": trace}


def combine(workers: list) -> dict:
    """The workers' files as one run: ``stats`` summed key by key;
    ``setup`` the slowest worker's each part; ``trace`` (None untraced):
    the cards' times summed, device operations summed by name, and the
    longest idle gaps over all cards, each named ``card<k>:``."""
    stats: dict = {}
    for w in workers:
        for key, v in w["stats"].items():
            stats[key] = stats.get(key, 0) + v
    setup = {key: max(w["setup"][key] for w in workers)
             for key in workers[0]["setup"]}
    trace = None
    if workers[0]["trace"] is not None:
        traces = [w["trace"] for w in workers]
        trace = {key: sum(t.get(key, 0.0) for t in traces)
                 for key in ("busy_s", "window_s", "kernel_s", "copy_s")}
        ops: dict = {}
        for t in traces:
            for name, s in t.get("device_ops", []):
                ops[name] = ops.get(name, 0.0) + s
        trace["device_ops"] = [[name, s] for name, s in sorted(
            ops.items(), key=lambda kv: -kv[1])[:devtrace.TOP]]
        trace["idle_gaps"] = sorted(
            ([f"card{w['card']}: {name}", s] for w in workers
             for name, s in w["trace"].get("idle_gaps", [])),
            key=lambda g: -g[1])[:devtrace.TOP]
    return {"stats": stats, "setup": setup, "trace": trace}


def judge(cell, genome, pool, out, tab, copies, flags) -> dict:
    """``refcheck``'s numbers for the merged SAM, read through ``mmap``
    in blocks of one listed file's records, each distinct block judged
    once."""
    mix = cell.mix
    ref = refcheck.Reference(
        genome, pool, mix["file_fragments"], bool(mix["paired"]),
        min_intron=harness.flag_value(flags, "-min_intron", 5),
        all_sj="-all_sj" in flags)
    rl = int(mix["read_len"])
    per = int(mix["file_fragments"]) * ref.mates
    with open(out, "rb") as f, \
            mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        blocks: dict = {}
        for lo, hi in sam_blocks(mm, per):
            key = hashlib.blake2b(mm[lo:hi]).digest()
            blocks.setdefault(key, [lo, hi, 0])[2] += 1
        for lo, hi, mult in blocks.values():
            ref.judge(refcheck.parse_sam(mm[lo:hi], ref.chrom_ix, rl), mult)
    return ref.finish(copies, refcheck.read_tab(tab))


def sam_blocks(mm, per: int) -> list:
    """The [lo, hi) byte ranges of ``per`` records each (the last, the
    rest) of the SAM text in ``mm``, its header lines left out."""
    body = 0
    while mm[body:body + 1] == b"@":
        nl = mm.find(b"\n", body)
        body = len(mm) if nl < 0 else nl + 1
    ends = []
    for lo in range(body, len(mm), STEP):
        view = np.frombuffer(mm, dtype=np.uint8,
                             count=min(STEP, len(mm) - lo), offset=lo)
        ends.append(np.flatnonzero(view == 10) + (lo + 1))
        del view  # no view of the map may outlive it
    cuts = [body] + (np.concatenate(ends)[per - 1::per].tolist()
                     if ends else [])
    if cuts[-1] < len(mm):
        cuts.append(len(mm))
    return list(zip(cuts[:-1], cuts[1:]))


def main(spec_path: str, k: int) -> int:
    spec = harness.load_json(spec_path)
    res = worker(spec, k)
    bad = harness.refused_modules()
    if bad:
        print(f"worker {k}: refused modules were loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    with open(os.path.join(spec["tmp"], f"worker{k}.json"), "w") as f:
        json.dump(res, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
