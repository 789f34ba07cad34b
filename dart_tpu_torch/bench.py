"""The port's bench line, the counterpart of the root ``bench.py`` (and of
``tools/prep_bench_data.py`` and ``tools/bench_big_wide.py``):

    python -m dart_tpu_torch.bench [--configs a,b] [--reads N]
        [--parity-reads N] [--device cuda|cpu]
    python -m dart_tpu_torch.bench prep [--configs a,b] [--reads N]
        [--parity-reads N]

prints ONE JSON line last, with ``bench.py``'s keys: ``metric``
("rna_seq_align_throughput"), ``value`` (8mbp_se's best reads/s),
``unit``, ``vs_baseline``, ``host_fault_mbps`` and ``configs``, plus
``device`` (the card's name and power limit, as ``nvidia-smi`` gives
them). It imports ``torch`` and the port, never JAX, ``dart_tpu``, the
root ``bench.py`` or ``tools/``.

Each config of ``benchdata.CONFIGS`` (``--configs`` selects them, in
that order) is a data set under ``benchdata.bench_dir()``, made from its
seed when it is not there, or, for a prebuilt one, read when its files
are there and skipped with the reason in the line when they are not.
For each: the engine is built once (``aligner.make_engine``; its set-up
priced apart, ``setup_s`` and ``setup_split``), one untimed warm pass
runs, then timed passes of ``DartAligner(...).run()`` each followed by
``torch.cuda.synchronize()``, timed by the host clock from just before
``run()`` to just after the synchronise (the aligner is made before the
clock starts), until at least 3 passes with two within 8% of the best,
and at most the config's ``passes`` + 4 (``pass_loop``, ``_converged``).
The line carries the best and median reads/s, every pass, the spread,
the best pass's stage split (``aligner.stats``, its own ``wall_s``
included), the launches of each kernel (the engine's counts after the
timed passes, the K-mer table build at set-up included, and over the
timed passes alone) and, from one more pass under
``aligner.profiled`` in a child process (not a timed pass: the profiler
slows the host),
the kernels' time by name, the card's idle share of the traced window,
the five device operations that took the most time and the five longest
idle gaps, each named by the CPU-side events of the trace that cover
it, precede it and end it (``trace_summary``).

Parity: the oracle is the reference binary's ``-t 1`` output when
``REF_BIN`` exists (then its passes are timed interleaved with ours, as
``bench.py`` does, and ``vs_baseline`` is filled); else the port's own
``--device cpu`` run of the same reads and flags (``port_cpu``), cached
beside the data set and made before any timed pass. The whole read set
is compared unless ``--parity-reads N`` names the first N records of
each read file, which the card then aligns in one untimed run. SAM is
compared record for record in order, BAM decompressed record for record.

The run exits 1 when a config raised, when any parity or junction count
is short of N/N, or when no config was measured; the line is printed
all the same. ``--device`` defaults to ``cuda`` and raises without a
card; ``cpu`` runs the plain versions (the profile is then "not
measured"). ``prep`` makes the non-prebuilt data sets, times their
index builds and writes the oracles, and times nothing else.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import glob
import gzip
import hashlib
import json
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import time

from . import benchdata
from .benchdata import CONFIGS, INDEX_EXTS, READ_LEN, SEED  # noqa: F401

REF_BIN = "/tmp/dart_ref/bin/dart"
REF_IDX_BIN = "/tmp/dart_ref/bin/bwt_index"
METRIC = "rna_seq_align_throughput"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 5  # device operations and idle gaps listed


class Skip(Exception):
    """A prebuilt config whose data set is not there."""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def host_fault_mbps() -> float:
    """First-touch anonymous-memory speed (MB/s) right now: a slow
    window multiplies every index load, so the number travels with the
    results to qualify the window."""
    import mmap

    sz = 256 << 20
    m = mmap.mmap(-1, sz)
    t0 = time.perf_counter()
    for off in range(0, sz, mmap.PAGESIZE):
        m[off] = 1
    dt = time.perf_counter() - t0
    m.close()
    return sz / 1e6 / max(dt, 1e-9)


def _count_fastq_records(path: str) -> int:
    n = 0
    with open(path, "rb") as f:
        while True:
            b = f.read(1 << 24)
            if not b:
                break
            n += b.count(b"\n")
    return n // 4


def ensure_dataset(cname: str, spec: dict, work: str | None = None) -> dict:
    """The data set of config ``cname``: made (``benchdata.make_dataset``)
    when the config generates it, found when it is prebuilt (raises
    ``Skip`` with the reason when it is not ready), or taken from the
    ``prefix`` and ``reads`` it names (raises FileNotFoundError when one
    is missing). Returns {"fq", "prefix", "dir" (where this config's
    outputs go: <work>/<cname>), "index_build_s", "meta_path"}."""
    work = work or benchdata.bench_dir()
    out = os.path.join(work, cname)
    if "prefix" in spec:
        fqs = tuple(spec["reads"])
        missing = [p for p in (spec["prefix"] + ".bwt", *fqs)
                   if p and not os.path.exists(p)]
        if missing:
            raise FileNotFoundError(f"{cname}: missing {', '.join(missing)}")
        os.makedirs(out, exist_ok=True)
        return {"fq": fqs, "prefix": spec["prefix"], "dir": out,
                "index_build_s": None, "meta_path": None}
    if spec.get("prebuilt"):
        d = os.path.join(work, spec["dir"])
        prefix = os.path.join(d, "idx")
        meta_p = os.path.join(d, "meta.json")
        fq1, fq2 = (os.path.join(d, r) for r in spec["reads"])
        # readiness gate: a bench that raced a still-running prep found
        # idx.bwt written and idx.sa half-written. Require every index
        # file, both read files and, where the prep writes one, the
        # prep-complete marker it writes last
        need = [prefix + ext for ext in INDEX_EXTS] + [fq1, fq2]
        missing = [p for p in need if not os.path.exists(p)]
        meta = benchdata.read_meta(d)
        if missing or (spec.get("ready_flag") and not meta.get("ready")):
            why = (f"missing {', '.join(os.path.basename(p) for p in missing)}"
                   if missing else "meta.json lacks ready=true "
                   "(prep still running or interrupted)")
            raise Skip(f"prebuilt data set not ready in {d} ({why}); "
                       f"made by {spec['made_by']}")
        # a stale read file at the expected path would skew reads/s
        got = _count_fastq_records(fq1) + _count_fastq_records(fq2)
        if got != spec["n_reads"]:
            raise Skip(f"read files hold {got} records, spec says "
                       f"{spec['n_reads']}")
        os.makedirs(out, exist_ok=True)
        return {"fq": (fq1, fq2), "prefix": prefix, "dir": out,
                "index_build_s": meta.get("index_build_s"),
                "ref_index_build_s": meta.get("ref_index_build_s"),
                "meta_path": meta_p}
    ds = benchdata.make_dataset(cname, work, spec)
    d = os.path.dirname(ds["prefix"])
    return {**ds, "index_build_s": benchdata.read_meta(d).get("index_build_s"),
            "meta_path": os.path.join(d, "meta.json")}


def _builder_fingerprint() -> str:
    """Version key for cached index-build timings: a hash of the
    builder sources, so any builder change invalidates the cache."""
    here = os.path.dirname(os.path.abspath(__file__))
    h = hashlib.sha256()
    for rel in ("native/sais.cpp", "index/builder.py", "index/packer.py"):
        with open(os.path.join(here, rel), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:12]


def time_index_builds(cname: str, spec: dict, ds: dict):
    """Time the port's builder and the reference ``bwt_index`` on the
    same genome, interleaved and best of 2 each, cached in the data
    set's meta as a pair; without the reference (or for a config that
    does not ask), the port's build seconds stored when the index was
    made. Returns (ours_s, ref_s)."""
    if ds["meta_path"] is None:
        return None, None
    meta = benchdata.read_meta(os.path.dirname(ds["meta_path"]))
    ver = _builder_fingerprint()
    if "build_pair_s" in meta and meta.get("build_pair_ver") == ver:
        return tuple(meta["build_pair_s"])
    if not spec.get("time_ref_build") or not os.path.exists(REF_IDX_BIN):
        return ds["index_build_s"], ds.get("ref_index_build_s")
    from .index import build_index

    d = os.path.dirname(ds["meta_path"])
    fa = os.path.join(d, "genome.fa")
    out_prefix = os.path.join(d, "refidx")
    log(f"bench[{cname}]: timing both index builders (2 interleaved "
        f"passes each)...")
    ours_t: list[float] = []
    ref_t: list[float] = []
    for _ in range(2):
        t0 = time.perf_counter()
        build_index(fa, out_prefix)
        ours_t.append(time.perf_counter() - t0)
        for ext in (*INDEX_EXTS, ".sad"):
            with contextlib.suppress(FileNotFoundError):
                os.unlink(out_prefix + ext)
        t0 = time.perf_counter()
        subprocess.run([REF_IDX_BIN, fa, out_prefix], check=True,
                       capture_output=True, timeout=7200)
        ref_t.append(time.perf_counter() - t0)
        for ext in INDEX_EXTS:
            with contextlib.suppress(FileNotFoundError):
                os.unlink(out_prefix + ext)
    meta["build_pair_s"] = [min(ours_t), min(ref_t)]
    meta["build_pair_ver"] = ver
    meta["build_pair_fault_mbps"] = host_fault_mbps()
    benchdata.write_meta(d, meta)
    log(f"bench[{cname}]: index build: ours {min(ours_t):.0f}s, "
        f"reference bwt_index {min(ref_t):.0f}s (best of 2 each)")
    return min(ours_t), min(ref_t)


def _flags(spec: dict, threads: str | None = None) -> list[str]:
    """The config's flags, with ``-t`` replaced by ``threads``."""
    flags, out = list(spec["flags"]), []
    while flags:
        f = flags.pop(0)
        if f == "-t":
            flags.pop(0)
        else:
            out.append(f)
    return out + (["-t", threads] if threads else [])


def _ref_cmd(spec: dict, ds: dict, out: str | None, bam: bool,
             silent: bool = True):
    fq1, fq2 = ds["fq"]
    cmd = [REF_BIN, "-i", ds["prefix"], "-f", fq1]
    if fq2:
        cmd += ["-f2", fq2]
    cmd += [*_flags(spec, "1"),
            "-j", os.path.join(ds["dir"], "ref.junctions.tab")]
    if silent:
        cmd += ["-silent"]
    if bam:
        cmd += ["-bo", out]
    elif out:
        cmd += ["-o", out]
    return cmd


def head_fastq(fq: str, n: int, out: str, name: str = "") -> str:
    """The first n records of a FASTQ file, as a file under out
    (``name``, default head<n>.fq)."""
    head = os.path.join(out, name or f"head{n}.fq")
    with open(fq, "rb") as f, open(head, "wb") as g:
        for i, line in enumerate(f):
            if i == 4 * n:
                break
            g.write(line)
    return head


def parity_reads(spec: dict, ds: dict, n_parity: int | None):
    """The read files parity is held on: the whole set, or the first
    n_parity records of each file (written beside the outputs)."""
    if not n_parity or n_parity * (2 if spec["paired"] else 1) >= \
            spec["n_reads"]:
        return ds["fq"]
    return tuple(head_fastq(fq, n_parity, ds["dir"], f"head{n_parity}_{m}.fq")
                 if fq else None for m, fq in zip((1, 2), ds["fq"]))


def bench_cfg(spec: dict, ds: dict, tag: str, fqs=None):
    """The aligner's config for ``spec``'s flags on ``fqs`` (default the
    data set's reads), writing <dir>/<tag>.sam|bam and
    <dir>/<tag>.junctions.tab."""
    from .cli import parse_args

    fq1, fq2 = fqs or ds["fq"]
    ext = "bam" if spec["bam"] else "sam"
    return parse_args(["-i", ds["prefix"], "-f", fq1,
                       *(["-f2", fq2] if fq2 else []), *spec["flags"],
                       "-bo" if spec["bam"] else "-o",
                       os.path.join(ds["dir"], f"{tag}.{ext}"), "-j",
                       os.path.join(ds["dir"], f"{tag}.junctions.tab"),
                       "-silent"])


def ensure_parity_oracle(cname: str, spec: dict, ds: dict,
                         n_parity: int | None = None) -> dict:
    """The outputs parity is held to, made before any timed pass and
    cached: the reference's ``-t 1`` SAM of the whole set when
    ``REF_BIN`` exists, else the port's ``--device cpu`` run of the same
    reads (``parity_reads``) and flags. Returns {"kind": "reference" or
    "port_cpu", "out", "tab", "fq", "reads", "s" (seconds it took here,
    None when cached)}."""
    from .aligner import run
    from .index import load_index

    if os.path.exists(REF_BIN):
        ref_sam = os.path.join(ds["dir"], f"ref_{spec['n_reads']}.sam")
        res = {"kind": "reference", "out": ref_sam, "fq": ds["fq"],
               "tab": os.path.join(ds["dir"], "ref.junctions.tab"),
               "reads": spec["n_reads"], "s": None}
        if not os.path.exists(ref_sam):
            log(f"bench[{cname}]: producing reference parity oracle...")
            t0 = time.perf_counter()
            subprocess.run(_ref_cmd(spec, ds, ref_sam, bam=False), check=True,
                           capture_output=True, timeout=86400)
            res["s"] = time.perf_counter() - t0
        return res
    fqs = parity_reads(spec, ds, n_parity)
    n = (spec["n_reads"] if fqs == ds["fq"]
         else n_parity * (2 if spec["paired"] else 1))
    cfg = bench_cfg(spec, ds, f"port_cpu_{n}", fqs)
    res = {"kind": "port_cpu", "out": cfg.output_file, "tab": cfg.sj_file,
           "fq": fqs, "reads": n, "s": None}
    # the oracle is made again when the flags, the reads or the index
    # change (a head file keeps its name whatever set it was cut from)
    key = {"flags": spec["flags"], "fq": list(fqs), "reads": n,
           "files": [[p, os.path.getsize(p), os.stat(p).st_mtime_ns]
                     for p in (*ds["fq"], ds["prefix"] + ".bwt") if p]}
    key_p = cfg.output_file + ".json"
    if os.path.exists(key_p) and os.path.exists(cfg.sj_file):
        with open(key_p) as f:
            if json.load(f) == key:
                return res
    log(f"bench[{cname}]: the port's CPU path on {n} reads (the oracle)...")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        aligner = run(load_index(ds["prefix"]), cfg, "cpu")
    res["s"] = time.perf_counter() - t0
    if aligner.counters["total"] != n:
        raise AssertionError(f"the oracle aligned {aligner.counters['total']}"
                             f" reads, not {n}")
    with open(key_p, "w") as f:
        json.dump(key, f)
    log(f"bench[{cname}]: oracle (port_cpu, {n} reads) in {res['s']:.2f} s")
    return res


def _reference_tiny_cmd(cname: str, spec: dict, ds: dict):
    """Command for a 2-read reference run: process startup + index
    load with negligible alignment, timed just before each reference
    pass and subtracted from it (both share one page-cache state)."""
    tiny = os.path.join(ds["dir"], "tiny.fq")
    if not os.path.exists(tiny):
        with open(ds["fq"][0]) as f, open(tiny, "w") as out:
            for _ in range(8):
                line = f.readline()
                if not line:
                    break
                out.write(line)
    tiny_ds = dict(ds, fq=(tiny, None))
    return _ref_cmd(dict(spec, paired=False), tiny_ds,
                    os.path.join(ds["dir"], "tiny.sam"), bam=False)


def _converged(times: list[float]) -> bool:
    """Two passes within 8% of the best = quiet window found."""
    if len(times) < 2:
        return False
    s = sorted(times)
    return s[1] <= s[0] * 1.08


def pass_loop(cname: str, spec: dict, ours_pass, ref_pass=None,
              clock=time.perf_counter):
    """``bench.py``'s sampling loop: each round runs one reference pass
    (``ref_pass()``, its seconds) until two of them agree within 8%, and
    one of ours (``ours_pass()``) until three or more passes hold two
    within 8%; it stops when both have, after ``passes`` - 1 rounds at
    least and ``passes`` + 4 at most, or once the config's wall budget
    is spent with a pass on each side. Returns (ours, ref) seconds."""
    ours: list[float] = []
    ref: list[float] = []
    budget_s = spec.get("wall_budget_s", 1800)
    t_loop = clock()
    for i in range(spec["passes"] + 4):
        if (clock() - t_loop > budget_s and ours
                and (ref_pass is None or ref)):
            log(f"bench[{cname}]: wall budget {budget_s}s exhausted "
                f"after {len(ours)}+{len(ref)} passes")
            break
        if ref_pass is not None and not (len(ref) >= 2 and _converged(ref)):
            ref.append(ref_pass())
        if not (len(ours) >= 3 and _converged(ours)):
            ours.append(ours_pass())
        if (len(ours) >= 3 and _converged(ours)
                and (ref_pass is None or (len(ref) >= 2 and _converged(ref)))
                and i + 1 >= spec["passes"] - 1):
            break
    return ours, ref


def _on_card(device) -> bool:
    import torch

    return torch.device(device).type == "cuda"


def _sync(device) -> None:
    if _on_card(device):
        import torch

        torch.cuda.synchronize()


def _main_path(launches: dict) -> dict:
    # the MEM walk serves another seeding path, not this one
    return {k: v for k, v in launches.items() if not k.startswith("mem_walks")}


def measure_both(cname: str, spec: dict, ds: dict, device: str,
                 oracle: dict):
    """Our timed passes on ``device`` and, with the reference binary,
    its passes interleaved in the same window (``pass_loop``); then the
    card's untimed run of the oracle's reads when they are a head, and
    one traced pass. Returns (our_rate, ref_rate, meta)."""
    from .aligner import DartAligner, make_engine
    from .index import load_index

    have_ref = oracle["kind"] == "reference"
    split: dict = {}
    t_setup = time.perf_counter()
    idx = load_index(ds["prefix"])
    split["index_load_s"] = time.perf_counter() - t_setup
    split["kernel_build_s"] = None
    if _on_card(device):
        from .ops import build

        split["kernel_build_s"] = build.build()[1]
    cfg = bench_cfg(spec, ds, "tpu")
    engine = make_engine(idx, cfg, device)
    split["table_s"] = engine.setup_s["table"]
    split["lut_s"] = engine.setup_s["lut"]
    if spec.get("wide") and not engine.wide:
        raise AssertionError(f"{cname}: the wide engine was expected")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        DartAligner(idx, cfg, engine).run()  # kernels' first launches
    _sync(device)
    split["warm_pass_s"] = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_setup

    self_timed = bool(spec.get("prebuilt"))
    ref_out = os.path.join(ds["dir"], "ref_timed." + ("bam" if spec["bam"]
                                                      else "sam"))
    ref_cmd = (_ref_cmd(spec, ds, ref_out, bam=spec["bam"],
                        silent=not self_timed) if have_ref else None)
    tiny_cmd = (_reference_tiny_cmd(cname, spec, ds)
                if have_ref and not self_timed else None)
    ref_loads: list[float] = []
    stats: list[dict] = []

    def ref_pass() -> float:
        if self_timed:
            # the reference's own mapping-phase report, printed from a
            # clock started after its index load (Mapping.cpp:594)
            t0 = time.perf_counter()
            r = subprocess.run(ref_cmd, check=True, capture_output=True,
                               timeout=7200)
            raw = time.perf_counter() - t0
            m = re.findall(rb"processed in (\d+) seconds", r.stdout + r.stderr)
            if not m:
                raise RuntimeError("reference self-report line not found")
            secs = max(float(m[-1]), 1.0)
            ref_loads.append(raw - secs)
            log(f"bench[{cname}]: reference pass: {secs:.0f}s self-reported "
                f"mapping phase ({raw:.0f}s wall incl. load)")
            return secs
        t0 = time.perf_counter()
        subprocess.run(tiny_cmd, check=True, capture_output=True, timeout=7200)
        ref_load = time.perf_counter() - t0
        ref_loads.append(ref_load)
        t0 = time.perf_counter()
        subprocess.run(ref_cmd, check=True, capture_output=True, timeout=7200)
        secs = max(time.perf_counter() - t0 - ref_load, 1e-3)
        log(f"bench[{cname}]: reference pass: {secs:.2f}s "
            f"(+{ref_load:.2f}s adjacent load)")
        return secs

    def ours_pass() -> float:
        aligner = DartAligner(idx, cfg, engine)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            aligner.run()
        _sync(device)
        dt = time.perf_counter() - t0
        stats.append(dict(aligner.stats))
        log(f"bench[{cname}]: pass {len(stats)}: {dt:.4f} s "
            f"({aligner.counters['total'] / dt:.0f} reads/s)")
        return dt

    before = dict(engine.launches)
    ours, ref = pass_loop(cname, spec, ours_pass,
                          ref_pass if ref_cmd else None)
    launches = _main_path(engine.launches)
    timed = {k: v - before.get(k, 0) for k, v in launches.items()}
    sfx = "_wide" if engine.wide else ""
    if _on_card(device):
        for k in (f"seed_scan{sfx}", f"locate{sfx}", f"lut_build{sfx}"):
            if not launches.get(k):
                raise AssertionError(f"{cname}: the main path launched no "
                                     f"{k} kernel: {launches}")
    if oracle["fq"] != ds["fq"]:
        with contextlib.redirect_stdout(sys.stderr):
            DartAligner(idx, bench_cfg(spec, ds, "tpu_head", oracle["fq"]),
                        engine).run()
    engine_desc = {"wide": engine.wide, "lut_k": engine.lut_k,
                   "cache": engine.cache}
    del engine, idx
    gc.collect()
    if _on_card(device):
        import torch

        torch.cuda.empty_cache()  # this cell's freed tables leave the card
    prof = profile_pass(cname, spec, ds, device)

    best = min(ours)
    n = spec["n_reads"]
    rate = n / best
    ref_rate = n / min(ref) if ref else None
    med_rate = n / statistics.median(ours)
    ref_med_rate = n / statistics.median(ref) if ref else None
    if ref:
        log(f"bench[{cname}]: reference: {min(ref):.2f}s "
            f"({ref_rate:.0f} reads/s, -t 1, {len(ref)} passes)")
    log(f"bench[{cname}]: dart_tpu_torch: {best:.4f}s ({rate:.0f} reads/s; "
        f"{len(ours)} passes, spread {max(ours) / best:.3f}x; "
        f"set-up {setup_s:.2f}s)")
    return rate, ref_rate, {
        "wall_s": best, "setup_s": setup_s, "setup_split": split,
        "passes": len(ours), "spread": max(ours) / best,
        "ours_passes_s": ours,
        "median_reads_per_sec": med_rate,
        "vs_baseline_median": (med_rate / ref_med_rate
                               if ref_med_rate else None),
        "stage_split": stats[ours.index(best)],
        "launches": launches, "launches_timed": timed, "engine": engine_desc,
        "ref_wall_s": min(ref) if ref else None,
        "ref_passes_s": ref, "ref_load_s": ref_loads,
        "ref_passes": len(ref), "same_window": bool(ref),
        **prof,
    }


def profile_pass(cname: str, spec: dict, ds: dict, device: str) -> dict:
    """One more pass of the config, not a timed one, under
    ``aligner.profiled``, in a child process (``traced_pass``), read with
    ``trace_summary``. torch.profiler traced the card's kernels in the
    first session of a process only (on the H100, later sessions of one
    process lost most of them), so each cell's trace is its own process's
    first. On the CPU nothing is traced: "not measured"."""
    keys = ("kernel_ms", "kernels_ms", "idle_share", "window_s", "top_ops",
            "idle_gaps")
    if not _on_card(device):
        return {k: None for k in keys} | {
            "profile": "not measured: no card (--device cpu)"}
    trace_dir = os.path.join(ds["dir"], "trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=benchdata.REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", "import sys; from dart_tpu_torch.bench import "
         "traced_pass; traced_pass(*sys.argv[1:])",
         json.dumps({"spec": spec, "ds": ds}), trace_dir, device],
        env=env, capture_output=True, text=True, timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f"the traced pass exited {proc.returncode}:\n"
                           f"{proc.stderr[-3000:]}")
    wall = float(proc.stdout.strip().splitlines()[-1])
    res = trace_summary(trace_dir)
    shutil.rmtree(trace_dir, ignore_errors=True)
    log(f"bench[{cname}]: traced pass {wall:.3f} s: kernels "
        f"{res['kernel_ms']:.3f} ms, idle {100 * res['idle_share']:.2f}% of "
        f"{res['window_s']:.3f} s")
    return {k: res[k] for k in keys} | {"profile": "traced pass",
                                        "traced_pass_s": wall}


def traced_pass(job: str, trace_dir: str, device: str) -> None:
    """``profile_pass``'s child: the engine for the job's config (JSON of
    its spec and data set), one warm pass, then one pass under
    ``aligner.profiled`` into trace_dir; prints that pass's seconds."""
    from .aligner import DartAligner, make_engine, profiled
    from .index import load_index

    job = json.loads(job)
    spec, ds = job["spec"], job["ds"]
    idx = load_index(ds["prefix"])
    cfg = bench_cfg(spec, ds, "traced")
    engine = make_engine(idx, cfg, device)
    with contextlib.redirect_stdout(sys.stderr):
        DartAligner(idx, cfg, engine).run()
        _sync(device)
        aligner = DartAligner(idx, cfg, engine)
        with profiled(trace_dir, device):
            t0 = time.perf_counter()
            aligner.run()
            _sync(device)
            wall = time.perf_counter() - t0
    print(wall)


def kernel_name(name: str) -> str:
    """A traced kernel's template name, without its namespace and
    parameter list."""
    m = re.search(r"\w+_kernel(<[^(]*>)?", name)
    return m.group(0) if m else name[:60]


def trace_summary(trace_dir: str, top: int = TOP) -> dict:
    """What the torch.profiler trace in trace_dir says of the card: the
    kernels' summed time (``kernel_ms``) and time by ``kernel_name``
    (``kernels_ms``), the traced window (first to last event) and the
    share of it in which no kernel or copy ran (``idle_share``), the
    ``top`` device operations by summed time (``top_ops``), and the
    ``top`` longest idle gaps (``idle_gaps``: offset in the window and
    length; ``cpu_event``, the shortest CPU-side event that covers the
    whole gap, None where none does but the profiler's own span;
    ``after``, the last CPU-side event to start before the gap, and
    ``next``, the first to start in it; ``covered``, the share of the gap
    in which a traced CPU-side event ran: the rest is host code the
    profiler does not trace, such as the native pipeline)."""
    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json*"))
    if len(files) != 1:
        raise AssertionError(f"expected one trace in {trace_dir}, found "
                             f"{files}")
    with (gzip.open if files[0].endswith(".gz") else open)(files[0],
                                                           "rb") as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    kernels = [e for e in dev if e["cat"] == "kernel"]
    if not kernels:
        raise AssertionError("torch.profiler traced no kernel on the card")
    busy: list[list[float]] = []
    for e in sorted(dev, key=lambda e: e["ts"]):
        lo, hi = e["ts"], e["ts"] + e["dur"]
        if busy and lo <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], hi)
        else:
            busy.append([lo, hi])
    start = min(e["ts"] for e in events)
    stop = max(e["ts"] + e["dur"] for e in events)
    edges = [start, *(x for b in busy for x in b), stop]
    gaps = sorted(((lo, hi) for lo, hi in zip(edges[::2], edges[1::2])
                   if hi > lo), key=lambda g: g[0] - g[1])[:top]
    # the CPU side, without the profiler's own span over the window
    cpu = [e for e in events if e.get("cat") not in DEVICE_CATS
           and not str(e.get("cat", "")).startswith("gpu_")
           and not (e["ts"] <= start and e["ts"] + e["dur"] >= stop)]

    def name(lo, hi) -> dict:
        inner = [e for e in cpu if e["ts"] <= lo and e["ts"] + e["dur"] >= hi]
        before = [e for e in cpu if e["ts"] < lo]
        inside = [e for e in cpu if lo <= e["ts"] < hi]
        covered, end = 0.0, lo
        for a, b in sorted((max(lo, e["ts"]), min(hi, e["ts"] + e["dur"]))
                           for e in cpu):
            if b > max(a, end):
                covered += b - max(a, end)
                end = b
        return {"at_ms": (lo - start) / 1e3, "ms": (hi - lo) / 1e3,
                "cpu_event": (min(inner, key=lambda e: e["dur"])["name"]
                              if inner else None),
                "after": (max(before, key=lambda e: e["ts"])["name"]
                          if before else None),
                "next": (min(inside, key=lambda e: e["ts"])["name"]
                         if inside else None),
                "covered": covered / (hi - lo)}

    by_name: dict = {}
    for e in kernels:
        k = kernel_name(e["name"])
        by_name[k] = by_name.get(k, 0) + e["dur"]
    ops: dict = {}
    for e in dev:
        k = kernel_name(e["name"]) if e["cat"] == "kernel" else e["name"]
        ms, count = ops.get(k, (0.0, 0))
        ops[k] = (ms + e["dur"] / 1e3, count + 1)
    return {"kernel_ms": sum(by_name.values()) / 1e3,
            "window_s": (stop - start) / 1e6,
            "idle_share": 1 - sum(hi - lo for lo, hi in busy) / (stop - start),
            "kernels_ms": {k: v / 1e3 for k, v in by_name.items()},
            "top_ops": [{"name": k, "ms": ms, "count": c} for k, (ms, c) in
                        sorted(ops.items(), key=lambda kv: -kv[1][0])[:top]],
            "idle_gaps": [name(lo, hi) for lo, hi in gaps]}


def _norm_flags_pairwise(recs: list[tuple[str, int, str]]) -> list[int]:
    """Return normalized FLAG values for reference -t 1 records.

    The reference formats flags from uninitialized or stale state in
    three cases (Mapping.cpp:74-186):
    - single-end unmapped reads: FLAG is garbage; ours is always 4.
    - half-mapped pairs (exactly one end unmapped): stale proper-pair
      and mate bits (e.g. 83/99/147).
    - both-ends-unmapped pairs: the same stale emission (e.g. 83/163 on
      rname-* records); the intended values are 77/141
      (Mapping.cpp:148-151 and 180-182: 0x41|0x4|0x8 / 0x81|0x4|0x8).
    The target is the reference's intended flags (Mapping.cpp:101-186,
    mate 2 stored reverse-complemented; tests/golden/c5_pe.sam's 105/149
    pairs), which the port emits (pipeline/report.py):
        mapped end:  1|8|first-last| (0x10 if itself reverse else 0x20)
        unmapped end: 1|4|first-last| (0x20 if mate reverse else 0x10)
    Only the mapped end's own strand bit (consistent with the SEQ it
    printed) is trusted from the stale value.
    recs: (qname, flag, rname) in file order."""
    out = [f for _, f, _ in recs]
    i = 0
    n = len(recs)
    while i < n:
        q, f, rn = recs[i]
        if not f & 1:
            if rn == "*":
                out[i] = 4
            i += 1
            continue
        if i + 1 < n and recs[i + 1][0] == q and recs[i + 1][1] & 1:
            q2, f2, rn2 = recs[i + 1]
            un1 = rn == "*"
            un2 = rn2 == "*"
            if un1 != un2:
                (mi, ui) = (i + 1, i) if un1 else (i, i + 1)
                mf = out[mi]
                uf = out[ui]
                rev = bool(mf & 0x10)
                out[mi] = 1 | 8 | (mf & 0xC0) | (0x10 if rev else 0x20)
                out[ui] = 1 | 4 | (uf & 0xC0) | (0x20 if rev else 0x10)
            elif un1 and un2:
                out[i] = 1 | 4 | 8 | (out[i] & 0xC0)
                out[i + 1] = 1 | 4 | 8 | (out[i + 1] & 0xC0)
            i += 2
            continue
        i += 1
    return out


def _load_ref_records(ref_sam: str):
    recs = []
    lines = []
    with open(ref_sam) as f:
        for line in f:
            if line.startswith("@"):
                continue
            p = line.rstrip("\n").split("\t")
            recs.append((p[0], int(p[1]), p[2]))
            lines.append(p)
    flags = _norm_flags_pairwise(recs)
    for p, fl in zip(lines, flags):
        p[1] = str(fl)
    return lines


def bam_records(path: str) -> list[bytes]:
    """The records of a BAM file, decompressed, each as its bytes."""
    with gzip.open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"BAM\x01":
        raise AssertionError(f"{path}: not a BAM stream")
    off = 8 + struct.unpack_from("<i", data, 4)[0]
    n_ref = struct.unpack_from("<i", data, off)[0]
    off += 4
    for _ in range(n_ref):
        off += 8 + struct.unpack_from("<i", data, off)[0]
    out = []
    while off < len(data):
        size = struct.unpack_from("<i", data, off)[0]
        out.append(data[off:off + 4 + size])
        off += 4 + size
    return out


def bam_core(rec: bytes) -> tuple:
    """A BAM record's name, FLAG, 1-based POS (0 unmapped) and CIGAR."""
    pos, l_name = struct.unpack_from("<iB", rec, 8)
    n_cigar, flag = struct.unpack_from("<HH", rec, 16)
    name = rec[36:36 + l_name - 1].decode()
    cig = struct.unpack_from(f"<{n_cigar}I", rec, 36 + l_name)
    return (name, flag, pos + 1,
            "".join(f"{c >> 4}{'MIDNSHP=X'[c & 15]}" for c in cig) or "*")


def parity_check(cname: str, spec: dict, ds: dict, ref_sam: str | None) -> str:
    """Record-for-record IN-ORDER comparison against the reference's
    -t 1 SAM (its order is deterministic = input order, like ours),
    with the reference's stale-FLAG divergences normalized to its
    intended values (which is what we emit)."""
    if ref_sam is None or not os.path.exists(ref_sam):
        return "n/a"
    want_rows = _load_ref_records(ref_sam)
    if spec["bam"]:
        got = [bam_core(r) for r in bam_records(os.path.join(ds["dir"],
                                                             "tpu.bam"))]
        want2 = []
        for p in want_rows:
            want2.append((p[0], int(p[1]),
                          int(p[3]) if p[2] != "*" else 0, p[5]))
        # BAM keeps the XS:A tag the reference truncates; compare core
        # fields only (name/flag/pos/cigar)
        same = sum(1 for x, y in zip(got, want2) if x == y)
        return f"{same}/{max(len(got), len(want2))} records (BAM core fields, in order)"
    want = ["\t".join(p) for p in want_rows]
    with open(os.path.join(ds["dir"], "tpu.sam")) as f:
        got = [l.rstrip("\n") for l in f if not l.startswith("@")]
    same = sum(1 for x, y in zip(got, want) if x == y)
    return f"{same}/{max(len(got), len(want))} identical SAM records (in order)"


def junction_parity(ds: dict) -> str:
    """Record-for-record diff of the junction tables (both sides sort
    by forward-genome coordinate, so order is deterministic): the
    reference's ref.junctions.tab against ours, tpu.junctions.tab."""
    ref_p = os.path.join(ds["dir"], "ref.junctions.tab")
    got_p = os.path.join(ds["dir"], "tpu.junctions.tab")
    if not (os.path.exists(ref_p) and os.path.exists(got_p)):
        return "n/a"
    with open(ref_p) as f:
        want = f.read().splitlines()
    with open(got_p) as f:
        got = f.read().splitlines()
    same = sum(1 for x, y in zip(got, want) if x == y)
    return (f"{same}/{max(len(got), len(want))} identical junction "
            f"records (ours {len(got)}, ref {len(want)})")


def records_parity(got: str, want: str) -> str:
    """The card's alignments against the port's CPU path on the same
    reads, record for record in order: SAM lines, or BAM records
    decompressed."""
    if got.endswith(".bam"):
        g, w = bam_records(got), bam_records(want)
        what = "identical BAM records (decompressed, in order)"
    else:
        with open(got, "rb") as f:
            g = [ln for ln in f if not ln.startswith(b"@")]
        with open(want, "rb") as f:
            w = [ln for ln in f if not ln.startswith(b"@")]
        what = "identical SAM records (in order)"
    same = sum(1 for x, y in zip(g, w) if x == y)
    return f"{same}/{max(len(g), len(w))} {what}"


def rows_parity(got: str, want: str) -> str:
    """The card's junction table against the CPU path's, row for row."""
    with open(got) as f:
        g = f.read().splitlines()
    with open(want) as f:
        w = f.read().splitlines()
    same = sum(1 for x, y in zip(g, w) if x == y)
    return (f"{same}/{max(len(g), len(w))} identical junction records "
            f"(ours {len(g)}, port_cpu {len(w)})")


def short(note: str | None) -> bool:
    """A parity note that is not N/N (or names no count)."""
    m = re.match(r"(\d+)/(\d+) ", note or "")
    return m is None or m.group(1) != m.group(2)


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m dart_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("command", nargs="?", choices=["prep"],
                    help="make the data sets and oracles; time nothing")
    ap.add_argument("--configs", default=",".join(CONFIGS),
                    help="comma-separated configs [all, in this order: "
                         f"{','.join(CONFIGS)}]")
    ap.add_argument("--reads", type=int, default=None,
                    help="reads of each generated config [100000]")
    ap.add_argument("--parity-reads", type=int, default=None,
                    help="hold parity on the first N records of each read "
                         "file [the whole set]")
    ap.add_argument("--device", default="cuda", help="cuda | cpu [cuda]")
    args = ap.parse_args(argv)
    args.configs = [c for c in args.configs.split(",") if c]
    bad = [c for c in args.configs if c not in CONFIGS]
    if bad:
        ap.error(f"unknown configs {bad}; choose from {list(CONFIGS)}")
    return args


def specs(args) -> dict:
    """The selected configs' specs, ``--reads`` applied to the ones the
    bench generates (even, on paired sets)."""
    out = {}
    for c in args.configs:
        spec = CONFIGS[c]
        if args.reads and not spec.get("prebuilt") and "prefix" not in spec:
            spec = dict(spec, n_reads=(args.reads // 2 * 2 if spec["paired"]
                                       else args.reads))
        out[c] = spec
    return out


def prep(args) -> int:
    """``tools/prep_bench_data.py``'s counterpart: the non-prebuilt data
    sets, their index build times and their oracles; nothing timed."""
    t0 = time.perf_counter()
    for cname, spec in specs(args).items():
        if spec.get("prebuilt"):
            continue
        ds = ensure_dataset(cname, spec)
        time_index_builds(cname, spec, ds)
        ensure_parity_oracle(cname, spec, ds, n_parity=args.parity_reads)
        log(f"prep[{cname}]: ready ({time.perf_counter() - t0:.0f}s elapsed)")
    return 0


def run_config(cname: str, spec: dict, args) -> dict:
    ds = ensure_dataset(cname, spec)
    build_s, ref_build_s = time_index_builds(cname, spec, ds)
    oracle = ensure_parity_oracle(cname, spec, ds, n_parity=args.parity_reads)
    rate, ref_rate, meta = measure_both(cname, spec, ds, args.device, oracle)
    if oracle["kind"] == "reference":
        note = parity_check(cname, spec, ds, oracle["out"])
        sj_note = junction_parity(ds)
    else:
        tag = "tpu" if oracle["fq"] == ds["fq"] else "tpu_head"
        ext = "bam" if spec["bam"] else "sam"
        note = records_parity(os.path.join(ds["dir"], f"{tag}.{ext}"),
                              oracle["out"])
        sj_note = rows_parity(os.path.join(ds["dir"],
                                           f"{tag}.junctions.tab"),
                              oracle["tab"])
    log(f"bench[{cname}]: parity ({oracle['kind']}, {oracle['reads']} "
        f"reads): {note}; junctions: {sj_note}")
    return {
        "reads_per_sec": rate,
        "vs_baseline": rate / ref_rate if ref_rate else None,
        "baseline_reads_per_sec": ref_rate,
        "n_reads": spec["n_reads"], "flags": spec["flags"],
        "parity": note, "sj_parity": sj_note,
        "parity_oracle": oracle["kind"], "parity_reads": oracle["reads"],
        "oracle_s": oracle["s"],
        "index_build_s": build_s, "ref_index_build_s": ref_build_s,
        **meta,
    }


def main(argv=None) -> int:
    import torch

    from .stream import card_line

    args = parse(sys.argv[1:] if argv is None else argv)
    if args.command == "prep":
        return prep(args)
    if _on_card(args.device) and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the "
                           "plain PyTorch kernels on the CPU")
    results = {}
    fault_mbps = host_fault_mbps()
    log(f"bench: host anon-fault speed {fault_mbps:.0f} MB/s")
    for cname, spec in specs(args).items():
        # each config's numbers are kept whatever another one does
        try:
            results[cname] = run_config(cname, spec, args)
        except Skip as e:
            log(f"bench[{cname}]: skipped: {e}")
            results[cname] = {"skipped": str(e)}
        except Exception as e:  # noqa: BLE001
            log(f"bench[{cname}]: FAILED: {type(e).__name__}: {e}")
            results[cname] = {"error": f"{type(e).__name__}: {e}"}
    head = results.get("8mbp_se", {})
    print(json.dumps({
        "metric": METRIC,
        "value": head.get("reads_per_sec"),
        "unit": "reads/s",
        "vs_baseline": head.get("vs_baseline"),
        "host_fault_mbps": fault_mbps,
        "device": card_line() if _on_card(args.device) else args.device,
        "configs": results,
    }))
    measured = [r for r in results.values() if "reads_per_sec" in r]
    bad = [c for c, r in results.items() if "error" in r or (
        "reads_per_sec" in r and (short(r["parity"]) or short(r["sj_parity"])))]
    if bad or not measured:
        log(f"bench: failed: {', '.join(bad) or 'no config measured'}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
