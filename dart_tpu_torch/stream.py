"""Long streams through the port's aligner: one read file passed N times
as N separate ``-f`` files (the multi-file input path, reference
main.cpp:142-151), the counterpart of ``tools/sustained_stream.py``.

    python -m dart_tpu_torch.stream -i PREFIX -f READS [-f2 READS2] \\
        --files N -o OUT | -bo OUT -j TAB [--device cuda] [flags]

The flags are ``dart-tpu-torch``'s (``cli.parse_args``), among them
``--checkpoint``, ``--ckpt-interval S``, ``--batch N``, ``-all_sj`` and
``-m``; ``--device`` defaults to ``cuda`` and raises without a card.
The engine is built once (``aligner.make_engine``), then one
uncounted warm pass aligns the file once into the one-file outputs
(``one_file_paths``), then one ``DartAligner`` streams it N times on
that engine. A leftover checkpoint of the output is resumed, as the
aligner resumes it.

Each chunk logs one line (``log``, default stderr): file index, reads,
seconds, reads/s, host RSS (``/proc/self/status``) and, on a card,
``torch.cuda.memory_allocated``, ``memory_reserved``, the used bytes
of ``torch.cuda.mem_get_info`` (every process's on the card) and this
process's own bytes as NVML counts them, which also sees allocations
made outside PyTorch's caching allocator. ``main`` ends with one JSON
summary line on stdout. ``check_stream`` holds a stream's outputs
against the one-file run without loading either whole; ``hold_card``
holds its memory on the card flat.
"""

from __future__ import annotations

import contextlib
import copy
import gzip
import hashlib
import json
import os
import struct
import subprocess
import sys
import time

import torch

from .aligner import DartAligner, make_engine

MiB = 1 << 20
BLOCK = 16 * MiB  # bytes hashed at a time by check_stream


def rss_mb() -> float:
    """This process's resident set, MB, from /proc/self/status."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024.0
    return 0.0


NVML_NA = (1 << 64) - 1  # NVML's "not available" for a process's bytes
_NVML = {}  # the loaded libnvidia-ml, or None where it does not start


def nvml_processes(index: int = 0):
    """The processes holding memory on card ``index`` as NVML lists them,
    [(pid, bytes)] (pids as NVML numbers them, which a container may
    number otherwise), through ``libnvidia-ml`` by ctypes; None where
    NVML does not answer."""
    import ctypes

    class Proc(ctypes.Structure):  # nvmlProcessInfo_t (v2 and v3)
        _fields_ = [("pid", ctypes.c_uint), ("used", ctypes.c_ulonglong),
                    ("gpu_instance", ctypes.c_uint),
                    ("compute_instance", ctypes.c_uint)]

    if "lib" not in _NVML:
        try:
            lib = ctypes.CDLL("libnvidia-ml.so.1")
            _NVML["lib"] = lib if lib.nvmlInit_v2() == 0 else None
        except (OSError, AttributeError):
            _NVML["lib"] = None
    lib = _NVML["lib"]
    if lib is None:
        return None
    handle = ctypes.c_void_p()
    procs, n = (Proc * 64)(), ctypes.c_uint(64)
    try:
        if (lib.nvmlDeviceGetHandleByIndex_v2(index, ctypes.byref(handle))
                != 0 or lib.nvmlDeviceGetComputeRunningProcesses_v3(
                    handle, ctypes.byref(n), procs) != 0):
            return None
    except AttributeError:
        return None
    return [(procs[i].pid, procs[i].used) for i in range(n.value)]


def own_bytes(procs, pid: int | None = None) -> int | None:
    """This process's (or ``pid``'s) bytes on the card in a list of
    ``nvml_processes``: the entry with its pid or, where the list holds
    one process alone (a container numbers its pids otherwise), that
    one. None where NVML gave no list, names several processes and not
    this one, or has no count."""
    if not procs:
        return None
    pid = os.getpid() if pid is None else pid
    mine = [u for p, u in procs if p == pid]
    if not mine and len(procs) == 1:
        mine = [procs[0][1]]
    return mine[0] if mine and mine[0] != NVML_NA else None


def card_memory(device) -> dict | None:
    """The card's bytes now: allocated and reserved by PyTorch's caching
    allocator, used on the whole card by every process
    (``mem_get_info``), and this process's own (``own_bytes``: NVML's
    count, which holds every allocation of its context, in PyTorch's
    allocator or not; None where NVML does not say); None off a card."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    free, total = torch.cuda.mem_get_info(device)
    return {"allocated": torch.cuda.memory_allocated(device),
            "reserved": torch.cuda.memory_reserved(device),
            "used": total - free,
            "own": own_bytes(nvml_processes(index))}


def hold_card(records, slack: int = 64 * MiB) -> dict:
    """Hold a stream's memory on the card flat from its third chunk on,
    from ``run_stream``'s per-chunk records: the caching allocator's
    reserve after the last chunk no larger than after the third, and
    this process's own bytes (``card_memory``'s "own") within
    ``slack`` of the third chunk's at every chunk from there. The card's
    used bytes count other processes' too, so they are reported, not
    held. Raises AssertionError, also where NVML gave no count at a
    chunk; returns the largest moves from the third chunk and the
    number of chunks whose used bytes moved past ``slack``."""
    if len(records) < 3:
        raise ValueError(f"{len(records)} chunks: the hold starts at the "
                         "third")
    cards = [r["card"] for r in records[2:]]
    grew = cards[-1]["reserved"] - cards[0]["reserved"]
    if grew > 0:
        raise AssertionError(f"the card's reserve grew {grew} bytes after "
                             "the third chunk")
    for i, c in enumerate(cards, 2):
        if c["own"] is None:
            raise AssertionError(f"chunk {i}: NVML gave no count of this "
                                 "process's bytes on the card")
    own = max(abs(c["own"] - cards[0]["own"]) for c in cards)
    if own > slack:
        raise AssertionError(f"this process's bytes on the card moved "
                             f"{own / MiB:.1f} MiB after the third chunk")
    used = [abs(c["used"] - cards[0]["used"]) for c in cards]
    return {"reserve_grew": grew, "own_moved": own, "used_moved": max(used),
            "used_moves_past_slack": sum(u > slack for u in used)}


def card_line() -> str | None:
    """The cards' names and power limits as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them;
    None where it does not run."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return "; ".join(r.stdout.strip().splitlines()) if r.returncode == 0 \
        else None


def one_file_paths(cfg) -> tuple[str, str]:
    """Where the warm pass writes its one-file outputs: ``.one`` before
    the extension of the output and of the junction table."""
    def one(path):
        stem, ext = os.path.splitext(path)
        return f"{stem}.one{ext}"

    return one(cfg.output_file), one(cfg.sj_file)


def _mib(n) -> str:
    return "?" if n is None else f"{n / MiB:.1f}"


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else 0.0


def run_stream(idx, cfg, n_files: int, device="cuda", engine=None,
               log=None, on_aligner=None) -> dict:
    """Stream ``cfg``'s one read file (or pair of files) ``n_files``
    times through one ``DartAligner`` on ``engine`` (default
    ``make_engine(idx, cfg, device)``), after a warm pass over it alone
    into ``one_file_paths(cfg)``. ``on_aligner(aligner)`` may change the
    streaming aligner before its run. Returns the summary (``main``'s
    JSON line, with host RSS before the engine is built and after the
    warm pass) and ``"log"``, the per-chunk records, and ``"engine"``."""
    log = log or sys.stderr
    files1 = cfg.read_files_1
    files2 = cfg.read_files_2
    if len(files1) != 1 or len(files2) > 1:
        raise ValueError("a stream repeats one read file (or one pair)")
    rss_before = rss_mb()
    if engine is None:
        engine = make_engine(idx, cfg, device)
    dev = getattr(engine, "device", torch.device(device))

    warm = copy.deepcopy(cfg)
    warm.checkpoint = False
    warm.output_file, warm.sj_file = one_file_paths(cfg)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        one = DartAligner(idx, warm, engine)
        one.run()
    warm_s = time.perf_counter() - t0
    rss_warm = rss_mb()
    per_file = one.counters["total"]
    if per_file == 0:
        raise ValueError(f"{files1[0]} holds no reads")
    print(f"[warm] {per_file} reads in {warm_s:.3f} s", file=log, flush=True)

    scfg = copy.deepcopy(cfg)
    scfg.read_files_1 = files1 * n_files
    scfg.read_files_2 = files2 * n_files
    aligner = DartAligner(idx, scfg, engine)
    if aligner.native is None:
        raise RuntimeError("the stream's chunk log needs the native host "
                           "pipeline (a C++ toolchain, without -d or "
                           "--no-native)")
    if on_aligner is not None:
        on_aligner(aligner)
    launches0 = dict(engine.launches)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    records = []
    clock = {"last": 0.0}
    orig = aligner._finish_chunk

    def finish_chunk(reads, job, pair_end, fastq, emit, on_wait=None):
        before = aligner.counters["total"]
        orig(reads, job, pair_end, fastq, emit, on_wait)
        now = time.perf_counter()
        n = aligner.counters["total"] - before
        dt = now - clock["last"]
        clock["last"] = now
        rec = {"file": before // per_file, "reads": n, "t": now, "s": dt,
               "rate": n / max(dt, 1e-9), "rss_mb": rss_mb(),
               "card": card_memory(dev),
               "launches": {k: v - launches0.get(k, 0)
                            for k, v in engine.launches.items()}}
        records.append(rec)
        mem = rec["card"]
        print(f"[chunk {len(records) - 1:4d}] file {rec['file']:3d} "
              f"{n:6d} reads {dt:7.3f} s {rec['rate']:9.0f} reads/s "
              f"rss {rec['rss_mb']:8.1f} MB"
              + (f" card allocated {mem['allocated'] / MiB:.1f} reserved "
                 f"{mem['reserved'] / MiB:.1f} used {mem['used'] / MiB:.1f}"
                 f" own {_mib(mem['own'])} MiB" if mem else ""), file=log,
              flush=True)

    aligner._finish_chunk = finish_chunk
    t0 = clock["last"] = time.perf_counter()
    with contextlib.redirect_stdout(log):
        aligner.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    return summarize(records, wall, aligner, scfg, n_files, per_file, dev,
                     warm_s) | {"rss_mb_before_engine": rss_before,
                                "rss_mb_after_warm": rss_warm,
                                "log": records, "engine": engine,
                                "one_file": list(one_file_paths(cfg))}


def summarize(records, wall, aligner, cfg, n_files, per_file, dev,
              warm_s) -> dict:
    """The JSON summary of a stream: ``tools/sustained_stream.py``'s
    keys, then the steady-state rate (the median chunk rate after the
    first file), host RSS at the end of each file, and the card's
    reserved, used and own bytes after the third and the last chunk."""
    n = len(records)
    rates = [r["rate"] for r in records]
    q = max(n // 4, 1)
    first_q, last_q = _median(rates[:q]), _median(rates[-q:])
    reads = sum(r["reads"] for r in records)
    by_file = {}
    for r in records:
        by_file[r["file"]] = r["rss_mb"]
    rss_files = [by_file[f] for f in sorted(by_file)]
    third = records[min(2, n - 1)] if n else None
    out = {
        "config": "stream", "files": n_files, "reads_per_file": per_file,
        "total_reads": aligner.counters["total"], "stream_reads": reads,
        "wall_s": wall, "warm_s": warm_s,
        "reads_per_sec": reads / max(wall, 1e-9), "chunks": n,
        "median_rate_first_quarter": first_q,
        "median_rate_last_quarter": last_q,
        "rate_drift": last_q / first_q if first_q else None,
        "median_rate_after_file_1": _median(
            [r["rate"] for r in records if r["file"] > 0]),
        "rss_mb_start": third["rss_mb"] if third else None,
        "rss_mb_end": records[-1]["rss_mb"] if n else None,
        "rss_mb_by_file": rss_files,
        "rss_mb_per_file": ((rss_files[-1] - rss_files[0])
                            / (len(rss_files) - 1)
                            if len(rss_files) > 1 else None),
        "checkpoint": cfg.checkpoint, "ckpt_interval_s": cfg.ckpt_interval_s,
        "device": str(dev),
        "launches": records[-1]["launches"] if n else {},
    }
    if n and records[-1]["card"] is not None:
        out.update(
            card=card_line(),
            reserved_peak=torch.cuda.max_memory_reserved(dev),
            reserved_third=third["card"]["reserved"],
            reserved_last=records[-1]["card"]["reserved"],
            used_third=third["card"]["used"],
            used_last=records[-1]["card"]["used"],
            used_max=max(r["card"]["used"] for r in records[2:] or records),
            own_third=third["card"]["own"],
            own_last=records[-1]["card"]["own"])
    return out


def check_stream(out, one, n: int, fmt: str = "sam") -> dict:
    """Hold a stream of ``n`` files against the one-file run of the same
    flags. ``out`` and ``one`` are (alignments, junctions.tab) paths;
    ``fmt`` is "sam" or "bam". The alignments must be the one-file
    run's header once, then its records n times, in order: compared
    slice by slice through a streamed hash (BAM decompressed, so its
    records and not its BGZF blocks are compared). ``junctions.tab``
    must hold the one-file run's rows with each count times n. Raises
    AssertionError at the first difference; returns the sizes
    compared."""
    if fmt not in ("sam", "bam"):
        raise ValueError(f"fmt is 'sam' or 'bam', not {fmt!r}")
    opener = open if fmt == "sam" else gzip.open
    with opener(one[0], "rb") as f:
        head = _sam_header(f) if fmt == "sam" else _bam_header(f)
        digest, body = _hash(f, None)
    with opener(out[0], "rb") as f:
        if f.read(len(head)) != head:
            raise AssertionError(f"{out[0]}: the header differs from the "
                                 "one-file run's")
        for i in range(n):
            got, size = _hash(f, body)
            if (got, size) != (digest, body):
                raise AssertionError(
                    f"{out[0]}: the records of file {i} differ from the "
                    f"one-file run's ({size} of {body} bytes)")
        if f.read(1):
            raise AssertionError(f"{out[0]}: more records than {n} files'")
    with open(one[1]) as f:
        rows = [line.split("\t") for line in f.read().splitlines()]
    want = ["\t".join([*r[:3], str(int(r[3]) * n)]) for r in rows]
    with open(out[1]) as f:
        got = f.read().splitlines()
    if got != want:
        bad = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                   min(len(got), len(want)))
        raise AssertionError(
            f"{out[1]}: row {bad} of {len(got)} is not the one-file run's "
            f"with its count times {n} ({len(want)} rows)")
    return {"header_bytes": len(head), "file_bytes": body,
            "junctions": len(want)}


def _sam_header(f) -> bytes:
    """The '@' lines at the start of a SAM stream; leaves f after them."""
    head = []
    while True:
        pos = f.tell()
        line = f.readline()
        if not line.startswith(b"@"):
            f.seek(pos)
            return b"".join(head)
        head.append(line)


def _bam_header(f) -> bytes:
    """The header of a decompressed BAM stream (magic, text, references),
    read from f."""
    head = f.read(8)
    if head[:4] != b"BAM\x01":
        raise AssertionError("not a BAM stream")
    head += f.read(struct.unpack("<i", head[4:8])[0] + 4)
    for _ in range(struct.unpack("<i", head[-4:])[0]):
        head += f.read(4)
        head += f.read(struct.unpack("<i", head[-4:])[0] + 4)
    return head


def _hash(f, size: int | None):
    """SHA-256 of the next ``size`` bytes of f (all that is left when
    None), read BLOCK at a time; returns (digest, bytes read)."""
    h, got = hashlib.sha256(), 0
    while size is None or got < size:
        b = f.read(BLOCK if size is None else min(BLOCK, size - got))
        if not b:
            break
        h.update(b)
        got += len(b)
    return h.hexdigest(), got


def main(argv: list[str] | None = None) -> int:
    from .cli import parse_args
    from .index import load_index

    argv = list(sys.argv[1:] if argv is None else argv)
    opts = {"--files": "1", "--device": "cuda"}
    for key in opts:
        if key in argv:
            i = argv.index(key)
            if i + 1 >= len(argv):
                print(f"Error! {key} needs a value", file=sys.stderr)
                return 1
            opts[key] = argv[i + 1]
            del argv[i:i + 2]
    cfg = parse_args(argv)
    if cfg is None:
        return 0
    for p in cfg.read_files_1 + cfg.read_files_2:
        if not os.path.exists(p):
            print(f"Cannot access file:[{p}]", file=sys.stderr)
            return 1
    res = run_stream(load_index(cfg.index_prefix), cfg, int(opts["--files"]),
                     opts["--device"])
    res.pop("log")
    res.pop("engine")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
