#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dart_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and a C++ compiler; imports no JAX. From
the root of a checkout it:

1. builds the CUDA kernels of ``dart_tpu_torch/csrc`` and prints the
   seconds the build took; meanwhile a child process generates
   ``bench.py``'s ``50mbp_se`` set (for phases 5 and 6);
2. holds each kernel against its plain PyTorch version on the card,
   exactly (integers, bit for bit): the locate kernels (narrow and wide)
   on every row of the toy index and on 2^16 random rows of the 8 Mbp
   index; the seed scans (narrow with and without the K = 11 K-mer
   table, wide with it) on 4096 reads of the 8 Mbp set with mismatches,
   N bases and reads shorter than 14 mixed in, the narrow scan with the
   table also against the one without; the narrow K-mer table build,
   whole; then times every kernel and its plain version at the main
   path's shapes (65536 reads of 128 padded bases; 65536 rows; one
   K = 11 table);
3. runs the nine golden configs through ``dart-tpu-torch --device
   cuda`` (narrow engine, K-mer table on) and through ``DartAligner``
   with the wide engine forced, and requires SAM and ``junctions.tab``
   byte-equal to ``tests/golden/``;
4. aligns ``bench.py``'s ``8mbp_se`` set (8 Mbp two-chromosome genome,
   100,000 100-bp reads: 70% genomic, 30% spliced, 0.5% mismatches,
   generated from bench.py's seed into ``chip_smoke_work/``) on the
   card with the narrow and with the wide engine, prints wall time,
   reads/s, set-up seconds and the kernels' launch counts, requires the
   two SAMs equal and the first 5,000 reads' SAM and junction table of
   each engine equal to the NumPy engine's of ``dart_tpu``;
5. on the 50 Mbp index (``50mbp_se``: a 30 + 20 Mbp genome, same read
   mix; its 125 MB narrow table is past the 50 MB L2) holds the wide
   K-mer table build against its plain version, whole, and times every
   kernel and its plain version at the same shapes as phase 2;
6. aligns ``50mbp_se``'s 100,000 reads with the narrow and with the wide
   engine (K-mer table on) and requires the whole SAM and junction
   table byte-equal between the two;
7. ``[nw]``, the gap DP (K7): runs the first 2,000 reads of ``8mbp_se``
   through ``dart_tpu``'s Python pipeline (``cfg.native = False``) on
   the port's engine, recording every fragment pair it hands its host
   DP, and requires SAM and junction table equal to the same pipeline
   on ``dart_tpu``'s NumPy engine; holds the kernel's planes equal to
   ``nw_plain``'s on the recorded pairs and on a fuzz set (0-127 bases a
   side, 127 x 127, N, lower case); runs the recorded pairs through
   ``nw_align_batch`` on the card (its path) and requires the strings of
   every recorded and fuzz pair equal to the host C++ DP ``nw_align``;
   times kernel and plain version at 65,536 pairs (the recorded ones
   tiled, and 127 x 127), and the host's share: packing and traceback
   of the recorded batch, and ``nw_align`` over the same pairs;
8. ``[mem_walks]``, the MEM walk (K8): holds the kernel equal to its
   plain version on the toy index (a 64-base task from every genome
   position) and on the 8 Mbp index (65,536 tasks of 128 bases cut from
   the set's reads, with 2% more substitutions, N bases and invalid
   tails); runs ``seeding.seed_reads_from_all_walks`` on 4,096 reads
   through the card's engine (its path) and requires the expanded
   occurrences equal to the engine's own seed scan's; runs
   ``dart_tpu_torch.entry``'s forward step (its other path) on the card
   against its plain run; times kernel and plain version at
   65,536 x 128.

Every engine of a main-path run (phases 4 and 6) is made inside that
run, so its launch counts start at 0 there; the checks and timings of
phases 2 and 5 use engines of their own. Phases 7 and 8 set the counts
of their paths to 0 just before driving them and read them just after.
The line before the last is a JSON object with each kernel's launches on
its path (phase 4 for K1-K6, phases 7 and 8 for the gap DP and the MEM
walk), its largest difference from the plain version, and both times
(at the 8 Mbp index for the FM kernels). The last line is ``{"ok":
true, "device": {...}}``; it is printed only when every phase passed,
and the exit code is 0 only then.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import subprocess
import sys
import time
import traceback

sys.modules["jax"] = None  # any attempt to import JAX fails loudly

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, "chip_smoke_work")
GOLD = os.path.join(HERE, "tests", "golden")
DATA = os.path.join(HERE, "tests", "data")
FM_SOURCE = "dart_tpu_torch/csrc/fm_kernels.cu"
KERNELS = {  # name -> the TPU device program it replaces
    "seed_scan": "dart_tpu/ops/fm_jax.py:819",
    "locate": "dart_tpu/ops/fm_jax.py:1172",
    "lut_build": "dart_tpu/ops/fm_jax.py:128",
    "seed_scan_wide": "dart_tpu/ops/fm_jax_wide.py:324",
    "locate_wide": "dart_tpu/ops/fm_jax_wide.py:732",
    "lut_build_wide": "dart_tpu/ops/fm_jax_wide.py:303",
}
NW_SOURCE = "dart_tpu_torch/csrc/nw_kernels.cu"
NW_REPLACES = "dart_tpu/ops/nw_pallas.py:54"
MEM_WALKS_REPLACES = "dart_tpu/ops/fm_jax.py:699"
GOLDEN = {  # tests/test_parity.py's nine configs, as CLI flags
    "c1_se_exact": ["-f", "se_exact.fa"],
    "c2_se_mm": ["-f", "se_mm.fq", "-mis", "5"],
    "c3_spliced": ["-f", "spliced.fa"],
    "c4_spliced_mm": ["-f", "spliced_mm.fq", "-mis", "5", "-all_sj"],
    "c5_pe": ["-f", "pe_1.fq", "-f2", "pe_2.fq", "-mis", "5"],
    "c6_pe_gz": ["-f", "pe_1.fq.gz", "-f2", "pe_2.fq.gz", "-mis", "5"],
    "c7_pe_inter": ["-f", "pe_inter.fq", "-p", "-mis", "5"],
    "c8_multi": ["-f", "se_exact.fa", "-m"],
    "c9_unique": ["-f", "se_mm.fq", "-unique", "-mis", "5"],
}
MAIN_R, MAIN_LP = 65536, 128  # the main path's seed-scan shape
LUT_K = 11  # the K-mer table's K on a card (dart_tpu_torch.aligner)
N_PARITY = 5000
N_NW_READS = 2000  # reads through the Python pipeline in phase 7
N_TIMED = 65536  # gap-DP pairs and MEM-walk tasks timed at once
N_WALK_READS = 4096  # reads seeded from MEM walks in phase 8


def log(msg: str) -> None:
    print(msg, flush=True)


def bench_env() -> None:
    os.environ["DART_TPU_BENCH_DIR"] = WORK
    if HERE not in sys.path:
        sys.path.insert(0, HERE)


def make_dataset(name: str = "8mbp_se"):
    """bench.py's genome, reads and index of config ``name``
    (bench.ensure_dataset, its seed and generators) under WORK."""
    bench_env()
    import bench

    return bench.ensure_dataset(name, bench.CONFIGS[name])


def start_dataset(name: str) -> subprocess.Popen:
    """make_dataset(name) in a child process, to overlap with the card."""
    bench_env()
    return subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
         " import chip_smoke; chip_smoke.make_dataset(sys.argv[2])",
         HERE, name], cwd=HERE, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)


def finish_dataset(proc: subprocess.Popen, name: str):
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"generating {name} failed ({proc.returncode}):\n"
                           f"{err[-3000:]}")
    return make_dataset(name)  # all files exist now: returns their paths


def read_fastq(path: str, n: int):
    """The first n records' sequences as a (n, L) code matrix + rlens."""
    import numpy as np

    from dart_tpu.constants import NT4_TABLE

    seqs = []
    with open(path, "rb") as f:
        for i, line in enumerate(f):
            if i % 4 == 1:
                seqs.append(line.rstrip(b"\n"))
                if len(seqs) == n:
                    break
    L = max(len(s) for s in seqs)
    codes = np.full((len(seqs), L), 4, dtype=np.uint8)
    for i, s in enumerate(seqs):
        codes[i, :len(s)] = NT4_TABLE[np.frombuffer(s, dtype=np.uint8)]
    return codes, np.array([len(s) for s in seqs], dtype=np.int32)


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps runs, after one warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_once(fn):
    """(fn(), its device time in ms): one run, no warm-up, for the
    plain versions, whose one run takes seconds."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def check_equal(name: str, got, want) -> int:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} != "
                             f"{want.dtype} {tuple(want.shape)}")
    err = max_abs_err(got, want)
    if err:
        bad = int((got != want).any(dim=-1).sum() if got.dim() > 1
                  else (got != want).sum())
        raise AssertionError(f"{name}: {bad} rows differ from the plain "
                             f"version (max abs err {err})")
    return err


def pack(codes, rlens, device: str):
    """Reads as the engine's seed-scan input tensor: (t, words, S)."""
    import numpy as np
    import torch

    from dart_tpu_torch.ops.fm_torch import FMIndexTorch, pack_codes

    buf, nmask, Lp = pack_codes(codes, rlens)
    words = Lp // 16
    host = np.concatenate([buf[:, :words], nmask, buf[:, words:]], axis=1)
    t = torch.from_numpy(host.view(np.int32)).to(device)
    return t, words, FMIndexTorch.seed_slots(Lp, int(rlens.max()))


def without_lut(eng):
    """A view of ``eng`` (same table on the card) that scans without
    the K-mer table."""
    out = copy.copy(eng)
    out.lut, out.lut_k = None, 0
    return out


def phase_kernels(toy, big, ds, device: str, n_scan: int, n_rows: int,
                  main_r: int, seed: int) -> dict:
    """Kernel vs plain on the card, exact, narrow and wide; then every
    kernel and its plain version timed on the 8 Mbp index."""
    import numpy as np
    import torch

    from dart_tpu_torch.ops.fm_torch import FMIndexTorch

    rng = np.random.default_rng(seed)
    res = {k: {"max_abs_err": 0} for k in KERNELS}

    def note(name, err):
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)

    def locate_check(eng, rows, what):
        name = "locate_wide" if eng.wide else "locate"
        t = torch.from_numpy(rows.astype(np.int64 if eng.wide else np.int32))
        t = t.to(device)
        note(name, check_equal(f"{name} {what}", eng.locate_rows(t),
                               eng.plain_locate(t)))
        log(f"  {name} kernel == plain on {rows.size} rows of {what}")

    for wide in (False, True):
        locate_check(FMIndexTorch(toy, device, wide=wide),
                     np.arange(toy.seq_len), "the toy index (all)")
    engs = {wide: FMIndexTorch(big, device, lut_k=LUT_K, wide=wide)
            for wide in (False, True)}
    log(f"  8 Mbp engines: narrow set-up {fmt_setup(engs[False])}, wide "
        f"{fmt_setup(engs[True])}")
    rows = rng.integers(0, big.seq_len, n_rows)
    for eng in engs.values():
        locate_check(eng, rows, "the 8 Mbp index (random)")
    note("lut_build", check_equal("lut_build (K=11, 8 Mbp)", engs[False].lut,
                                  engs[False].plain_build_lut()))
    log(f"  lut_build kernel == plain, whole K={LUT_K} table of the 8 Mbp "
        f"index ({int((engs[False].lut[:, 2] == 0).sum())} of "
        f"{4**LUT_K} K-mers dead)")

    codes, rlens = read_fastq(ds["fq"][0], max(n_scan, main_r))
    sc, sl = codes[:n_scan].copy(), rlens[:n_scan].copy()
    R, L = sc.shape
    mm = rng.random((R, L)) < 0.02  # more mismatches on top of the set's
    sc = np.where(mm, (sc + rng.integers(1, 4, (R, L))) % 4, sc)
    with_n = rng.random(R) < 0.1
    sc[with_n, rng.integers(0, L, int(with_n.sum()))] = 4
    short = rng.random(R) < 0.05
    sl[short] = rng.integers(1, 14, int(short.sum()))
    t, words, S = pack(sc.astype(np.uint8), sl, device)
    plain_nolut = without_lut(engs[False]).plain_seed_scan(t, words, S)
    err = check_equal("seed_scan without LUT",
                      without_lut(engs[False]).seed_scan(t, words, S),
                      plain_nolut)
    note("seed_scan", err)
    for wide, eng in engs.items():
        name = "seed_scan_wide" if wide else "seed_scan"
        got = eng.seed_scan(t, words, S)
        note(name, check_equal(f"{name} with LUT", got,
                               eng.plain_seed_scan(t, words, S)))
        check_equal(f"{name} with LUT vs seed_scan without", got.long(),
                    plain_nolut.long())
    nseeds = plain_nolut[:, 0].long()
    log(f"  seed_scan kernel == plain without and with the K={LUT_K} table, "
        f"and seed_scan_wide with it, on {R} reads "
        f"({int(with_n.sum())} with N, {int(short.sum())} shorter than 14, "
        f"{int(nseeds.sum())} seeds, "
        f"{int((plain_nolut[:, 1 + 3 * S:] == -1).sum())} by "
        "locate-and-compare); all three scans give the same seeds")

    if device == "cuda":
        times = main_shape_times(engs, codes[:main_r], rlens[:main_r], rng,
                                 device, "8 Mbp")
        for k, v in times.items():
            note(k, v.pop("max_abs_err"))
            res[k].update(v)
    return res


def fmt_setup(eng) -> str:
    return (f"table {eng.setup_s['table']:.3f} s + LUT "
            f"{eng.setup_s['lut']:.3f} s")


def main_shape_times(engs, codes, rlens, rng, device: str, what: str) -> dict:
    """Each kernel and its plain version at the main path's shapes, on
    the engines' index: the seed scans on the reads (with the K-mer
    table; the narrow one also without), the locates on as many random
    rows, one K-mer table build. Each plain run is also held against
    the kernel's result."""
    import numpy as np
    import torch

    t, words, S = pack(codes, rlens, device)
    if len(rlens) == MAIN_R and words * 16 != MAIN_LP:
        raise AssertionError(f"expected {MAIN_LP} padded bases, got "
                             f"{words * 16}")
    out = {}
    for wide, eng in engs.items():
        sfx = "_wide" if wide else ""
        rows = torch.from_numpy(rng.integers(0, eng.seq_len, len(rlens)))
        rows = rows.to(eng.idx_dtype).to(device)
        jobs = {
            "seed_scan": (lambda: eng.seed_scan(t, words, S),
                          lambda: eng.plain_seed_scan(t, words, S), 5),
            "locate": (lambda: eng.locate_rows(rows),
                       lambda: eng.plain_locate(rows), 20),
            "lut_build": (lambda: eng.build_lut(),
                          lambda: eng.plain_build_lut(), 3),
        }
        for name, (kern, plain, reps) in jobs.items():
            ms = time_ms(kern, reps)
            want, plain_ms = timed_once(plain)
            err = check_equal(f"{name}{sfx} ({what}, timing shape)", kern(),
                              want)
            out[name + sfx] = {"ms": ms, "plain_ms": plain_ms,
                               "max_abs_err": err}
            log(f"  {name}{sfx} on the {what} index: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.3f} ms")
    nolut = without_lut(engs[False])
    ms = time_ms(lambda: nolut.seed_scan(t, words, S), 5)
    out["seed_scan"]["ms_without_lut"] = ms
    log(f"  seed_scan without the K-mer table on the {what} index: kernel "
        f"{ms:.4f} ms (R={len(rlens)}, Lp={words * 16}, S={S})")
    return out


def phase_kernels50(big50, ds50, device: str, seed: int) -> dict:
    """The wide K-mer table build held against its plain version on the
    50 Mbp index, whole; then every kernel timed there."""
    import numpy as np

    from dart_tpu_torch.ops.fm_torch import FMIndexTorch

    engs = {wide: FMIndexTorch(big50, device, lut_k=LUT_K, wide=wide)
            for wide in (False, True)}
    mb = {w: e.table.numel() * 4e-6 for w, e in engs.items()}
    log(f"  50 Mbp engines: narrow set-up {fmt_setup(engs[False])}, wide "
        f"{fmt_setup(engs[True])}; tables {mb[False]:.1f} MB narrow, "
        f"{mb[True]:.1f} MB wide")
    res = {"lut_build_wide": check_equal(
        "lut_build_wide (K=11, 50 Mbp)", engs[True].lut,
        engs[True].plain_build_lut())}
    log(f"  lut_build_wide kernel == plain, whole K={LUT_K} table of the "
        "50 Mbp index")
    if device == "cuda":
        codes, rlens = read_fastq(ds50["fq"][0], MAIN_R)
        res["times"] = main_shape_times(engs, codes, rlens,
                                        np.random.default_rng(seed), device,
                                        "50 Mbp")
    return res


def run_cli(argv):
    """dart-tpu-torch's main() with its report kept off stdout."""
    from dart_tpu_torch.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        raise AssertionError(f"dart-tpu-torch {' '.join(argv)} -> {rc}")


def same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def phase_goldens(toy, device: str) -> None:
    """The nine goldens through the CLI (narrow engine, K-mer table on)
    and through DartAligner with the wide engine forced."""
    from dart_tpu.cli import parse_args

    from dart_tpu_torch.aligner import default_lut_k, run

    out = os.path.join(WORK, "golden")
    os.makedirs(out, exist_ok=True)
    prefix = os.path.join(GOLD, "index", "toy")
    for name, flags in GOLDEN.items():
        flags = [os.path.join(DATA, f) if f.endswith((".fa", ".fq", ".gz"))
                 else f for f in flags]
        for how in ("cli", "wide"):
            sam = os.path.join(out, f"{name}.{how}.sam")
            tab = os.path.join(out, f"{name}.{how}.junctions.tab")
            argv = ["-i", prefix, *flags, "-o", sam, "-j", tab, "-silent"]
            if how == "cli":
                run_cli([*argv, "--device", device])
            else:
                with contextlib.redirect_stdout(io.StringIO()):
                    eng = run(toy, parse_args(argv), device, wide=True).engine
                if not eng.wide or eng.lut_k != default_lut_k(device):
                    raise AssertionError("expected the wide engine with the "
                                         "K-mer table")
            for got, gold in ((sam, f"{name}.sam"),
                              (tab, f"{name}.junctions.tab")):
                if not same_bytes(got, os.path.join(GOLD, gold)):
                    raise AssertionError(f"{name} ({how}): {gold} differs "
                                         "from golden")
        log(f"  {name}: SAM and junctions.tab byte-equal to golden, through "
            "the CLI and through the wide engine")


def align(idx, ds, out: str, tag: str, device: str, wide: bool) -> dict:
    """One main-path run over the whole read set: the engine (and its
    launch counts, which start at 0) is made inside it. Logs and
    returns wall time, reads/s, set-up seconds and launch counts."""
    from dart_tpu.cli import parse_args

    from dart_tpu_torch.aligner import default_lut_k, run

    err = io.StringIO()
    cfg = parse_args(["-i", ds["prefix"], "-f", ds["fq"][0], "-o",
                      os.path.join(out, f"{tag}.sam"), "-j",
                      os.path.join(out, f"{tag}.tab"), "-silent", "--stats"])
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        aligner = run(idx, cfg, device, wide=wide)
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng = aligner.engine
    n = aligner.counters["total"]
    # the MEM walk serves another seeding path (phase 8), not this one
    launches = {k: v for k, v in eng.launches.items() if k != "mem_walks"}
    log(f"  {tag}: {n} reads in {wall:.3f} s wall incl. set-up "
        f"({n / wall:.0f} reads/s); set-up {fmt_setup(eng)}; launches "
        + ", ".join(f"{k} {v}" for k, v in launches.items()))
    for line in err.getvalue().splitlines():
        if line.startswith("[stats]"):
            log(f"    {line}")
    if device == "cuda":
        for k, v in launches.items():
            if v == 0:
                raise AssertionError(f"{tag}: the main path launched no "
                                     f"{k} kernel")
    if eng.wide != wide or eng.lut_k != default_lut_k(device):
        raise AssertionError(f"{tag}: unexpected engine (wide {eng.wide}, "
                             f"lut_k {eng.lut_k})")
    if aligner.native is None:
        raise AssertionError("the native host pipeline did not load")
    return {"launches": launches, "wall_s": wall, "reads": n,
            "setup_s": eng.setup_s}


def require_same(out: str, a: str, b: str, what: str) -> None:
    for ext in ("sam", "tab"):
        if not same_bytes(os.path.join(out, f"{a}.{ext}"),
                          os.path.join(out, f"{b}.{ext}")):
            raise AssertionError(f"{what}: {a}.{ext} differs from {b}.{ext}")


def head_fastq(fq: str, n: int, out: str) -> str:
    """The first n records of a FASTQ file, as a file under out."""
    head = os.path.join(out, f"head{n}.fq")
    with open(fq, "rb") as f, open(head, "wb") as g:
        for i, line in enumerate(f):
            if i == 4 * n:
                break
            g.write(line)
    return head


def phase_scale(big, ds, device: str, n_parity: int) -> dict:
    """The 8mbp_se set through the narrow and the wide engine; then its
    first n_parity reads through both against dart_tpu's NumPy engine."""
    from dart_tpu.aligner import DartAligner
    from dart_tpu.cli import parse_args

    from dart_tpu_torch.aligner import run

    out = os.path.join(WORK, "scale")
    os.makedirs(out, exist_ok=True)
    res = {"narrow": align(big, ds, out, "narrow", device, wide=False),
           "wide": align(big, ds, out, "wide", device, wide=True)}
    require_same(out, "narrow", "wide", "8mbp_se")
    log(f"  all {res['narrow']['reads']} reads: SAM and junction table "
        "byte-equal between the narrow and the wide engine")

    head = head_fastq(ds["fq"][0], n_parity, out)
    for who in ("numpy", "port", "port_wide"):
        cfg = parse_args(["-i", ds["prefix"], "-f", head, "-o",
                          os.path.join(out, f"{who}.sam"), "-j",
                          os.path.join(out, f"{who}.tab"), "-silent"])
        with contextlib.redirect_stdout(io.StringIO()):
            if who == "numpy":
                cfg.engine = "numpy"
                DartAligner(big, cfg).run()
            else:
                run(big, cfg, device, wide=who == "port_wide")
    for who in ("port", "port_wide"):
        require_same(out, who, "numpy", f"first {n_parity} reads")
    log(f"  first {n_parity} reads: SAM and junction table of both engines "
        "byte-equal to dart_tpu's NumPy engine")
    return res


def phase_scale50(big50, ds50, device: str) -> dict:
    """The 50mbp_se set through the narrow and the wide engine, whole
    outputs byte-equal."""
    out = os.path.join(WORK, "scale50")
    os.makedirs(out, exist_ok=True)
    res = {"narrow": align(big50, ds50, out, "narrow", device, wide=False),
           "wide": align(big50, ds50, out, "wide", device, wide=True)}
    require_same(out, "narrow", "wide", "50mbp_se")
    log(f"  all {res['narrow']['reads']} reads: SAM and junction table "
        "byte-equal between the narrow and the wide engine")
    return res


def nw_fuzz_pairs(rng, n: int):
    """n fragment pairs of 0..127 bases a side: 127 x 127, empty sides,
    N and lower case among them; half of them similar sides (a shifted
    copy with substitutions and indels)."""
    alpha = [*b"ACGTNacgtn"]
    pairs = [(b"", b"ACG"), (b"ACG", b""), (b"A" * 127, b"A" * 127),
             (b"ACGTN" * 25 + b"AC", b"acgtn" * 25 + b"ac")]
    while len(pairs) < n:
        m, k = (int(v) for v in rng.integers(0, 128, 2))
        s1 = bytes(rng.choice(alpha, m).tolist())
        if s1 and rng.random() < 0.5:
            s2 = bytearray((s1 * 3)[int(rng.integers(3)):][:k])
            for _ in range(int(rng.integers(6))):
                at = int(rng.integers(len(s2) + 1))
                s2[at:at + int(rng.integers(2))] = bytes(
                    rng.choice(alpha, int(rng.integers(2))).tolist())
            s2 = bytes(s2[:127])
        else:
            s2 = bytes(rng.choice(alpha, k).tolist())
        pairs.append((s1, s2))
    return pairs


def nw_inputs(pairs, device: str):
    import torch

    from dart_tpu_torch.ops.nw_torch import pack_pairs

    return [torch.from_numpy(a).to(device) for a in pack_pairs(pairs)]


def phase_nw(idx, prefix: str, fq: str, device: str, n_reads: int,
             n_timed: int, seed: int) -> dict:
    """The gap DP (K7): pairs recorded from dart_tpu's Python pipeline on
    the port's engine (output equal to the NumPy engine's), kernel vs
    plain planes, nw_align_batch vs the host C++ DP, and times."""
    import numpy as np

    from dart_tpu.aligner import DartAligner
    from dart_tpu.cli import parse_args
    from dart_tpu.ops.nw_numpy import nw_align

    from dart_tpu_torch.aligner import run
    from dart_tpu_torch.ops import nw_torch
    from dart_tpu_torch.ops.nw_plain import MAX_LEN, nw_plain

    out = os.path.join(WORK, "nw")
    os.makedirs(out, exist_ok=True)
    head = head_fastq(fq, n_reads, out)
    recorded = {}
    for who in ("port", "numpy"):
        cfg = parse_args(["-i", prefix, "-f", head, "-o",
                          os.path.join(out, f"{who}.sam"), "-j",
                          os.path.join(out, f"{who}.tab"), "-silent"])
        cfg.native = False
        with nw_torch.recording_host_dp() as rec, \
                contextlib.redirect_stdout(io.StringIO()):
            if who == "numpy":
                cfg.engine = "numpy"
                DartAligner(idx, cfg).run()
            else:
                run(idx, cfg, device)
        recorded[who] = rec
    require_same(out, "port", "numpy", f"Python pipeline, first {n_reads} "
                 "reads")
    if recorded["port"] != recorded["numpy"]:
        raise AssertionError("the two engines' pipelines sent other DPs")
    pairs = [p for p in recorded["port"] if max(map(len, p)) <= MAX_LEN]
    if not pairs:
        raise AssertionError("the Python pipeline sent no gap DP")
    biggest = max(max(map(len, p)) for p in pairs)
    log(f"  first {n_reads} reads through dart_tpu's Python pipeline on the "
        f"port's engine: SAM and junction table equal to the NumPy engine's; "
        f"{len(recorded['port'])} DPs recorded, {len(pairs)} of <= 127 bases "
        f"a side (largest side {biggest})")

    rng = np.random.default_rng(seed)
    fuzz = nw_fuzz_pairs(rng, 512)
    err = 0
    for what, ps in (("recorded", pairs), ("fuzz", fuzz)):
        c1, c2, mn = nw_inputs(ps, device)
        err = max(err, check_equal(f"nw planes ({what})",
                                   nw_torch.nw_planes(c1, c2, mn),
                                   nw_plain(c1, c2, mn)))
    log(f"  nw kernel planes == plain on the {len(pairs)} recorded pairs "
        f"and {len(fuzz)} fuzz pairs (127 x 127, empty sides, N, lower case)")

    nw_torch.launches["nw"] = 0
    t0 = time.perf_counter()
    got = nw_torch.nw_align_batch(pairs, device)
    batch_s = time.perf_counter() - t0
    launches = nw_torch.launches["nw"]
    if device == "cuda" and launches == 0:
        raise AssertionError("nw_align_batch launched no nw kernel")
    t0 = time.perf_counter()
    want = [nw_align(s1, s2) for s1, s2 in pairs]
    host_dp_s = time.perf_counter() - t0
    if got != want:
        bad = sum(g != w for g, w in zip(got, want))
        raise AssertionError(f"nw_align_batch: {bad} recorded pairs differ "
                             "from nw_align")
    if nw_torch.nw_align_batch(fuzz, device) != [nw_align(*p) for p in fuzz]:
        raise AssertionError("nw_align_batch: fuzz pairs differ from nw_align")
    log(f"  nw_align_batch on {device} == nw_align (host C++) on every "
        f"recorded and fuzz pair; {launches} launch(es) for the recorded "
        "batch")
    res = {"max_abs_err": err, "launches": launches, "pairs": len(pairs),
           "batch_s": batch_s, "host_dp_s": host_dp_s}
    if device != "cuda":
        return res

    # the host's share of nw_align_batch on the recorded batch
    t0 = time.perf_counter()
    c1, c2, mn = nw_inputs(pairs, device)
    planes = nw_torch.nw_planes(c1, c2, mn).cpu().numpy()
    t1 = time.perf_counter()
    for k, (s1, s2) in enumerate(pairs):
        nw_torch.traceback(planes[k], s1, s2)
    res["pack_kernel_copy_s"] = t1 - t0
    res["traceback_s"] = time.perf_counter() - t1
    tiled = [pairs[k % len(pairs)] for k in range(n_timed)]
    t0 = time.perf_counter()
    for s1, s2 in tiled:
        nw_align(s1, s2)
    res["host_dp_tiled_s"] = time.perf_counter() - t0
    for what, ps, key in (("recorded pairs tiled", tiled, ""),
                          ("127 x 127", [(b"ACGT" * 31 + b"ACG",
                                          b"TGCA" * 31 + b"TGC")] * n_timed,
                           "_127")):
        c1, c2, mn = nw_inputs(ps, device)
        ms = time_ms(lambda: nw_torch.nw_planes(c1, c2, mn), 10)
        want, plain_ms = timed_once(lambda: nw_plain(c1, c2, mn))
        res["max_abs_err"] = max(res["max_abs_err"], check_equal(
            f"nw planes ({what}, timing shape)",
            nw_torch.nw_planes(c1, c2, mn), want))
        res["ms" + key], res["plain_ms" + key] = ms, plain_ms
        del want
        log(f"  nw on {n_timed} pairs ({what}): kernel {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms")
    log(f"  host share, {len(pairs)} recorded pairs: nw_align_batch "
        f"{batch_s:.4f} s (pack + kernel + copy "
        f"{res['pack_kernel_copy_s']:.4f} s, traceback "
        f"{res['traceback_s']:.4f} s); nw_align {host_dp_s:.4f} s; "
        f"nw_align over the {n_timed} tiled pairs "
        f"{res['host_dp_tiled_s']:.3f} s")
    return res


def walk_tasks(codes, rlens, rng, L: int):
    """MEM-walk tasks of L bases cut from reads: each from a random start
    in its read, with 2% more substitutions and N bases, valid to the
    read's end or to an earlier random cut (one task in four)."""
    import numpy as np

    R, Lr = codes.shape
    st = rng.integers(0, max(1, Lr // 4), R)
    idx = st[:, None] + np.arange(L)[None, :]
    chars = np.take_along_axis(
        np.concatenate([codes, np.full((R, L), 4, np.uint8)], axis=1),
        idx, axis=1)
    mut = rng.random((R, L)) < 0.02
    chars = np.where(mut, rng.integers(0, 5, (R, L)), chars).astype(np.uint8)
    end = rlens.astype(np.int64) - st
    end = np.where(rng.random(R) < 0.25, rng.integers(0, L, R), end)
    return chars, np.arange(L)[None, :] < end[:, None]


def phase_mem_walks(toy, big, ds, device: str, n_timed: int,
                    n_reads: int, seed: int) -> dict:
    """The MEM walk (K8): kernel vs plain on the toy and the 8 Mbp index,
    seeding from walks vs the seed scan, the entry step, and times."""
    import numpy as np
    import torch

    from dart_tpu.pipeline.seeding import (_expand_occurrences,
                                           seed_reads_from_all_walks)

    from dart_tpu_torch.entry import entry
    from dart_tpu_torch.ops.fm_torch import FMIndexTorch

    rng = np.random.default_rng(seed)
    res = {"max_abs_err": 0}

    def hold(eng, chars, valid, what):
        c = torch.from_numpy(chars).to(device)
        v = torch.from_numpy(valid).to(device)
        got = eng.mem_walk_rows(c, v)
        for name, g, w in zip(("lens", "x0", "x2"), got,
                              eng.plain_mem_walks(c, v)):
            res["max_abs_err"] = max(res["max_abs_err"], check_equal(
                f"mem_walks {name} ({what})", g, w))
        return c, v, got[0]

    toy_eng = FMIndexTorch(toy, device)
    G, L = toy.genome_size, 64
    padded = np.concatenate([toy.ref_codes[:G], np.full(L, 4, np.uint8)])
    chars = np.lib.stride_tricks.sliding_window_view(padded, L)[:G].copy()
    valid = np.arange(L)[None, :] < (G - np.arange(G))[:, None]
    lens = hold(toy_eng, chars, valid, "toy index")[2]
    log(f"  mem_walks kernel == plain, a task from each of the {G} toy "
        f"genome positions ({int((lens == L).sum())} walks of all {L} bases)")

    eng = FMIndexTorch(big, device)
    codes, rlens = read_fastq(ds["fq"][0], max(n_timed, n_reads))
    chars, valid = walk_tasks(codes[:n_timed], rlens[:n_timed], rng, 128)
    c, v, lens = hold(eng, chars, valid, "8 Mbp index")
    log(f"  mem_walks kernel == plain on {len(chars)} tasks of 128 bases "
        f"of the 8 Mbp set (mean length {float(lens.float().mean()):.1f}, "
        f"{int((lens == 0).sum())} never started)")

    # the seeding path of engines without the automaton, on a fresh
    # engine: its counts start at 0 here
    walker = FMIndexTorch(big, device)
    rc, rl = codes[:n_reads], rlens[:n_reads]
    walks = seed_reads_from_all_walks(walker, rc, rl, walker.max_dup_num)
    seed_launches = walker.launches["mem_walks"]
    scan = walker.seed_reads(rc, rl)
    got, want = (_expand_occurrences(walker, *t, len(rl))
                 for t in (walks, scan))
    if not np.array_equal(got[0], want[0]):
        raise AssertionError("seeding from walks: occurrence offsets differ "
                             "from the seed scan's")
    for r in range(len(rl)):
        a, b = got[0][r], got[0][r + 1]
        if sorted(zip(got[3][a:b], got[1][a:b], got[2][a:b])) != \
                sorted(zip(want[3][a:b], want[1][a:b], want[2][a:b])):
            raise AssertionError(f"seeding from walks: read {r}'s "
                                 "occurrences differ from the seed scan's")
    log(f"  seed_reads_from_all_walks on {len(rl)} reads through the card's "
        f"MEM walks == the seed scan ({int(got[0][-1])} occurrences), "
        f"{seed_launches} mem_walks launch(es)")

    step, args = entry(device)
    got = step(*args)
    entry_launches = step.engine.launches
    for name, g, w in zip(("lens", "x2", "locs"), got, step.plain(*args)):
        res["max_abs_err"] = max(res["max_abs_err"], check_equal(
            f"entry step {name}", g, w))
    log(f"  entry() forward step on {device} == its plain run "
        f"({int((got[2] >= 0).sum())} of {len(got[2])} walks accepted); "
        f"launches mem_walks {entry_launches['mem_walks']}, locate "
        f"{entry_launches['locate']}")
    res["launches"] = seed_launches + entry_launches["mem_walks"]
    if device == "cuda":
        if not (seed_launches and entry_launches["mem_walks"]
                and entry_launches["locate"]):
            raise AssertionError("a MEM-walk path launched no kernel")
        res["ms"] = time_ms(lambda: eng.mem_walk_rows(c, v), 20)
        _, res["plain_ms"] = timed_once(lambda: eng.plain_mem_walks(c, v))
        log(f"  mem_walks on {len(chars)} x 128 tasks of the 8 Mbp set: "
            f"kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.3f} ms")
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    log(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
        else f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    from dart_tpu.index import load_index

    from dart_tpu_torch.ops import build

    failed = []
    state = {}

    def phase(name, fn):
        log(f"[{name}]")
        t0 = time.perf_counter()
        try:
            state[name] = fn()
            log(f"[{name}] ok ({time.perf_counter() - t0:.1f} s)")
        except Exception:
            failed.append(name)
            log(f"[{name}] FAILED\n{traceback.format_exc()}")

    def do_build():
        lib, secs = build.build()
        build.load()
        log(f"  {os.path.relpath(lib, HERE)}: built in {secs:.1f} s")
        return secs

    gen50 = start_dataset("50mbp_se")
    try:
        phase("build", do_build)
        phase("dataset", make_dataset)
        if "dataset" in state and "build" in state:
            ds = state["dataset"]
            toy = load_index(os.path.join(GOLD, "index", "toy"))
            big = load_index(ds["prefix"])
            phase("kernels", lambda: phase_kernels(
                toy, big, ds, "cuda", 4096, 1 << 16, MAIN_R, 20260816))
            phase("goldens", lambda: phase_goldens(toy, "cuda"))
            phase("scale", lambda: phase_scale(big, ds, "cuda", N_PARITY))
            phase("nw", lambda: phase_nw(big, ds["prefix"], ds["fq"][0],
                                         "cuda", N_NW_READS, N_TIMED,
                                         20261017))
            phase("mem_walks", lambda: phase_mem_walks(
                toy, big, ds, "cuda", N_TIMED, N_WALK_READS, 20261018))
        phase("dataset50", lambda: finish_dataset(gen50, "50mbp_se"))
        if "dataset50" in state and "build" in state:
            ds50 = state["dataset50"]
            big50 = load_index(ds50["prefix"])
            phase("kernels50", lambda: phase_kernels50(big50, ds50, "cuda",
                                                       20261016))
            phase("scale50", lambda: phase_scale50(big50, ds50, "cuda"))
    finally:
        if gen50.poll() is None:
            gen50.kill()
            gen50.wait()
    if failed or not {"scale", "scale50", "nw", "mem_walks"} <= set(state):
        log(f"chip_smoke: failed phases: {', '.join(failed) or 'none'}")
        return 1
    kern, scale = state["kernels"], state["scale"]
    launches = {**scale["narrow"]["launches"], **scale["wide"]["launches"]}
    k50 = state["kernels50"]
    err50 = {k: v["max_abs_err"] for k, v in k50["times"].items()}
    err50["lut_build_wide"] = max(err50["lut_build_wide"],
                                  k50["lut_build_wide"])
    rows = [{"name": k, "route": "cuda", "source": FM_SOURCE,
             "replaces": KERNELS[k], "launches": launches[k],
             "max_abs_err": max(kern[k]["max_abs_err"], err50[k]),
             "ms": kern[k]["ms"], "plain_ms": kern[k]["plain_ms"]}
            for k in KERNELS]
    for name, source, replaces in (
            ("nw", NW_SOURCE, NW_REPLACES),
            ("mem_walks", FM_SOURCE, MEM_WALKS_REPLACES)):
        r = state[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": r["launches"],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
