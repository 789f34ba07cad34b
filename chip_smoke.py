#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dart_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and a C++ compiler; imports no JAX. From
the root of a checkout it:

1. builds the CUDA kernels of ``dart_tpu_torch/csrc`` and prints the
   seconds the build took;
2. holds each kernel against its plain PyTorch version on the card,
   exactly (integers, bit for bit): the locate kernel on every row of
   the toy index and on 2^16 random rows of the 8 Mbp index, the seed
   scan on 4096 reads of the 8 Mbp set with mismatches, N bases and
   reads shorter than 14 mixed in; then times both at the main path's
   shapes (65536 reads of 128 padded bases; 65536 rows);
3. runs the nine golden configs through ``dart-tpu-torch --device
   cuda`` and requires SAM and ``junctions.tab`` byte-equal to
   ``tests/golden/``;
4. aligns ``bench.py``'s ``8mbp_se`` set (8 Mbp two-chromosome genome,
   100,000 100-bp reads: 70% genomic, 30% spliced, 0.5% mismatches,
   generated from bench.py's seed into ``chip_smoke_work/``) on the
   card, prints wall time, reads/s and the kernels' launch counts, and
   requires the first 5,000 reads' SAM and junction table to equal the
   NumPy engine's of ``dart_tpu``.

The line before the last is a JSON object with each kernel's launches on
the main path (phase 4), its largest difference from the plain version,
and both times. The last line is ``{"ok": true, "device": {...}}``; it
is printed only when every phase passed, and the exit code is 0 only
then.
"""

from __future__ import annotations

import contextlib
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
SOURCE = "dart_tpu_torch/csrc/fm_kernels.cu"
KERNELS = {  # name -> the TPU device program it replaces
    "seed_scan": "dart_tpu/ops/fm_jax.py:819",
    "locate": "dart_tpu/ops/fm_jax.py:1172",
}
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
N_PARITY = 5000


def log(msg: str) -> None:
    print(msg, flush=True)


def make_dataset():
    """bench.py's 8mbp_se genome, reads and index (bench.ensure_dataset,
    its seed and generators) under WORK."""
    os.environ["DART_TPU_BENCH_DIR"] = WORK
    sys.path.insert(0, HERE)
    import bench

    return bench.ensure_dataset("8mbp_se", bench.CONFIGS["8mbp_se"])


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


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def check_equal(name: str, got, want) -> int:
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    err = max_abs_err(got, want)
    if err:
        bad = int((got != want).any(dim=-1).sum() if got.dim() > 1
                  else (got != want).sum())
        raise AssertionError(f"{name}: {bad} rows differ from the plain "
                             f"version (max abs err {err})")
    return err


def phase_kernels(toy, big, ds, device: str, n_scan: int, n_rows: int,
                  main_r: int, seed: int) -> dict:
    """Kernel vs plain on the card, exact; then both timed."""
    import numpy as np
    import torch

    from dart_tpu_torch.ops.fm_torch import FMIndexTorch, pack_codes

    rng = np.random.default_rng(seed)
    res = {k: {"max_abs_err": 0} for k in KERNELS}

    def locate_check(eng, rows, what):
        t = torch.from_numpy(rows.astype(np.int32)).to(device)
        err = check_equal(f"locate {what}", eng.locate_rows(t),
                          eng.plain_locate(t))
        res["locate"]["max_abs_err"] = max(res["locate"]["max_abs_err"], err)
        log(f"  locate kernel == plain on {rows.size} rows of {what}")

    toy_eng = FMIndexTorch(toy, device)
    locate_check(toy_eng, np.arange(toy.seq_len), "the toy index (all)")
    eng = FMIndexTorch(big, device)
    rows = rng.integers(0, big.seq_len, n_rows)
    locate_check(eng, rows, "the 8 Mbp index (random)")

    codes, rlens = read_fastq(ds["fq"][0], max(n_scan, main_r))
    sc, sl = codes[:n_scan].copy(), rlens[:n_scan].copy()
    R, L = sc.shape
    mm = rng.random((R, L)) < 0.02  # more mismatches on top of the set's
    sc = np.where(mm, (sc + rng.integers(1, 4, (R, L))) % 4, sc)
    with_n = rng.random(R) < 0.1
    sc[with_n, rng.integers(0, L, int(with_n.sum()))] = 4
    short = rng.random(R) < 0.05
    sl[short] = rng.integers(1, 14, int(short.sum()))
    buf, nmask, Lp = pack_codes(sc.astype(np.uint8), sl)
    S = eng.seed_slots(Lp, int(sl.max()))
    words = Lp // 16
    t = torch.from_numpy(np.concatenate([buf[:, :words], nmask, buf[:, words:]],
                                        axis=1).view(np.int32)).to(device)
    got = eng.seed_scan(t, words, S)
    want = eng.plain_seed_scan(t, words, S)
    res["seed_scan"]["max_abs_err"] = check_equal("seed scan", got, want)
    nseeds = got[:, 0].long()
    log(f"  seed scan kernel == plain on {R} reads "
        f"({int(with_n.sum())} with N, {int(short.sum())} shorter than 14, "
        f"{int(nseeds.sum())} seeds, "
        f"{int((got[:, 1 + 3 * S:] == -1).sum())} by locate-and-compare)")

    # times at the main path's shapes
    buf, nmask, Lp = pack_codes(codes[:main_r], rlens[:main_r])
    if Lp != MAIN_LP and main_r == MAIN_R:
        raise AssertionError(f"expected {MAIN_LP} padded bases, got {Lp}")
    words = Lp // 16
    S = eng.seed_slots(Lp, int(rlens[:main_r].max()))
    t = torch.from_numpy(np.concatenate([buf[:, :words], nmask, buf[:, words:]],
                                        axis=1).view(np.int32)).to(device)
    got = eng.seed_scan(t, words, S)
    check_equal("seed scan (main shape)", got, eng.plain_seed_scan(t, words, S))
    rows_t = torch.from_numpy(
        rng.integers(0, big.seq_len, main_r).astype(np.int32)).to(device)
    if device == "cuda":
        res["seed_scan"]["ms"] = time_ms(lambda: eng.seed_scan(t, words, S), 5)
        res["seed_scan"]["plain_ms"] = time_ms(
            lambda: eng.plain_seed_scan(t, words, S), 1)
        res["locate"]["ms"] = time_ms(lambda: eng.locate_rows(rows_t), 20)
        res["locate"]["plain_ms"] = time_ms(
            lambda: eng.plain_locate(rows_t), 3)
        log(f"  seed scan at R={main_r}, Lp={Lp}, S={S}: kernel "
            f"{res['seed_scan']['ms']:.3f} ms, plain "
            f"{res['seed_scan']['plain_ms']:.3f} ms")
        log(f"  locate at N={main_r} random rows: kernel "
            f"{res['locate']['ms']:.4f} ms, plain "
            f"{res['locate']['plain_ms']:.3f} ms")
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


def phase_goldens(device: str) -> None:
    out = os.path.join(WORK, "golden")
    os.makedirs(out, exist_ok=True)
    toy = os.path.join(GOLD, "index", "toy")
    for name, flags in GOLDEN.items():
        flags = [os.path.join(DATA, f) if f.endswith((".fa", ".fq", ".gz"))
                 else f for f in flags]
        sam = os.path.join(out, f"{name}.sam")
        tab = os.path.join(out, f"{name}.junctions.tab")
        run_cli(["-i", toy, *flags, "-o", sam, "-j", tab, "-silent",
                 "--device", device])
        for got, gold in ((sam, f"{name}.sam"),
                          (tab, f"{name}.junctions.tab")):
            if not same_bytes(got, os.path.join(GOLD, gold)):
                raise AssertionError(f"{name}: {gold} differs from golden")
        log(f"  {name}: SAM and junctions.tab byte-equal to golden")


def phase_scale(big, ds, device: str, n_parity: int) -> dict:
    """The 8mbp_se set through the CLI path; then its first n_parity
    reads against dart_tpu's NumPy engine."""
    from dart_tpu.aligner import DartAligner
    from dart_tpu.cli import parse_args

    from dart_tpu_torch.aligner import run

    out = os.path.join(WORK, "scale")
    os.makedirs(out, exist_ok=True)
    fq = ds["fq"][0]
    err = io.StringIO()
    cfg = parse_args(["-i", ds["prefix"], "-f", fq, "-o",
                      os.path.join(out, "all.sam"), "-j",
                      os.path.join(out, "all.tab"), "-silent", "--stats"])
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        aligner = run(big, cfg, device)
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng = aligner.engine
    n = aligner.counters["total"]
    log(f"  {n} reads in {wall:.3f} s wall incl. table build and upload "
        f"({n / wall:.0f} reads/s); seed-scan launches "
        f"{eng.n_seed_launches}, locate launches {eng.n_locate_launches}")
    for line in err.getvalue().splitlines():
        if line.startswith("[stats]"):
            log(f"  {line}")
    if eng.n_seed_launches == 0 and device == "cuda":
        raise AssertionError("the main path launched no seed-scan kernel")
    if eng.n_locate_launches == 0 and device == "cuda":
        raise AssertionError("the main path launched no locate kernel")
    if aligner.native is None:
        raise AssertionError("the native host pipeline did not load")

    head = os.path.join(out, f"head{n_parity}.fq")
    with open(fq, "rb") as f, open(head, "wb") as g:
        for i, line in enumerate(f):
            if i == 4 * n_parity:
                break
            g.write(line)
    for who in ("port", "numpy"):
        cfg = parse_args(["-i", ds["prefix"], "-f", head, "-o",
                          os.path.join(out, f"{who}.sam"), "-j",
                          os.path.join(out, f"{who}.tab"), "-silent"])
        with contextlib.redirect_stdout(io.StringIO()):
            if who == "port":
                run(big, cfg, device)
            else:
                cfg.engine = "numpy"
                DartAligner(big, cfg).run()
    for ext in ("sam", "tab"):
        if not same_bytes(os.path.join(out, f"port.{ext}"),
                          os.path.join(out, f"numpy.{ext}")):
            raise AssertionError(f"first {n_parity} reads: port .{ext} "
                                 "differs from the NumPy engine's")
    log(f"  first {n_parity} reads: SAM and junction table byte-equal to "
        "dart_tpu's NumPy engine")
    return {"seed_scan": eng.n_seed_launches, "locate": eng.n_locate_launches,
            "wall_s": wall, "reads": n}


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

    phase("build", do_build)
    phase("dataset", make_dataset)
    if "dataset" in state:
        ds = state["dataset"]
        toy = load_index(os.path.join(GOLD, "index", "toy"))
        big = load_index(ds["prefix"])
        if "build" in state:
            phase("kernels", lambda: phase_kernels(
                toy, big, ds, "cuda", 4096, 1 << 16, MAIN_R, 20260816))
            phase("goldens", lambda: phase_goldens("cuda"))
            phase("scale", lambda: phase_scale(big, ds, "cuda", N_PARITY))
    if failed or "scale" not in state:
        log(f"chip_smoke: failed phases: {', '.join(failed) or 'none ran'}")
        return 1
    kern = state["kernels"]
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE, "replaces": KERNELS[k],
         "launches": state["scale"][k],
         "max_abs_err": kern[k]["max_abs_err"], "ms": kern[k]["ms"],
         "plain_ms": kern[k]["plain_ms"]} for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
