#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dart_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # one card: phases 1-17 below
    python3 chip_smoke.py --cards    # two cards or more: phase_cards only
    python3 chip_smoke.py --big [--gbp 1.1]   # one card: phase_big only
    python3 chip_smoke.py --stream [--files 100]   # one card: a long stream

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
   table also against the one without; all four seed scans (narrow and
   wide, with and without the table) on repeat reads (the telomeric
   repeat, with a mismatch in its last base, with an N; tandem repeats;
   a repeat into unique sequence) at max_dup 0, 1 and 100, against the
   plain scan run on the CPU; the K-mer table builds, whole, narrow and
   wide, at K = 11 on the 8 Mbp index and at K = 1, 4, 8, 11 and 12 on
   the toy index (one launch at K = 1, two from K = 2 on); the seed
   scans (narrow with the K = 11 table and without, wide with it) on
   toy reads of 1,000 to 65,535 bases, which a block reads in place
   (past ~1,000 bases they do not fit its shared memory), against the
   plain scan run on the CPU in a child process from the start; then
   times every kernel and its plain version at the main path's shapes
   (65536 reads of 128 padded bases; 65536 rows; one K = 11 table);
3. runs the nine golden configs through ``dart-tpu-torch --device
   cuda`` (narrow engine, K-mer table on) and through ``DartAligner``
   with the wide engine forced, and requires SAM and ``junctions.tab``
   byte-equal to ``tests/golden/``;
4. aligns ``bench.py``'s ``8mbp_se`` set (8 Mbp two-chromosome genome,
   100,000 100-bp reads: 70% genomic, 30% spliced, 0.5% mismatches,
   generated from bench.py's seed into ``chip_smoke_work/``) on the
   card with the narrow and with the wide engine, prints wall time,
   reads/s, set-up seconds, the kernels' launch counts and the rows of
   each locate launch (recorded for phase 13), requires the
   two SAMs equal and the first 5,000 reads' SAM and junction table of
   each engine equal to the port's CPU path's (its plain versions);
5. on the 50 Mbp index (``50mbp_se``: a 30 + 20 Mbp genome, same read
   mix; its 125 MB narrow table is past the 50 MB L2) holds the narrow
   and the wide K-mer table builds against their plain versions, whole,
   and times every kernel and its plain version at the same shapes as
   phase 2;
6. aligns ``50mbp_se``'s 100,000 reads with the narrow and with the wide
   engine (K-mer table on) and requires the whole SAM and junction
   table byte-equal between the two;
7. ``[nw]``, the gap DP (K7): runs the first 2,000 reads of ``8mbp_se``
   through the port's Python pipeline (``cfg.native = False``) on the
   card's engine, recording every fragment pair it hands its host DP,
   and requires SAM, junction table and pairs equal to the same pipeline
   on the CPU path; holds the kernel's planes equal to
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
   65,536 x 128 (and the kernel on the same tasks padded past its
   staging budget, read in place), and the kernel at the task sets of
   ``walk_shapes`` on the toy and 8 Mbp indexes: the seeding path's
   409,600 x 100, ``entry()``'s 256 x 96, a 64-base task from every toy
   genome position.

9. ``[mesh]``, the device grid (``--mesh``): holds each ``Sharded``
   kernel (the FM kernels reading a range-sharded table, one allocation
   a shard, all on the one card) exactly against its plain version over
   the same ``ShardedTable`` and against its ``Flat`` twin: the locates
   on every toy row at index 2, 3 and 7 (narrow) or 4 (wide), whose
   boundaries fall in the Occ, genome and sample rows; the K = 11 table
   builds, whole, and the seed scans with them on reads across the toy
   table's genome-row boundaries and on 4,096 reads of the 8 Mbp set at
   index=2; the MEM walk on a task from every toy genome position;
   times each at phase 2's shapes; then runs the nine goldens through
   ``dart-tpu-torch --mesh data=2,index=2`` and the whole ``8mbp_se``
   set at ``--mesh data=2`` and ``data=2,index=2``, narrow and wide,
   requiring every output byte-equal to the goldens and to phase 4's
   single-engine run, and prints wall time, reads/s and each data
   group's launches;
10. ``[dryrun]``: ``dart_tpu_torch.entry.dryrun_multichip(4, "cuda")``
    (the sharded engine's toy checks, the 4 Mbp overflow proof with a
    whole aligner run, the scaling lines of slots sharing one card);
11. ``[dist]``: two ``dart-tpu-torch --dist-nprocs 2`` processes each
    for goldens c3, c6 and c7 and for the first 20,000 reads of
    ``8mbp_se``, all eight processes at once on the card, requiring the
    merged outputs byte-equal to the goldens and to a one-process run;
12. ``[profile]``: one ``--profile`` run of ``8mbp_se``, whose
    ``torch.profiler`` trace must name the seed-scan kernel; prints the
    kernels' summed time, the seed scans' share of it and the card's
    idle share of the traced window;
13. ``[diagnosis]``, after phase 6, what bounds the seed scan and the
    locate (``phase_diagnosis``): ``-Xptxas -v`` of every kernel (the
    seed scans, the locates and the K-mer table builds must show no
    stack and no spill), the latency of one dependent load in and past
    the L2, the seed scan's time against the reads of a launch, and the
    dependent loads a read makes (the plain version counts them), with
    the critical-path floor they give; then the locate at the row sets
    of ``locate_shapes`` (65,536 random rows, the rows of each locate
    launch of phases 4 and 6, the repeat runs of ``copies_set``): each
    row's LF steps (the plain version counts them), the floor they give,
    the bytes bound, and the kernel's time against the whole host call
    (``locate_diagnosis``); then the MEM walk at the task sets of
    ``walk_shapes`` (phase 8's and, also at 50 Mbp, 65,536 x 128):
    each task's extension steps (the plain version counts them), what
    divergence in a warp costs, the floor, the bytes bound, the kernel
    against the whole host call (``walks_diagnosis``), and the kernel
    held equal to the plain version there on both branches, on one
    table and at index=2 and 3 (``check_walk_shapes``; a stack or
    spills in a MEM walk fail the phase too);
14. ``[redesign]``, only where ``chip_smoke_work/parent/fm_kernels.cu``
    holds an earlier kernel source, put there for a measurement call:
    its seed scans, K-mer table builds, locates (at every row set of
    phase 13, narrow and wide, on one table and on two shards) and MEM
    walks (at every task set of phase 13, on one table and on two
    shards) against this tree's, in turns (``phase_redesign``);
15. ``[outputs]``, after phase 4: ``bench.py``'s ``8mbp_pe_bam`` set
    (the 8 Mbp genome, 50,000 pairs simulated in its paired steps,
    generated in a child process from the start) through ``-bo``: the
    card's BAM and junction table at ``-t 4`` byte-equal to ``-t 1``,
    on the first 5,000 pairs byte-equal to the port's CPU path, and a
    ``--checkpoint`` run crashed in its third chunk, then resumed,
    byte-equal to an uninterrupted one (``phase_outputs``); the mapping
    wall of each run, with the card's name and power limit;
16. ``[cache]``, after phase 6: the engine tables through the layout
    cache (its threshold patched to 0) on the 8 and 50 Mbp indexes,
    narrow and wide: a miss that writes the sidecar, then a hit that
    uploads its read-only memmap; tables and seed scans equal, both
    set-up times logged (``phase_cache``);
17. ``[stream]``, after phases 4 and 15, the long-stream paths
    (``phase_stream``, ``dart_tpu_torch.stream``): (a) ``8mbp_se``'s
    file as 10 ``-f`` files (1,000,000 reads, 20 chunks) with phase 4's
    flags and ``--checkpoint`` on the narrow engine (K = 11 table),
    whose SAM and junction table pass ``stream.check_stream`` against
    phase 4's one-file run, every kernel of the path launched once a
    chunk, the card's reserved bytes after the last chunk no more than
    after the third and this process's own bytes on the card (NVML's
    count, read once a chunk) within 64 MiB of the third chunk's
    (``stream.hold_card``), the card's used bytes (``mem_get_info``,
    every process's), host RSS and card bytes logged a file; (b)
    the same stream crashed in the second chunk of file 4 and resumed,
    at ``--ckpt-interval 0`` and at ``--ckpt-interval 2 --batch 16384``
    (the crash placed two chunks or more after the last save, so the
    resume re-does them), byte-equal to (a); (c) the wide engine over 3
    files, held as (a); (d) ``-all_sj -m``: ``8mbp_se`` and
    ``8mbp_dup`` (8mbp_se's genome with chr1's first 20 genes copied
    into a third chromosome, so that reads from them map twice and the
    flags change the outputs; on 8mbp_se every mapped read maps once)
    byte-equal between the engines and, on the first 5,000 reads, to
    the CPU path; ``8mbp_pe_bam`` through ``-bo``, its first 5,000 pairs
    byte-equal to the CPU path; two processes on the card against one
    over all 50,000 pairs (BAM) on its index and on 8mbp_dup's, and over
    8mbp_se's reads on 8mbp_dup's (SAM), merged outputs and junction
    tables byte-equal.

``--stream [--files N]`` (``phase_stream_long``) streams ``8mbp_se``'s
file N times (default 100: 10 M reads, 200 chunks) through
``dart_tpu_torch.stream`` with ``-bo`` and ``--checkpoint``, holds the
BAM and junction table to the stream's one-file warm pass with
``check_stream`` and the card's memory as ``[stream]`` (a) does, and
logs every chunk, each file's host RSS and card bytes, and the summary
line with the card's name and power limit. It ends with the ``ok``
line and no ``kernels`` line.

``--big`` (``phase_big``, ``dart_tpu_torch.crossing``) writes the
synthetic genome of ``tools/run_big_wide_check.py`` (1.1 Gbp, fwd+rc
text 2.2 G positions, past 2^31) under ``chip_smoke_work/big``, builds
its index with the port's builder (time and peak RSS logged, free memory
and disk first), then on the card: the wide engine missing and hitting
the layout cache; 2,048 locates (K5) either side of 2^31 against the CPU
engine's plain locate and the index's own samples; 2,048 reads from both
strands (2% of bases changed) through the seed scan (K4) with the K = 11
table (K6, held whole against its plain version), against the CPU engine
on 64 of them and against the genome text at every seed; 10,000 pairs
through ``dart-tpu-torch -bo -t 4`` against ``--device cpu``; and
``entry.giant_proof`` at index=2 on the table repacked from ``.wtab``
(the ``Sharded`` K4/K5); it also times K4-K6 there at phase 2's shapes
and one dependent load in a buffer of the table's size (``big_times``).
Its index build peaks at ~37 GiB of host memory; it writes ~13 GB of
disk. It ends with the ``ok`` line and no ``kernels`` line.

The data sets are generated in ``bench.py``'s steps with the port's own
index builder; nothing of JAX or of the JAX package ``dart_tpu`` is
imported, and an attempt to is refused.

Every engine of a main-path run (phases 4, 6 and the grid runs of 9) is
made inside that run, so its launch counts start at 0 there; the
streams (a) and (c) of 17 count their launches from just after their
warm pass to the stream's end (``stream.run_stream``'s "launches"); the
checks
and timings of phases 2, 5 and 9 use engines of their own. Phases 7 and
8 set the counts of their paths to 0 just before driving them and read
them just after, and the dry run makes its engines inside it. The line
before the last is a JSON object with each kernel's launches on its
path (phase 4 for K1-K6, phases 7 and 8 for the gap DP and the MEM
walk, phase 9's ``data=2,index=2`` runs for the ``*_sharded`` kernels
but the MEM walk's, which is the dry run's; ``launches_by_path`` adds the
paired BAM path of phase 15 and the stream of phase 17), its largest
difference
from the plain version, and both times (at the 8 Mbp index for the FM
kernels, at index=2 for the sharded ones), its bound (the bytes it
must move at the card's memory rate: inputs once, outputs once, and the
table rows and K-mer entries this run's data reads, once each) and its
library call (none: no one PyTorch call computes any of these
functions); the MEM walk's entry adds its floor at its timed set
(phase 13) and its launches on each of its paths. The last line is
``{"ok": true, "device": {...}}``; it is printed only when every phase
passed, and the exit code is 0 only then.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import io
import json
import os
import subprocess
import sys
import time
import traceback

# any attempt to import JAX, or the JAX package, fails loudly: the port
# stands alone
sys.modules["jax"] = None
sys.modules["dart_tpu"] = None

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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate (published peak)
LUT_K = 11  # the K-mer table's K on a card (dart_tpu_torch.aligner)
TOY_LUT_KS = (1, 4, 8, 11, 12)  # K-mer tables held whole on the toy index
N_PARITY = 5000
N_NW_READS = 2000  # reads through the Python pipeline in phase 7
N_TIMED = 65536  # gap-DP pairs and MEM-walk tasks timed at once
N_WALK_READS = 4096  # reads seeded from MEM walks in phase 8
N_DIST_READS = 20000  # reads of 8mbp_se through the two-process run
# the kernels reading a range-sharded table (--mesh ...,index=N)
SHARDED = ("seed_scan_sharded", "locate_sharded", "lut_build_sharded",
           "seed_scan_wide_sharded", "locate_wide_sharded",
           "lut_build_wide_sharded", "mem_walks_sharded")


def log(msg: str) -> None:
    print(msg, flush=True)


def make_dataset(name: str = "8mbp_se"):
    """bench.py's genome, reads and index of config ``name`` under WORK,
    made in the steps of ``bench.ensure_dataset`` (its ``CONFIGS``,
    ``SEED`` and ``READ_LEN``, ``tools/make_fixtures.py``'s generators)
    with the port's own index builder; a paired config's reads as
    ``bench.py`` simulates them (``sim_reads_paired``). Files that
    exist are kept. Returns {"fq": (reads, None) or (mates 1, mates 2),
    "prefix", "dir"}."""
    import random

    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    import bench  # its CONFIGS and seeds; importing it runs nothing

    import make_fixtures as mf  # on sys.path through bench

    from dart_tpu_torch.index import build_index

    spec = bench.CONFIGS[name]
    d = os.path.join(WORK, name)
    fa = os.path.join(d, "genome.fa")
    prefix = os.path.join(d, "idx")
    n = spec["n_reads"]
    fq = os.path.join(d, f"reads_{n}.fq")
    fqs = ((os.path.join(d, f"reads_{n}_1.fq"),
            os.path.join(d, f"reads_{n}_2.fq")) if spec["paired"]
           else (fq, None))
    os.makedirs(d, exist_ok=True)
    if not os.path.exists(fa):
        rng = random.Random(bench.SEED)
        genome = mf.make_genome(rng, spec["genome"], n_runs=4)
        n_genes = max(50, sum(spec["genome"].values()) // 50000)
        genome["chr1"], genes = mf.plant_genes(rng, genome["chr1"],
                                               n_genes=n_genes)
        with open(os.path.join(d, "genes.txt"), "w") as f:
            for exs in genes:
                f.write("chr1\t" + ",".join(f"{a}-{b}" for a, b in exs)
                        + "\n")
        mf.write_fasta(fa + ".tmp", sorted(genome.items()))
        os.replace(fa + ".tmp", fa)
    if spec["paired"] and not os.path.exists(fqs[1]):
        rng = random.Random(bench.SEED + 1)
        r1, r2 = mf.sim_reads_paired(rng, read_genome(fa), n // 2,
                                     bench.READ_LEN, mismatch_rate=0.005)
        for path, reads in zip(fqs, (r1, r2)):
            mf.write_reads_fastq(path + ".tmp", reads)
        for path in fqs:
            os.replace(path + ".tmp", path)
    if not spec["paired"] and not os.path.exists(fq):
        rng = random.Random(bench.SEED + 1)
        genome = read_genome(fa)
        with open(os.path.join(d, "genes.txt")) as f:
            genes = [[tuple(map(int, p.split("-"))) for p in
                      line.split("\t")[1].split(",")] for line in f]
        n_spliced = n * 3 // 10
        reads = mf.sim_reads_genomic(rng, genome, n - n_spliced,
                                     bench.READ_LEN, 0.005, tag="g")
        reads += mf.sim_reads_spliced(rng, "chr1", genome["chr1"], genes,
                                      n_spliced, bench.READ_LEN, 0.005,
                                      tag="s")
        rng.shuffle(reads)
        mf.write_reads_fastq(fq + ".tmp", reads)
        os.replace(fq + ".tmp", fq)
    if not os.path.exists(prefix + ".bwt"):
        build_index(fa, prefix)
    return {"fq": fqs, "prefix": prefix, "dir": d}


def read_genome(fa: str) -> dict:
    """A FASTA file's sequences by name (bench.py's ``_read_genome``)."""
    genome, name, parts = {}, None, []
    with open(fa) as f:
        for line in f:
            if line.startswith(">"):
                if name:
                    genome[name] = "".join(parts)
                name, parts = line[1:].split()[0].strip(), []
            else:
                parts.append(line.strip())
    genome[name] = "".join(parts)
    return genome


def start_dataset(name: str) -> subprocess.Popen:
    """make_dataset(name) in a child process, to overlap with the card."""
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

    from dart_tpu_torch.constants import NT4_TABLE

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
    """Mean device time of fn() over reps runs, after one warm-up. The
    card first sleeps for 20 ms, so that every launch is queued before
    the first one starts: a kernel shorter than its launch's host time
    (Python, ctypes, allocation: tens of µs) is then timed by the card's
    work alone."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)  # clock cycles: ~20 ms at ~2 GHz
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


class Touched:
    """A table (tensor or ``ShardedTable``) that records which of its rows
    the plain versions gather: ``seen`` marks each row read."""

    def __init__(self, t):
        self.t = t
        self.shape, self.device, self.dtype = t.shape, t.device, t.dtype
        import torch

        self.seen = torch.zeros(t.shape[0], dtype=torch.bool,
                                device=t.device)

    def __getitem__(self, rows):
        self.seen[rows.to(self.seen.device)] = True
        return self.t[rows]


def bytes_bound(nbytes: int) -> dict:
    """The least time to move nbytes at the card's memory rate (H100 SXM,
    3.35 TB/s, NVIDIA's data sheet). The FM kernels' work is integer
    popcounts and compares, for which the data sheet gives no peak rate
    (its integer rate is the tensor cores' int8), so their bound is the
    bytes'."""
    return {"bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bound_bytes": int(nbytes), "library_ms": None}


def touched_bytes(eng, run) -> int:
    """The bytes of the distinct table rows and K-mer table entries that
    ``run(view)`` reads through the plain versions of ``view``, a copy
    of ``eng`` whose tables record the rows they hand out."""
    view = copy.copy(eng)
    view.table = Touched(eng.table)
    view.lut = Touched(eng.lut) if eng.lut is not None else None
    run(view)
    n = int(view.table.seen.sum()) * eng.table.shape[1] * 4
    if view.lut is not None:
        n += int(view.lut.seen.sum()) * (24 if eng.wide else 16)
    return n


def scan_bound(eng, t, words: int, S: int) -> dict:
    """K1/K4's bound on these reads: the reads in, the seed tables out,
    and the table rows and K-mer entries the scan reads, once each."""
    out = t.shape[0] * (1 + 4 * S) * (8 if eng.wide else 4)
    return bytes_bound(t.numel() * 4 + out + touched_bytes(
        eng, lambda v: v.plain_seed_scan(t, words, S)))


def phase_kernels(toy, big, ds, device: str, n_scan: int, n_rows: int,
                  main_r: int, seed: int, long_proc) -> dict:
    """Kernel vs plain on the card, exact, narrow and wide (the seed
    scans also on long reads, ``check_long_reads`` of ``long_proc``);
    then every kernel and its plain version timed on the 8 Mbp index."""
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
    for wide, eng in engs.items():
        name = "lut_build_wide" if wide else "lut_build"
        note(name, check_equal(f"{name} (K={LUT_K}, 8 Mbp)", eng.lut,
                               eng.plain_build_lut()))
    log(f"  lut_build and lut_build_wide kernels == plain, whole K={LUT_K} "
        f"tables of the 8 Mbp index "
        f"({int((engs[False].lut[:, 2] == 0).sum())} of {4**LUT_K} K-mers "
        "dead)")
    for k in TOY_LUT_KS:
        for wide in (False, True):
            name = "lut_build_wide" if wide else "lut_build"
            eng = FMIndexTorch(toy, device, lut_k=k, wide=wide)
            note(name, check_equal(f"{name} (K={k}, toy)", eng.lut,
                                   eng.plain_build_lut()))
            if device == "cuda" and eng.n_lut_launches != 1 + (k > 1):
                raise AssertionError(f"{name} at K={k}: "
                                     f"{eng.n_lut_launches} launches")
    log(f"  lut_build and lut_build_wide kernels == plain, whole tables of "
        f"the toy index at K={', '.join(map(str, TOY_LUT_KS))}")

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

    err = check_repeats(device)
    note("seed_scan", err)
    note("seed_scan_wide", err)
    err = check_long_reads(long_proc, toy, device)
    note("seed_scan", err)
    note("seed_scan_wide", err)

    if device == "cuda":
        times = main_shape_times(engs, codes[:main_r], rlens[:main_r], rng,
                                 device, "8 Mbp")
        for k, v in times.items():
            note(k, v.pop("max_abs_err"))
            res[k].update(v)
    return res


def repeat_set(device: str, L: int = 64):
    """A 24 kbp genome, the telomeric repeat then unique sequence from a
    seed, indexed under WORK, and repeat reads of L bases packed for the
    seed scan: the telomeric repeat (every walk reaches the read's end),
    the same with a mismatch in its last base and with an N in its
    middle, tandem repeats of periods 2 and 3, a repeat running into
    unique sequence. Returns (index, (t, words, S))."""
    import numpy as np

    from dart_tpu_torch.index import build_index, load_index

    d = os.path.join(WORK, "repeat")
    prefix = os.path.join(d, "rep")
    if not os.path.exists(prefix + ".bwt"):
        os.makedirs(d, exist_ok=True)
        rng = np.random.default_rng(7)
        seq = ("TTAGGG" * 2000)[:12000] + "".join(rng.choice(list("ACGT"),
                                                             12000))
        with open(prefix + ".fa", "w") as f:
            f.write(">rep\n" + "\n".join(seq[i:i + 70] for i in
                                          range(0, len(seq), 70)) + "\n")
        build_index(prefix + ".fa", prefix)
    idx = load_index(prefix)
    telo = np.tile(np.array([3, 3, 0, 2, 2, 2], np.uint8), L // 6 + 1)[:L]
    last, mid = telo.copy(), telo.copy()
    last[-1] = (last[-1] + 1) % 4
    mid[L // 2] = 4
    h = 2 * L // 5
    reads = [telo, last, mid, np.tile(np.array([0, 1], np.uint8), L // 2),
             np.tile(np.array([0, 0, 3], np.uint8), L // 3 + 1)[:L],
             np.concatenate([telo[:h], idx.ref_codes[12000:12000 + L - h]])]
    codes = np.stack(reads)
    return idx, pack(codes, np.full(len(codes), L, np.int32), device)


REPEAT_PLAIN: dict = {}  # (max_dup, wide) -> the plain scan of the repeat reads


def check_repeats(device: str, shards: int = 1) -> int:
    """The seed scans on the repeat reads against the plain version, at
    max_dup 0, 1 and 100, narrow and wide, with the K-mer table and
    without; with shards > 1 on a table range-sharded over as many slots
    of the card. The plain scan (without the table, which gives the same
    seeds) runs on the CPU, once for each max_dup and width: the literal
    scan restarts at every position of a repeat read, O(L^2) steps of
    tiny tensors, which the card runs no faster. Returns the largest
    difference (0)."""
    from dart_tpu_torch.ops.fm_torch import FMIndexTorch

    idx, (t, words, S) = repeat_set(device)
    err = 0
    for max_dup in (0, 1, 100):
        for wide in (False, True):
            key = (max_dup, wide)
            if key not in REPEAT_PLAIN:
                REPEAT_PLAIN[key] = FMIndexTorch(
                    idx, "cpu", max_dup_num=max_dup,
                    wide=wide).plain_seed_scan(t.cpu(), words, S)
            eng = FMIndexTorch(idx, device, max_dup_num=max_dup, lut_k=LUT_K,
                               wide=wide, shard_devices=[device] * shards
                               if shards > 1 else None)
            for e in (eng, without_lut(eng)):
                err = max(err, check_equal(
                    f"seed scan on repeat reads (max_dup {max_dup}, wide "
                    f"{wide}, K={e.lut_k}, {shards} shard(s))",
                    e.seed_scan(t, words, S).cpu(), REPEAT_PLAIN[key]))
    log(f"  seed scans == plain on {t.shape[0]} repeat reads (telomeric, "
        "last-base mismatch, N, tandem, into unique) at max_dup 0, 1, 100, "
        f"narrow and wide, K={LUT_K} and none, {shards} shard(s)")
    return err


LONG_READS = (1000, 4000, 16000, 65535)  # bases: the seed scan in place


def long_reads(toy):
    """Toy-genome reads of LONG_READS bases, 0.2% substitutions (N among
    them): past ~1,000 bases a block's reads no longer fit its shared
    memory and the seed scan reads them in place; the longest has seeds
    past read position 32,768."""
    import numpy as np

    rng = np.random.default_rng(41)
    codes = np.full((len(LONG_READS), max(LONG_READS)), 4, np.uint8)
    for i, n in enumerate(LONG_READS):
        p = int(rng.integers(0, toy.seq_len - n))
        read = toy.ref_codes[p:p + n].copy()
        mut = rng.random(n) < 0.002
        read[mut] = rng.integers(0, 5, int(mut.sum()))
        codes[i, :n] = read
    return codes, np.array(LONG_READS, np.int32)


def long_plain() -> None:
    """The plain scan of ``long_reads`` on the CPU (without the K-mer
    table, which gives the same seeds), into WORK/long/plain.npy: one
    step a turn over the longest read, tens of seconds, which the card
    runs no faster; run in a child process while the card works."""
    import numpy as np
    import torch

    from dart_tpu_torch.index import load_index
    from dart_tpu_torch.ops.fm_torch import FMIndexTorch

    torch.set_num_threads(2)
    toy = load_index(os.path.join(GOLD, "index", "toy"))
    t, words, S = pack(*long_reads(toy), "cpu")
    out = FMIndexTorch(toy, "cpu").plain_seed_scan(t, words, S).numpy()
    d = os.path.join(WORK, "long")
    os.makedirs(d, exist_ok=True)
    np.save(os.path.join(d, "plain.tmp.npy"), out)
    os.replace(os.path.join(d, "plain.tmp.npy"), os.path.join(d, "plain.npy"))


def start_long_plain() -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
         " import chip_smoke; chip_smoke.long_plain()", HERE], cwd=HERE,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


def check_long_reads(proc: subprocess.Popen, toy, device: str) -> int:
    """The seed scans (narrow with the K = 11 table and without, wide
    with it) on ``long_reads``, read in place, against the plain scan of
    ``long_plain`` (``proc``). Returns the largest difference (0)."""
    import numpy as np
    import torch

    from dart_tpu_torch.ops.fm_torch import FMIndexTorch

    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"the plain scan of the long reads failed "
                           f"({proc.returncode}):\n{err[-3000:]}")
    want = torch.from_numpy(np.load(os.path.join(WORK, "long", "plain.npy")))
    t, words, S = pack(*long_reads(toy), device)
    if 128 * (words + words // 2 + 1) * 4 <= 48 * 1024:
        raise AssertionError("the long reads fit the scan's staging")
    rpos = want[:, 1:1 + S]
    if int(rpos.max()) <= 32768:
        raise AssertionError("no seed past read position 32,768")
    out = 0
    for wide in (False, True):
        eng = FMIndexTorch(toy, device, lut_k=LUT_K, wide=wide)
        for e in ((eng, without_lut(eng)) if not wide else (eng,)):
            out = max(out, check_equal(
                f"seed scan on long reads (wide {wide}, K={e.lut_k})",
                e.seed_scan(t, words, S).cpu().long(), want.long()))
    log(f"  seed scans (narrow K={LUT_K} and none, wide K={LUT_K}) == plain "
        f"on reads of {', '.join(map(str, LONG_READS))} bases, read in place "
        f"({int(want[:, 0].sum())} seeds, up to read position "
        f"{int(rpos.max())})")
    return out


COPIES = (2, 3, 5, 10, 20, 50, 100)  # copies of a segment (repeat runs)


def copies_set(device: str):
    """Repeat runs as the main path sends them to the locate: a 200 kbp
    genome of random bases (from a seed) that holds a 400-base segment
    in 2, 3, 5, 10, 20, 50 and 100 copies (a gene family, a segmental
    duplication), indexed under WORK; 8 reads of 100 bases from each
    segment, one or two substitutions in half of them. Every seed of
    such a read occurs once in each copy of its segment, so the engine's
    seeds (max_dup 100), expanded by ``seeding._expand_occurrences``,
    hand the locate runs of consecutive rows k0 .. k0 + freq - 1.
    Returns (index, [the rows of that one locate launch])."""
    import numpy as np

    from dart_tpu_torch.index import build_index, load_index
    from dart_tpu_torch.ops.fm_torch import FMIndexTorch
    from dart_tpu_torch.pipeline.seeding import _expand_occurrences

    d = os.path.join(WORK, "copies")
    prefix = os.path.join(d, "cp")
    rng = np.random.default_rng(11)
    segs = {c: rng.integers(0, 4, 400) for c in COPIES}
    if not os.path.exists(prefix + ".bwt"):
        os.makedirs(d, exist_ok=True)
        order = rng.permutation(np.repeat(COPIES, COPIES))
        bg = rng.integers(0, 4, 200_000 - 400 * len(order))
        cuts = np.sort(rng.integers(0, bg.size, len(order)))
        parts, at = [], 0
        for c, cut in zip(order, cuts):
            parts += [bg[at:cut], segs[c]]
            at = cut
        seq = "".join("ACGT"[b] for b in np.concatenate(parts + [bg[at:]]))
        with open(prefix + ".fa", "w") as f:
            f.write(">cp\n" + "\n".join(seq[i:i + 70] for i in
                                         range(0, len(seq), 70)) + "\n")
        build_index(prefix + ".fa", prefix)
    idx = load_index(prefix)
    rng = np.random.default_rng(12)
    reads = []
    for c in COPIES:
        for r in range(8):
            off = int(rng.integers(0, 300))
            read = segs[c][off:off + 100].copy()
            if r % 2:
                at = rng.integers(20, 80, int(rng.integers(1, 3)))
                read[at] = (read[at] + rng.integers(1, 4, at.size)) % 4
            reads.append(read)
    codes = np.stack(reads).astype(np.uint8)
    eng = FMIndexTorch(idx, device, max_dup_num=100)
    seeds = eng.seed_reads(codes, np.full(len(codes), 100, np.int32))
    with recording_locates() as rec:
        _expand_occurrences(eng, *seeds, len(codes))
    if len(rec) != 1:
        raise AssertionError(f"the repeat reads made {len(rec)} locate "
                             "launches, expected one")
    return idx, rec


def runs_of(rows) -> list:
    """The lengths of the runs of consecutive rows in a launch's rows."""
    import numpy as np

    breaks = np.flatnonzero(np.diff(rows) != 1) + 1
    return np.diff(np.concatenate([[0], breaks, [len(rows)]])).tolist()


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
        isz = 8 if wide else 4
        lut_bytes = 4**eng.lut_k * (24 if wide else 16)
        jobs = {
            "seed_scan": (lambda: eng.seed_scan(t, words, S),
                          lambda: eng.plain_seed_scan(t, words, S), 5,
                          lambda: scan_bound(eng, t, words, S)),
            "locate": (lambda: eng.locate_rows(rows),
                       lambda: eng.plain_locate(rows), 20,
                       lambda: bytes_bound(2 * rows.numel() * isz
                                           + touched_bytes(
                           eng, lambda v: v.plain_locate(rows)))),
            "lut_build": (lambda: eng.build_lut(),
                          lambda: eng.plain_build_lut(), 3,
                          lambda: bytes_bound(lut_bytes + touched_bytes(
                              eng, lambda v: v.plain_build_lut()))),
        }
        for name, (kern, plain, reps, bound) in jobs.items():
            ms = time_ms(kern, reps)
            want, plain_ms = timed_once(plain)
            err = check_equal(f"{name}{sfx} ({what}, timing shape)", kern(),
                              want)
            out[name + sfx] = {"ms": ms, "plain_ms": plain_ms,
                               "max_abs_err": err, **bound()}
            b = out[name + sfx]
            log(f"  {name}{sfx} on the {what} index: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.3f} ms; bound {b['bound_ms']:.4f} ms "
                f"({b['bound_bytes'] / 1e6:.1f} MB), "
                f"{100 * b['bound_ms'] / ms:.1f}% of it")
    nolut = without_lut(engs[False])
    ms = time_ms(lambda: nolut.seed_scan(t, words, S), 5)
    b = scan_bound(nolut, t, words, S)["bound_ms"]
    out["seed_scan"].update(ms_without_lut=ms, bound_ms_without_lut=b)
    log(f"  seed_scan without the K-mer table on the {what} index: kernel "
        f"{ms:.4f} ms, bound {b:.4f} ms (R={len(rlens)}, Lp={words * 16}, "
        f"S={S})")
    return out


def phase_kernels50(big50, ds50, device: str, seed: int) -> dict:
    """The narrow and the wide K-mer table builds held against their
    plain versions on the 50 Mbp index, whole; then every kernel timed
    there."""
    import numpy as np

    from dart_tpu_torch.ops.fm_torch import FMIndexTorch

    engs = {wide: FMIndexTorch(big50, device, lut_k=LUT_K, wide=wide)
            for wide in (False, True)}
    mb = {w: e.table.numel() * 4e-6 for w, e in engs.items()}
    log(f"  50 Mbp engines: narrow set-up {fmt_setup(engs[False])}, wide "
        f"{fmt_setup(engs[True])}; tables {mb[False]:.1f} MB narrow, "
        f"{mb[True]:.1f} MB wide")
    res = {("lut_build_wide" if w else "lut_build"): check_equal(
        f"lut_build{'_wide' if w else ''} (K={LUT_K}, 50 Mbp)", e.lut,
        e.plain_build_lut()) for w, e in engs.items()}
    log(f"  lut_build and lut_build_wide kernels == plain, whole K={LUT_K} "
        "tables of the 50 Mbp index")
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
    from dart_tpu_torch.aligner import default_lut_k, run
    from dart_tpu_torch.cli import parse_args

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


@contextlib.contextmanager
def recording_locates():
    """The rows of every locate launch that ``FMIndexTorch.locate_submit``
    makes inside it, as int64 NumPy arrays in launch order. They are
    copied on the host before the upload, so the run is not made to
    wait for the card."""
    import numpy as np

    from dart_tpu_torch.ops.fm_torch import FMIndexTorch

    rec, orig = [], FMIndexTorch.locate_submit

    def locate_submit(self, rows):
        if rows.shape[0]:
            rec.append(np.array(rows, dtype=np.int64))
        return orig(self, rows)

    FMIndexTorch.locate_submit = locate_submit
    try:
        yield rec
    finally:
        FMIndexTorch.locate_submit = orig


def align(idx, ds, out: str, tag: str, device: str, wide: bool,
          mesh: str = "", extra=()) -> dict:
    """One main-path run over the whole read set (``extra`` flags added),
    on one engine or, with ``mesh``, on a device grid: the engine (and
    its launch counts, which start at 0) is made inside it. Logs and
    returns wall time, reads/s, set-up seconds, launch counts (and each
    data group's, on a grid) and, on one engine, the rows of each locate
    launch."""
    from dart_tpu_torch.aligner import default_lut_k, run
    from dart_tpu_torch.cli import parse_args

    err = io.StringIO()
    cfg = parse_args(["-i", ds["prefix"], "-f", ds["fq"][0], "-o",
                      os.path.join(out, f"{tag}.sam"), "-j",
                      os.path.join(out, f"{tag}.tab"), "-silent", "--stats",
                      *(["--mesh", mesh] if mesh else []), *extra])
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err), recording_locates() as located:
        aligner = run(idx, cfg, device, wide=wide)
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng = aligner.engine
    n = aligner.counters["total"]
    # the MEM walk serves another seeding path (phase 8), not this one
    launches = {k: v for k, v in eng.launches.items()
                if not k.startswith("mem_walks")}
    slots = [{k: v for k, v in s.items() if not k.startswith("mem_walks")}
             for s in getattr(eng, "slot_launches", [])]
    log(f"  {tag}: {n} reads in {wall:.3f} s wall incl. set-up "
        f"({n / wall:.0f} reads/s); set-up {fmt_setup(eng)}; launches "
        + ", ".join(f"{k} {v}" for k, v in launches.items())
        + (f"; per data group {slots}" if slots else ""))
    if not mesh:
        log(f"    locate: {eng.n_locate_rows} rows in "
            f"{eng.n_locate_launches} launches, rows a launch "
            f"{[len(r) for r in located]}")
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
            "setup_s": eng.setup_s, "slot_launches": slots,
            "located": [] if mesh else located}


def require_same(out: str, a: str, b: str, what: str,
                 exts=("sam", "tab")) -> None:
    for ext in exts:
        if not same_bytes(os.path.join(out, f"{a}.{ext}"),
                          os.path.join(out, f"{b}.{ext}")):
            raise AssertionError(f"{what}: {a}.{ext} differs from {b}.{ext}")


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


def phase_scale(big, ds, device: str, n_parity: int) -> dict:
    """The 8mbp_se set through the narrow and the wide engine; then its
    first n_parity reads through both against the port's CPU path (the
    plain versions)."""
    from dart_tpu_torch.aligner import run
    from dart_tpu_torch.cli import parse_args

    out = os.path.join(WORK, "scale")
    os.makedirs(out, exist_ok=True)
    res = {"narrow": align(big, ds, out, "narrow", device, wide=False),
           "wide": align(big, ds, out, "wide", device, wide=True)}
    require_same(out, "narrow", "wide", "8mbp_se")
    log(f"  all {res['narrow']['reads']} reads: SAM and junction table "
        "byte-equal between the narrow and the wide engine")

    head = head_fastq(ds["fq"][0], n_parity, out)
    for who in ("cpu", "port", "port_wide"):
        cfg = parse_args(["-i", ds["prefix"], "-f", head, "-o",
                          os.path.join(out, f"{who}.sam"), "-j",
                          os.path.join(out, f"{who}.tab"), "-silent"])
        with contextlib.redirect_stdout(io.StringIO()):
            run(big, cfg, "cpu" if who == "cpu" else device,
                wide=who == "port_wide")
    for who in ("port", "port_wide"):
        require_same(out, who, "cpu", f"first {n_parity} reads")
    log(f"  first {n_parity} reads: SAM and junction table of both engines "
        "byte-equal to the port's CPU path (plain versions)")
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


CARD = "the card"  # its name and power limit, as nvidia-smi gives them
BAM = ("bam", "tab")  # a -bo run's outputs


def pe_run(idx, ds, out: str, tag: str, device: str, threads: int,
           fqs=None, extra=(), engine_hook=None) -> dict:
    """``dart-tpu-torch -i idx -f r1 -f2 r2 -bo <tag>.bam -t threads``
    through ``aligner.run`` (the engine, and its launch counts, made
    inside it), or, with ``engine_hook``, through a ``DartAligner`` the
    hook may change before its run. Logs and returns the wall (set-up
    included), the mapping wall of ``--stats`` and the launches."""
    from dart_tpu_torch.aligner import DartAligner, make_engine, run
    from dart_tpu_torch.cli import parse_args

    r1, r2 = fqs or ds["fq"]
    cfg = parse_args(["-i", ds["prefix"], "-f", r1, "-f2", r2, "-bo",
                      os.path.join(out, f"{tag}.bam"), "-j",
                      os.path.join(out, f"{tag}.tab"), "-t", str(threads),
                      "-silent", "--stats", *extra])
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        if engine_hook is None:
            aligner = run(idx, cfg, device)
        else:
            aligner = DartAligner(idx, cfg,
                                  engine=make_engine(idx, cfg, device))
            engine_hook(aligner)
            aligner.run()
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = [ln for ln in err.getvalue().splitlines()
             if ln.startswith("[stats] wall")]
    launches = {k: v for k, v in aligner.engine.launches.items()
                if not k.startswith("mem_walks")}
    n = aligner.counters["total"]
    log(f"  {tag}: {n} reads ({n // 2} pairs) in {wall:.3f} s wall incl. "
        f"set-up, -t {threads}, {device} ({CARD}); "
        f"{stats[0][8:] if stats else 'no [stats] line'}; launches "
        + ", ".join(f"{k} {v}" for k, v in launches.items()))
    return {"wall_s": wall, "stats": stats, "launches": launches,
            "reads": n}


def same_bam(a: str, b: str) -> bool:
    """The same BAM records: the BGZF members decompressed."""
    import gzip

    with gzip.open(a, "rb") as fa, gzip.open(b, "rb") as fb:
        return fa.read() == fb.read()


def phase_outputs(ds, device: str, n_parity: int, batch: int = 8192) -> dict:
    """The main path's other outputs on 8mbp_pe_bam (paired reads, BAM):
    the card's BAM and junction table byte-equal to the port's CPU path
    on the first n_parity pairs; the whole set at -t 4 byte-equal to -t
    1; and a --checkpoint run (``batch`` reads a chunk) that crashes in
    its third chunk, resumed, byte-equal to an uninterrupted one and
    holding the same records as the -t 1 run. Returns each run's walls
    and the -t 1 run's launches."""
    from dart_tpu_torch.index import load_index

    out = os.path.join(WORK, "outputs")
    os.makedirs(out, exist_ok=True)
    idx = load_index(ds["prefix"])
    res = {"t1": pe_run(idx, ds, out, "t1", device, 1),
           "t4": pe_run(idx, ds, out, "t4", device, 4)}
    for tag in ("t1", "t4"):
        if device == "cuda" and not all(res[tag]["launches"].values()):
            raise AssertionError(f"{tag}: a kernel of the path never "
                                 f"launched: {res[tag]['launches']}")
    require_same(out, "t4", "t1", "8mbp_pe_bam -t 4 against -t 1", BAM)
    log(f"  all {res['t1']['reads'] // 2} pairs: BAM and junction table "
        "byte-equal at -t 4 and -t 1")

    heads = (head_fastq(ds["fq"][0], n_parity, out, "head_1.fq"),
             head_fastq(ds["fq"][1], n_parity, out, "head_2.fq"))
    res["head"] = pe_run(idx, ds, out, "head", device, 1, fqs=heads)
    res["head_cpu"] = pe_run(idx, ds, out, "head_cpu", "cpu", 1, fqs=heads)
    require_same(out, "head", "head_cpu",
                 f"first {n_parity} pairs, {device} against the CPU path", BAM)
    log(f"  first {n_parity} pairs: BAM and junction table byte-equal to "
        "the port's CPU path (plain versions)")

    ckpt = ["--checkpoint", "--batch", str(batch)]
    res["whole"] = pe_run(idx, ds, out, "whole", device, 1, extra=ckpt)
    crash, _ = crash_hook(sys.maxsize, 0, 3)  # one file: its third chunk
    try:
        pe_run(idx, ds, out, "resumed", device, 1, extra=ckpt,
               engine_hook=crash)
        raise AssertionError("the injected crash did not stop the run")
    except RuntimeError as e:
        if str(e) != "injected crash":
            raise
    gc.collect()  # the crashed run's writer goes, as with its process
    bam = os.path.join(out, "resumed.bam")
    if not os.path.exists(bam + ".ckpt"):
        raise AssertionError("the crashed run left no checkpoint")
    cut = os.path.getsize(bam)
    res["resumed"] = pe_run(idx, ds, out, "resumed", device, 1, extra=ckpt)
    if os.path.exists(bam + ".ckpt"):
        raise AssertionError("the resumed run left its checkpoint")
    require_same(out, "resumed", "whole",
                 "the crashed and resumed --checkpoint run", BAM)
    if not same_bam(bam, os.path.join(out, "t1.bam")):
        raise AssertionError("the --checkpoint run's records differ from "
                             "the -t 1 run's")
    log(f"  --checkpoint --batch {batch}: crashed in chunk 3 ({cut} BAM "
        "bytes on disk), resumed: BAM and junction table byte-equal to an "
        "uninterrupted --checkpoint run, records equal to the -t 1 run's")
    return res


N_STREAM_FILES = 10  # 8mbp_se's 100,000 reads as 10 -f files: 1 M reads
N_WIDE_FILES = 3  # the same through the wide engine
STREAM_SLACK = 64 << 20  # bytes the card's used memory may move
MiB = 1 << 20


def stream_args(ds, out: str, tag: str, fmt: str = "sam", extra=()):
    """Phase 4's flags with ``--checkpoint``, into out/<tag>.<fmt>:
    (argv, (alignments, junctions.tab))."""
    outs = (os.path.join(out, f"{tag}.{fmt}"), os.path.join(out, f"{tag}.tab"))
    return (["-i", ds["prefix"], "-f", ds["fq"][0],
             "-bo" if fmt == "bam" else "-o", outs[0], "-j", outs[1],
             "-silent", "--stats", "--checkpoint", *extra], outs)


def run_stream(idx, args, n_files: int, device: str, engine=None,
               hook=None, quiet: bool = False) -> dict:
    """``dart_tpu_torch.stream.run_stream`` of ``args`` over n_files files
    on ``engine`` (made inside it when None), its chunk lines logged
    unless ``quiet``; the summary line logged and returned, with the
    per-chunk records under "log"."""
    from dart_tpu_torch import stream
    from dart_tpu_torch.cli import parse_args

    sink = io.StringIO() if quiet else sys.stdout
    res = stream.run_stream(idx, parse_args(args), n_files, device,
                            engine=engine, log=sink, on_aligner=hook)
    log("  " + json.dumps({k: v for k, v in res.items()
                           if k not in ("log", "engine")}))
    return res


def hold_stream(res, what: str, kernels) -> None:
    """A stream's host RSS and card bytes at the end of each file, logged;
    every kernel of ``kernels`` launched once a chunk at least in the
    stream itself; its memory on the card flat from the third chunk
    (``stream.hold_card``: the reserve, and this process's own bytes
    within STREAM_SLACK)."""
    from dart_tpu_torch import stream

    last = {}
    for r in res["log"]:
        last[r["file"]] = r
    for f, r in sorted(last.items()):
        c = r["card"]
        log(f"    file {f}: rss {r['rss_mb']:.1f} MB, card reserved "
            f"{c['reserved'] / MiB:.1f} MiB, used {c['used'] / MiB:.1f} "
            f"MiB, own {stream._mib(c['own'])} MiB, allocated "
            f"{c['allocated'] / MiB:.1f} MiB")
    for k in kernels:
        if res["launches"].get(k, 0) < res["chunks"]:
            raise AssertionError(f"{what}: {k} launched "
                                 f"{res['launches'].get(k, 0)} times in "
                                 f"{res['chunks']} chunks")
    try:
        held = stream.hold_card(res["log"], STREAM_SLACK)
    except AssertionError as e:
        raise AssertionError(f"{what}: {e}") from None
    log(f"  {what}: {res['chunks']} chunks, launches {res['launches']}; "
        f"card reserved {res['reserved_third'] / MiB:.1f} MiB after chunk 3, "
        f"{res['reserved_last'] / MiB:.1f} MiB after the last (peak "
        f"{res['reserved_peak'] / MiB:.1f}); this process's own bytes "
        f"{stream._mib(res['own_third'])} MiB after chunk 3, moved at most "
        f"{held['own_moved'] / MiB:.1f} MiB from there; the card's used "
        f"bytes moved at most {held['used_moved'] / MiB:.1f} MiB, past "
        f"{STREAM_SLACK // MiB} MiB at {held['used_moves_past_slack']} "
        f"chunks; host RSS {res['rss_mb_per_file']:+.2f} MB a file ({CARD})")


def crash_hook(per_file: int, file_idx: int, chunk: int, lag: int = 0):
    """A hook that makes the streaming aligner's native pipeline raise in
    chunk ``chunk`` (from 1) of file ``file_idx`` (from 0), as a process
    that dies there, or, with ``lag``, in the first chunk from there on
    that follows ``lag`` or more chunks finished since the last
    checkpoint save, so that the resume re-does them. Records the
    crashed chunk and the chunks done at the last save (from 1)."""
    seen = {"calls": 0, "saved": 0, "since": 0, "files": {}}

    def hook(aligner):
        proc, save = aligner.native.process_chunk, aligner._ckpt_save

        def saving(*a, **kw):
            seen["saved"], seen["since"] = seen["calls"], 0
            return save(*a, **kw)

        def flaky(*a, **kw):
            f = aligner.counters["total"] // per_file
            seen["files"][f] = seen["files"].get(f, 0) + 1
            seen["calls"] += 1
            if ((f, seen["files"][f]) >= (file_idx, chunk)
                    and seen["since"] >= lag):
                seen["crashed"], seen["file"] = seen["calls"], f
                raise RuntimeError("injected crash")
            out = proc(*a, **kw)
            seen["since"] += 1
            return out

        aligner._ckpt_save = saving
        aligner.native.process_chunk = flaky

    return hook, seen


def crash_and_resume(idx, args, outs, n_files: int, device: str, engine,
                     per_file: int, lag: int) -> dict:
    """The stream of ``args`` crashed in the second chunk of file 4 (with
    ``lag``: as ``crash_hook`` moves it), then run again: it resumes
    from its checkpoint. Returns the crash point and the resumed run."""
    hook, seen = crash_hook(per_file, 3, 2, lag)
    try:
        run_stream(idx, args, n_files, device, engine, hook, quiet=True)
        raise AssertionError("the injected crash did not stop the stream")
    except RuntimeError as e:
        if str(e) != "injected crash":
            raise
    gc.collect()  # the crashed run's writer goes, as with its process
    out = outs[0]
    with open(out + ".ckpt") as f:
        ckpt = json.load(f)
    redone = seen["crashed"] - 1 - seen["saved"]
    if redone < lag:
        raise AssertionError(f"the last save lags the crash by {redone} "
                             f"chunks, not {lag} or more")
    res = run_stream(idx, args, n_files, device, engine, quiet=True)
    if os.path.exists(out + ".ckpt"):
        raise AssertionError("the resumed stream left its checkpoint")
    log(f"  crashed in chunk {seen['crashed']} (file {seen['file']}, "
        f"chunk {seen['files'][seen['file']]}), checkpoint at file "
        f"{ckpt['file_idx']} chunk {ckpt['chunks']} ({os.path.getsize(out)} "
        f"bytes on disk, the last save {redone} chunks before the crash); "
        f"resumed: {res['chunks']} chunks in {res['wall_s']:.3f} s")
    return {"crashed": seen["crashed"], "redone": redone, "ckpt": ckpt,
            "resumed_chunks": res["chunks"], "wall_s": res["wall_s"]}


DUP_GENES = 20  # chr1's first genes, copied whole into chrDup


def make_dup(ds) -> dict:
    """``8mbp_dup``: 8mbp_se's genome with a copy of chr1 from its start
    to past its DUP_GENES-th gene as a third chromosome, chrDup, indexed
    under WORK by the port's index builder. 8mbp_se's reads (and
    8mbp_pe_bam's) from that span map twice there, so -m reports more
    than one alignment and -all_sj records junctions that phase 4's
    run, which keeps only unique alignments' junctions, leaves out.
    Returns a data set dict with 8mbp_se's reads."""
    import make_fixtures as mf  # on sys.path through bench (make_dataset)

    from dart_tpu_torch.index import build_index

    d = os.path.join(WORK, "8mbp_dup")
    prefix = os.path.join(d, "idx")
    if not os.path.exists(prefix + ".bwt"):
        os.makedirs(d, exist_ok=True)
        genome = read_genome(os.path.join(ds["dir"], "genome.fa"))
        with open(os.path.join(ds["dir"], "genes.txt")) as f:
            ends = [int(line.rsplit("-", 1)[1]) for line in f]
        genome["chrDup"] = genome["chr1"][:ends[DUP_GENES - 1] + 1000]
        fa = os.path.join(d, "genome.fa")
        mf.write_fasta(fa, sorted(genome.items()))
        build_index(fa, prefix)
    return {"fq": ds["fq"], "prefix": prefix, "dir": d}


def allsj_se(idx, ds, d: str, name: str, device: str, n_parity: int) -> dict:
    """``-all_sj -m`` on a single-end set: the whole set on the narrow and
    the wide engine byte-equal, and its first n_parity reads byte-equal
    to the port's CPU path. Outputs d/<name>_{narrow,wide,port,cpu}."""
    from dart_tpu_torch.aligner import run
    from dart_tpu_torch.cli import parse_args

    allsj = ["-all_sj", "-m"]
    res = {w: align(idx, ds, d, f"{name}_{w}", device, w == "wide",
                    extra=allsj) for w in ("narrow", "wide")}
    require_same(d, f"{name}_narrow", f"{name}_wide", f"{name} -all_sj -m")
    head = head_fastq(ds["fq"][0], n_parity, d, f"{name}_head.fq")
    for who in ("cpu", "port"):
        cfg = parse_args(["-i", ds["prefix"], "-f", head, "-o",
                          os.path.join(d, f"{name}_{who}.sam"), "-j",
                          os.path.join(d, f"{name}_{who}.tab"), "-silent",
                          *allsj])
        with contextlib.redirect_stdout(io.StringIO()):
            run(idx, cfg, "cpu" if who == "cpu" else device)
    require_same(d, f"{name}_port", f"{name}_cpu",
                 f"{name} -all_sj -m, first {n_parity} reads")
    log(f"  (d) {name} -all_sj -m: SAM and junction table byte-equal between "
        f"the engines; first {n_parity} reads byte-equal to the port's CPU "
        "path")
    return res


def phase_stream(big, ds, ds_pe, device: str, n_parity: int) -> dict:
    """[stream], after phases 4 and 15: the long-stream paths (BASELINE
    config 5's shape at 8 Mbp).

    (a) 8mbp_se's file as N_STREAM_FILES -f files (1 M reads) through
        ``dart_tpu_torch.stream`` with phase 4's flags and --checkpoint,
        narrow engine with the K = 11 table: ``check_stream`` against
        phase 4's one-file run, every kernel of the path launched once a
        chunk, the card's memory flat (``hold_stream``);
    (b) the same stream crashed in the second chunk of file 4, then
        resumed, at --ckpt-interval 0 and at --ckpt-interval 2 with
        --batch 16384 (the last save lags the crash): byte-equal to (a);
    (c) the wide engine over N_WIDE_FILES files, held as (a);
    (d) -all_sj -m (``allsj_se``) on 8mbp_se and on 8mbp_dup
        (``make_dup``, where the flags change the outputs, which is
        checked): narrow and wide byte-equal, the first n_parity reads
        byte-equal to the port's CPU path; 8mbp_pe_bam through -bo, its
        first n_parity pairs byte-equal to the CPU path; two processes
        on the card against one over all of 8mbp_pe_bam (BAM) on its
        own index and on 8mbp_dup's, and over 8mbp_se's reads on
        8mbp_dup's (SAM): merged outputs and junction tables
        byte-equal."""
    import torch

    from dart_tpu_torch import stream
    from dart_tpu_torch.aligner import make_engine
    from dart_tpu_torch.cli import parse_args
    from dart_tpu_torch.index import load_index

    out = os.path.join(WORK, "stream")
    os.makedirs(out, exist_ok=True)
    one = (os.path.join(WORK, "scale", "narrow.sam"),
           os.path.join(WORK, "scale", "narrow.tab"))
    narrow = ("seed_scan", "locate")
    res = {}

    torch.cuda.empty_cache()
    args, outs = stream_args(ds, out, "a")
    r = res["a"] = run_stream(big, args, N_STREAM_FILES, device)
    engine = r.pop("engine")
    stream.check_stream(outs, one, N_STREAM_FILES)
    if engine.launches["lut_build"] < 1:
        raise AssertionError("the stream's engine built no K-mer table")
    hold_stream(r, f"(a) {r['stream_reads']} reads in {N_STREAM_FILES} "
                "files", narrow)
    res["a_launches"] = r["launches"]  # the stream's own, not the warm pass's
    log(f"  (a) SAM and junction table pass check_stream against phase 4's "
        f"one-file run: {N_STREAM_FILES} x the records, counts x "
        f"{N_STREAM_FILES}")

    per_file = r["reads_per_file"]
    for tag, extra, lag in (("b0", ["--ckpt-interval", "0"], 0),
                            ("b2", ["--ckpt-interval", "2", "--batch",
                                    "16384"], 2)):
        bargs, bouts = stream_args(ds, out, tag, extra=extra)
        res[tag] = crash_and_resume(big, bargs, bouts, N_STREAM_FILES, device,
                                    engine, per_file, lag)
        require_same(out, tag, "a", f"({tag}) the crashed and resumed stream")
        log(f"  ({tag}) {' '.join(extra)}: SAM and junction table byte-equal "
            "to (a)")
    os.remove(outs[0])
    del engine, r
    gc.collect()

    torch.cuda.empty_cache()
    args, outs = stream_args(ds, out, "c")
    wide = make_engine(big, parse_args(args), device, wide=True)
    r = res["c"] = run_stream(big, args, N_WIDE_FILES, device, wide)
    r.pop("engine")
    stream.check_stream(outs, one, N_WIDE_FILES)
    hold_stream(r, f"(c) wide engine, {r['stream_reads']} reads in "
                f"{N_WIDE_FILES} files", ("seed_scan_wide", "locate_wide"))
    res["c_launches"] = r["launches"]
    log("  (c) SAM and junction table pass check_stream against phase 4's "
        "one-file run")
    del wide
    gc.collect()

    allsj = ["-all_sj", "-m"]
    d = os.path.join(out, "allsj")
    os.makedirs(d, exist_ok=True)
    dup = make_dup(ds)
    dup_idx = load_index(dup["prefix"])
    for name, idx, data in (("8mbp_se", big, ds), ("8mbp_dup", dup_idx, dup)):
        res[f"d_{name}"] = allsj_se(idx, data, d, name, device, n_parity)
    # the flags must change 8mbp_dup's outputs, or they were not tested
    plain = align(dup_idx, dup, d, "8mbp_dup_plain", device, False)
    counts = {}
    for tag in ("8mbp_dup_plain", "8mbp_dup_narrow", "8mbp_se_narrow"):
        with open(os.path.join(d, f"{tag}.sam"), "rb") as f:
            n_rec = sum(1 for line in f if not line.startswith(b"@"))
        with open(os.path.join(d, f"{tag}.tab")) as f:
            counts[tag] = (n_rec, sum(1 for _ in f))
    more = [b - a for a, b in zip(counts["8mbp_dup_plain"],
                                  counts["8mbp_dup_narrow"])]
    log(f"  (d) -all_sj -m on 8mbp_dup: {more[0]} more SAM records and "
        f"{more[1]} more junction rows than without the flags "
        f"({counts['8mbp_dup_plain']} records, rows); on 8mbp_se "
        f"{counts['8mbp_se_narrow']} (every mapped read maps once, so the "
        "flags change nothing there)")
    if min(more) <= 0:
        raise AssertionError("-all_sj -m changed nothing on 8mbp_dup")
    res["d_dup_more"], res["d_dup_plain"] = more, plain

    pe_idx = load_index(ds_pe["prefix"])
    heads = (head_fastq(ds_pe["fq"][0], n_parity, d, "head_1.fq"),
             head_fastq(ds_pe["fq"][1], n_parity, d, "head_2.fq"))
    res["d_pe_head"] = pe_run(pe_idx, ds_pe, d, "pe_head", device, 1,
                              fqs=heads, extra=allsj)
    pe_run(pe_idx, ds_pe, d, "pe_head_cpu", "cpu", 1, fqs=heads, extra=allsj)
    require_same(d, "pe_head", "pe_head_cpu",
                 f"-all_sj -m -bo, first {n_parity} pairs", BAM)
    log(f"  (d) 8mbp_pe_bam -all_sj -m -bo: first {n_parity} pairs byte-equal "
        "to the CPU path")
    dup_pe = {"prefix": dup["prefix"], "fq": ds_pe["fq"]}
    res["d_pe"] = pe_run(pe_idx, ds_pe, d, "pe_one", device, 4, extra=allsj)
    res["d_dup_pe"] = pe_run(dup_idx, dup_pe, d, "dup_pe_one", device, 4,
                             extra=allsj)
    # two processes on the card against one: all pairs of 8mbp_pe_bam on
    # its own index and on 8mbp_dup's (BAM), and 8mbp_se's reads on
    # 8mbp_dup's (SAM), the three pairs at once
    procs = []
    for tag, data, fmt in (("pe", ds_pe, "bam"), ("dup_pe", dup_pe, "bam"),
                           ("8mbp_dup", dup, "sam")):
        fq = (["-f", data["fq"][0]] if data["fq"][1] is None
              else ["-f", data["fq"][0], "-f2", data["fq"][1]])
        procs += start_pair(tag, [
            "-i", data["prefix"], *fq, *allsj,
            "-bo" if fmt == "bam" else "-o",
            os.path.join(d, f"{tag}_two.{fmt}"), "-j",
            os.path.join(d, f"{tag}_two.tab"), "-silent"], device)
    t0 = time.perf_counter()
    wait_procs(procs, timeout=600)
    res["d_dist_wall_s"] = time.perf_counter() - t0
    for two, one, exts in (("pe_two", "pe_one", BAM),
                           ("dup_pe_two", "dup_pe_one", BAM),
                           ("8mbp_dup_two", "8mbp_dup_narrow", ("sam",
                                                                "tab"))):
        require_same(d, two, one, f"-all_sj -m, two processes against one "
                     f"({two})", exts)
    log(f"  (d) two processes on the card against one, -all_sj -m: all "
        f"{res['d_pe']['reads'] // 2} pairs of 8mbp_pe_bam (BAM) on its index "
        "and on 8mbp_dup's, and 8mbp_se's reads on 8mbp_dup's (SAM), six "
        f"processes at once in {res['d_dist_wall_s']:.1f} s with start-up: "
        "merged outputs and junction tables byte-equal")
    return res


def rss_by_mapping(top: int = 8) -> list:
    """This process's resident MB by mapping (/proc/self/smaps: the file
    mapped, or "[anon]" for anonymous memory), the largest first."""
    sizes, name = {}, "[anon]"
    with open("/proc/self/smaps") as f:
        for line in f:
            head = line.split()
            if "-" in head[0] and not head[0].endswith(":"):
                name = head[5] if len(head) > 5 else "[anon]"
            elif head[0] == "Rss:":
                sizes[name] = sizes.get(name, 0) + int(head[1]) / 1024
    return sorted(sizes.items(), key=lambda kv: -kv[1])[:top]


def phase_stream_long(big, ds, device: str, n_files: int) -> dict:
    """``--stream``: 8mbp_se's file as n_files -f files through
    ``dart_tpu_torch.stream`` with -bo and --checkpoint (BAM bounds the
    disk), narrow engine with the K = 11 table: ``check_stream`` against
    the stream's own one-file warm pass, ``hold_stream`` as [stream]'s
    (a), every chunk's line and the summary line logged."""
    import torch

    from dart_tpu_torch import stream

    out = os.path.join(WORK, "stream_long")
    os.makedirs(out, exist_ok=True)
    torch.cuda.empty_cache()
    args, outs = stream_args(ds, out, "long", "bam")
    r = run_stream(big, args, n_files, device)
    r.pop("engine")
    stream.check_stream(outs, r["one_file"], n_files, "bam")
    hold_stream(r, f"--stream: {r['stream_reads']} reads in {n_files} files",
                ("seed_scan", "locate"))
    log(f"  BAM and junction table pass check_stream against the one-file "
        f"run ({os.path.getsize(outs[0])} BAM bytes)")
    log(f"  host RSS {r['rss_mb_before_engine']:.1f} MB before the engine, "
        f"{r['rss_mb_after_warm']:.1f} MB after the warm pass; by mapping "
        "now: " + ", ".join(f"{os.path.basename(k)} {v:.1f} MB"
                            for k, v in rss_by_mapping()))
    os.remove(outs[0])
    return r


@contextlib.contextmanager
def cache_on(prefix: str):
    """The layout cache on for every text (``CACHE_MIN_SEQ`` 0), with
    the engine tables' sidecars of ``prefix`` removed on the way in and
    out."""
    from dart_tpu_torch.index import layout_cache

    def drop():
        for kind in ("ntab", "wtab", "wtab2"):
            with contextlib.suppress(FileNotFoundError):
                os.remove(f"{prefix}.{kind}")

    old = layout_cache.CACHE_MIN_SEQ
    drop()
    layout_cache.CACHE_MIN_SEQ = 0
    try:
        yield
    finally:
        layout_cache.CACHE_MIN_SEQ = old
        drop()


def phase_cache(indexes: dict, device: str, n_reads: int) -> dict:
    """The engine tables through the layout cache, with its threshold
    patched to 0, on each of ``indexes`` ({name: (index, reads)}), narrow
    and wide: a first engine misses and writes the sidecar, a second
    hits it; tables and the seed scans of n_reads reads equal. Logs and
    returns both set-up times."""
    import torch

    from dart_tpu_torch.ops.fm_torch import FMIndexTorch

    res = {}
    for name, (idx, fq) in indexes.items():
        codes, rlens = read_fastq(fq, n_reads)
        with cache_on(idx.prefix):
            for wide in (False, True):
                engs = [FMIndexTorch(idx, device, lut_k=LUT_K, wide=wide)
                        for _ in range(2)]
                got = [e.cache for e in engs]
                if got != ["miss", "hit"]:
                    raise AssertionError(f"{name} wide={wide}: cache {got}, "
                                         "expected a miss, then a hit")
                if not torch.equal(engs[0].table, engs[1].table):
                    raise AssertionError(f"{name} wide={wide}: the cached "
                                         "table differs")
                for a, b in zip(*(e.seed_reads(codes, rlens) for e in engs)):
                    if not (a == b).all():
                        raise AssertionError(f"{name} wide={wide}: the seed "
                                             "scan on the cached table "
                                             "differs")
                tag = f"{name} {'wide' if wide else 'narrow'}"
                res[tag] = {"miss_s": engs[0].setup_s,
                            "hit_s": engs[1].setup_s}
                log(f"  {tag}: set-up miss {fmt_setup(engs[0])} (build and "
                    f"save), hit {fmt_setup(engs[1])} (memmap and upload); "
                    f"tables and {len(rlens)} reads' seeds equal ({CARD})")
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
    """The gap DP (K7): pairs recorded from the port's Python pipeline on
    the card's engine (output equal to the same pipeline on the CPU
    path's), kernel vs plain planes, nw_align_batch vs the host C++ DP,
    and times."""
    import numpy as np

    from dart_tpu_torch.aligner import run
    from dart_tpu_torch.cli import parse_args
    from dart_tpu_torch.ops import nw_torch
    from dart_tpu_torch.ops.nw_numpy import nw_align
    from dart_tpu_torch.ops.nw_plain import MAX_LEN, nw_plain

    out = os.path.join(WORK, "nw")
    os.makedirs(out, exist_ok=True)
    head = head_fastq(fq, n_reads, out)
    recorded = {}
    for who in ("port", "cpu"):
        cfg = parse_args(["-i", prefix, "-f", head, "-o",
                          os.path.join(out, f"{who}.sam"), "-j",
                          os.path.join(out, f"{who}.tab"), "-silent",
                          "--no-native"])
        with nw_torch.recording_host_dp() as rec, \
                contextlib.redirect_stdout(io.StringIO()):
            run(idx, cfg, "cpu" if who == "cpu" else device)
        recorded[who] = rec
    require_same(out, "port", "cpu", f"Python pipeline, first {n_reads} "
                 "reads")
    if recorded["port"] != recorded["cpu"]:
        raise AssertionError("the two engines' pipelines sent other DPs")
    pairs = [p for p in recorded["port"] if max(map(len, p)) <= MAX_LEN]
    if not pairs:
        raise AssertionError("the Python pipeline sent no gap DP")
    biggest = max(max(map(len, p)) for p in pairs)
    log(f"  first {n_reads} reads through the port's Python pipeline on the "
        f"card's engine: SAM and junction table equal to the CPU path's; "
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
        if not key:  # its bound: the inputs in, the planes out, once each
            res.update(bytes_bound(sum(x.numel() * x.element_size()
                                       for x in (c1, c2, mn, want))))
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


def toy_walks(toy, L: int = 64):
    """A task of L bases from every toy genome position, the genome's end
    as invalid tails: (chars, valid)."""
    import numpy as np

    G = toy.genome_size
    padded = np.concatenate([toy.ref_codes[:G], np.full(L, 4, np.uint8)])
    chars = np.lib.stride_tricks.sliding_window_view(padded, L)[:G].copy()
    return chars, np.arange(L)[None, :] < (G - np.arange(G))[:, None]


def timed_walks(fq: str, seed: int, n: int = N_TIMED):
    """Phase 8's timed set: n tasks of 128 bases cut from the first n
    reads of ``fq`` (``walk_tasks``, from ``seed``)."""
    import numpy as np

    codes, rlens = read_fastq(fq, n)
    return walk_tasks(codes, rlens, np.random.default_rng(seed), 128)


def walk_shapes(toy, indexes: dict, seed: int) -> dict:
    """The task sets K8's paths send, {name: (index, chars, valid)}: for
    each of ``indexes`` ({name: (index, reads)}) phase 8's 65,536 tasks
    of 128 bases (``timed_walks``); the seeding path's tasks, every start
    of the first N_WALK_READS reads of the first index
    (``seeding.all_walk_tasks``, 409,600 of 100 bases); ``entry()``'s
    batch (256 x 96, toy index); a 64-base task from every toy genome
    position."""
    import numpy as np

    from dart_tpu_torch.entry import example_batch
    from dart_tpu_torch.pipeline.seeding import all_walk_tasks

    out = {f"{what} {N_TIMED} x 128": (idx, *timed_walks(fq, seed))
           for what, (idx, fq) in indexes.items()}
    what, (idx, fq) = next(iter(indexes.items()))
    codes, rlens = read_fastq(fq, N_WALK_READS)
    chars, valid = all_walk_tasks(codes, rlens)
    out[f"{what} seeding, {N_WALK_READS} reads"] = (idx, chars, valid)
    out["toy entry()"] = (toy, *example_batch(toy))
    out["toy every position"] = (toy, *toy_walks(toy))
    for name, (_, chars, _) in out.items():
        log(f"  walk tasks {name}: {chars.shape[0]} x {chars.shape[1]}")
    return out


def walk_call(lib, eng, c, v):
    """One MEM-walk launch of ``lib``'s C entry for ``eng``'s table
    access, on the tasks (c, v), as ``FMIndexTorch.mem_walk_rows`` makes
    it (the C interface is the same in every version): (lens, x0, x2)."""
    import torch

    W, L = c.shape
    out = [torch.empty(W, dtype=torch.int32, device=eng.device)
           for _ in range(3)]
    fn = getattr(lib, f"dart_fm_mem_walks{eng._sfx}")
    rc = fn(*eng._tab, eng._params_ptr(), c.data_ptr(), v.data_ptr(), W, L,
            *(o.data_ptr() for o in out), eng._stream())
    if rc:
        raise RuntimeError(f"MEM walk launch failed: CUDA error {rc}")
    return out


WALK_INPLACE_LC = 1536  # past the kernel's staging budget (1,520 bases)


def in_place(c, v):
    """The tasks padded with invalid columns to WALK_INPLACE_LC: the
    same walks, which the kernel reads in place."""
    import torch

    W, L = c.shape
    cp = torch.full((W, WALK_INPLACE_LC), 4, dtype=torch.uint8,
                    device=c.device)
    vp = torch.zeros((W, WALK_INPLACE_LC), dtype=torch.bool, device=c.device)
    cp[:, :L] = c
    vp[:, :L] = v
    return cp, vp


def check_walk_shapes(shapes: dict, device: str) -> int:
    """This tree's K8 held equal to the plain version at every task set
    of ``shapes``, on both branches (staged; read in place, the tasks
    padded past the staging budget), on one table and at index=2 and 3.
    Returns the largest difference (0)."""
    import torch

    from dart_tpu_torch.ops.fm_torch import FMIndexTorch

    err = 0
    for what, (idx, chars, valid) in shapes.items():
        c = torch.from_numpy(chars).to(device)
        v = torch.from_numpy(valid).to(device)
        cp, vp = in_place(c, v)
        want = FMIndexTorch(idx, device).plain_mem_walks(c, v)
        for shards in (1, 2, 3):
            eng = (FMIndexTorch(idx, device) if shards == 1
                   else sharded(idx, device, shards))
            for branch, args in (("staged", (c, v)), ("in place", (cp, vp))):
                for name, g, w in zip(("lens", "x0", "x2"),
                                      eng.mem_walk_rows(*args), want):
                    err = max(err, check_equal(
                        f"mem_walks {name} ({what}, {branch}, "
                        f"{shards} shard(s))", g, w))
        del cp, vp
        log(f"  mem_walks == plain on {what}: staged and in place, flat "
            "and index=2, 3")
    return err


def phase_mem_walks(toy, big, ds, device: str, n_timed: int,
                    n_reads: int, seed: int) -> dict:
    """The MEM walk (K8): kernel vs plain on the toy and the 8 Mbp index,
    seeding from walks vs the seed scan, the entry step; then times at
    the task sets of ``walk_shapes`` on the toy and 8 Mbp indexes."""
    import numpy as np
    import torch

    from dart_tpu_torch.entry import entry
    from dart_tpu_torch.ops.fm_torch import FMIndexTorch
    from dart_tpu_torch.pipeline.seeding import (_expand_occurrences,
                                                 seed_reads_from_all_walks)

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
    chars, valid = toy_walks(toy)
    G, L = chars.shape
    lens = hold(toy_eng, chars, valid, "toy index")[2]
    log(f"  mem_walks kernel == plain, a task from each of the {G} toy "
        f"genome positions ({int((lens == L).sum())} walks of all {L} bases)")

    eng = FMIndexTorch(big, device)
    chars, valid = timed_walks(ds["fq"][0], seed, n_timed)
    c, v, lens = hold(eng, chars, valid, "8 Mbp index")
    log(f"  mem_walks kernel == plain on {len(chars)} tasks of 128 bases "
        f"of the 8 Mbp set (mean length {float(lens.float().mean()):.1f}, "
        f"{int((lens == 0).sum())} never started)")

    # the seeding path of engines without the automaton, on a fresh
    # engine: its counts start at 0 here
    walker = FMIndexTorch(big, device)
    rc, rl = read_fastq(ds["fq"][0], n_reads)
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
    res["launches_by_path"] = {"seeding": seed_launches,
                               "entry": entry_launches["mem_walks"]}
    if device == "cuda":
        if not (seed_launches and entry_launches["mem_walks"]
                and entry_launches["locate"]):
            raise AssertionError("a MEM-walk path launched no kernel")
        res["ms"] = time_ms(lambda: eng.mem_walk_rows(c, v), 20)
        _, res["plain_ms"] = timed_once(lambda: eng.plain_mem_walks(c, v))
        res.update(walks_bound(eng, c, v))
        log(f"  mem_walks on {len(chars)} x 128 tasks of the 8 Mbp set: "
            f"kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.3f} ms")
        cp, vp = in_place(c, v)
        res["ms_in_place"] = time_ms(lambda: eng.mem_walk_rows(cp, vp), 20)
        log(f"  mem_walks on the same tasks read in place (padded to "
            f"{WALK_INPLACE_LC} columns): {res['ms_in_place']:.4f} ms")
        del cp, vp
        res["ms_by_shape"] = {}
        shapes = walk_shapes(toy, {"8 Mbp": (big, ds["fq"][0])}, seed)
        for what, (idx, chars, valid) in shapes.items():
            e = FMIndexTorch(idx, device)
            c, v = (torch.from_numpy(a).to(device) for a in (chars, valid))
            res["ms_by_shape"][what] = ms = time_ms(
                lambda: e.mem_walk_rows(c, v), 20)
            log(f"  mem_walks on {what} ({c.shape[0]} x {c.shape[1]}): "
                f"kernel {ms:.4f} ms")
    return res


def walks_bound(eng, chars, valid) -> dict:
    """K8's bound on these tasks: chars and valid in, lens, x0 and x2
    out, and the table rows the walks read, once each."""
    W = chars.shape[0]
    out = W * (4 + 2 * (8 if eng.wide else 4))
    return bytes_bound(chars.numel() + valid.numel() + out + touched_bytes(
        eng, lambda v: v.plain_mem_walks(chars, valid)))


def boundary_reads(idx, n_shards: int, wide: bool):
    """Exact 100-base reads across the text positions where a boundary
    of n_shards range shards splits the genome rows of the table: their
    compare windows read genome words from both sides of it."""
    import numpy as np

    from dart_tpu_torch.ops.layout import tables_from_index

    tabs = tables_from_index(idx, wide=wide, index_shards=n_shards)
    rows = tabs["table"].shape[0] // n_shards
    codes = []
    for s in range(1, n_shards):
        if tabs["ref_off"] <= s * rows < tabs["sad_off"]:
            g = (s * rows - tabs["ref_off"]) * (256 if wide else 128)
            for back in (40, 57, 90):
                lo = min(max(g - back, 0), idx.seq_len - 100)
                codes.append(idx.ref_codes[lo:lo + 100])
    return np.array(codes, dtype=np.uint8).reshape(-1, 100)


def sharded(idx, device: str, n: int, **kw):
    """An engine whose table is range-sharded over n slots of the card,
    each a separate allocation."""
    from dart_tpu_torch.ops.fm_torch import FMIndexTorch

    return FMIndexTorch(idx, device, shard_devices=[device] * n, **kw)


def phase_mesh_kernels(toy, big, ds, device: str, seed: int) -> dict:
    """Each Sharded kernel against its plain version over the same
    ShardedTable, exactly, and against the Flat kernel: the locates on
    every toy row at index 2, 3 and 7 (narrow) / 4 (wide), whose
    boundaries fall in the Occ, genome and sample rows; the K-mer table
    builds whole and the seed scans with it on 4,096 reads of the 8 Mbp
    set at index=2 and on reads across the toy table's genome
    boundaries; the MEM walk on a task from every toy genome position.
    Then each timed with its plain version at the main path's shapes."""
    import numpy as np
    import torch

    from dart_tpu_torch.ops.fm_torch import FMIndexTorch

    rng = np.random.default_rng(seed)
    res = {}

    def note(name, err):
        res.setdefault(name, {"max_abs_err": 0})
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)

    for wide in (False, True):
        sfx = "_wide" if wide else ""
        dt = torch.int64 if wide else torch.int32
        rows = torch.arange(toy.seq_len, dtype=dt, device=device)
        want = FMIndexTorch(toy, device, wide=wide).locate_rows(rows)
        for n in (2, 3, 4 if wide else 7):
            eng = sharded(toy, device, n, wide=wide)
            got = eng.locate_rows(rows)
            note(f"locate{sfx}_sharded", check_equal(
                f"locate{sfx}_sharded (toy, index={n})", got,
                eng.plain_locate(rows)))
            check_equal(f"locate{sfx}_sharded vs flat (toy, index={n})", got,
                        want)
        log(f"  locate{sfx}_sharded == plain == flat on every toy row at "
            f"index=2, 3, {4 if wide else 7}")

        codes = np.concatenate([boundary_reads(toy, n, wide)
                                for n in (2, 3, 4 if wide else 7)])
        t, words, S = pack(codes, np.full(len(codes), 100, np.int32), device)
        flat = FMIndexTorch(toy, device, lut_k=LUT_K, wide=wide)
        for n in (2, 3):
            eng = sharded(toy, device, n, lut_k=LUT_K, wide=wide)
            note(f"lut_build{sfx}_sharded", check_equal(
                f"lut_build{sfx}_sharded (toy, index={n})", eng.lut,
                eng.plain_build_lut()))
            got = eng.seed_scan(t, words, S)
            note(f"seed_scan{sfx}_sharded", check_equal(
                f"seed_scan{sfx}_sharded (toy boundaries, index={n})", got,
                eng.plain_seed_scan(t, words, S)))
            check_equal(f"seed_scan{sfx}_sharded vs flat (toy)", got,
                        flat.seed_scan(t, words, S))
        log(f"  seed_scan{sfx}_sharded == plain == flat on {len(codes)} reads "
            "across the toy table's genome-row boundaries, K-mer table "
            "built through the sharded access == plain, index=2 and 3")

    chars, valid = (torch.from_numpy(a).to(device) for a in toy_walks(toy))
    G = chars.shape[0]
    eng = sharded(toy, device, 2)
    want = FMIndexTorch(toy, device).mem_walk_rows(chars, valid)
    for name, g, p, f in zip(("lens", "x0", "x2"),
                             eng.mem_walk_rows(chars, valid),
                             eng.plain_mem_walks(chars, valid), want):
        note("mem_walks_sharded", check_equal(
            f"mem_walks_sharded {name} (toy)", g, p))
        check_equal(f"mem_walks_sharded {name} vs flat (toy)", g, f)
    log(f"  mem_walks_sharded == plain == flat, a task from each of the {G} "
        "toy genome positions, index=2")

    engs = {w: sharded(big, device, 2, lut_k=LUT_K, wide=w)
            for w in (False, True)}
    codes, rlens = read_fastq(ds["fq"][0], MAIN_R)
    sc, sl = codes[:4096].copy(), rlens[:4096].copy()
    mm = rng.random(sc.shape) < 0.02
    sc = np.where(mm, (sc + rng.integers(1, 4, sc.shape)) % 4, sc)
    sc[rng.random(len(sc)) < 0.1, 50] = 4
    t, words, S = pack(sc.astype(np.uint8), sl, device)
    for wide, eng in engs.items():
        sfx = "_wide" if wide else ""
        note(f"lut_build{sfx}_sharded", check_equal(
            f"lut_build{sfx}_sharded (8 Mbp, index=2)", eng.lut,
            eng.plain_build_lut()))
        got = eng.seed_scan(t, words, S)
        note(f"seed_scan{sfx}_sharded", check_equal(
            f"seed_scan{sfx}_sharded (8 Mbp, index=2)", got,
            eng.plain_seed_scan(t, words, S)))
    log(f"  8 Mbp at index=2: lut_build_sharded and lut_build_wide_sharded "
        f"== plain (whole K={LUT_K} tables), seed_scan_sharded and "
        f"seed_scan_wide_sharded == plain on {len(sc)} reads")
    err = check_repeats(device, shards=2)
    note("seed_scan_sharded", err)
    note("seed_scan_wide_sharded", err)

    if device != "cuda":
        return res
    times = main_shape_times(engs, codes, rlens, rng, device,
                             "8 Mbp, index=2")
    for k, v in times.items():
        note(k + "_sharded", v.pop("max_abs_err"))
        v.pop("ms_without_lut", None)
        v.pop("bound_ms_without_lut", None)
        res[k + "_sharded"].update(v)
    chars, valid = walk_tasks(codes, rlens, rng, 128)
    c, v = (torch.from_numpy(a).to(device) for a in (chars, valid))
    eng = engs[False]
    want, plain_ms = timed_once(lambda: eng.plain_mem_walks(c, v))
    for g, w in zip(eng.mem_walk_rows(c, v), want):
        note("mem_walks_sharded", check_equal("mem_walks_sharded (8 Mbp)",
                                              g, w))
    res["mem_walks_sharded"].update(
        ms=time_ms(lambda: eng.mem_walk_rows(c, v), 20), plain_ms=plain_ms,
        **walks_bound(eng, c, v))
    log(f"  mem_walks_sharded on {len(chars)} x 128 tasks of the 8 Mbp set: "
        f"kernel {res['mem_walks_sharded']['ms']:.4f} ms, plain "
        f"{plain_ms:.3f} ms")
    return res


def phase_mesh(toy, big, ds, device: str, seed: int) -> dict:
    """The Sharded kernels against their plain versions, then the mesh
    path (``mesh_path``)."""
    return {"kernels": phase_mesh_kernels(toy, big, ds, device, seed),
            "runs": mesh_path(big, ds, device)}


def mesh_path(big, ds, device: str) -> dict:
    """The mesh path: the nine goldens through ``dart-tpu-torch --mesh
    data=2,index=2``, then the 8mbp_se set at ``--mesh data=2`` and
    ``data=2,index=2``, narrow and wide, each byte-equal to phase 4's
    single-engine output."""
    prefix = os.path.join(GOLD, "index", "toy")
    out = os.path.join(WORK, "mesh")
    os.makedirs(out, exist_ok=True)
    for name, flags in GOLDEN.items():
        flags = [os.path.join(DATA, f) if f.endswith((".fa", ".fq", ".gz"))
                 else f for f in flags]
        sam = os.path.join(out, f"{name}.sam")
        tab = os.path.join(out, f"{name}.junctions.tab")
        run_cli(["-i", prefix, *flags, "-o", sam, "-j", tab, "-silent",
                 "--device", device, "--mesh", "data=2,index=2"])
        for got, gold in ((sam, f"{name}.sam"),
                          (tab, f"{name}.junctions.tab")):
            if not same_bytes(got, os.path.join(GOLD, gold)):
                raise AssertionError(f"{name} (--mesh data=2,index=2): "
                                     f"{gold} differs from golden")
    log("  the nine goldens through dart-tpu-torch --mesh data=2,index=2: "
        "SAM and junctions.tab byte-equal")
    single = os.path.join(WORK, "scale")
    res = {}
    for mesh in ("data=2", "data=2,index=2"):
        for wide in (False, True):
            tag = f"{mesh.replace('=', '').replace(',', '_')}" + \
                ("_wide" if wide else "")
            res[tag] = align(big, ds, out, tag, device, wide, mesh=mesh)
            for ext in ("sam", "tab"):
                if not same_bytes(os.path.join(out, f"{tag}.{ext}"),
                                  os.path.join(single, f"narrow.{ext}")):
                    raise AssertionError(f"--mesh {mesh}: {tag}.{ext} "
                                         "differs from the single engine's")
    log(f"  all {res['data2']['reads']} reads at --mesh data=2 and "
        "data=2,index=2, narrow and wide: SAM and junction table byte-equal "
        "to phase 4's single-engine run")
    return res


def phase_dryrun(device: str) -> dict:
    from dart_tpu_torch.entry import dryrun_multichip

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = dryrun_multichip(4, device, work=os.path.join(WORK, "dryrun"))
    for line in buf.getvalue().splitlines():
        if not line.startswith("\t") and line.strip():
            log(f"  {line}")
    launches = res["toy"]["launches"]
    if device == "cuda" and not all(launches.values()):
        raise AssertionError(f"the dry run launched no kernel of {launches}")
    return res


def start_pair(name: str, args, device: str) -> list:
    """Ranks 0 and 1 of ``dart-tpu-torch args --dist-nprocs 2`` on a free
    port, as [(name, rank, process)]."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    return [(name, pid, subprocess.Popen(
        [sys.executable, "-m", "dart_tpu_torch.cli", *args, "--device",
         device, "--dist-coordinator", f"127.0.0.1:{port}", "--dist-nprocs",
         "2", "--dist-pid", str(pid)], cwd=HERE, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
        for pid in range(2)]


def wait_procs(procs, timeout: int = 300) -> None:
    """Wait for every (name, rank, process); raise if one failed. Every
    process still running at the end is killed."""
    try:
        for name, pid, p in procs:
            err = p.communicate(timeout=timeout)[1]
            if p.returncode != 0:
                raise AssertionError(f"{name} rank {pid} -> {p.returncode}:\n"
                                     f"{err[-3000:]}")
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def phase_dist(big, ds, device: str, n_reads: int) -> dict:
    """Two ``dart-tpu-torch --dist-nprocs 2`` processes for each of the
    goldens c3, c6, c7 and the first n_reads reads of 8mbp_se, all pairs
    at once (both ranks of a pair share the card when there is one):
    the merged outputs byte-equal to the goldens and to a one-process
    run."""
    out = os.path.join(WORK, "dist")
    os.makedirs(out, exist_ok=True)
    head = head_fastq(ds["fq"][0], n_reads, out)
    one = ["-i", ds["prefix"], "-f", head, "-o", os.path.join(out, "one.sam"),
           "-j", os.path.join(out, "one.tab"), "-silent"]
    run_cli([*one, "--device", device])
    jobs = {"8mbp_se": (["-i", ds["prefix"], "-f", head],
                        os.path.join(out, "one"))}
    for name in ("c3_spliced", "c6_pe_gz", "c7_pe_inter"):
        flags = [os.path.join(DATA, f) if f.endswith((".fa", ".fq", ".gz"))
                 else f for f in GOLDEN[name]]
        jobs[name] = (["-i", os.path.join(GOLD, "index", "toy"), *flags],
                      os.path.join(GOLD, name))
    procs = []
    t0 = time.perf_counter()
    for name, (args, _) in jobs.items():
        procs += start_pair(name, [
            *args, "-o", os.path.join(out, f"{name}.sam"), "-j",
            os.path.join(out, f"{name}.tab"), "-silent"], device)
    wait_procs(procs)
    wall = time.perf_counter() - t0
    for name, (_, want) in jobs.items():
        for ext, wext in (("sam", "sam"), ("tab", "junctions.tab"
                                           if name != "8mbp_se" else "tab")):
            if not same_bytes(os.path.join(out, f"{name}.{ext}"),
                              f"{want}.{wext}"):
                raise AssertionError(f"--dist-nprocs 2, {name}: the merged "
                                     f"{ext} differs from the one-process "
                                     "output")
    log(f"  {len(procs)} processes ({len(jobs)} pairs, at once) in "
        f"{wall:.1f} s: c3, c6, c7 byte-equal to the goldens and the first "
        f"{n_reads} reads of 8mbp_se to the one-process run")
    return {"wall_s": wall, "pairs": len(jobs)}


def trace_summary(trace_dir: str) -> dict:
    """Kernel time and the device's idle share from the torch.profiler
    trace in trace_dir: kernels summed, and the share of the traced
    window (first to last event) in which no kernel or copy ran."""
    import glob
    import gzip

    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json*"))
    if len(files) != 1:
        raise AssertionError(f"expected one trace in {trace_dir}, found "
                             f"{files}")
    with (gzip.open if files[0].endswith(".gz") else open)(files[0],
                                                           "rb") as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy",
                                                 "gpu_memset")]
    kernels = [e for e in dev if e["cat"] == "kernel"]
    if not kernels:
        raise AssertionError("torch.profiler traced no kernel on the card")
    busy, end = 0.0, None
    for e in sorted(dev, key=lambda e: e["ts"]):
        lo, hi = e["ts"], e["ts"] + e["dur"]
        if end is None or lo > end:
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    start = min(e["ts"] for e in events)
    stop = max(e["ts"] + e["dur"] for e in events)
    by_name: dict = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0) + e["dur"]
    return {"kernel_ms": sum(by_name.values()) / 1e3,
            "window_s": (stop - start) / 1e6,
            "idle_share": 1 - busy / (stop - start),
            "kernels_ms": {k: v / 1e3 for k, v in by_name.items()}}


def kernel_name(name: str) -> str:
    """A traced kernel's template name, without its namespace and
    parameter list."""
    import re

    m = re.search(r"\w+_kernel(<[^(]*>)?", name)
    return m.group(0) if m else name[:60]


def phase_profile(ds, device: str) -> dict:
    """One ``--profile`` run of 8mbp_se: the trace names the seed-scan
    kernel; its kernel time and the device's idle share; the SAM equal
    to phase 4's."""
    import shutil

    out = os.path.join(WORK, "profile")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    trace_dir = os.path.join(out, "trace")
    run_cli(["-i", ds["prefix"], "-f", ds["fq"][0], "-o",
             os.path.join(out, "p.sam"), "-j", os.path.join(out, "p.tab"),
             "-silent", "--device", device, "--profile", trace_dir])
    require_same(out, "p", os.path.join("..", "scale", "narrow"),
                 "--profile run")
    res = trace_summary(trace_dir)
    if not any("seed_scan_kernel" in k for k in res["kernels_ms"]):
        raise AssertionError("the trace names no seed_scan_kernel")
    top = sorted(res["kernels_ms"].items(), key=lambda kv: -kv[1])[:4]
    res["seed_scan_ms"] = sum(v for k, v in res["kernels_ms"].items()
                              if "seed_scan_kernel" in k)
    log(f"  trace of {res['window_s']:.3f} s: kernels {res['kernel_ms']:.3f} "
        f"ms in all (seed scans {res['seed_scan_ms']:.3f} ms), device idle "
        f"{100 * res['idle_share']:.2f}% of the window; "
        + "; ".join(f"{kernel_name(k)} {v:.3f} ms" for k, v in top))
    return res


def ptxas_table(src: str) -> list:
    """``nvcc -Xptxas -v`` of a source: each kernel's demangled name,
    registers, stack frame and spill bytes."""
    import re

    from dart_tpu_torch.ops import build

    rows, cur = [], None
    for line in build.ptxas_report(src).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"name": m.group(1)}
            rows.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                cur.update(stack=int(m.group(1)), spill_st=int(m.group(2)),
                           spill_ld=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["regs"] = int(m.group(1))
    filt = subprocess.run(["c++filt"], input="\n".join(r["name"] for r in rows),
                          capture_output=True, text=True)
    if filt.returncode == 0:
        for r, name in zip(rows, filt.stdout.splitlines()):
            r["name"] = name.replace("(anonymous namespace)::", "")
    return rows


def log_ptxas(rows: list, what: str, only: str = "") -> None:
    for r in rows:
        if only in r["name"]:
            log(f"  ptxas ({what}): {r['name'][:90]}: {r.get('regs')} "
                f"registers, {r.get('stack')} B stack, spills "
                f"{r.get('spill_st')}/{r.get('spill_ld')} B")


def chase_ns(mb: int, device: str, steps: int = 200_000) -> float:
    """The latency in ns of one dependent load in a buffer of mb MiB: one
    thread chases a random cycle over its 32-byte lines (``probe.cu``),
    after one lap (at most 2^21 loads) has warmed the caches."""
    import torch

    from dart_tpu_torch.ops import build

    lines = mb * 2**20 // 32
    g = torch.Generator(device=device)
    g.manual_seed(mb)
    perm = torch.randperm(lines, device=device, generator=g)
    nxt = torch.zeros(lines * 8, dtype=torch.int32, device=device)
    nxt[perm * 8] = (torch.roll(perm, -1) * 8).int()
    out = torch.zeros(1, dtype=torch.int32, device=device)
    lib = build.load()

    def chase(n):
        rc = lib.dart_probe_chase(nxt.data_ptr(), n, int(perm[0]) * 8,
                                  out.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"chase launch failed: CUDA error {rc}")

    chase(min(lines, 1 << 21))
    _, ms = timed_once(lambda: chase(steps))
    return ms * 1e6 / steps


def load_stats(loads) -> dict:
    """Per-read dependent-load counts: mean, p99, max, and the sum over
    warps (32 reads in launch order) of each warp's largest."""
    import torch

    f = loads.double()
    pad = (-loads.numel()) % 32
    warps = torch.cat([loads, loads.new_zeros(pad)]).view(-1, 32)
    return {"mean": float(f.mean()), "p99": float(f.quantile(0.99)),
            "max": int(loads.max()), "argmax": int(loads.argmax()),
            "warp_max_sum": int(warps.max(1).values.sum()),
            "sum": int(loads.sum()), "warps": warps.shape[0]}


def phase_diagnosis(big, ds, device: str, shapes: dict,
                    walks: dict) -> dict:
    """What bounds the seed scan (K1, K4) and the locate (K2, K5): K1's
    time at 16,384, 34,464, 65,536 and 262,144 reads of
    8mbp_se (flat in R: the critical path or the tail sets it; linear:
    throughput); each read's dependent table loads, counted by the plain
    version, at the main path's 65,536 reads, with the K-mer table and
    without (narrow) and with it (wide, whose SA is sampled more
    densely); the latency of one dependent load at 20 MiB (in the L2)
    and 128 MiB (past it); the critical-path floor (the longest read's
    loads times that latency); the locate at the row sets of ``shapes``
    (``locate_diagnosis``); the MEM walk at the task sets of ``walks``
    (``walks_diagnosis``), where this tree's kernel is also held equal to
    the plain version on both branches, flat and sharded
    (``check_walk_shapes``); and ``-Xptxas -v`` of every kernel, which
    fails the phase, at its end, if a seed scan, a locate, a K-mer table
    build or a MEM walk has a stack frame or spills."""
    import numpy as np
    import torch

    from dart_tpu_torch.ops.fm_torch import FMIndexTorch

    res = {"ptxas": ptxas_table(os.path.join(HERE, FM_SOURCE))}
    log_ptxas(res["ptxas"], "this tree")
    local = [r["name"] for r in res["ptxas"]
             if any(k in r["name"] for k in ("seed_scan", "lut_", "locate",
                                             "mem_walks"))
             and (r.get("stack") or r.get("spill_st") or r.get("spill_ld"))]
    res["chase_ns"] = {mb: chase_ns(mb, device) for mb in (20, 128)}
    log(f"  dependent-load latency (pointer chase, one thread): "
        f"{res['chase_ns'][20]:.1f} ns at 20 MiB, "
        f"{res['chase_ns'][128]:.1f} ns at 128 MiB")
    eng = FMIndexTorch(big, device, lut_k=LUT_K)
    codes, rlens = read_fastq(ds["fq"][0], 1 << 18)
    reps = -(-(1 << 18) // len(rlens))
    codes, rlens = np.tile(codes, (reps, 1)), np.tile(rlens, reps)
    res["k1_ms_by_R"] = {}
    for R in (16384, 34464, MAIN_R, 1 << 18):
        t, words, S = pack(codes[:R], rlens[:R], device)
        res["k1_ms_by_R"][R] = ms = time_ms(lambda: eng.seed_scan(
            t, words, S), 5)
        log(f"  K1 (narrow, K={LUT_K}) at R={R}: {ms:.4f} ms, "
            f"{1e6 * ms / R:.3f} ns a read")
    t, words, S = pack(codes[:MAIN_R], rlens[:MAIN_R], device)
    wide = FMIndexTorch(big, device, lut_k=LUT_K, wide=True)
    for tag, e in (("lut", eng), ("no_lut", without_lut(eng)),
                   ("wide_lut", wide)):
        kinds = torch.zeros((MAIN_R, 5), dtype=torch.int64, device=device)
        e.plain_seed_scan(t, words, S, loads=kinds)
        loads = kinds[:, :4].sum(1)
        st = res[f"loads_{tag}"] = load_stats(loads)
        st["by_kind"] = dict(zip(("extend", "locate", "compare", "lut",
                                  "walks"), kinds.sum(0).tolist()))
        st["longest_by_kind"] = kinds[st["argmax"]].tolist()
        floor_us = st["max"] * res["chase_ns"][20] / 1e3
        st["floor_ms"] = floor_us / 1e3
        log(f"  dependent loads a read ({tag}, {MAIN_R} reads): mean "
            f"{st['mean']:.1f}, p99 {st['p99']:.0f}, max {st['max']} (read "
            f"{st['argmax']}); sum of warp maxima {st['warp_max_sum']} over "
            f"{st['warps']} warps (sum of loads {st['sum']}); critical-path "
            f"floor {floor_us:.2f} us; all reads by kind {st['by_kind']}, "
            f"the longest read [extend, locate, compare, lut, walks] "
            f"{st['longest_by_kind']}")
    res["locate"] = locate_diagnosis(shapes, device, res["chase_ns"])
    res["walks"] = walks_diagnosis(walks, device, res["chase_ns"])
    res["walks_err"] = check_walk_shapes(walks, device)
    res["shapes"] = {"locate": shapes, "walks": walks}
    if local:
        raise AssertionError(f"local memory (stack or spills) in {local}")
    return res


def locate_shapes(indexes: dict, runs: dict, seed: int) -> dict:
    """The row sets the locate is timed at: {name: (index, {wide: [the
    rows of each launch]})}. For each index, 65,536 random rows (one
    launch) and the rows each locate launch of its main-path run got
    (phases 4 and 6, narrow and wide); then the repeat runs
    (``copies_set``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shapes = {}
    for what, idx in indexes.items():
        rows = rng.integers(0, idx.seq_len, MAIN_R)
        shapes[f"{what} random"] = (idx, {False: [rows], True: [rows]})
        main = {w: runs[what]["wide" if w else "narrow"]["located"]
                for w in (False, True)}
        if main[False] or main[True]:
            shapes[f"{what} main path"] = (idx, main)
        else:
            log(f"  the {what} main-path runs located no rows")
    idx, rec = copies_set("cuda")
    shapes["repeat runs"] = (idx, {False: rec, True: rec})
    return shapes


def host_ms(fn, reps: int = 20) -> float:
    """Mean host wall time in ms of fn() over reps runs after one
    warm-up; fn must end in a synchronisation."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def locate_diagnosis(shapes: dict, device: str, chase: dict) -> dict:
    """What bounds the locate (K2 narrow, K5 wide) at each row set of
    ``shapes``: each row's LF steps, counted by the plain version (mean,
    p99, max); the critical-path floor of each launch, (its longest walk
    + 1) times one dependent load's latency at the table's size, and at
    the size of its Occ rows alone (the walks read nothing else); its
    bytes bound; the kernel's time (card only, launches queued) against
    the whole host call ``FMIndexTorch.locate`` makes on the main path
    (upload, launch, download, wait); and the distinct Occ rows the
    lanes of a warp read at their first step."""
    import numpy as np
    import torch

    from dart_tpu_torch.ops.fm_torch import FMIndexTorch

    res = {}
    for what, (idx, by_width) in shapes.items():
        for wide, launches in by_width.items():
            eng = FMIndexTorch(idx, device, wide=wide)
            name = "locate_wide" if wide else "locate"
            # the whole table's size, and the Occ rows' alone (the rows a
            # walk reads before its one sample)
            mb = -(-eng.table.numel() * 4 // 2**20)
            occ_mb = -(-eng.ref_off * eng.table.shape[1] * 4 // 2**20)
            for m in (mb, occ_mb):
                if m not in chase:
                    chase[m] = chase_ns(m, device)
            out = []
            for i, rows in enumerate(launches):
                t = torch.from_numpy(rows.astype(
                    np.int64 if wide else np.int32)).to(device)
                steps = torch.zeros(t.numel(), dtype=torch.int64,
                                    device=device)
                check_equal(f"{name} ({what})", eng.locate_rows(t),
                            eng.plain_locate(t, lf_steps=steps))
                st = steps.double()
                kk = rows - (rows > eng.primary)
                occ = kk >> (7 if wide else 6)
                pad = (-len(occ)) % 32
                warps = np.concatenate([occ, np.full(pad, -1)]).reshape(
                    -1, 32)
                first = np.mean([len(set(w[w >= 0])) for w in warps])
                r = {"rows": len(rows), "runs": len(runs_of(rows)),
                     "mean": float(st.mean()),
                     "p99": float(st.quantile(0.99)),
                     "max": int(steps.max()), "table_mib": mb,
                     "chase_ns": chase[mb],
                     "floor_ms": (int(steps.max()) + 1) * chase[mb] / 1e6,
                     "occ_mib": occ_mb,
                     "floor_occ_ms": (int(steps.max()) + 1)
                     * chase[occ_mb] / 1e6,
                     "first_rows_a_warp": float(first),
                     "ms": time_ms(lambda: eng.locate_rows(t), 20),
                     "host_ms": host_ms(lambda: eng.locate(rows)),
                     **bytes_bound(2 * t.numel() * t.element_size()
                                   + touched_bytes(
                                       eng, lambda v: v.plain_locate(t)))}
                out.append(r)
                log(f"  {name}, {what}"
                    + (f" launch {i}" if len(launches) > 1 else "")
                    + f": {r['rows']} rows ({r['runs']} runs), LF steps "
                    f"mean {r['mean']:.2f}, p99 {r['p99']:.0f}, max "
                    f"{r['max']}; floor ({r['max']} + 1) x "
                    f"{chase[mb]:.1f} ns ({mb} MiB) = "
                    f"{1e3 * r['floor_ms']:.2f} us ({chase[occ_mb]:.1f} ns "
                    f"at the Occ rows' {occ_mb} MiB: "
                    f"{1e3 * r['floor_occ_ms']:.2f} us), bytes bound "
                    f"{1e3 * r['bound_ms']:.2f} us; kernel "
                    f"{1e3 * r['ms']:.2f} us, whole host call "
                    f"{1e3 * r['host_ms']:.1f} us; first-step Occ rows a "
                    f"warp {first:.1f}")
            res[f"{name} {what}"] = out
    return res


def walks_diagnosis(shapes: dict, device: str, chase: dict,
                    lib=None) -> dict:
    """What bounds the MEM walk (K8) at each task set of ``shapes``
    (``walk_shapes``): each task's extension steps (a pair of dependent
    Occ-row loads each), counted by the plain version: mean, p99, max,
    and the sum over warps (32 tasks in launch order) of each warp's
    longest against the sum / 32 (what divergence costs); the
    critical-path floor, (the longest walk + 1) times one dependent
    load's latency at the size of the Occ rows (the walks read nothing
    else) and of the whole table; the bytes bound; the kernel's time
    (card only, launches queued) against the whole host call
    ``FMIndexTorch.mem_walks`` makes (upload, launch, download); and,
    from 65,536 tasks on, the kernel on the first 1/16 and 1/4 of them
    (flat in W: the longest walks' chains set the time; linear: the
    steps' throughput). The kernel is ``lib``'s (``walk_call``; the
    parent's, for a diagnosis before a redesign), by default this
    tree's."""
    import numpy as np
    import torch

    from dart_tpu_torch.ops.fm_torch import FMIndexTorch

    res = {}
    for what, (idx, chars, valid) in shapes.items():
        eng = FMIndexTorch(idx, device)
        mb = -(-eng.table.numel() * 4 // 2**20)
        occ_mb = -(-eng.ref_off * eng.table.shape[1] * 4 // 2**20)
        for m in (mb, occ_mb):
            if m not in chase:
                chase[m] = chase_ns(m, device)

        def kern(c, v):
            return (eng.mem_walk_rows(c, v) if lib is None
                    else walk_call(lib, eng, c, v))

        def host_call():  # FMIndexTorch.mem_walks, through ``kern``
            c = torch.from_numpy(np.ascontiguousarray(chars)).to(device)
            v = torch.from_numpy(np.ascontiguousarray(valid)).to(device)
            return [t.cpu().numpy().astype(np.int64) for t in kern(c, v)]

        c, v = (torch.from_numpy(a).to(device) for a in (chars, valid))
        steps = torch.zeros(c.shape[0], dtype=torch.int64, device=device)
        want = eng.plain_mem_walks(c, v, steps=steps)
        for name, g, w in zip(("lens", "x0", "x2"), kern(c, v), want):
            check_equal(f"mem_walks {name} ({what})", g, w)
        st = load_stats(steps)
        top = st["max"] + 1
        r = {"tasks": c.shape[0], "L": c.shape[1], **st,
             "divergence": st["warp_max_sum"] / (st["sum"] / 32),
             "table_mib": mb, "occ_mib": occ_mb,
             "floor_ms": top * chase[occ_mb] / 1e6,
             "floor_table_ms": top * chase[mb] / 1e6,
             "ms": time_ms(lambda: kern(c, v), 20),
             "host_ms": host_ms(host_call),
             **walks_bound(eng, c, v)}
        if c.shape[0] >= 65536:
            r["ms_by_W"] = {n: time_ms(lambda: kern(c[:n], v[:n]), 20)
                            for n in (c.shape[0] // 16, c.shape[0] // 4)}
            r["ms_by_W"][c.shape[0]] = r["ms"]
        res[what] = r
        log(f"  mem_walks, {what}: {r['tasks']} x {r['L']} tasks, steps "
            f"mean {r['mean']:.2f}, p99 {r['p99']:.0f}, max {r['max']}; "
            f"sum of warp maxima {r['warp_max_sum']} against sum / 32 "
            f"{r['sum'] / 32:.0f} (x{r['divergence']:.2f}); floor "
            f"({r['max']} + 1) x {chase[occ_mb]:.1f} ns (the Occ rows' "
            f"{occ_mb} MiB) = {1e3 * r['floor_ms']:.2f} us "
            f"({1e3 * r['floor_table_ms']:.2f} us at the table's {mb} "
            f"MiB), bytes bound {1e3 * r['bound_ms']:.2f} us; kernel "
            f"{1e3 * r['ms']:.2f} us, whole host call "
            f"{1e3 * r['host_ms']:.1f} us"
            + "".join(f"; {n} tasks {1e3 * ms:.2f} us"
                      for n, ms in r.get("ms_by_W", {}).items()))
    return res


def fm_call(lib, eng, t, words: int, S: int, lut) -> "torch.Tensor":
    """One seed-scan launch of ``lib``'s C entry for ``eng``'s layout and
    table access, on ``eng``'s tables, as ``FMIndexTorch.seed_scan``
    makes it (the C interface is the same in every version)."""
    import torch

    out = torch.empty((t.shape[0], 1 + 4 * S), dtype=eng.idx_dtype,
                      device=eng.device)
    fn = getattr(lib, f"dart_fm_seed_scan{eng._sfx}")
    rc = fn(*eng._tab, eng._params_ptr(),
            lut.data_ptr() if lut is not None else None,
            eng.lut_k if lut is not None else 0, t.data_ptr(), t.shape[0],
            words, S, out.data_ptr(), eng._stream())
    if rc:
        raise RuntimeError(f"seed scan launch failed: CUDA error {rc}")
    return out


def lut_call(lib, eng, out):
    """One K-mer table build of ``lib``'s C entry for ``eng``'s layout
    and table access, K = ``eng.lut_k``, into ``out``, as
    ``FMIndexTorch.build_lut`` makes it (the C interface is the same in
    every version)."""
    fn = getattr(lib, f"dart_fm_lut_build{eng._sfx}")
    rc = fn(*eng._tab, eng._params_ptr(), eng.lut_k, out.data_ptr(),
            eng._stream())
    if rc:
        raise RuntimeError(f"LUT build launch failed: CUDA error {rc}")
    return out


def loc_call(lib, eng, t, out):
    """One locate launch of ``lib``'s C entry for ``eng``'s layout and
    table access, on the rows ``t``, into ``out``, as
    ``FMIndexTorch.locate_rows`` makes it (the C interface is the same
    in every version)."""
    fn = getattr(lib, f"dart_fm_locate{eng._sfx}")
    rc = fn(*eng._tab, eng._params_ptr(), t.data_ptr(), t.numel(),
            out.data_ptr(), eng._stream())
    if rc:
        raise RuntimeError(f"locate launch failed: CUDA error {rc}")
    return out


def redesign_locate(old, shapes: dict, device: str) -> dict:
    """The parent's locate against this tree's, in turns, at every row
    set of ``shapes`` (``locate_shapes``), narrow and wide, on one table
    and on two shards of it (index=2); both held equal to the plain
    version."""
    import numpy as np
    import torch

    from dart_tpu_torch.ops.fm_torch import FMIndexTorch

    times = {}
    for what, (idx, by_width) in shapes.items():
        for wide, launches in by_width.items():
            for shards in (1, 2):
                eng = (FMIndexTorch(idx, device, wide=wide) if shards == 1
                       else sharded(idx, device, shards, wide=wide))
                for i, rows in enumerate(launches):
                    t = torch.from_numpy(rows.astype(
                        np.int64 if wide else np.int32)).to(device)
                    tag = (f"{what} locate{'_wide' if wide else ''}"
                           + ("" if shards == 1 else f", index={shards}")
                           + (f", launch {i}" if len(launches) > 1 else "")
                           + f" ({len(rows)} rows)")
                    want = eng.plain_locate(t)
                    out = torch.empty_like(t)
                    check_equal(f"old {tag}", loc_call(old, eng, t, out),
                                want)
                    check_equal(f"new {tag}", eng.locate_rows(t), want)
                    times[tag] = turns(
                        tag, lambda: loc_call(old, eng, t, out),
                        lambda: eng.locate_rows(t))
                del eng
    return times


def redesign_lut(old, indexes: dict, device: str) -> dict:
    """The parent's K-mer table build against this tree's at K = 11, in
    turns, on each index, narrow and wide, on one table and on two
    shards of it (index=2); both held equal to the plain version."""
    import torch

    from dart_tpu_torch.ops.fm_torch import FMIndexTorch

    times = {}
    for what, (idx, _) in indexes.items():
        for wide in (False, True):
            for shards in (1, 2):
                eng = (FMIndexTorch(idx, device, lut_k=LUT_K, wide=wide)
                       if shards == 1 else sharded(idx, device, shards,
                                                   lut_k=LUT_K, wide=wide))
                tag = (f"{what} lut_build{'_wide' if wide else ''}"
                       + ("" if shards == 1 else f", index={shards}"))
                want = eng.plain_build_lut()
                out = torch.empty_like(want)
                check_equal(f"old {tag}", lut_call(old, eng, out), want)
                check_equal(f"new {tag}", eng.build_lut(), want)
                times[tag] = turns(tag, lambda: lut_call(old, eng, out),
                                   eng.build_lut)
                del eng, want, out
    return times


TWO_ROW_LOADS = """  load_row(a, rk, vk);
  load_row(a, rl, vl);
"""


def one_load_variant():
    """This tree's kernels built with K8's step loading one Occ row where
    both ends of the interval fall in it (a compare, then the second
    load or a copy): the alternative to its two loads, timed beside it in
    turns (``redesign_walks``)."""
    import ctypes

    from dart_tpu_torch.ops import build

    src = open(os.path.join(HERE, FM_SOURCE)).read()
    if src.count(TWO_ROW_LOADS) != 1:
        raise AssertionError("K8's row loads are not where expected")
    d = os.path.join(WORK, "one_load")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "fm_kernels.cu"), "w") as f:
        f.write(src.replace(TWO_ROW_LOADS, """  load_row(a, rk, vk);
  if (rl != rk) {
    load_row(a, rl, vl);
  } else {
    vl[0] = vk[0];
    vl[1] = vk[1];
  }
"""))
    return build.typed(ctypes.CDLL(build.build(d, ("fm_kernels.cu",))[0]))


def redesign_walks(old, shapes: dict, device: str) -> dict:
    """The parent's MEM walk against this tree's, in turns, at every task
    set of ``shapes`` (``walk_shapes``), on one table and on two shards
    of it (index=2); both held equal to the plain version. On one table,
    also ``one_load_variant`` against this tree's."""
    import torch

    from dart_tpu_torch.ops.fm_torch import FMIndexTorch

    one = one_load_variant()
    times = {}
    for what, (idx, chars, valid) in shapes.items():
        c, v = (torch.from_numpy(a).to(device) for a in (chars, valid))
        for shards in (1, 2):
            eng = (FMIndexTorch(idx, device) if shards == 1
                   else sharded(idx, device, shards))
            tag = (f"{what} mem_walks"
                   + ("" if shards == 1 else f", index={shards}")
                   + f" ({c.shape[0]} x {c.shape[1]})")
            want = eng.plain_mem_walks(c, v)
            for g, o, w in zip(eng.mem_walk_rows(c, v),
                               walk_call(old, eng, c, v), want):
                check_equal(f"new {tag}", g, w)
                check_equal(f"old {tag}", o, w)
            times[tag] = turns(tag, lambda: walk_call(old, eng, c, v),
                               lambda: eng.mem_walk_rows(c, v))
            if shards == 1:
                for g, w in zip(walk_call(one, eng, c, v), want):
                    check_equal(f"one load {tag}", g, w)
                times[f"{tag}, one load"] = turns(
                    f"{tag}: old = one load", lambda: walk_call(
                        one, eng, c, v), lambda: eng.mem_walk_rows(c, v))
            del eng
    return times


def phase_redesign(indexes: dict, shapes: dict, device: str) -> dict:
    """The parent's kernels (``chip_smoke_work/parent/fm_kernels.cu``,
    put there for a measurement call) against this tree's, in one call
    on one card: its ``-Xptxas -v``, then at 8 and 50 Mbp the seed
    scans, narrow and wide, with and without the K-mer table, both held
    equal to the plain version's output and timed in turns (old, new,
    new, old) with the table warm, and both at 16,384 and 262,144 reads
    of the first index (narrow, K = 11), which shows whether the floor
    under the time moved; then the K-mer table builds
    (``redesign_lut``), the locates (``redesign_locate``) and the MEM
    walks (``redesign_walks``). Skipped without the parent's source."""
    import ctypes

    import numpy as np

    from dart_tpu_torch.ops import build
    from dart_tpu_torch.ops.fm_torch import FMIndexTorch

    parent = os.path.join(WORK, "parent")
    if not os.path.exists(os.path.join(parent, "fm_kernels.cu")):
        log("  skipped: no parent fm_kernels.cu under chip_smoke_work/parent")
        return {"skipped": True}
    old = build.typed(ctypes.CDLL(build.build(parent, ("fm_kernels.cu",))[0]))
    res = {"ptxas_old": ptxas_table(os.path.join(parent, "fm_kernels.cu")),
           "times": {}}
    for only in ("seed_scan", "lut_", "locate", "mem_walks"):
        log_ptxas(res["ptxas_old"], "parent", only)
    for what, (idx, fq) in indexes.items():
        codes, rlens = read_fastq(fq, MAIN_R)
        t, words, S = pack(codes, rlens, device)
        for wide in (False, True):
            eng = FMIndexTorch(idx, device, lut_k=LUT_K, wide=wide)
            for lut in (eng.lut, None):
                view = eng if lut is not None else without_lut(eng)
                tag = f"{what} {'wide' if wide else 'narrow'} " + \
                    ("K=11" if lut is not None else "no LUT")
                want = view.plain_seed_scan(t, words, S)
                check_equal(f"old seed scan ({tag})",
                            fm_call(old, eng, t, words, S, lut), want)
                check_equal(f"new seed scan ({tag})",
                            view.seed_scan(t, words, S), want)
                res["times"][tag] = turns(
                    tag, lambda: fm_call(old, eng, t, words, S, lut),
                    lambda: view.seed_scan(t, words, S))
            del eng
    what, (idx, fq) = next(iter(indexes.items()))
    eng = FMIndexTorch(idx, device, lut_k=LUT_K)
    codes, rlens = read_fastq(fq, MAIN_R)
    for R in (16384, 1 << 18):
        reps = -(-R // len(rlens))
        t, words, S = pack(np.tile(codes, (reps, 1))[:R],
                           np.tile(rlens, reps)[:R], device)
        check_equal(f"new seed scan ({what}, R={R}) vs old",
                    eng.seed_scan(t, words, S),
                    fm_call(old, eng, t, words, S, eng.lut))
        res["times"][f"{what} narrow K=11 R={R}"] = turns(
            f"{what} narrow K=11, R={R}",
            lambda: fm_call(old, eng, t, words, S, eng.lut),
            lambda: eng.seed_scan(t, words, S))
    del eng
    res["lut_times"] = redesign_lut(old, indexes, device)
    res["locate_times"] = redesign_locate(old, shapes["locate"], device)
    res["walk_times"] = redesign_walks(old, shapes["walks"], device)
    return res


def turns(tag: str, old, new) -> dict:
    """old and new timed in turns (old, new, new, old); logs and returns
    both pairs of times."""
    import numpy as np

    ms = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        ms[which].append(time_ms(old if which == "old" else new, 10))
    o, n = ms["old"], ms["new"]
    log(f"  {tag}: old {o[0]:.4f} / {o[1]:.4f} ms, new {n[0]:.4f} / "
        f"{n[1]:.4f} ms (x{np.mean(o) / np.mean(n):.2f})")
    return ms


def phase_cards(toy, big, ds, n_dist: int) -> dict:
    """``--cards``, on two cards or more: the Sharded kernels with their
    shards on cuda:0, cuda:1, ... read peer to peer, against their plain
    versions and the Flat kernels; the 8 Mbp seed scan timed flat, with
    two shards on one card and with two shards on two cards; 8mbp_se at
    ``--mesh index=2`` (``data=2,index=2`` from four cards) and
    ``data=<cards>`` byte-equal to one engine's run; the two-process runs
    of phase 11 (the ranks on two cards) and the dry run over four
    slots."""
    import numpy as np
    import torch

    from dart_tpu_torch.ops.fm_torch import FMIndexTorch

    count = torch.cuda.device_count()
    if count < 2:
        raise AssertionError(f"--cards needs two cards or more, found {count}")
    cards = [f"cuda:{i}" for i in range(count)]
    res = {"cards": count}
    chars, valid = (torch.from_numpy(a).cuda() for a in toy_walks(toy))
    for wide in (False, True):
        dt = torch.int64 if wide else torch.int32
        rows = torch.arange(toy.seq_len, dtype=dt, device="cuda:0")
        flat = FMIndexTorch(toy, "cuda:0", lut_k=LUT_K, wide=wide)
        for n in sorted({2, min(count, 4)}):
            eng = FMIndexTorch(toy, "cuda:0", lut_k=LUT_K, wide=wide,
                               shard_devices=cards[:n])
            what = f"toy, {n} shards on {n} cards, wide={wide}"
            got = eng.locate_rows(rows)
            check_equal(f"locate ({what})", got, eng.plain_locate(rows))
            check_equal(f"locate vs flat ({what})", got,
                        flat.locate_rows(rows))
            check_equal(f"lut_build ({what})", eng.lut, eng.plain_build_lut())
            check_equal(f"lut_build vs flat ({what})", eng.lut, flat.lut)
            codes = np.concatenate([boundary_reads(toy, m, wide)
                                    for m in (2, 3, 4)])
            t, words, S = pack(codes, np.full(len(codes), 100, np.int32),
                               "cuda:0")
            got = eng.seed_scan(t, words, S)
            check_equal(f"seed_scan ({what})", got,
                        eng.plain_seed_scan(t, words, S))
            check_equal(f"seed_scan vs flat ({what})", got,
                        flat.seed_scan(t, words, S))
            if not wide:
                for g, p, f in zip(eng.mem_walk_rows(chars, valid),
                                   eng.plain_mem_walks(chars, valid),
                                   flat.mem_walk_rows(chars, valid)):
                    check_equal(f"mem_walks ({what})", g, p)
                    check_equal(f"mem_walks vs flat ({what})", g, f)
            log(f"  {what}: locate, lut_build, seed_scan"
                + ("" if wide else ", mem_walks")
                + " == plain == flat, the shards read peer to peer")

    codes, rlens = read_fastq(ds["fq"][0], MAIN_R)
    t, words, S = pack(codes, rlens, "cuda:0")
    want = None
    for what, devs in (("flat", None), ("2 shards on one card",
                                        ["cuda:0"] * 2),
                       ("2 shards on 2 cards", cards[:2])):
        eng = FMIndexTorch(big, "cuda:0", lut_k=LUT_K, shard_devices=devs)
        got = eng.seed_scan(t, words, S)
        if want is None:
            want = got
        check_equal(f"seed_scan 8 Mbp ({what}) vs flat", got, want)
        res[f"seed_scan_ms ({what})"] = ms = time_ms(
            lambda: eng.seed_scan(t, words, S), 5)
        log(f"  seed_scan on the 8 Mbp index, {len(rlens)} reads, {what}: "
            f"{ms:.4f} ms")

    out = os.path.join(WORK, "cards")
    os.makedirs(out, exist_ok=True)
    res["single"] = align(big, ds, out, "single", "cuda", False)
    for mesh in ("data=2,index=2" if count >= 4 else "index=2",
                 f"data={count}"):
        tag = mesh.replace("=", "").replace(",", "_")
        res[tag] = align(big, ds, out, tag, "cuda", False, mesh=mesh)
        require_same(out, tag, "single", f"--mesh {mesh} on {count} cards")
        log(f"  8mbp_se at --mesh {mesh} over {count} cards: SAM and "
            "junction table byte-equal to one engine's run")
    res["dist"] = phase_dist(big, ds, "cuda", n_dist)
    res["dryrun"] = phase_dryrun("cuda")
    return res


def stamp(msg: str) -> None:
    log(f"[{time.strftime('%H:%M:%S')}] {msg}")


def host_room(path: str) -> str:
    """The host's available memory and the free disk under path."""
    import shutil

    with open("/proc/meminfo") as f:
        mem = {ln.split(":")[0]: int(ln.split()[1]) for ln in f}
    return (f"{mem['MemAvailable'] / 2**20:.1f} GiB of "
            f"{mem['MemTotal'] / 2**20:.1f} GiB memory available, "
            f"{shutil.disk_usage(path).free / 2**30:.1f} GiB disk free")


def build_big_index(fa: str, prefix: str) -> dict:
    """The port's builder (native SA-IS) on fa, in a child process whose
    stage lines are relayed here; returns its seconds and peak RSS."""
    import resource

    code = ("import sys; sys.path.insert(0, sys.argv[1]); from "
            "dart_tpu_torch.index import build_index; "
            "build_index(sys.argv[2], sys.argv[3])")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", code, HERE, fa, prefix],
        env=dict(os.environ, DART_TPU_BUILD_LOG="1"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    for line in proc.stdout:
        log(f"    {line.rstrip()}")
    if proc.wait() != 0:
        raise AssertionError(f"the index build failed ({proc.returncode})")
    secs = time.perf_counter() - t0
    rss = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss / 2**20
    return {"seconds": secs, "peak_rss_gib": rss}


def sim_pairs(fa: str, n: int, d: str):
    """n pairs simulated from the genome in fa by ``bench.py``'s paired
    steps (``sim_reads_paired``, 0.5% mismatches, seed SEED + 1)."""
    import random

    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    import bench

    import make_fixtures as mf

    fqs = (os.path.join(d, f"pairs_{n}_1.fq"),
           os.path.join(d, f"pairs_{n}_2.fq"))
    rng = random.Random(bench.SEED + 1)
    r1, r2 = mf.sim_reads_paired(rng, read_genome(fa), n, bench.READ_LEN,
                                 mismatch_rate=0.005)
    for path, reads in zip(fqs, (r1, r2)):
        mf.write_reads_fastq(path, reads)
    return fqs


def big_times(eng, idx) -> dict:
    """The wide kernels timed on this table at phase 2's shapes (MAIN_R
    reads from both strands, 2% of bases changed; MAIN_R random rows; one
    K-mer table), and one dependent load in buffers of 20 MiB, 128 MiB
    and the table's size."""
    import numpy as np
    import torch

    from dart_tpu_torch import crossing

    rng = np.random.default_rng(9)
    codes = crossing.strand_reads(idx, MAIN_R, 100, rng)
    t, words, S = pack(codes, np.full(MAIN_R, 100, np.int32), "cuda")
    rows = torch.from_numpy(rng.integers(1, idx.seq_len, MAIN_R,
                                         dtype=np.int64)).cuda()
    table_mb = int(eng.table.nbytes) >> 20
    return {"seed_scan_wide_ms": time_ms(lambda: eng.seed_scan(t, words, S),
                                         10),
            "locate_wide_ms": time_ms(lambda: eng.locate_rows(rows), 10),
            "lut_build_wide_ms": time_ms(eng.build_lut, 5),
            "chase_ns": {mb: chase_ns(mb, "cuda")
                         for mb in (20, 128, table_mb)}}


def phase_big(gbp: float, device: str = "cuda") -> dict:
    """``--big``: the wide engine across 2^31 text positions on a
    synthetic genome of gbp Gbp (``dart_tpu_torch.crossing``): the
    index built by the port's builder, the layout cache missed and hit,
    2,048 locates and 2,048 reads' seed scan on both sides of 2^31
    against the CPU engine and oracles independent of the layout,
    10,000 pairs through the whole aligner (BAM, -t 4) against the CPU
    path, and the index=2 table repacked from the cache."""
    from dart_tpu_torch import crossing
    from dart_tpu_torch.index import load_index
    from dart_tpu_torch.ops.fm_torch import FMIndexTorch

    if 2 * gbp * 1e9 < crossing.TWO31:
        raise ValueError(f"--gbp {gbp}: the fwd+rc text must pass 2^31")
    d = os.path.join(WORK, "big")
    os.makedirs(d, exist_ok=True)
    fa, prefix = os.path.join(d, "genome.fa"), os.path.join(d, "idx")
    res = {}
    stamp(f"{CARD}; {host_room(d)}")
    if not os.path.exists(prefix + ".bwt"):
        t0 = time.perf_counter()
        crossing.write_genome(fa, gbp)
        stamp(f"wrote a {gbp:.2f} Gbp genome, 4 chromosomes, seed 42, in "
              f"{time.perf_counter() - t0:.1f} s")
        res["build"] = b = build_big_index(fa, prefix)
        stamp(f"index built by the port's builder in {b['seconds']:.0f} s "
              f"({2 * gbp * 1e9 / b['seconds'] / 1e6:.2f} M text positions "
              f"a second), peak RSS {b['peak_rss_gib']:.1f} GiB; "
              f"{host_room(d)}")
    t0 = time.perf_counter()
    idx = load_index(prefix)
    stamp(f"index loaded in {time.perf_counter() - t0:.1f} s: seq_len "
          f"{idx.seq_len:,} (2^31 = {crossing.TWO31:,}), sampling interval "
          f"{idx.sad_intv or idx.sa_intv}")
    eng, c = crossing.check_cache(idx, device, LUT_K)
    res["cache"] = c
    stamp(f"cache: the first wide engine missed and wrote .wtab "
          f"({c['wtab_bytes'] / 2**30:.2f} GiB), set-up table "
          f"{c['miss_s']['table']:.2f} s + K-mer table "
          f"{c['miss_s']['lut']:.3f} s; the second hit it, table "
          f"{c['hit_s']['table']:.2f} s + K-mer table "
          f"{c['hit_s']['lut']:.3f} s; tables equal ({CARD})")
    oracle = FMIndexTorch(idx, "cpu", wide=True)
    stamp(f"CPU engine (plain versions): layout cache {oracle.cache}, "
          f"set-up {fmt_setup(oracle)}")
    res["locate"] = r = crossing.check_locate(eng, oracle, idx, 2048, 7)
    stamp(f"locate PASS: {r['rows']} rows ({r['rows_above']} at or above "
          f"2^31, {r['on_grid']} on the sampling grid) equal to the CPU "
          f"engine and to the index's samples; {r['positions_above']} "
          f"positions at or above 2^31; card {r['device_s']:.3f} s, CPU "
          f"{r['oracle_s']:.1f} s")
    res["seed_scan"] = r = crossing.check_seed_scan(eng, oracle, idx, 2048,
                                                    64, 8)
    stamp(f"seed scan PASS: K = {LUT_K} K-mer table whole equal to its "
          f"plain version; {r['reads']} reads, {r['seeds']} seeds "
          f"({r['located']} located, {r['on_rows']} as rows), {r['subset']} "
          f"reads equal to the CPU engine, every seed's bases equal to the "
          f"text at its position; {r['rows_above']} seed rows and "
          f"{r['positions_above']} seed positions at or above 2^31; card "
          f"{r['device_s']:.3f} s, CPU {r['oracle_s']:.1f} s")
    launches = eng.launches
    stamp(f"launches of the checked engine: {launches}")
    if device == "cuda" and not all(launches.values()):
        raise AssertionError(f"a wide kernel never launched: {launches}")
    if device == "cuda":
        res["times"] = t = big_times(eng, idx)
        stamp(f"at this size ({CARD}): seed_scan_wide "
              f"{t['seed_scan_wide_ms']:.4f} ms ({MAIN_R} reads, Lp = "
              f"{MAIN_LP}), locate_wide {t['locate_wide_ms']:.4f} ms "
              f"({MAIN_R} random rows), lut_build_wide "
              f"{t['lut_build_wide_ms']:.4f} ms (K = {LUT_K}); one "
              "dependent load: " + ", ".join(
                  f"{mb} MiB {ns:.1f} ns" for mb, ns in t["chase_ns"].items()))
    del eng, oracle
    gc.collect()
    t0 = time.perf_counter()
    r1, r2 = sim_pairs(fa, 10_000, d)
    stamp(f"simulated 10,000 pairs in {time.perf_counter() - t0:.1f} s")
    res["aligner"] = r = crossing.check_aligner(
        prefix, r1, r2, os.path.join(d, "aln"), device, threads=4)
    stamp(f"aligner PASS: 10,000 pairs, -bo, -t 4: BAM ({r['bam_bytes']:,} "
          f"bytes) and junctions.tab byte-equal on {device} and on the CPU "
          f"path; mapping walls ([stats] wall) {device} "
          f"{r['mapping_s']['device']:.2f} s, CPU {r['mapping_s']['cpu']:.2f}"
          f" s; with index load and set-up {r['wall_s']['device']:.1f} s, "
          f"{r['wall_s']['cpu']:.1f} s ({CARD})")
    res["sharded"] = r = crossing.check_sharded(prefix, device)
    stamp(f"sharded PASS: index=2 on one card, .wtab2 repacked from .wtab "
          f"(cache {r['cache']}; the single engine's {r['single_cache']}), "
          f"{r['table_gib']:.2f} GiB in shards of {r['shard_gib']:.2f} GiB; "
          "seeds and locates equal to the single engine's")
    stamp("ALL CHECKS PASS")
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    global CARD
    lines = (smi.stdout.strip().splitlines() if smi.returncode == 0
             else [f"nvidia-smi failed: {smi.stderr.strip()}"])
    for line in lines:
        log(line)
    CARD = "; ".join(lines)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    from dart_tpu_torch.index import load_index
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

    if "--big" in sys.argv[1:]:
        args = sys.argv[1:]
        gbp = float(args[args.index("--gbp") + 1]) if "--gbp" in args else 1.1
        phase("build", do_build)
        if "build" in state:
            phase("big", lambda: phase_big(gbp))
        if failed or "big" not in state:
            log(f"chip_smoke --big: failed phases: {', '.join(failed)}")
            return 1
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if "--stream" in sys.argv[1:]:
        args = sys.argv[1:]
        files = (int(args[args.index("--files") + 1]) if "--files" in args
                 else 100)
        phase("build", do_build)
        phase("dataset", make_dataset)
        if {"build", "dataset"} <= set(state):
            ds = state["dataset"]
            phase("stream_long", lambda: phase_stream_long(
                load_index(ds["prefix"]), ds, "cuda", files))
        if failed or "stream_long" not in state:
            log(f"chip_smoke --stream: failed phases: {', '.join(failed)}")
            return 1
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if "--cards" in sys.argv[1:]:
        phase("build", do_build)
        phase("dataset", make_dataset)
        if "dataset" in state and "build" in state:
            ds = state["dataset"]
            phase("cards", lambda: phase_cards(
                load_index(os.path.join(GOLD, "index", "toy")),
                load_index(ds["prefix"]), ds, N_DIST_READS))
        if failed or "cards" not in state:
            log(f"chip_smoke --cards: failed phases: {', '.join(failed)}")
            return 1
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    gen50 = start_dataset("50mbp_se")
    genpe = start_dataset("8mbp_pe_bam")
    long_proc = start_long_plain()
    try:
        phase("build", do_build)
        phase("dataset", make_dataset)
        if "dataset" in state and "build" in state:
            ds = state["dataset"]
            toy = load_index(os.path.join(GOLD, "index", "toy"))
            big = load_index(ds["prefix"])
            phase("kernels", lambda: phase_kernels(
                toy, big, ds, "cuda", 4096, 1 << 16, MAIN_R, 20260816,
                long_proc))
            phase("goldens", lambda: phase_goldens(toy, "cuda"))
            phase("scale", lambda: phase_scale(big, ds, "cuda", N_PARITY))
            phase("dataset_pe", lambda: finish_dataset(genpe, "8mbp_pe_bam"))
            if "dataset_pe" in state:
                phase("outputs", lambda: phase_outputs(state["dataset_pe"],
                                                       "cuda", N_PARITY))
            if {"scale", "outputs"} <= set(state):
                phase("stream", lambda: phase_stream(
                    big, ds, state["dataset_pe"], "cuda", N_PARITY))
            phase("nw", lambda: phase_nw(big, ds["prefix"], ds["fq"][0],
                                         "cuda", N_NW_READS, N_TIMED,
                                         20261017))
            phase("mem_walks", lambda: phase_mem_walks(
                toy, big, ds, "cuda", N_TIMED, N_WALK_READS, 20261018))
            if "scale" in state:
                phase("mesh", lambda: phase_mesh(toy, big, ds, "cuda",
                                                 20261019))
                phase("dryrun", lambda: phase_dryrun("cuda"))
                phase("dist", lambda: phase_dist(big, ds, "cuda",
                                                 N_DIST_READS))
                phase("profile", lambda: phase_profile(ds, "cuda"))
        phase("dataset50", lambda: finish_dataset(gen50, "50mbp_se"))
        if "dataset50" in state and "build" in state:
            ds50 = state["dataset50"]
            big50 = load_index(ds50["prefix"])
            phase("kernels50", lambda: phase_kernels50(big50, ds50, "cuda",
                                                       20261016))
            phase("scale50", lambda: phase_scale50(big50, ds50, "cuda"))
            phase("cache", lambda: phase_cache(
                {"8 Mbp": (big, ds["fq"][0]),
                 "50 Mbp": (big50, ds50["fq"][0])}, "cuda", 4096))
            if {"scale", "scale50"} <= set(state):
                phase("diagnosis", lambda: phase_diagnosis(
                    big, ds, "cuda", locate_shapes(
                        {"8 Mbp": big, "50 Mbp": big50},
                        {"8 Mbp": state["scale"],
                         "50 Mbp": state["scale50"]}, 20261020),
                    walk_shapes(toy, {"8 Mbp": (big, ds["fq"][0]),
                                      "50 Mbp": (big50, ds50["fq"][0])},
                                20261018)))
            if "diagnosis" in state:
                phase("redesign", lambda: phase_redesign(
                    {"8 Mbp": (big, ds["fq"][0]),
                     "50 Mbp": (big50, ds50["fq"][0])},
                    state["diagnosis"]["shapes"], "cuda"))
    finally:
        for proc in (gen50, genpe, long_proc):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed or not {"scale", "scale50", "outputs", "stream", "cache",
                      "nw", "mem_walks", "mesh", "dryrun", "dist", "profile",
                      "diagnosis"} <= set(state):
        log(f"chip_smoke: failed phases: {', '.join(failed) or 'none'}")
        return 1
    kern, scale = state["kernels"], state["scale"]
    launches = {**scale["narrow"]["launches"], **scale["wide"]["launches"]}
    k50 = state["kernels50"]
    err50 = {k: v["max_abs_err"] for k, v in k50["times"].items()}
    for k in ("lut_build", "lut_build_wide"):
        err50[k] = max(err50[k], k50[k])

    def row(name, source, replaces, n, r, err):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n, "max_abs_err": err,
                **{k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")}}

    rows = [row(k, FM_SOURCE, KERNELS[k], launches[k], kern[k],
                max(kern[k]["max_abs_err"], err50[k])) for k in KERNELS]
    # the narrow kernels also run on the paired BAM path ([outputs]),
    # and on the 1 M-read stream ([stream] (a); the wide ones in (c))
    pe = state["outputs"]["t1"]["launches"]
    st = {**state["stream"]["a_launches"], **state["stream"]["c_launches"]}
    for r in rows:
        if r["name"] in pe:
            r["launches_by_path"] = {"8mbp_se": r["launches"],
                                     "8mbp_pe_bam": pe[r["name"]]}
        if r["name"] in st:
            r.setdefault("launches_by_path", {"8mbp_se": r["launches"]})[
                "stream"] = st[r["name"]]
    for name, source, replaces in (
            ("nw", NW_SOURCE, NW_REPLACES),
            ("mem_walks", FM_SOURCE, MEM_WALKS_REPLACES)):
        r = state[name]
        rows.append(row(name, source, replaces, r["launches"], r,
                        r["max_abs_err"]))
    # K8's floor at its timed set (the longest walk's dependent loads)
    # beside its bytes bound, and its launches on each of its paths
    walks = state["diagnosis"]["walks"][f"8 Mbp {N_TIMED} x 128"]
    rows[-1].update(
        max_abs_err=max(rows[-1]["max_abs_err"],
                        state["diagnosis"]["walks_err"]),
        floor_ms=walks["floor_ms"],
        launches_by_path={**state["mem_walks"]["launches_by_path"],
                          "dryrun (sharded)": state["dryrun"]["toy"][
                              "launches"]["mem_walks_sharded"]})
    # the Sharded kernels: launches on the mesh path (data=2,index=2,
    # narrow and wide; the MEM walk in the dry run), times at index=2
    runs, mk = state["mesh"]["runs"], state["mesh"]["kernels"]
    launches = {**runs["data2_index2"]["launches"],
                **runs["data2_index2_wide"]["launches"],
                "mem_walks_sharded":
                    state["dryrun"]["toy"]["launches"]["mem_walks_sharded"]}
    for k in SHARDED:
        base = k[:-len("_sharded")]
        rows.append(row(k, FM_SOURCE, KERNELS.get(base, MEM_WALKS_REPLACES),
                        launches[k], mk[k], mk[k]["max_abs_err"]))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
