"""``dart-tpu-torch``: the flag-compatible command line (reference:
main.cpp:96-239) on the port's engine.

Every reference flag is accepted with identical defaults and clamping,
as ``dart-tpu`` takes them, with its ``index``, ``eva``, ``fluxeva``
and ``sjeva`` subcommands, plus ``--device DEV`` (default ``cuda``;
``cpu`` runs the plain PyTorch kernels). Without a card, ``cuda``
raises rather than falling back. The engine follows the index (wide
from 2^31 text positions on), the device (K-mer table of K = 11 on
``cuda``) and ``--mesh``, as ``aligner.make_engine`` chooses them;
``--profile DIR`` writes a ``torch.profiler`` trace; ``--dist-nprocs N``
> 1 makes this process one of N of a ``torch.distributed`` run
(``parallel.distributed``).
"""

from __future__ import annotations

import os
import sys

from .config import DartConfig
from .constants import VERSION_STR

PROG = "dart-tpu-torch"


def usage(prog: str = PROG) -> None:
    print(f"""
DART-TPU-TORCH (the dart-tpu aligner on PyTorch and CUDA, reference
parity v{VERSION_STR})

Usage: {prog} -i Index_Prefix -f <ReadFile_A1 ...> [-f2 <ReadFile_A2 ...>] -o|-bo Output
       {prog} index ref.fa prefix
       {prog} eva|fluxeva|sjeva ...

Options: -t INT        number of threads [4]
         -f            files with #1 mates reads
         -f2           files with #2 mates reads
         -mis INT      maximal number of mismatches in an alignment
         -max_dup INT  maximal number of repetitive fragments (100-10000) [100]
         -o            alignment filename in SAM format
         -bo           alignment filename in BAM format
         --bam-level INT  BGZF compression level 0-9 [1]
         -j            splice junction output filename [junctions.tab]
         -m            output multiple alignments [false]
         -all_sj       detect all splice junctions regardless of mapq [false]
         -p            paired-end reads are interlaced in the same file
         -unique       output unique alignments
         -max_intron   the maximal intron size [500000]
         -min_intron   the minimal intron size [10]
         -v            version
Extensions:
         --device DEV  cuda | cuda:N | cpu [cuda]; cpu runs the plain
                       PyTorch kernels
         --mesh SPEC   device grid, e.g. data=4 or data=4,index=2
                       (reads split over data groups; the FM table
                       range-sharded by row over each group's index
                       devices; slots go round-robin onto the cards
                       there are)
         --batch N     reads per device chunk [65536]
         --checkpoint  per-chunk resume cursor (SAM/BAM; per process
                       when distributed)
         --ckpt-interval S  min seconds between checkpoint saves
                       (0 = every chunk) [0]
         --stats       per-stage timing report
         --profile DIR write a torch.profiler trace (CPU, and the card
                       on cuda) into DIR
         --no-native   pure-Python host pipeline (no C++ toolchain)
         --dist-coordinator HOST:PORT / --dist-nprocs N / --dist-pid I
                       multi-host run via torch.distributed (gloo over
                       TCP); with cuda, process I runs on card
                       I mod the card count
""")


def parse_args(argv: list[str]) -> DartConfig | None:
    cfg = DartConfig()
    i = 0
    n = len(argv)
    while i < n:
        a = argv[i]
        if a == "-i":
            i += 1
            cfg.index_prefix = argv[i]
        elif a == "-f":
            while i + 1 < n and not argv[i + 1].startswith("-"):
                i += 1
                cfg.read_files_1.append(argv[i])
        elif a == "-f2":
            while i + 1 < n and not argv[i + 1].startswith("-"):
                i += 1
                cfg.read_files_2.append(argv[i])
        elif a == "-t":
            i += 1
            cfg.threads = int(argv[i])
            if cfg.threads <= 0:
                print("Warning! Thread number should be a positive number!")
                cfg.threads = 4
        elif a == "-o":
            i += 1
            cfg.output_format = 0
            cfg.output_file = argv[i]
        elif a == "-bo":
            i += 1
            cfg.output_format = 1
            cfg.output_file = argv[i]
        elif a in ("--bam-level", "-bam_level") and i + 1 < n:
            i += 1
            cfg.bam_level = min(max(int(argv[i]), 0), 9)
        elif a == "-mis" and i + 1 < n:
            i += 1
            cfg.max_mismatch = int(argv[i])
        elif a == "-max_dup" and i + 1 < n:
            i += 1
            cfg.max_dup_num = min(max(int(argv[i]), 100), 10000)
        elif a == "-silent":
            cfg.silent = True
        elif a == "-j":
            i += 1
            cfg.sj_file = argv[i]
        elif a == "-p":
            cfg.pair_end = True
        elif a == "-m":
            cfg.multi_hit = True
        elif a == "-unique":
            cfg.unique_only = True
        elif a == "-all_sj":
            cfg.find_all_junction = True
        elif a == "-max_intron":
            i += 1
            cfg.max_intron_size = max(int(argv[i]), 100000)
        elif a == "-min_intron":
            i += 1
            cfg.min_intron_size = int(argv[i])
        elif a in ("-d", "-debug"):
            cfg.debug = True
        elif a in ("-v", "--version"):
            print(f"DART-TPU (reference parity v{VERSION_STR})\n")
            return None
        elif a == "--engine":
            i += 1
            cfg.engine = argv[i]
        elif a == "--mesh":
            i += 1
            cfg.mesh = argv[i]
        elif a == "--batch":
            i += 1
            cfg.batch_reads = max(2, int(argv[i]))
        elif a == "--no-native":
            cfg.native = False
        elif a == "--checkpoint":
            cfg.checkpoint = True
        elif a == "--ckpt-interval":
            i += 1
            cfg.ckpt_interval_s = float(argv[i])
        elif a == "--stats":
            cfg.stats = True
        elif a == "--profile":
            i += 1
            cfg.profile_dir = argv[i]
        elif a == "--dist-coordinator":
            i += 1
            cfg.dist_coordinator = argv[i]
        elif a == "--dist-nprocs":
            i += 1
            cfg.dist_nprocs = int(argv[i])
        elif a == "--dist-pid":
            i += 1
            cfg.dist_pid = int(argv[i])
        else:
            print(f"Error! Unknown parameter: {a}", file=sys.stderr)
            usage(PROG)
            sys.exit(1)
        i += 1
    return cfg


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            print("Error! --device needs a value (cuda, cuda:N or cpu)",
                  file=sys.stderr)
            return 1
        device = argv[i + 1]
        del argv[i:i + 2]
    if not argv or argv[0] == "-h":
        usage()
        return 0
    if argv[0] == "index":
        if len(argv) == 3:
            from .index import build_index

            build_index(argv[1], argv[2])
            return 0
        print(f"usage: {PROG} index ref.fa prefix", file=sys.stderr)
        return 1
    if argv[0] in ("eva", "fluxeva", "sjeva"):
        from .evaluation import main as eval_main

        return eval_main(argv)

    try:
        cfg = parse_args(argv)
    except SystemExit as e:  # an unknown flag; parse_args printed the usage
        return int(e.code or 0)
    if cfg is None:
        return 0
    if not cfg.read_files_1:
        print("Error! Please specify a valid read input!", file=sys.stderr)
        return 1
    if cfg.read_files_2 and len(cfg.read_files_1) != len(cfg.read_files_2):
        print("Error! Paired-end reads input numbers do not match!",
              file=sys.stderr)
        return 1
    for p in cfg.read_files_1 + cfg.read_files_2:
        if not os.path.exists(p):
            print(f"Cannot access file:[{p}]", file=sys.stderr)
            return 1
    if not cfg.index_prefix or not os.path.exists(cfg.index_prefix + ".ann"):
        print("Error! Please specify a valid reference index!",
              file=sys.stderr)
        return 1
    if cfg.dist_nprocs > 1:
        from .parallel.distributed import run_distributed

        return run_distributed(cfg, cfg.dist_coordinator, cfg.dist_nprocs,
                               cfg.dist_pid, device)
    from .aligner import run
    from .index import load_index

    print("Load the genome index files...", file=sys.stderr)
    run(load_index(cfg.index_prefix), cfg, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
