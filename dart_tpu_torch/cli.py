"""``dart-tpu-torch``: the dart-tpu command line on the port's engine.

Takes every flag of ``dart-tpu`` (parsed by ``dart_tpu.cli.parse_args``)
and its ``index``, ``eva``, ``fluxeva`` and ``sjeva`` subcommands, plus
``--device DEV`` (default ``cuda``; ``cpu`` runs the plain PyTorch
kernels). Without a card, ``cuda`` raises rather than falling back. The
engine follows the index (wide from 2^31 text positions on), the device
(K-mer table of K = 11 on ``cuda``) and ``--mesh``, as
``aligner.make_engine`` chooses them; ``--profile DIR`` writes a
``torch.profiler`` trace; ``--dist-nprocs N`` > 1 makes this process
one of N of a ``torch.distributed`` run (``parallel.distributed``).
"""

from __future__ import annotations

import contextlib
import io
import os
import sys

from dart_tpu.cli import parse_args
from dart_tpu.cli import usage as dart_tpu_usage

PROG = "dart-tpu-torch"
EXTENSIONS = """\
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
"""


def usage(prog: str = PROG) -> None:
    """dart-tpu's usage lines for the reference's flags, then the
    port's own extensions."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dart_tpu_usage(prog)
    print(buf.getvalue().split("Extensions:")[0] + EXTENSIONS)


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
            from dart_tpu.index import build_index

            build_index(argv[1], argv[2])
            return 0
        print(f"usage: {PROG} index ref.fa prefix", file=sys.stderr)
        return 1
    if argv[0] in ("eva", "fluxeva", "sjeva"):
        from dart_tpu.evaluation import main as eval_main

        return eval_main(argv)

    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            cfg = parse_args(argv)
    except SystemExit as e:  # an unknown flag; parse_args printed its usage
        usage()
        return int(e.code or 0)
    sys.stdout.write(out.getvalue())
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
    from dart_tpu.index import load_index

    from .aligner import run

    print("Load the genome index files...", file=sys.stderr)
    run(load_index(cfg.index_prefix), cfg, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
