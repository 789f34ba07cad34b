"""``dart-tpu-torch``: the dart-tpu command line on the port's engine.

Takes every flag of ``dart-tpu`` (parsed by ``dart_tpu.cli.parse_args``)
plus ``--device DEV`` (default ``cuda``; ``cpu`` runs the plain PyTorch
kernels). Without a card, ``cuda`` raises rather than falling back. The
engine follows the index (wide from 2^31 text positions on) and the
device (K-mer table of K = 11 on ``cuda``), as ``aligner.make_engine``
chooses them.
"""

from __future__ import annotations

import os
import sys

from dart_tpu.cli import parse_args, usage

PROG = "dart-tpu-torch"


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
        usage(PROG)
        print("         --device DEV  cuda | cuda:N | cpu [cuda]\n")
        return 0
    if argv[0] == "index":
        if len(argv) == 3:
            from dart_tpu.index import build_index

            build_index(argv[1], argv[2])
            return 0
        print(f"usage: {PROG} index ref.fa prefix", file=sys.stderr)
        return 1

    cfg = parse_args(argv)
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
    from dart_tpu.index import load_index

    from .aligner import run

    print("Load the genome index files...", file=sys.stderr)
    run(load_index(cfg.index_prefix), cfg, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
