"""A temporary copy of the benchmark with a toy configuration, mixes,
cells and a metric of their own, added as a later change would add
them: files and entries, no code. Cells run on the CPU through
``harness.run_cell``, which skips the look for a card."""

from __future__ import annotations

import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TOY = {
    "name": "toy",
    "source": "a toy genome for the CPU tests",
    "genome": {
        "chromosomes": {"chrT": 1500000},
        "seed": 5,
        "genes": {"per_mbp": 40, "exon_len": [80, 220],
                  "introns": {"median": 1023, "mean": 3365, "least": 60,
                              "most": 300000}},
        "copy": {"name": "chrDup", "of": "chrT", "bases": 100000},
    },
    "flags": ["-mis", "5", "-t", "4", "--batch", "1024"],
    "reduced": {},
    "assumed": [],
}
MIX = {"paired": True, "read_len": 100, "mismatch": 0.005,
       "insert": [200, 500], "spliced_share": 0.3, "format": "fastq",
       "gzip": False, "files": 2, "file_fragments": 1024, "output": "sam"}
# a toy run judges some thousands of records, so one record off reads
# some hundreds per million
LIMITS = {"reads_missing": 0, "records_wrong": 0, "mates_wrong": 0,
          "nm_off_ppm": 100, "unplaced_pct": 20, "sj_rows_off": 0}
# a per-layer metric of the toy cells' own
METRIC = '''
def read(run):
    return run["stats"]["chunks"]
'''
CELLS = {
    "toy_pe_sam": ("toy_pe_sam", MIX),
    "toy_pe_bam": ("toy_pe_bam", dict(MIX, output="bam")),
    "toy_se_gz": ("toy_se_gz", dict(MIX, paired=False, spliced_share=0.3,
                                     format="fasta", gzip=True,
                                     gzip_level=1, file_fragments=2048)),
}


def make_root(tmp: str, cache: str | None = None) -> str:
    """The copy under ``tmp``: ``BENCHMARK.json`` and ``benchmark/`` as
    committed, plus the toy files and entries; ``cache`` (a directory
    of built indexes to share between tests) replaces
    ``benchmark/cache``."""
    root = os.path.join(tmp, "root")
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    d = os.path.join(root, "benchmark")

    def put(rel, obj):
        with open(os.path.join(d, rel), "w") as f:
            f.write(obj if isinstance(obj, str) else json.dumps(obj))

    put("configs/toy.json", TOY)
    put("metrics/toy_chunks.py", METRIC)
    bench["configs"].append({"name": "toy", "source": TOY["source"],
                             "file": "benchmark/configs/toy.json",
                             "reduced": [], "why": "CPU tests"})
    for name, (traffic, mix) in CELLS.items():
        put(f"traffic/{traffic}.json", mix)
        put(f"limits/{name}.json", LIMITS)
        bench["workloads"].append({"name": name, "config": "toy",
                                   "traffic": traffic, "chips": 1,
                                   "why": "CPU tests"})
    bench["per_layer"].append({"name": "toy_chunks", "unit": "chunks",
                               "better": "lower", "source": "program_span",
                               "layer": "toy", "moves": "reads_per_s",
                               "workloads": list(CELLS)})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    if cache is not None:
        os.makedirs(cache, exist_ok=True)
        os.symlink(cache, os.path.join(d, "cache"))
    return root
