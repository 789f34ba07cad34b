"""The wide engine across 2^31 text positions.

The checks that ``chip_smoke.py --big`` runs on a synthetic genome
whose fwd+rc text passes 2^31 positions (the port's counterpart of
``tools/run_big_wide_check.py``), each taking an index, or its prefix,
and a device, so that the same code runs on the toy index on the CPU:

- ``write_genome``: ``run_big_wide_check``'s genome (uniform random
  bases, 4 chromosomes, seed 42);
- ``check_cache``: the first wide engine misses the layout cache and
  writes ``.wtab``, the second hits it; tables, offsets and K-mer
  tables equal;
- ``check_locate``: rows on both sides of ``split`` (2^31 on the big
  genome) located on the engine against the CPU engine's plain locate,
  and rows on the sampling grid against the ``.sa``/``.sad`` sample
  itself;
- ``check_seed_scan``: reads from both strands with 2% of their bases
  changed, the K-mer table (K6 on a card) whole against its plain
  version, the scan against the CPU engine on a subset, and every
  seed's bases against the genome text at its located position;
- ``check_aligner``: ``dart-tpu-torch -bo`` on pairs, on the device and
  with ``--device cpu``, BAM and ``junctions.tab`` byte-equal;
- ``check_sharded``: ``entry.giant_proof`` at index=2, its ``.wtab2``
  repacked from ``.wtab``.

Each raises AssertionError on a disagreement and returns what it
measured.
"""

from __future__ import annotations

import contextlib
import io
import os
import re
import time

import numpy as np
import torch

from .entry import _require, giant_proof
from .index import layout_cache
from .ops.fm_torch import FMIndexTorch

TWO31 = 2**31


def write_genome(fa: str, gbp: float, seed: int = 42) -> None:
    """``run_big_wide_check``'s synthetic genome: gbp x 10^9 uniform
    random bases in 4 chromosomes, lines of 2^24 bases."""
    n = int(gbp * 1e9)
    rng = np.random.default_rng(seed)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    per = n // 4
    with open(fa + ".tmp", "wb") as f:
        for c in range(4):
            f.write(b">chr%d\n" % (c + 1))
            seq = lut[rng.integers(0, 4, per, dtype=np.int8)]
            for off in range(0, per, 1 << 24):
                f.write(seq[off:off + (1 << 24)].tobytes())
                f.write(b"\n")
    os.replace(fa + ".tmp", fa)


def _equal(got, want, what: str) -> None:
    _require(np.array_equal(np.asarray(got), np.asarray(want)),
             f"{what} differs")


def _drop(prefix: str, kind: str) -> None:
    with contextlib.suppress(FileNotFoundError):
        os.remove(f"{prefix}.{kind}")


def check_cache(idx, device, lut_k: int) -> tuple[FMIndexTorch, dict]:
    """Two wide engines on ``device`` (the index's ``.wtab`` removed
    first): the first misses the layout cache and writes ``.wtab``, the
    second hits it; their tables, offsets and K-mer tables must be
    equal. Returns the second engine and both set-up times."""
    _require(layout_cache.eligible(idx.seq_len), "the layout cache does "
             f"not apply to a text of {idx.seq_len} positions")
    _drop(idx.prefix, "wtab")
    miss = FMIndexTorch(idx, device, lut_k=lut_k, wide=True)
    _require(miss.cache == "miss" and os.path.exists(idx.prefix + ".wtab"),
             f"the first wide engine: cache {miss.cache}, expected a miss "
             "that writes .wtab")
    hit = FMIndexTorch(idx, device, lut_k=lut_k, wide=True)
    _require(hit.cache == "hit", f"the second wide engine: cache "
             f"{hit.cache}, expected a hit")
    _require((miss.ref_off, miss.sad_off) == (hit.ref_off, hit.sad_off),
             "the offsets of the cached table differ")
    _require(torch.equal(miss.table, hit.table), "the cached table differs")
    if lut_k:
        _require(torch.equal(miss.lut, hit.lut), "the K-mer table built "
                 "from the cached table differs")
    return hit, {"miss_s": miss.setup_s, "hit_s": hit.setup_s,
                 "table_bytes": int(hit.table.nbytes),
                 "wtab_bytes": os.path.getsize(idx.prefix + ".wtab")}


def check_locate(eng: FMIndexTorch, oracle: FMIndexTorch, idx, n_rows: int,
                 seed: int, split: int = TWO31) -> dict:
    """``n_rows`` rows, half below ``split`` and half at or above it, a
    quarter of them moved onto the sampling grid: the engine's locate
    against ``oracle``'s (on the CPU, its plain version), and every
    row on the grid against its sample from the index files. Requires
    some positions at or above ``split``."""
    rng = np.random.default_rng(seed)
    half = n_rows // 2
    rows = np.concatenate([
        rng.integers(1, split, half, dtype=np.int64),
        rng.integers(split, idx.seq_len, n_rows - half, dtype=np.int64)])
    intv = eng.sa_intv
    rows[::4] = np.maximum(rows[::4] // intv, 1) * intv
    t0 = time.perf_counter()
    got = eng.locate(rows)
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _equal(got, oracle.locate(rows), "locate against the CPU engine")
    oracle_s = time.perf_counter() - t0
    samples = idx.sad_samples if idx.sad_intv else idx.sa_samples
    on_grid = rows % intv == 0
    _equal(got[on_grid], samples[rows[on_grid] // intv],
          "locate on the sampling grid against the index's samples")
    above = int((got >= split).sum())
    _require(above > 0, f"no located position at or above {split}")
    return {"rows": n_rows, "rows_above": int((rows >= split).sum()),
            "on_grid": int(on_grid.sum()), "positions_above": above,
            "device_s": dev_s, "oracle_s": oracle_s}


def strand_reads(idx, n: int, L: int, rng, change: float = 0.02):
    """n reads of L bases from random genome positions, every other one
    reverse-complemented (the text's other strand), with ``change`` of
    their bases replaced by a random code 0-4 (4 is N)."""
    gsz = int(idx.genome_size)
    codes = np.empty((n, L), dtype=np.uint8)
    for i in range(n):
        p = int(rng.integers(0, gsz - L))
        s = np.minimum(idx.ref_codes[p:p + L], 3)
        codes[i] = s if i % 2 == 0 else 3 - s[::-1]
    m = rng.random((n, L)) < change
    return np.where(m, rng.integers(0, 5, (n, L)).astype(np.uint8), codes)


def check_seed_scan(eng: FMIndexTorch, oracle: FMIndexTorch, idx,
                    n_reads: int, n_sub: int, seed: int,
                    split: int = TWO31) -> dict:
    """``n_reads`` reads of 100 bases (``strand_reads``) through the
    engine's seed scan: its K-mer table whole against the plain
    version, the scan against ``oracle``'s on ``n_sub`` of them, and
    each seed's bases against the genome text at its first located
    position. Counts the seeds whose row or position is at or above
    ``split`` and requires some."""
    rng = np.random.default_rng(seed)
    L = 100
    codes = strand_reads(idx, n_reads, L, rng)
    rlens = np.full(n_reads, L, np.int32)
    if eng.lut_k:
        _require(torch.equal(eng.lut, eng.plain_build_lut()),
                 "the K-mer table differs from its plain version")
    t0 = time.perf_counter()
    n, rpos, slen, k0, freq = eng.seed_reads(codes, rlens)
    dev_s = time.perf_counter() - t0
    sub = np.sort(rng.choice(n_reads, n_sub, replace=False))
    t0 = time.perf_counter()
    for a, b, what in zip((n, rpos, slen, k0, freq),
                          oracle.seed_reads(codes[sub], rlens[sub]),
                          ("n", "rpos", "len", "k0", "freq")):
        _equal(a[sub], b, f"seed scan {what} against the CPU engine")
    oracle_s = time.perf_counter() - t0
    live = np.arange(rpos.shape[1])[None, :] < n[:, None]
    r_i, s_i = np.nonzero(live)
    rows_hit = live & (freq >= 1)
    pos = np.where(freq[r_i, s_i] < 0, k0[r_i, s_i], 0)
    on_row = freq[r_i, s_i] >= 1
    if on_row.any():
        pos[on_row] = eng.locate(k0[r_i, s_i][on_row])
    text = idx.ref_codes
    for r, s, p in zip(r_i, s_i, pos):
        a, ln = int(rpos[r, s]), int(slen[r, s])
        _require(np.array_equal(text[p:p + ln], codes[r, a:a + ln]),
                 f"read {r} seed {s}: the text at {p} is not its bases")
    rows_above = int((k0[rows_hit] >= split).sum())
    pos_above = int((pos >= split).sum())
    _require(rows_above + pos_above > 0,
             f"no seed row or position at or above {split}")
    return {"reads": n_reads, "seeds": int(n.sum()),
            "located": int((~on_row).sum()), "on_rows": int(on_row.sum()),
            "rows_above": rows_above, "positions_above": pos_above,
            "subset": n_sub, "device_s": dev_s, "oracle_s": oracle_s}


def check_aligner(prefix: str, r1: str, r2: str, out: str, device,
                  threads: int = 4) -> dict:
    """``dart-tpu-torch -i prefix -f r1 -f2 r2 -bo ... -t threads
    --stats`` on ``device`` and with ``--device cpu``: BAM and
    ``junctions.tab`` byte-equal. Returns each run's wall (index load
    and engine set-up included), its mapping wall (``[stats] wall``)
    and the BAM's size."""
    from .cli import main

    os.makedirs(out, exist_ok=True)
    walls, mapping, files = {}, {}, {}
    for who, dev in (("device", str(device)), ("cpu", "cpu")):
        bam = os.path.join(out, f"{who}.bam")
        tab = os.path.join(out, f"{who}.junctions.tab")
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(err):
            rc = main(["-i", prefix, "-f", r1, "-f2", r2, "-bo", bam, "-j",
                       tab, "-t", str(threads), "-silent", "--stats",
                       "--device", dev])
        walls[who] = time.perf_counter() - t0
        _require(rc == 0, f"dart-tpu-torch on {dev} exited {rc}")
        stats = re.search(r"\[stats\] wall ([0-9.]+)s", err.getvalue())
        _require(stats is not None, f"no [stats] wall line on {dev}")
        mapping[who] = float(stats.group(1))
        files[who] = [open(p, "rb").read() for p in (bam, tab)]
    _require(files["device"][0] == files["cpu"][0],
             "the BAM differs from the CPU path's")
    _require(files["device"][1] == files["cpu"][1],
             "junctions.tab differs from the CPU path's")
    return {"wall_s": walls, "mapping_s": mapping,
            "bam_bytes": len(files["cpu"][0])}


def check_sharded(prefix: str, device, min_gib: float = 1.0) -> dict:
    """``entry.giant_proof`` over two index shards of ``device`` (its
    seeds and locates equal to one engine's), with the index's
    ``.wtab2`` removed first: the sharded table must be repacked from
    ``.wtab``, which must be there."""
    _require(os.path.exists(prefix + ".wtab"), "no .wtab to repack from")
    _drop(prefix, "wtab2")
    res = giant_proof(2, prefix, device, min_gib=min_gib)
    _require(res["cache"] == "repack", f"the index=2 table: cache "
             f"{res['cache']}, expected a repack from .wtab")
    _require(os.path.exists(prefix + ".wtab2"), "the repack wrote no .wtab2")
    return res
