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

BASELINE config 5's shape on the same index (spliced paired-end reads,
``-bo -all_sj -m -mis 5``), each taking the index, its prefix, the read
files and a device:

- ``write_spliced_genome``: ``write_genome``'s chromosomes with genes
  planted (GT..AG at every intron's ends, introns from the three bands
  of ``INTRON_BANDS``) and ``chrDup``, a copy of chr1's start;
- ``check_config5``: the whole set from a layout-cache hit, its first
  pairs byte-equal to the CPU path, its counts (``aln_counts``: records,
  spliced, proper, unmapped, junction rows, CIGARs with an ``N`` in each
  band of ``N_BANDS``, reverse-strand spliced records past ``split``);
- ``check_config5_stream``: the pair of files as N ``-f``/``-f2`` pairs
  through ``stream.run_stream`` with ``--checkpoint``, held by
  ``stream.check_stream`` to the one-file run and, on a card, by
  ``stream.hold_card``;
- ``check_config5_resume``: that stream crashed and resumed
  (``stream.crash_and_resume``), equal to the uninterrupted stream;
- ``check_two_processes``: ``--dist-nprocs 2``, merged outputs equal to
  one process's;
- ``check_max_intron``: ``-max_intron`` runs held to the CPU path and
  required to change the output; ``check_bands`` holds their ``N``
  bands to what the flag allows.

Each raises AssertionError on a disagreement and returns what it
measured.
"""

from __future__ import annotations

import contextlib
import gzip
import io
import os
import re
import struct
import subprocess
import sys
import time

import numpy as np
import torch

from .entry import _require, giant_proof
from .parallel.distributed import held_port
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


def strand_reads(idx, n: int, L: int, rng, change: float = 0.02,
                 span=None):
    """n reads of L bases from random genome positions (in the forward
    positions [span[0], span[1]) when given), every other one
    reverse-complemented (the text's other strand), with ``change`` of
    their bases replaced by a random code 0-4 (4 is N)."""
    lo, hi = span or (0, int(idx.genome_size))
    codes = np.empty((n, L), dtype=np.uint8)
    for i in range(n):
        p = int(rng.integers(lo, hi - L))
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


# ---- BASELINE config 5's shape: genes with long introns, spliced pairs

# introns drawn in these shares: (share, least, most bases). -max_intron's
# default, 500,000, chains the second band and splits the third; 100,000
# splits the second, 1,000,000 chains the third
INTRON_BANDS = ((0.75, 60, 8_000), (0.20, 100_001, 450_000),
                (0.05, 520_000, 900_000))
EXON_LEN = (80, 220)  # bases of an exon, as make_fixtures.plant_genes
GENES_PER_MBP = 25  # genes overlap: a gene may sit in another's intron
# the bands a CIGAR's N is counted in: (name, least, most bases)
N_BANDS = (("le8k", 1, 8_000), ("8k_100k", 8_001, 100_000),
           ("100k_500k", 100_001, 500_000), ("gt500k", 500_001, None))
CONFIG5 = ("-all_sj", "-m", "-mis", "5")
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def draw_genes(rng, lengths: dict, n_genes: int, bands=INTRON_BANDS) -> list:
    """n_genes gene structures of 2-4 exons of EXON_LEN bases, each on a
    chromosome drawn by its length (``lengths``: name -> bases) at a
    uniform start between 200 bases in and 5,000 before its end (as
    ``make_fixtures.plant_genes`` keeps them); the introns' bands are in
    ``bands``' shares exactly, shuffled, each intron's length uniform in
    its band. A gene that does not fit its chromosome is dropped.
    Returns [(chrom, [(start, end), ...])], 0-based, end exclusive."""
    margin, tail = 200, 5000
    names = list(lengths)
    size = np.array([lengths[c] for c in names], dtype=np.int64)
    n_ex = rng.integers(2, 5, n_genes)
    ex = rng.integers(EXON_LEN[0], EXON_LEN[1], (n_genes, 4))
    n_in = int((n_ex - 1).sum())
    counts = [int(round(share * n_in)) for share, _, _ in bands]
    counts[0] = n_in - sum(counts[1:])
    which = rng.permutation(np.repeat(np.arange(len(bands)), counts))
    lo = np.array([b[1] for b in bands], dtype=np.int64)[which]
    hi = np.array([b[2] for b in bands], dtype=np.int64)[which] + 1
    introns = rng.integers(lo, hi)
    chrom = rng.choice(len(names), n_genes, p=size / size.sum())
    where = rng.random(n_genes)
    genes, k = [], 0
    for g in range(n_genes):
        m = int(n_ex[g])
        il, k = introns[k:k + m - 1], k + m - 1
        room = int(size[chrom[g]]) - tail - margin - int(ex[g, :m].sum()
                                                         + il.sum())
        if room <= 0:
            continue
        s, exs = margin + int(where[g] * room), []
        for e in range(m):
            exs.append((s, s + int(ex[g, e])))
            s = exs[-1][1] + (int(il[e]) if e < m - 1 else 0)
        genes.append((names[chrom[g]], exs))
    return genes


def stamp_genes(seqs: dict, genes: list) -> list:
    """GT at each intron's first two bases and AG at its last two
    (``make_fixtures.plant_genes``' motifs), stamped into the uint8
    ASCII arrays of ``seqs`` at once; a gene whose stamps would touch
    another's is dropped first. Returns the genes kept."""
    taken = {c: set() for c in seqs}
    kept, at = [], {c: [] for c in seqs}
    for chrom, exs in genes:
        pos = [p for (_, a), (b, _) in zip(exs, exs[1:])
               for p in (a, a + 1, b - 2, b - 1)]
        if taken[chrom].isdisjoint(pos):
            taken[chrom].update(pos)
            at[chrom] += pos
            kept.append((chrom, exs))
    motif = np.frombuffer(b"GTAG", dtype=np.uint8)
    for chrom, pos in at.items():
        if pos:
            seqs[chrom][np.asarray(pos, dtype=np.int64)] = np.tile(
                motif, len(pos) // 4)
    return kept


def intron_bands(genes: list, bands=INTRON_BANDS) -> list:
    """The genes' introns counted in each band of ``bands``."""
    lens = [b - a for _, exs in genes for (_, a), (b, _) in zip(exs, exs[1:])]
    return [sum(lo <= n <= hi for n in lens) for _, lo, hi in bands]


def write_spliced_genome(fa: str, genes_txt: str, gbp: float, seed: int = 42,
                         n_chrom: int = 4, dup_bp: int = 4_000_000,
                         genes_per_mbp: float = GENES_PER_MBP,
                         bands=INTRON_BANDS) -> dict:
    """``write_genome``'s uniform bases (the same draws from ``seed``; its
    4 chromosomes unless ``n_chrom``) with genes planted: gbp x 10^3 x
    ``genes_per_mbp`` gene structures (``draw_genes``, seed + 1; introns
    in ``bands``), their motifs stamped (``stamp_genes``), then
    ``chrDup``, a copy of chr1's first ``dup_bp`` bases, appended, so
    that reads from there map twice. Writes the FASTA (lines of 2^24
    bases) and ``genes_txt`` (``chrom<TAB>start-end,...``, 0-based, end
    exclusive, by chromosome and start). Returns the genes kept, the
    introns in each band, the chromosomes' lengths."""
    n = int(gbp * 1e9)
    per = n // n_chrom
    rng = np.random.default_rng(seed)
    seqs = {f"chr{c + 1}": ACGT[rng.integers(0, 4, per, dtype=np.int8)]
            for c in range(n_chrom)}
    genes = draw_genes(np.random.default_rng(seed + 1),
                       {c: per for c in seqs},
                       int(round(genes_per_mbp * n / 1e6)), bands)
    genes = stamp_genes(seqs, genes)
    genes.sort(key=lambda g: (int(g[0][3:]), g[1][0][0]))
    if dup_bp:
        seqs["chrDup"] = seqs["chr1"][:dup_bp].copy()
    with open(fa + ".tmp", "wb") as f:
        for name, seq in seqs.items():
            f.write(b">%s\n" % name.encode())
            for off in range(0, len(seq), 1 << 24):
                f.write(seq[off:off + (1 << 24)].tobytes())
                f.write(b"\n")
    with open(genes_txt + ".tmp", "w") as f:
        for chrom, exs in genes:
            f.write(chrom + "\t" + ",".join(f"{a}-{b}" for a, b in exs)
                    + "\n")
    os.replace(genes_txt + ".tmp", genes_txt)
    os.replace(fa + ".tmp", fa)
    return {"genes": len(genes), "introns": intron_bands(genes, bands),
            "lengths": {c: len(s) for c, s in seqs.items()}}


def n_band(n: int) -> str:
    """The band of ``N_BANDS`` an N of n bases falls in."""
    for name, lo, hi in N_BANDS:
        if n >= lo and (hi is None or n <= hi):
            return name
    raise ValueError(f"an N of {n} bases")


def aln_counts(path: str, tab: str, idx=None, split: int = TWO31) -> dict:
    """A SAM or BAM file's records, spliced records (an N in the CIGAR),
    records flagged as a proper pair, unmapped records, the junction
    table's rows, and the records with an N in each band of ``N_BANDS``
    (a record counts once in each band it has an N in). With ``idx``,
    also "rc_past": the spliced records on the reverse strand whose
    alignment lies wholly at or above text position ``split``; a
    reverse-strand record at forward position g (its chromosome's
    offset plus POS - 1) spanning s reference bases was matched in the
    text's reverse-complement half at seq_len - g - s."""
    n = {"records": 0, "spliced": 0, "proper": 0, "unmapped": 0,
         **{name: 0 for name, _, _ in N_BANDS}}
    if idx is not None:
        n["rc_past"] = 0
        fwd = {c.name: c.forward_location for c in idx.chromosomes}
        fwd_by_id = [c.forward_location for c in idx.chromosomes]

    def count(flag: int, cigar, ref, pos0: int) -> None:
        n["records"] += 1
        n["proper"] += flag & 2 != 0
        n["unmapped"] += flag & 4 != 0
        ns = [k for k, op in cigar if op == "N"]
        if not ns:
            return
        n["spliced"] += 1
        for band in {n_band(k) for k in ns}:
            n[band] += 1
        if idx is not None and flag & 16:
            span = sum(k for k, op in cigar if op in "MDN=X")
            g = (fwd_by_id[ref] if isinstance(ref, int) else fwd[ref]) + pos0
            n["rc_past"] += idx.seq_len - g - span >= split

    if path.endswith(".bam"):
        with gzip.open(path, "rb") as f:
            data = f.read()
        l_text = struct.unpack_from("<i", data, 4)[0]
        off = 8 + l_text
        n_ref = struct.unpack_from("<i", data, off)[0]
        off += 4
        for _ in range(n_ref):
            off += 8 + struct.unpack_from("<i", data, off)[0]
        while off < len(data):
            size, ref, pos = struct.unpack_from("<iii", data, off)
            l_name = data[off + 12]
            n_cigar, flag = struct.unpack_from("<HH", data, off + 16)
            cig = struct.unpack_from(f"<{n_cigar}I", data, off + 36 + l_name)
            count(flag, [(c >> 4, "MIDNSHP=X"[c & 15]) for c in cig], ref,
                  pos)
            off += 4 + size
    else:
        with open(path, "rb") as f:
            for line in f:
                if not line.startswith(b"@"):
                    fields = line.split(b"\t", 6)
                    cig = [(int(k), op.decode()) for k, op in re.findall(
                        rb"(\d+)([MIDNSHP=X])", fields[5])]
                    count(int(fields[1]), cig, fields[2].decode(),
                          int(fields[3]) - 1)
    with open(tab, "rb") as f:
        n["rows"] = sum(1 for _ in f)
    return n


def planted_found(tab: str, genes: list, bands=INTRON_BANDS) -> list:
    """The planted introns (``genes``) in each band of ``bands`` that
    ``junctions.tab`` holds as a row (chrom, first intron base, last
    intron base, 1-based)."""
    with open(tab) as f:
        rows = {(c, int(a), int(b)) for c, a, b, *_ in
                (line.split("\t") for line in f)}
    found = [0] * len(bands)
    for chrom, exs in genes:
        for (_, a), (b, _) in zip(exs, exs[1:]):
            if (chrom, a + 1, b) in rows:
                for i, (_, lo, hi) in enumerate(bands):
                    found[i] += lo <= b - a <= hi
    return found


def check_bands(counts: dict) -> dict:
    """Hold the N bands of ``-max_intron`` runs (``{max_intron: counts}``,
    0 for the default) to what the flag allows: no N past 500,000 at the
    default (500,000), some at 1,000,000, none past 100,000 at 100,000
    (the chaining joins seeds less than -max_intron apart). Checks each
    run given; returns the bands by run."""
    rules = {0: ("gt500k",), 100_000: ("100k_500k", "gt500k")}
    for mi, c in counts.items():
        for band in rules.get(mi, ()):
            _require(c[band] == 0, f"-max_intron {mi or 'default'}: "
                     f"{c[band]} CIGARs with an N in {band}")
    if 1_000_000 in counts:
        _require(counts[1_000_000]["gt500k"] > 0, "-max_intron 1000000: no "
                 "CIGAR with an N past 500,000 bases")
    return {mi: {name: c[name] for name, _, _ in N_BANDS}
            for mi, c in counts.items()}


def head_pairs(r1: str, r2: str, n: int, out: str) -> tuple[str, str]:
    """The first n records of each FASTQ file of a pair, written under
    out as head_1.fq and head_2.fq."""
    heads = []
    for i, src in enumerate((r1, r2), 1):
        dst = os.path.join(out, f"head_{i}.fq")
        with open(src, "rb") as f, open(dst, "wb") as g:
            for k, line in enumerate(f):
                if k >= 4 * n:
                    break
                g.write(line)
        heads.append(dst)
    return heads[0], heads[1]


def align_pairs(idx, prefix: str, r1, r2, out: str, tag: str, device,
                flags=CONFIG5, threads: int = 4, wide: bool | None = None,
                split: int = TWO31) -> dict:
    """``dart-tpu-torch -i prefix -f r1 -f2 r2 <flags> -bo out/<tag>.bam
    -j out/<tag>.tab -t threads --stats`` through ``aligner.run`` on
    ``device`` (``wide`` as ``make_engine`` takes it). Returns the wall
    (set-up included), the aligner's stats, the engine's launches and
    layout cache, the outputs and their ``aln_counts`` (at ``split``)."""
    from .aligner import run
    from .cli import parse_args

    os.makedirs(out, exist_ok=True)
    files = (os.path.join(out, f"{tag}.bam"), os.path.join(out, f"{tag}.tab"))
    cfg = parse_args(["-i", prefix, "-f", r1, "-f2", r2, *flags, "-bo",
                      files[0], "-j", files[1], "-t", str(threads),
                      "-silent", "--stats"])
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        aligner = run(idx, cfg, str(device), wide=wide)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    eng = aligner.engine
    return {"wall_s": time.perf_counter() - t0, "stats": dict(aligner.stats),
            "launches": dict(eng.launches), "cache": eng.cache,
            "wide": eng.wide, "reads": aligner.counters["total"],
            "files": files, "counts": aln_counts(*files, idx, split)}


def same_outputs(a, b, what: str, decompress: bool = False) -> None:
    """Two (BAM, junctions.tab) pairs byte-equal (the BAMs' records,
    decompressed, with ``decompress``)."""
    opener = gzip.open if decompress else open
    with opener(a[0], "rb") as fa, opener(b[0], "rb") as fb:
        _require(fa.read() == fb.read(), f"{what}: the BAM "
                 f"{'records' if decompress else 'bytes'} differ")
    with open(a[1], "rb") as fa, open(b[1], "rb") as fb:
        _require(fa.read() == fb.read(), f"{what}: junctions.tab differs")


def held_to_cpu(idx, prefix: str, heads, out: str, tag: str, device,
                flags=CONFIG5, wide: bool | None = None) -> dict:
    """The head pairs on ``device`` and with the CPU path (plain
    versions), BAM and junctions.tab byte-equal. Returns both runs."""
    dev = align_pairs(idx, prefix, *heads, out, f"{tag}_head", device, flags,
                      wide=wide)
    cpu = align_pairs(idx, prefix, *heads, out, f"{tag}_head_cpu", "cpu",
                      flags, wide=wide)
    same_outputs(dev["files"], cpu["files"], f"({tag}) the first pairs, "
                 f"{device} against the CPU path")
    return {"device": dev, "cpu": cpu}


def check_config5(idx, prefix: str, r1: str, r2: str, out: str, device,
                  n_head: int, threads: int = 4, wide: bool | None = None,
                  split: int = TWO31) -> dict:
    """(a): the whole pair of files through ``-bo -all_sj -m -mis 5 -t
    threads`` on ``device``, its engine from a layout-cache hit (the
    index's sidecar must be there), and its first n_head pairs
    byte-equal (BAM, junctions.tab) to the CPU path. Requires a spliced
    record on the reverse strand wholly past ``split`` (``aln_counts``'
    "rc_past"). Returns the whole run and the heads."""
    whole = align_pairs(idx, prefix, r1, r2, out, "a", device, threads=threads,
                        wide=wide, split=split)
    _require(whole["cache"] == "hit", f"(a) the engine's layout cache: "
             f"{whole['cache']}, expected a hit")
    heads = head_pairs(r1, r2, n_head, out)
    res = {"whole": whole, "heads": held_to_cpu(idx, prefix, heads, out, "a",
                                                device, wide=wide)}
    _require(whole["counts"]["rc_past"] > 0, "(a) no spliced record on the "
             f"reverse strand at or above text position {split}")
    return res


def stream_cfg(prefix: str, r1: str, r2: str, out: str, tag: str,
               threads: int = 4, extra=()):
    """``CONFIG5``'s flags with ``--checkpoint``, -bo out/<tag>.bam."""
    from .cli import parse_args

    return parse_args(["-i", prefix, "-f", r1, "-f2", r2, *CONFIG5, "-bo",
                       os.path.join(out, f"{tag}.bam"), "-j",
                       os.path.join(out, f"{tag}.tab"), "-t", str(threads),
                       "-silent", "--stats", "--checkpoint", *extra])


def check_config5_stream(idx, prefix: str, r1: str, r2: str, out: str,
                         device, n_files: int, one, engine=None,
                         wide: bool | None = None, threads: int = 4,
                         extra=(), slack: int = 64 << 20) -> dict:
    """(b): the pair of files as n_files ``-f``/``-f2`` pairs through
    ``stream.run_stream`` with ``--checkpoint`` (``engine``, or one made
    with ``wide``), held by ``stream.check_stream`` to ``one`` (the
    one-file run's BAM and junctions.tab) and, on a card, by
    ``stream.hold_card`` (reserve and own bytes flat from the third
    chunk), with the seed scan and the locate launched in every chunk.
    Returns the stream's summary (its engine under "engine")."""
    from . import stream
    from .aligner import make_engine

    cfg = stream_cfg(prefix, r1, r2, out, "b", threads, extra)
    if engine is None:
        engine = make_engine(idx, cfg, device, wide=wide)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        res = stream.run_stream(idx, cfg, n_files, device, engine,
                                log=io.StringIO())
    res["stats"] = [ln[8:] for ln in err.getvalue().splitlines()
                    if ln.startswith("[stats]")][-3:]  # the stream's own
    files = (cfg.output_file, cfg.sj_file)
    res["check"] = stream.check_stream(files, one, n_files, "bam")
    res["files"] = files
    if torch.device(device).type == "cuda":
        res["held"] = stream.hold_card(res["log"], slack)
        sfx = "_wide" if engine.wide else ""
        for k in (f"seed_scan{sfx}", f"locate{sfx}"):
            _require(res["launches"].get(k, 0) >= res["chunks"],
                     f"(b) {k} launched {res['launches'].get(k, 0)} times "
                     f"in {res['chunks']} chunks")
    return res


def check_config5_resume(idx, prefix: str, r1: str, r2: str, out: str,
                         device, n_files: int, engine, per_file: int, ref,
                         threads: int = 4, extra=(), lag_batch: int = 16384,
                         at=(3, 2)) -> dict:
    """(c): the stream of (b) (its ``extra`` flags) crashed in chunk
    at[1] of file at[0] (from 0: the second chunk of file 4) and resumed
    (``stream.crash_and_resume``) at ``--ckpt-interval 0``, then at
    ``--ckpt-interval 2 --batch lag_batch`` with the crash two chunks or
    more after the last save: the first byte-equal to ``ref`` (the
    uninterrupted stream's BAM and junctions.tab), the second equal in
    its records (a lagging BAM resume puts the same records in other
    BGZF blocks) and its junctions.tab. Returns both crashes."""
    from . import stream

    res = {}
    for tag, more, lag in (("c0", ("--ckpt-interval", "0"), 0),
                           ("c2", ("--ckpt-interval", "2", "--batch",
                                   str(lag_batch)), 2)):
        cfg = stream_cfg(prefix, r1, r2, out, tag, threads, (*extra, *more))
        with contextlib.redirect_stderr(io.StringIO()):
            r = res[tag] = stream.crash_and_resume(idx, cfg, n_files, device,
                                                   engine, per_file, lag, *at)
        r["resumed"] = {k: v for k, v in r["resumed"].items()
                        if k not in ("log", "engine")}
        same_outputs((cfg.output_file, cfg.sj_file), ref,
                     f"({tag}) the crashed and resumed stream against (b)",
                     decompress=lag > 0)
        os.remove(cfg.output_file)
    return res


def check_two_processes(prefix: str, r1: str, r2: str, out: str, device,
                        one, threads: int = 4, timeout: int = 1200) -> dict:
    """(d): ``dart-tpu-torch --dist-nprocs 2`` (gloo) with ``CONFIG5``'s
    flags, ``-bo``, ``-t threads``, both processes on ``device``: the
    merged BAM and junctions.tab byte-equal to ``one``'s (one process's
    run). Each process logs its engine's layout cache ("[stats] engine"
    with ``--stats``); returns each one's, and the wall with start-up."""
    os.makedirs(out, exist_ok=True)
    files = (os.path.join(out, "d_two.bam"), os.path.join(out, "d_two.tab"))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    port, hold = held_port()  # held until both processes are done
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "dart_tpu_torch.cli", "-i", prefix, "-f", r1,
         "-f2", r2, *CONFIG5, "-bo", files[0], "-j", files[1], "-t",
         str(threads), "-silent", "--stats", "--device", str(device),
         "--dist-coordinator", f"127.0.0.1:{port}", "--dist-nprocs", "2",
         "--dist-pid", str(pid)], env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True) for pid in range(2)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=timeout)[1])
    finally:
        hold.close()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for pid, (p, err) in enumerate(zip(procs, errs)):
        _require(p.returncode == 0, f"(d) process {pid} exited "
                 f"{p.returncode}:\n{err[-3000:]}")
    caches = [re.findall(r"\[stats\] engine (\S+), layout cache (\S+)", e)
              for e in errs]
    _require(all(len(c) == 1 for c in caches), "(d) a process logged no "
             "engine line")
    same_outputs(files, one, "(d) two processes against one")
    return {"wall_s": wall, "engines": [c[0] for c in caches]}


def check_max_intron(idx, prefix: str, r1: str, r2: str, out: str, device,
                     heads, base, values=(100_000, 1_000_000),
                     threads: int = 4, wide: bool | None = None) -> dict:
    """(e): ``-max_intron`` at each of ``values`` with ``CONFIG5``'s flags
    on the whole pair of files: the outputs must differ from ``base``'s
    (the run without the flag), the head pairs (``heads``) byte-equal to
    the CPU path. Returns each run and its heads."""
    res = {}
    for mi in values:
        flags = (*CONFIG5, "-max_intron", str(mi))
        tag = f"e{mi}"
        r = res[mi] = align_pairs(idx, prefix, r1, r2, out, tag, device,
                                  flags, threads, wide)
        with gzip.open(r["files"][0], "rb") as fa, \
                gzip.open(base[0], "rb") as fb:
            _require(fa.read() != fb.read(), f"({tag}) -max_intron {mi} "
                     "changed no record")
        r["heads"] = held_to_cpu(idx, prefix, heads, out, tag, device, flags,
                                 wide)
    return res
