"""The one read generator: a traffic mix's parameters and a genome in, a
pool of distinct reads out, with each read's origin.

A mix (``traffic/<name>.json``) gives:

- ``paired``: pairs of mates (a fragment of ``insert`` bases, uniform
  in [least, most), capped at its transcript; mate 1 its first
  ``read_len`` bases and mate 2 the reverse complement of its last, on
  a strand drawn for each fragment) or single reads (either strand);
- ``read_len``, ``mismatch`` (each base substituted at this rate);
- ``spliced_share``: the share cut from the planted genes' transcripts
  (exons concatenated), so that reads cross introns; the rest is cut
  from the genome, from every chromosome but a copy, by length;
- ``format`` (``fastq``, every quality ``I``, or ``fasta``), ``gzip``
  (and ``gzip_level``), ``files`` and ``file_fragments``: the pool is
  ``files`` files (pairs of files) of ``file_fragments`` reads (pairs);
- ``output`` (``sam`` or ``bam``): what the window writes.

These are the read mixes of ``dart_tpu_torch/benchdata.py``
(``sim_reads_genomic``, ``sim_reads_paired``, ``sim_pairs_spliced``,
``spliced_pair_set``) drawn in NumPy, whole arrays at a time, with two
changes: genomic pairs take a strand as spliced ones do, and every read
name is 32 characters, ``r<id:09d>_<left:010d>_<right:010d>`` (the
fragment's first and last genome position, 1-based), so that the files
are built as fixed-width rows. The seed decides the reads alone.
"""

from __future__ import annotations

import gzip
import os

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
CODE = np.zeros(256, dtype=np.uint8)
CODE[np.frombuffer(b"ACGT", dtype=np.uint8)] = np.arange(4, dtype=np.uint8)
COMP = np.arange(256, dtype=np.uint8)
COMP[np.frombuffer(b"ACGTN", dtype=np.uint8)] = np.frombuffer(
    b"TGCAN", dtype=np.uint8)
NAME_LEN = 32


def revcomp(rows: np.ndarray) -> np.ndarray:
    """Reverse complements of uint8 ASCII rows."""
    return COMP[rows[:, ::-1]]


class Pool:
    """``n`` fragments: ``seq`` (mates, each (n, read_len) uint8 ASCII),
    ``chrom`` (index into the genome's ``names``), ``left`` / ``right``
    (each mate's first and last genome position, 1-based, each (n,)),
    ``frag`` ((n, 2) the fragment's), ``spliced`` ((n,) bool)."""

    def __init__(self, seq, chrom, left, right, frag, spliced):
        self.seq, self.chrom, self.left, self.right = seq, chrom, left, right
        self.frag, self.spliced = frag, spliced
        self.n = int(chrom.shape[0])
        self._names = None

    def names(self) -> np.ndarray:
        """Each fragment's name as (n, NAME_LEN) uint8 ASCII."""
        if self._names is None:
            u = np.full((self.n, 1), ord("_"), dtype=np.uint8)
            self._names = np.concatenate(
                [np.full((self.n, 1), ord("r"), dtype=np.uint8),
                 digits(np.arange(self.n), 9), u, digits(self.frag[:, 0], 10),
                 u, digits(self.frag[:, 1], 10)], axis=1)
        return self._names


def digits(x: np.ndarray, width: int) -> np.ndarray:
    """Each number of ``x`` in ``width`` decimal digits, as uint8 ASCII
    rows."""
    scale = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    return ((x.astype(np.int64)[:, None] // scale) % 10 + 48).astype(np.uint8)


def windows(seq: np.ndarray, starts: np.ndarray, width: int) -> np.ndarray:
    """Rows seq[s:s + width] for each start, copied."""
    return np.lib.stride_tricks.sliding_window_view(seq, width)[starts]


def mutate(rng, rows: np.ndarray, rate: float) -> None:
    """Substitute each base of ``rows`` in place with probability
    ``rate`` by one of the three others (a Bernoulli process drawn as
    geometric gaps, so that no base is hit twice)."""
    if rate <= 0:
        return
    flat = rows.reshape(-1)
    n = flat.shape[0]
    at = np.cumsum(rng.geometric(rate, int(n * rate * 1.2) + 64)) - 1
    while at[-1] < n:  # too few gaps drawn: draw on from the last
        at = np.concatenate([at, at[-1] + np.cumsum(
            rng.geometric(rate, int(n * rate * 0.2) + 64))])
    at = at[at < n]
    flat[at] = ACGT[(CODE[flat[at]] + rng.integers(1, 4, at.shape[0]))
                    & 3]


def _transcripts(genome):
    """The genes' transcripts laid end to end: (bases, genome position of
    each base, chromosome index of each transcript, each transcript's
    offset and length)."""
    bases, pos, chrom, off, ln = [], [], [], [], []
    at = 0
    for c, exs in genome.genes:
        p = np.concatenate([np.arange(a, b, dtype=np.int64) for a, b in exs])
        pos.append(p)
        bases.append(genome.seqs[c][p])
        chrom.append(genome.names.index(c))
        off.append(at)
        ln.append(p.shape[0])
        at += p.shape[0]
    return (np.concatenate(bases), np.concatenate(pos), np.array(chrom),
            np.array(off, dtype=np.int64), np.array(ln, dtype=np.int64))


def _genomic(rng, genome, n, size):
    """n fragments of ``size`` bases (an (n,) array) from the source
    chromosomes, drawn by length: (bases, genome position of each base's
    row start, chromosome index)."""
    src = genome.sources
    lens = np.array([genome.seqs[c].shape[0] for c in src], dtype=np.int64)
    which = rng.choice(len(src), n, p=lens / lens.sum())
    start = (rng.random(n) * (lens[which] - size)).astype(np.int64)
    chrom = np.array([genome.names.index(c) for c in src])[which]
    return which, start, chrom


def make_pool(genome, mix: dict, seed: int) -> Pool:
    """The mix's whole pool (``files`` x ``file_fragments`` fragments)
    from ``seed``: the same seed gives the same pool."""
    rng = np.random.default_rng(seed)
    n = int(mix["files"]) * int(mix["file_fragments"])
    rl = int(mix["read_len"])
    paired = bool(mix["paired"])
    n_sp = int(round(n * float(mix.get("spliced_share", 0))))
    if n_sp and not genome.genes:
        raise ValueError("a spliced share needs a genome with genes")
    lo, hi = mix.get("insert", (rl, rl + 1)) if paired else (rl, rl + 1)
    size = rng.integers(lo, hi, n).astype(np.int64)
    spliced = np.zeros(n, dtype=bool)
    spliced[rng.permutation(n)[:n_sp]] = True
    strand = rng.random(n) < 0.5
    head = np.empty((n, rl), dtype=np.uint8)  # the fragment's first bases
    tail = np.empty((n, rl), dtype=np.uint8)  # and its last, forward
    left = np.empty((n, 2), dtype=np.int64)  # head's, tail's first base
    right = np.empty((n, 2), dtype=np.int64)
    chrom = np.empty(n, dtype=np.int64)
    g = np.flatnonzero(~spliced)
    which, start, chrom[g] = _genomic(rng, genome, g.shape[0], size[g])
    for k, c in enumerate(genome.sources):
        sel = which == k
        rows, s, z = g[sel], start[sel], size[g][sel]
        head[rows] = windows(genome.seqs[c], s, rl)
        tail[rows] = windows(genome.seqs[c], s + z - rl, rl)
        left[rows, 0], right[rows, 0] = s + 1, s + rl
        left[rows, 1], right[rows, 1] = s + z - rl + 1, s + z
    s = np.flatnonzero(spliced)
    if s.shape[0]:
        tb, tp, tc, toff, tlen = _transcripts(genome)
        keep = np.flatnonzero(tlen >= lo)
        t = keep[rng.integers(0, keep.shape[0], s.shape[0])]
        z = np.minimum(size[s], tlen[t])
        size[s] = z
        p = toff[t] + (rng.random(s.shape[0]) * (tlen[t] - z + 1)).astype(
            np.int64)
        head[s] = windows(tb, p, rl)
        tail[s] = windows(tb, p + z - rl, rl)
        chrom[s] = tc[t]
        left[s, 0], right[s, 0] = tp[p] + 1, tp[p + rl - 1] + 1
        left[s, 1], right[s, 1] = tp[p + z - rl] + 1, tp[p + z - 1] + 1
    frag = np.stack([left[:, 0], right[:, 1]], axis=1)
    if paired:
        # forward strand: mate 1 the head, mate 2 the tail's reverse
        # complement; reverse strand: mate 1 the tail's, mate 2 the head
        rc = revcomp(tail)
        m1 = np.where(strand[:, None], rc, head)
        m2 = np.where(strand[:, None], head, rc)
        seq = [m1, m2]
        first = np.where(strand, 1, 0)
        lft = np.stack([left[np.arange(n), first],
                        left[np.arange(n), 1 - first]], axis=1)
        rgt = np.stack([right[np.arange(n), first],
                        right[np.arange(n), 1 - first]], axis=1)
    else:
        seq = [np.where(strand[:, None], revcomp(head), head)]
        lft, rgt = left[:, :1], right[:, :1]
    for m in seq:
        mutate(rng, m, float(mix["mismatch"]))
    return Pool(seq, chrom, lft, rgt, frag, spliced)


def records(pool: Pool, mate: int, fmt: str, lo: int = 0,
            hi: int | None = None) -> bytes:
    """Fragments lo..hi of mate ``mate`` as FASTQ or FASTA text, built as
    fixed-width rows."""
    hi = pool.n if hi is None else hi
    seq = pool.seq[mate][lo:hi]
    n, rl = seq.shape
    names = pool.names()[lo:hi]
    nl = np.full((n, 1), ord("\n"), dtype=np.uint8)
    if fmt == "fasta":
        parts = [np.full((n, 1), ord(">"), dtype=np.uint8), names, nl, seq,
                 nl]
    else:
        parts = [np.full((n, 1), ord("@"), dtype=np.uint8), names, nl, seq,
                 nl, np.full((n, 1), ord("+"), dtype=np.uint8), nl,
                 np.full((n, rl), ord("I"), dtype=np.uint8), nl]
    return np.concatenate(parts, axis=1).tobytes()


def write_files(pool: Pool, mix: dict, out_dir: str, tag: str = "pool",
                n_files: int | None = None) -> list:
    """The pool as the mix's files in ``out_dir``: a list of (mate 1 path,
    mate 2 path or None), one entry a file of ``file_fragments``
    fragments (``n_files`` of them, default the mix's ``files``)."""
    fmt = mix["format"]
    ext = {"fastq": ".fq", "fasta": ".fa"}[fmt] + (".gz" if mix.get("gzip")
                                                     else "")
    per = int(mix["file_fragments"])
    n_files = int(mix["files"]) if n_files is None else n_files
    paths = []
    for k in range(n_files):
        pair = []
        for mate in range(len(pool.seq)):
            path = os.path.join(out_dir, f"{tag}_{k}_{mate + 1}{ext}")
            data = records(pool, mate, fmt, k * per, (k + 1) * per)
            if mix.get("gzip"):
                data = gzip.compress(data, int(mix.get("gzip_level", 6)),
                                     mtime=0)
            with open(path, "wb") as f:
                f.write(data)
            pair.append(path)
        paths.append((pair[0], pair[1] if len(pair) > 1 else None))
    return paths
