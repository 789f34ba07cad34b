"""A configuration's genome, made from the configuration's own seed.

A deployment's reference genome is fixed, so each configuration fixes
its genome by ``genome.seed``: uniform random bases at the published
chromosome lengths, genes planted on them (2-4 exons, intron lengths
drawn from a log-normal law, GT..AG stamped at every intron's ends)
and, where the
configuration asks for it, a copy of a chromosome's start appended as a
chromosome of its own, so that reads from there map twice. The same
configuration gives the same bases and genes in every run, and the
harness keeps the port's index of it in a cache that later runs reuse.

The gene drawing is a copy of ``dart_tpu_torch.crossing``'s
``draw_genes`` and ``stamp_genes``, taking its sizes from the
configuration, with the intron lengths drawn from a log-normal law of
a stated median and mean in place of ``crossing``'s bands. This module imports NumPy alone, so that the reference
(``refcheck``) may use the same genome.
"""

from __future__ import annotations

import hashlib
import json
import math
import os

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
LINE = 1 << 24  # bases a FASTA line


class Genome:
    """Chromosomes in FASTA order (``names``; ``seqs``: name -> uint8 ASCII
    array), the planted genes ([(chrom, [(start, end), ...])], 0-based,
    end exclusive), the chromosomes reads are drawn from (``sources``:
    every chromosome but a copy) and the configuration's digest."""

    def __init__(self, names, seqs, genes, sources, digest):
        self.names = list(names)
        self.seqs = seqs
        self.genes = genes
        self.sources = list(sources)
        self.digest = digest


def digest(spec: dict) -> str:
    """A digest of the genome's part of a configuration and of this file,
    so that a cached index is rebuilt when either changes."""
    h = hashlib.sha256(json.dumps(spec, sort_keys=True).encode())
    with open(os.path.abspath(__file__), "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def intron_lengths(rng, n: int, law: dict) -> np.ndarray:
    """n intron lengths from the log-normal law of ``law``'s ``median``
    and ``mean`` (so sigma^2 = 2 ln(mean / median)), each length outside
    [``least``, ``most``] drawn again."""
    mu = math.log(law["median"])
    sigma = math.sqrt(2 * math.log(law["mean"] / law["median"]))
    out = np.zeros(n, dtype=np.int64)
    todo = np.arange(n)
    while todo.shape[0]:
        x = np.rint(rng.lognormal(mu, sigma, todo.shape[0])).astype(np.int64)
        fit = (x >= law["least"]) & (x <= law["most"])
        out[todo[fit]] = x[fit]
        todo = todo[~fit]
    return out


def draw_genes(rng, lengths: dict, n_genes: int, introns: dict,
               exon_len) -> list:
    """n_genes gene structures of 2-4 exons of ``exon_len`` bases, each on
    a chromosome drawn by its length at a uniform start between 200
    bases in and 5,000 before its end; the intron lengths drawn by
    ``intron_lengths`` from the law ``introns``. A gene that does not
    fit its chromosome is dropped."""
    margin, tail = 200, 5000
    names = list(lengths)
    size = np.array([lengths[c] for c in names], dtype=np.int64)
    n_ex = rng.integers(2, 5, n_genes)
    ex = rng.integers(exon_len[0], exon_len[1], (n_genes, 4))
    introns = intron_lengths(rng, int((n_ex - 1).sum()), introns)
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
    """GT at each intron's first two bases and AG at its last two, stamped
    into ``seqs`` at once; a gene whose stamps would touch another's is
    dropped first. Returns the genes kept."""
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


def make_genome(spec: dict) -> Genome:
    """The genome of a configuration's ``genome`` object:
    ``chromosomes`` (name -> bases), ``seed``, ``genes`` (absent or
    {"per_mbp", "exon_len", "introns"}, the last {"median", "mean",
    "least", "most"}) and ``copy`` (absent or
    {"name", "of", "bases"})."""
    rng = np.random.default_rng(spec["seed"])
    names = list(spec["chromosomes"])
    seqs = {c: ACGT[rng.integers(0, 4, int(n), dtype=np.int8)]
            for c, n in spec["chromosomes"].items()}
    genes = []
    g = spec.get("genes")
    if g:
        total = sum(int(n) for n in spec["chromosomes"].values())
        genes = draw_genes(np.random.default_rng(spec["seed"] + 1),
                           {c: len(s) for c, s in seqs.items()},
                           int(round(g["per_mbp"] * total / 1e6)),
                           g["introns"], g["exon_len"])
        genes = stamp_genes(seqs, genes)
        genes.sort(key=lambda x: (names.index(x[0]), x[1][0][0]))
    sources = list(names)
    cp = spec.get("copy")
    if cp:
        seqs[cp["name"]] = seqs[cp["of"]][:int(cp["bases"])].copy()
        names.append(cp["name"])
    return Genome(names, seqs, genes, sources, digest(spec))


def write_fasta(genome: Genome, path: str) -> None:
    """The genome as FASTA, lines of ``LINE`` bases."""
    with open(path + ".tmp", "wb") as f:
        for name in genome.names:
            seq = genome.seqs[name]
            f.write(b">%s\n" % name.encode())
            for off in range(0, len(seq), LINE):
                f.write(seq[off:off + LINE].tobytes())
                f.write(b"\n")
    os.replace(path + ".tmp", path)
