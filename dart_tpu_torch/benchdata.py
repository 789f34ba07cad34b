"""The bench's data sets: synthetic genomes, planted genes, simulated
RNA-seq reads and the port's index of each, generated from fixed seeds
into a work directory (``bench_dir()``: ``DART_TPU_BENCH_DIR``, default
``chip_smoke_work/`` at the root of the checkout, where ``chip_smoke.py``
makes the same sets). Files that exist are kept, and each index's build
seconds are stored in its directory's ``meta.json``.

The generators of ``tools/make_fixtures.py`` that the sets use are
copied here (``revcomp`` to ``write_reads_fastq``), so that the port
needs neither ``tools/`` nor the root ``bench.py``: the same seed gives
the same bytes. ``CONFIGS`` describes each set:

- ``genome``: ``bench_genome``'s chromosomes (seed ``SEED``) with genes
  planted on chr1, and ``n_reads`` single-end reads (70% genomic, 30%
  cut from the genes' transcripts, 0.5% mismatches, seed ``SEED + 1``)
  or, when ``paired``, genomic pairs (``sim_reads_paired``, seed
  ``SEED + 1``);
- ``genome_of``: ``spliced_pair_set``'s pairs (seed ``SEED + 2``) on
  another set's genome and genes, whose index it reuses;
- ``gbp``: ``crossing.write_spliced_genome``'s long-intron genome with
  chrDup and ``spliced_pair_set``'s pairs (seed ``SEED + 3``);
- ``prebuilt``: files another tool writes under the work directory
  (``dir``, ``reads``), never generated here;
- ``prefix`` and ``reads``: a set given by its files, which must exist.
"""

from __future__ import annotations

import gzip
import io
import json
import os
import random
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 20260816
READ_LEN = 100
MIX = 0.005  # the mismatch rate of every simulated read
INDEX_EXTS = (".bwt", ".pac", ".ann", ".amb", ".sa")

CONFIGS = {
    "8mbp_se": {
        "genome": {"chr1": 5_000_000, "chr2": 3_000_000},
        "n_reads": 100_000, "paired": False, "bam": False,
        "passes": 10, "time_ref_build": True, "flags": ["-mis", "5"],
    },
    "50mbp_se": {
        "genome": {"chr1": 30_000_000, "chr2": 20_000_000},
        "n_reads": 100_000, "paired": False, "bam": False,
        "passes": 6, "time_ref_build": True, "flags": ["-mis", "5"],
    },
    "8mbp_pe_bam": {
        "genome": {"chr1": 5_000_000, "chr2": 3_000_000},
        "n_reads": 100_000, "paired": True, "bam": True,
        "passes": 6, "flags": ["-mis", "5"],
    },
    "grch38_pe_bam": {
        # made by tools/prep_flagship.py: a 3.09 Gbp genome, 50,000 pairs
        # and its wide index, hours of build; skipped when absent
        "prebuilt": True, "dir": "grch38_pe_bam", "ready_flag": True,
        "reads": ("reads_100000_1.fq", "reads_100000_2.fq"),
        "n_reads": 100_000, "paired": True, "bam": True,
        "passes": 4, "wall_budget_s": 3600, "flags": ["-mis", "5"],
        "made_by": "tools/prep_flagship.py",
    },
    "big_sp": {
        # chip_smoke.py --big's 1.1 Gbp genome past 2^31 and its 100,000
        # spliced pairs; the wide engine from a layout-cache hit
        "prebuilt": True, "dir": "big",
        "reads": ("big_sp_100000_1.fq", "big_sp_100000_2.fq"),
        "n_reads": 200_000, "paired": True, "bam": True, "wide": True,
        "passes": 4, "flags": ["-all_sj", "-m", "-mis", "5", "-t", "4"],
        "made_by": "python3 chip_smoke.py --big",
    },
    "8mbp_sp": {
        "genome_of": "8mbp_se", "seed": SEED + 2,
        "n_reads": 100_000, "paired": True, "bam": False,
        "passes": 6, "flags": ["-mis", "5", "-t", "1"],
    },
    "12mbp_li": {
        # three chromosomes of 4 Mbp with genes of introns to 900 kb,
        # and chrDup, chr1's first Mbp again
        "gbp": 0.012, "n_chrom": 3, "dup_bp": 1_000_000, "seed": SEED + 3,
        "n_reads": 100_000, "paired": True, "bam": False,
        "passes": 6, "flags": ["-mis", "5", "-t", "1"],
    },
}

# ---- tools/make_fixtures.py's generators ----

BASES = "ACGT"
COMP = str.maketrans("ACGTN", "TGCAN")


def revcomp(s: str) -> str:
    return s.translate(COMP)[::-1]


def wrap(seq: str, width: int = 70) -> str:
    return "\n".join(seq[i : i + width] for i in range(0, len(seq), width))


def make_genome(rng: random.Random, chrom_lens: dict[str, int], n_runs: int = 2) -> dict[str, str]:
    out = {}
    for name, ln in chrom_lens.items():
        seq = [rng.choice(BASES) for _ in range(ln)]
        for _ in range(n_runs):
            start = rng.randrange(ln - 60)
            for i in range(start, start + rng.randrange(5, 40)):
                seq[i] = "N"
        out[name] = "".join(seq)
    return out


def plant_genes(rng: random.Random, chrom: str, n_genes: int, exons=(80, 220), introns=(60, 8000)):
    """Pick gene structures on a chromosome: lists of exon (start, end).
    Donor/acceptor motifs GT..AG are stamped into the sequence."""
    seq = list(chrom)
    genes = []
    cursor = 200
    limit = len(chrom) - 5000
    for _ in range(n_genes):
        n_ex = rng.randrange(2, 5)
        exs = []
        overrun = False
        for e in range(n_ex):
            elen = rng.randrange(*exons)
            if cursor + elen >= limit:
                overrun = True
                break
            exs.append((cursor, cursor + elen))
            cursor += elen
            if e < n_ex - 1:
                ilen = rng.randrange(*introns)
                if cursor + ilen >= limit:
                    overrun = True
                    break
                # stamp canonical GT/AG at intron ends
                seq[cursor] = "G"
                seq[cursor + 1] = "T"
                seq[cursor + ilen - 2] = "A"
                seq[cursor + ilen - 1] = "G"
                cursor += ilen
        if len(exs) >= 2:
            genes.append(exs)
        if overrun or cursor > limit:
            break
        cursor += rng.randrange(500, 1500)
    return "".join(seq), genes


def sim_reads_genomic(rng, genome, n, rlen, mismatch_rate=0.0, tag="r"):
    """Uniform genomic single-end reads (both strands)."""
    names = sorted(genome)
    reads = []
    for i in range(n):
        chrom = rng.choice(names)
        seq = genome[chrom]
        pos = rng.randrange(len(seq) - rlen)
        frag = seq[pos : pos + rlen]
        strand = rng.random() < 0.5
        if strand:
            frag = revcomp(frag)
        frag = mutate(rng, frag, mismatch_rate)
        reads.append((f"{tag}{i}_{chrom}:{pos+1}-{pos+rlen}{'_R' if strand else '_F'}", frag))
    return reads


def mutate(rng, seq, rate):
    if rate <= 0:
        return seq
    s = list(seq)
    for i in range(len(s)):
        if s[i] != "N" and rng.random() < rate:
            s[i] = rng.choice([b for b in BASES if b != s[i]])
    return "".join(s)


def sim_reads_spliced(rng, chrom_name, chrom_seq, genes, n, rlen, mismatch_rate=0.0, tag="s"):
    """Reads sampled from spliced transcripts (exon concatenations)."""
    reads = []
    transcripts = []
    for exs in genes:
        t = "".join(chrom_seq[a:b] for a, b in exs)
        transcripts.append((t, exs))
    for i in range(n):
        t, exs = transcripts[rng.randrange(len(transcripts))]
        if len(t) <= rlen:
            continue
        pos = rng.randrange(len(t) - rlen)
        frag = t[pos : pos + rlen]
        strand = rng.random() < 0.5
        if strand:
            frag = revcomp(frag)
        frag = mutate(rng, frag, mismatch_rate)
        reads.append((f"{tag}{i}_{chrom_name}:t{pos}{'_R' if strand else '_F'}", frag))
    return reads


def sim_reads_paired(rng, genome, n, rlen, insert=(200, 500), mismatch_rate=0.0, tag="p"):
    names = sorted(genome)
    r1, r2 = [], []
    for i in range(n):
        chrom = rng.choice(names)
        seq = genome[chrom]
        isz = rng.randrange(*insert)
        pos = rng.randrange(len(seq) - isz)
        frag = seq[pos : pos + isz]
        a = mutate(rng, frag[:rlen], mismatch_rate)
        b = mutate(rng, revcomp(frag[-rlen:]), mismatch_rate)
        r1.append((f"{tag}{i}_{chrom}:{pos+1}", a))
        r2.append((f"{tag}{i}_{chrom}:{pos+1}", b))
    return r1, r2


def write_fasta(path, entries, width=70):
    with open(path, "w") as f:
        for name, seq in entries:
            f.write(f">{name}\n{wrap(seq, width)}\n")


def write_reads_fastq(path, reads, gz=False):
    if gz:
        # mtime=0 keeps regeneration byte-identical
        raw = io.BytesIO()
        with gzip.GzipFile(fileobj=raw, mode="wb", mtime=0) as f:
            for name, seq in reads:
                f.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n".encode())
        with open(path, "wb") as out:
            out.write(raw.getvalue())
        return
    with open(path, "w") as f:
        for name, seq in reads:
            f.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")


# ---- the bench's read mixes ----


def bench_genome(spec: dict):
    """The genome of config ``spec`` (seed SEED, its chromosomes, genes
    planted on chr1): ({name: sequence}, [exons of each gene])."""
    rng = random.Random(SEED)
    genome = make_genome(rng, spec["genome"], n_runs=4)
    n_genes = max(50, sum(spec["genome"].values()) // 50000)
    genome["chr1"], genes = plant_genes(rng, genome["chr1"], n_genes=n_genes)
    return genome, genes


def write_pairs(fqs, pairs) -> None:
    """Mates 1 and 2 as FASTQ files, each written whole or not at all."""
    for path, reads in zip(fqs, pairs):
        write_reads_fastq(path + ".tmp", reads)
    for path in fqs:
        os.replace(path + ".tmp", path)


def read_genes(path: str) -> list:
    """A ``genes.txt`` (``chrom<TAB>start-end,...``, ``plant_genes``'
    exons, 0-based, end exclusive) as [(chrom, [(start, end), ...])]."""
    with open(path) as f:
        return [(chrom, [tuple(map(int, p.split("-")))
                         for p in exons.split(",")])
                for chrom, exons in (line.rstrip("\n").split("\t")
                                     for line in f if line.strip())]


def read_genome(fa: str, skip: str | None = None) -> dict:
    """A FASTA file's sequences by name (bench.py's ``_read_genome``),
    without the sequence named ``skip`` (reads simulated from the rest
    map twice where chrDup copies them, as users' reads from a
    duplicated region do)."""
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
    genome.pop(skip, None)
    return genome


def sim_pairs_spliced(rng, genome: dict, genes: list, n: int, rlen: int,
                      insert=(200, 500), mismatch_rate: float = 0.0,
                      tag: str = "s"):
    """n read pairs cut from spliced transcripts, as ``sim_reads_paired``
    cuts them from the genome: a fragment of a transcript (a gene's exons
    concatenated; ``genes`` as ``read_genes`` gives them) of a length
    uniform in ``insert``, capped at the transcript's, from either
    strand; mate 1 is its first rlen bases and mate 2 the reverse
    complement of its last rlen, each with ``mismatch_rate``
    substitutions. Transcripts shorter than the least insert are
    skipped. Both mates are named ``{tag}{i}_{chrom}:t{pos}_F|R`` (pos:
    the fragment's offset in the transcript). Returns (mates 1, mates
    2) as lists of (name, sequence)."""
    transcripts = [(chrom, "".join(genome[chrom][a:b] for a, b in exs))
                   for chrom, exs in genes]
    transcripts = [t for t in transcripts if len(t[1]) >= insert[0]]
    r1, r2 = [], []
    for i in range(n):
        chrom, t = transcripts[rng.randrange(len(transcripts))]
        isz = min(rng.randrange(*insert), len(t))
        pos = rng.randrange(len(t) - isz + 1)
        frag = t[pos:pos + isz]
        strand = rng.random() < 0.5
        if strand:
            frag = revcomp(frag)
        name = f"{tag}{i}_{chrom}:t{pos}{'_R' if strand else '_F'}"
        r1.append((name, mutate(rng, frag[:rlen], mismatch_rate)))
        r2.append((name, mutate(rng, revcomp(frag[-rlen:]), mismatch_rate)))
    return r1, r2


def spliced_pair_set(rng, genome: dict, genes: list, n: int, rlen: int,
                     mismatch_rate: float = MIX):
    """8mbp_se's read mix as pairs: 70% genomic pairs
    (``sim_reads_paired``, tag "g") and 30% spliced ones
    (``sim_pairs_spliced``), shuffled together: (mates 1, mates 2)."""
    n_sp = n * 3 // 10
    g1, g2 = sim_reads_paired(rng, genome, n - n_sp, rlen,
                              mismatch_rate=mismatch_rate, tag="g")
    s1, s2 = sim_pairs_spliced(rng, genome, genes, n_sp, rlen,
                               mismatch_rate=mismatch_rate)
    pairs = list(zip(g1 + s1, g2 + s2))
    rng.shuffle(pairs)
    return [a for a, _ in pairs], [b for _, b in pairs]


def se_reads(genome: dict, genes: list, n: int):
    """The single-end mix of ``n`` reads (seed SEED + 1): 70% genomic,
    30% cut from the transcripts of ``genes`` (exon lists on chr1),
    shuffled together."""
    rng = random.Random(SEED + 1)
    n_spliced = n * 3 // 10
    reads = sim_reads_genomic(rng, genome, n - n_spliced, READ_LEN, MIX,
                              tag="g")
    reads += sim_reads_spliced(rng, "chr1", genome["chr1"], genes, n_spliced,
                               READ_LEN, MIX, tag="s")
    rng.shuffle(reads)
    return reads


# ---- the data sets ----


def bench_dir() -> str:
    """Where the data sets live: ``DART_TPU_BENCH_DIR`` (``bench.py``'s
    name), else ``chip_smoke_work`` at the root of the checkout."""
    return os.environ.get("DART_TPU_BENCH_DIR",
                          os.path.join(REPO, "chip_smoke_work"))


def read_meta(d: str) -> dict:
    p = os.path.join(d, "meta.json")
    if not os.path.exists(p):
        return {}
    with open(p) as f:
        return json.load(f)


def write_meta(d: str, meta: dict) -> None:
    p = os.path.join(d, "meta.json")
    with open(p + ".tmp", "w") as f:
        json.dump(meta, f)
    os.replace(p + ".tmp", p)


def build_timed(fa: str, prefix: str) -> float:
    """The port's index of ``fa`` at ``prefix``, its seconds stored in
    ``meta.json`` beside it as ``index_build_s``."""
    from .index import build_index

    t0 = time.perf_counter()
    build_index(fa, prefix)
    secs = time.perf_counter() - t0
    d = os.path.dirname(prefix)
    write_meta(d, {**read_meta(d), "index_build_s": secs})
    return secs


def make_dataset(name: str = "8mbp_se", work: str | None = None,
                 spec: dict | None = None) -> dict:
    """Config ``name``'s genome, reads and index under ``work`` (default
    ``bench_dir()``) as ``spec`` (default ``CONFIGS[name]``) describes
    them; files that exist are kept. Returns {"fq": (reads, None) or
    (mates 1, mates 2), "prefix", "dir"} ("genes" too for a ``gbp``
    set). A ``prebuilt`` set is not made here: see ``bench``."""
    work = work or bench_dir()
    spec = CONFIGS[name] if spec is None else spec
    if "genome_of" in spec:
        return make_spliced_pairs(name, work, spec)
    if "gbp" in spec:
        return make_long_introns(name, work, spec)
    if spec.get("prebuilt") or "genome" not in spec:
        raise ValueError(f"{name}: not a data set made here")
    d = os.path.join(work, name)
    fa = os.path.join(d, "genome.fa")
    prefix = os.path.join(d, "idx")
    n = spec["n_reads"]
    fq = os.path.join(d, f"reads_{n}.fq")
    fqs = ((os.path.join(d, f"reads_{n}_1.fq"),
            os.path.join(d, f"reads_{n}_2.fq")) if spec["paired"]
           else (fq, None))
    os.makedirs(d, exist_ok=True)
    if not os.path.exists(fa):
        genome, genes = bench_genome(spec)
        with open(os.path.join(d, "genes.txt"), "w") as f:
            for exs in genes:
                f.write("chr1\t" + ",".join(f"{a}-{b}" for a, b in exs)
                        + "\n")
        write_fasta(fa + ".tmp", sorted(genome.items()))
        os.replace(fa + ".tmp", fa)
    if spec["paired"] and not os.path.exists(fqs[1]):
        rng = random.Random(SEED + 1)
        write_pairs(fqs, sim_reads_paired(rng, read_genome(fa), n // 2,
                                          READ_LEN, mismatch_rate=MIX))
    if not spec["paired"] and not os.path.exists(fq):
        genes = [exs for _, exs in read_genes(os.path.join(d, "genes.txt"))]
        write_reads_fastq(fq + ".tmp", se_reads(read_genome(fa), genes, n))
        os.replace(fq + ".tmp", fq)
    if not os.path.exists(prefix + ".bwt"):
        build_timed(fa, prefix)
    return {"fq": fqs, "prefix": prefix, "dir": d}


def make_spliced_pairs(name: str = "8mbp_sp", work: str | None = None,
                       spec: dict | None = None) -> dict:
    """``spec``'s n_reads / 2 pairs of 100 bases (``spliced_pair_set``,
    0.5% mismatches, seed ``spec["seed"]``) on the genome and genes of
    set ``spec["genome_of"]``, read from its files when they are there,
    else made again from its seed in memory (so that a child process can
    start before that set's files are written). It reuses that set's
    index: nothing new is built. Returns a data set dict as
    ``make_dataset`` does."""
    work = work or bench_dir()
    spec = CONFIGS[name] if spec is None else spec
    of = spec["genome_of"]
    se = os.path.join(work, of)
    d = os.path.join(work, name)
    n = spec["n_reads"] // 2
    fqs = (os.path.join(d, f"pairs_{n}_1.fq"),
           os.path.join(d, f"pairs_{n}_2.fq"))
    if not os.path.exists(fqs[1]):
        os.makedirs(d, exist_ok=True)
        fa = os.path.join(se, "genome.fa")
        if os.path.exists(fa):  # genes.txt is written before it
            genome = read_genome(fa)
            genes = read_genes(os.path.join(se, "genes.txt"))
        else:
            genome, exons = bench_genome(CONFIGS[of])
            genes = [("chr1", exs) for exs in exons]
        write_pairs(fqs, spliced_pair_set(random.Random(spec["seed"]), genome,
                                          genes, n, READ_LEN))
    return {"fq": fqs, "prefix": os.path.join(se, "idx"), "dir": d}


def make_long_introns(name: str = "12mbp_li", work: str | None = None,
                      spec: dict | None = None) -> dict:
    """``crossing.write_spliced_genome`` at ``spec["gbp"]`` in
    ``n_chrom`` chromosomes (genes with introns of 60-8,000,
    100,001-450,000 and 520,000-900,000 bases, seed 42) plus chrDup (chr1's
    first ``dup_bp`` bases), indexed by the port's builder, and n_reads
    / 2 pairs of 100 bases from ``spliced_pair_set`` (0.5% mismatches,
    seed ``spec["seed"]``) simulated without chrDup. Files that exist
    are kept. Returns a data set dict as ``make_dataset`` does, with the
    genes under "genes"."""
    from . import crossing

    work = work or bench_dir()
    spec = CONFIGS[name] if spec is None else spec
    d = os.path.join(work, name)
    fa, genes_txt = os.path.join(d, "genome.fa"), os.path.join(d, "genes.txt")
    prefix = os.path.join(d, "idx")
    n = spec["n_reads"] // 2
    fqs = (os.path.join(d, f"pairs_{n}_1.fq"),
           os.path.join(d, f"pairs_{n}_2.fq"))
    os.makedirs(d, exist_ok=True)
    if not os.path.exists(fa):
        crossing.write_spliced_genome(fa, genes_txt, spec["gbp"],
                                      n_chrom=spec["n_chrom"],
                                      dup_bp=spec["dup_bp"])
    genes = read_genes(genes_txt)
    if not os.path.exists(fqs[1]):
        write_pairs(fqs, spliced_pair_set(
            random.Random(spec["seed"]), read_genome(fa, skip="chrDup"),
            genes, n, READ_LEN))
    if not os.path.exists(prefix + ".bwt"):
        build_timed(fa, prefix)
    return {"fq": fqs, "prefix": prefix, "dir": d, "genes": genes}
