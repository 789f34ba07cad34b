"""Shared constants mirroring the reference aligner's semantics.

Reference provenance (cited for parity checking, not copied):
- nucleotide code table: Dart's src/BWT_Index/bntseq.c:40-57
- splice-junction motifs: Dart's src/main.cpp:18
- boundary shift search order: Dart's src/AlignmentCandidates.cpp:6
- chunk/kmer constants: Dart's src/structure.h:19-22
"""

import numpy as np

# 2-bit nucleotide encoding: A=0 C=1 G=2 T=3, N/other=4, '-'=5.
# Case-insensitive, matching the reference table exactly.
NT4_TABLE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    NT4_TABLE[ord(_c)] = _i
    NT4_TABLE[ord(_c.lower())] = _i
NT4_TABLE[ord("-")] = 5

BASES = np.frombuffer(b"ACGTN", dtype=np.uint8)

# Splice junction donor/acceptor motifs, tried in this order.
SPLICE_JUNCTIONS = ("GT/AG", "CT/AC", "GC/AG", "CT/GC")

# Junction boundary shift search order (0, +1, -1, ..., +9, -9).
SHIFT_ARR = (0, 1, -1, 2, -2, 3, -3, 4, -4, 5, -5, 6, -6, 7, -7, 8, -8, 9, -9)

# Reads per work chunk / max bases per chunk.
READ_CHUNK_SIZE = 4000
CHUNK_BASE_LIMIT = 1000000

# First-chunk ramp: when the configured chunk is larger than this, the
# FIRST chunk of every file is capped here so the device pipeline
# starts after a few milliseconds of parsing instead of the full
# chunk's worth (the first chunk's parse is the only one that cannot
# overlap device work). Deterministic, so checkpoint resume boundaries
# line up; checkpoints record the value and refuse to resume across a
# change.
RAMP_READS = 4096

KMER_SIZE = 8
KMER_POWER = 0x3FFF

# FM-index layout constants (BWA format).
OCC_INTERVAL = 128  # Occ checkpoint every 128 bases
SA_INTERVAL = 32    # SA sampled every 32 rows

# Seeding thresholds.
MIN_SEED_LEN = 16

MAX_MAPQ = 50

VERSION_STR = "1.4.6"  # reference version mirrored in SAM @PG for parity
