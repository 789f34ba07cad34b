"""Index construction: FASTA -> BWA-compatible .bwt/.sa/.pac/.ann/.amb.

Byte-compatible with indexes produced by the reference `bwt_index`
binary and by stock `bwa index` (the reference aligner accepts those,
Dart's README.md:69-72). The BWT is derived from a suffix
array (native SA-IS) instead of the reference's block-incremental
BWT-SW construction (Dart's src/BWT_Index/bwt_gen.c) — the
resulting BWT is identical because the BWT is unique given the text.

File formats (reference provenance):
- .pac: 2-bit packed forward genome + length trailer (bntseq.c:192-205)
- .ann/.amb: contig / ambiguity metadata (bntseq.c:59-89)
- .bwt: primary, L2[1..4], then BWT words with Occ[4] u64 checkpoints
  interleaved every 128 bases (bwtindex.c:53-75, bwt.c:174-183)
- .sa: primary, L2[1..4], sa_intv, seq_len, then every-32nd SA entry
  from row 32 on (bwt.c:185-196)
"""

from __future__ import annotations

import os

import numpy as np

from ..constants import OCC_INTERVAL, SA_INTERVAL
from . import packer
from .suffix_array import suffix_array


def full_text(pg_codes: np.ndarray) -> np.ndarray:
    """Forward genome codes ++ reverse complement (bntseq.c:184-190)."""
    rc = (3 - pg_codes[::-1]).astype(np.uint8)
    return np.concatenate([pg_codes, rc])


def bwt_from_sa(text: np.ndarray, sa: np.ndarray) -> tuple[np.ndarray, int]:
    """Stored BWT (length n, the $ row removed) and primary row index.

    Row k of the conceptual BWT matrix (n+1 rows, sentinel convention)
    holds text[SA_bwa[k]-1]; SA_bwa = [n] ++ sa. The row whose suffix is
    the whole text (SA value 0) is `primary`; its BWT char is the
    sentinel and is omitted from storage.
    """
    n = int(text.shape[0])
    primary = int(np.flatnonzero(sa == 0)[0]) + 1
    sa_bwa = np.concatenate([np.array([n], dtype=np.int64), sa])
    rows = np.delete(sa_bwa, primary)
    return text[rows - 1].astype(np.uint8), primary


def pack_bwt_words(bwt: np.ndarray) -> np.ndarray:
    """Pack BWT codes into u32 words, 16 bases per word, first base in
    the top 2 bits (bwt.h bwt_B00 layout)."""
    n = int(bwt.shape[0])
    n_words = (n + 15) // 16
    padded = np.zeros(n_words * 16, dtype=np.uint32)
    padded[:n] = bwt
    w = padded.reshape(-1, 16)
    shifts = np.arange(15, -1, -1, dtype=np.uint32) * 2
    return (w << shifts).sum(axis=1, dtype=np.uint64).astype(np.uint32)


def occ_checkpoints(bwt: np.ndarray, interval: int = OCC_INTERVAL) -> np.ndarray:
    """Cumulative base counts before each interval boundary, plus the
    final total: shape (n_blocks+1, 4) uint64."""
    n = int(bwt.shape[0])
    n_blocks = (n + interval - 1) // interval
    padded = np.zeros(n_blocks * interval, dtype=np.uint8)
    padded[:n] = bwt
    onehot = padded.reshape(n_blocks, interval, 1) == np.arange(4, dtype=np.uint8)
    per_block = onehot.sum(axis=1).astype(np.uint64)
    ck = np.zeros((n_blocks + 1, 4), dtype=np.uint64)
    np.cumsum(per_block, axis=0, out=ck[1:])
    # Trailing pad bases were counted as base 0 in the final checkpoint.
    ck[-1, 0] -= n_blocks * interval - n
    return ck


def interleave_bwt(bwt: np.ndarray) -> np.ndarray:
    """Produce the interleaved .bwt payload: per 128-base block, 4 u64
    occ counts (as 8 u32, little-endian) then 8 u32 BWT words; the last
    block carries only the words that exist; final occ appended
    (bwtindex.c:53-75)."""
    n = int(bwt.shape[0])
    words = pack_bwt_words(bwt)
    ck = occ_checkpoints(bwt)
    n_blocks = ck.shape[0] - 1
    words_per_block = OCC_INTERVAL // 16
    out: list[np.ndarray] = []
    ck_u32 = ck.astype("<u8").view("<u4").reshape(ck.shape[0], 8)
    for b in range(n_blocks):
        out.append(ck_u32[b])
        out.append(words[b * words_per_block : min((b + 1) * words_per_block, words.shape[0])])
    out.append(ck_u32[n_blocks])
    payload = np.concatenate(out).astype("<u4")
    expected = words.shape[0] + (n_blocks + 1) * 8
    assert payload.shape[0] == expected, (payload.shape[0], expected)
    return payload


def interleave_bwt_fast(bwt: np.ndarray) -> np.ndarray:
    """Vectorized interleave for large genomes (identical output)."""
    n = int(bwt.shape[0])
    words = pack_bwt_words(bwt)
    ck = occ_checkpoints(bwt)
    n_blocks = ck.shape[0] - 1
    wpb = OCC_INTERVAL // 16
    ck_u32 = ck.astype("<u8").view("<u4").reshape(ck.shape[0], 8)
    n_full = n // OCC_INTERVAL  # number of complete blocks
    payload = np.empty(words.shape[0] + (n_blocks + 1) * 8, dtype="<u4")
    body = payload[: n_full * (8 + wpb)].reshape(n_full, 8 + wpb)
    body[:, :8] = ck_u32[:n_full]
    body[:, 8:] = words[: n_full * wpb].reshape(n_full, wpb)
    pos = n_full * (8 + wpb)
    if n_blocks > n_full:  # partial last block
        payload[pos : pos + 8] = ck_u32[n_full]
        pos += 8
        tail = words[n_full * wpb :]
        payload[pos : pos + tail.shape[0]] = tail
        pos += tail.shape[0]
    payload[pos : pos + 8] = ck_u32[n_blocks]
    return payload


def compute_L2(text: np.ndarray) -> np.ndarray:
    """L2[0..4]: cumulative character counts (L2[0]=0, L2[4]=len)."""
    counts = np.bincount(text, minlength=4)[:4]
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.uint64)


def sample_sa(sa: np.ndarray, seq_len: int, intv: int = SA_INTERVAL) -> np.ndarray:
    """Every intv-th SA_bwa row from row 0; sa_bwa[0] = seq_len.
    Returned array is the in-memory table (entry 0 later treated as -1)."""
    sa_bwa0 = np.concatenate([np.array([seq_len], dtype=np.int64), sa])
    return sa_bwa0[::intv].copy()


def write_bwt_file(path: str, primary: int, L2: np.ndarray, payload: np.ndarray) -> None:
    with open(path, "wb") as f:
        header = np.empty(5, dtype="<u8")
        header[0] = primary
        header[1:] = L2[1:5]
        f.write(header.tobytes())
        f.write(payload.astype("<u4").tobytes())


def write_sa_file(path: str, primary: int, L2: np.ndarray, samples: np.ndarray, seq_len: int,
                  intv: int = SA_INTERVAL) -> None:
    with open(path, "wb") as f:
        header = np.empty(7, dtype="<u8")
        header[0] = primary
        header[1:5] = L2[1:5]
        header[5] = intv
        header[6] = seq_len
        f.write(header.tobytes())
        f.write(samples[1:].astype("<u8").tobytes())


SAD_MAGIC = 0x44415344    # "DSAD": int32 payload (seq_len < 2^31)
SAD_MAGIC64 = 0x44415345  # "ESAD": int64 payload (wide genomes)
SAD_INTERVAL = 8


def write_sad_file(path: str, samples: np.ndarray, intv: int,
                   wide: bool = False) -> None:
    """dart_tpu extension: dense SA samples for the device locate
    kernel. A batched LF-walk's cost is its LONGEST lane (~intv * ln(B)
    steps over batch B), not the mean, so the TPU wants denser samples
    than the BWA .sa's every-32 (bwtindex.c:141). int32 payload for
    seq_len < 2^31, int64 ("ESAD" magic) beyond."""
    with open(path, "wb") as f:
        magic = SAD_MAGIC64 if wide else SAD_MAGIC
        header = np.array([magic, intv, samples.shape[0]], dtype="<u8")
        f.write(header.tobytes())
        f.write(samples.astype("<i8" if wide else "<i4").tobytes())


def _core_native(text: np.ndarray):
    """SA + BWT + interleaved payload via the one-call native core
    (native/sais.cpp dart_index_core/dart_bwt_payload): no NumPy
    concatenate/delete/fancy-gather passes, which at GRCh38 scale
    (6.2e9 text) would each copy a 50 GB array and exceed host RAM.
    Returns (sa_full, bwt, primary, payload) where sa_full has n+1
    entries with sa_full[0] == n (the sentinel row), so BWA's
    sa_bwa = [n] ++ sa is literally sa_full."""
    import ctypes

    from ..native import build as native_build

    lib = native_build.load()
    if lib is None:
        return None
    n = int(text.shape[0])
    text = np.ascontiguousarray(text, dtype=np.uint8)
    sa_full = np.empty(n + 1, dtype=np.int64)
    bwt = np.empty(n, dtype=np.uint8)
    fn = lib.dart_index_core
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                   ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
                   ctypes.POINTER(ctypes.c_uint8)]
    K = int(text.max()) + 2
    primary = fn(text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                 n, K,
                 sa_full.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                 bwt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if primary < 0:
        raise RuntimeError("native index core failed")
    n_blocks = (n + OCC_INTERVAL - 1) // OCC_INTERVAL
    n_words = (n + 15) // 16
    payload = np.empty(n_words + (n_blocks + 1) * 8, dtype="<u4")
    pf = lib.dart_bwt_payload
    pf.restype = None
    pf.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                   ctypes.POINTER(ctypes.c_uint32)]
    pf(bwt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n,
       payload.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return sa_full, bwt, int(primary), payload


def _stage_log(msg: str) -> None:
    if os.environ.get("DART_TPU_BUILD_LOG"):
        import time
        print(f"[build {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def build_index(fasta_path: str, prefix: str, seed: int = 11,
                sad_intv: int = SAD_INTERVAL) -> None:
    """Build all five BWA-compatible index files for `fasta_path` under
    `prefix`, plus the .sad dense-sample file (TPU extension)."""
    _stage_log(f"packing {fasta_path}")
    pg = packer.pack_fasta(fasta_path, seed=seed)
    text = full_text(pg.seq2)
    seq_len = int(text.shape[0])

    _stage_log(f"suffix array + BWT over {seq_len:,} text positions")
    core = _core_native(text)
    if core is not None:
        sa_full, bwt, primary, payload = core
        del text
        # the BWT is a permutation of the text, so L2 from its counts
        L2 = compute_L2(bwt)
        samples = sa_full[::SA_INTERVAL]
        sample = lambda intv: sa_full[::intv]  # noqa: E731
    else:
        sa = suffix_array(text)
        bwt, primary = bwt_from_sa(text, sa)
        L2 = compute_L2(text)
        payload = interleave_bwt_fast(bwt)
        samples = sample_sa(sa, seq_len)
        sample = lambda intv: sample_sa(sa, seq_len, intv)  # noqa: E731

    _stage_log("writing index files")
    write_bwt_file(prefix + ".bwt", primary, L2, payload)
    write_sa_file(prefix + ".sa", primary, L2, samples, seq_len)
    packer.write_pac(prefix + ".pac", pg.seq2)
    packer.write_ann(prefix + ".ann", pg)
    packer.write_amb(prefix + ".amb", pg)
    if sad_intv:
        # wide genomes use a middle interval: every-8 at int64 pair
        # width would put ~6 GB of samples in HBM on a GRCh38-class
        # table (10.3 GiB total), while the BWA every-32 doubles the
        # fast-extension LF-walks' iteration tail (on the JAX engine
        # 12% of flagship lanes exhausted its first round's iteration
        # cap). Every-16 costs +1.5 GiB of device memory (7.2 GiB in
        # all on GRCh38) and halves the walks.
        wide = seq_len >= 2**31
        intv = max(sad_intv, SA_INTERVAL // 2) if wide else sad_intv
        write_sad_file(prefix + ".sad", sample(intv), intv, wide=wide)
