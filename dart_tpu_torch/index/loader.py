"""Index loading: BWA-format files -> in-memory arrays + TPU layouts.

Mirrors the reference loader semantics (Dart's src/bwt_index.cpp:
bwa_idx_load :147, RestoreReferenceInfo :229) but keeps everything as
NumPy arrays and adds a device-friendly FM-index block layout.

Unlike the reference (which eagerly heap-loads every structure each
run), the big derived arrays here are LAZY: file headers are read at
load time, while the multi-GB payloads (BWT codes, occ checkpoints, SA
samples, reference codes) materialize on first access. The JAX
package's production runs (its engine + native pipeline) never touch
most of them once the engine's merged device table comes from the
layout cache (index/layout_cache.py; the port's engine does not read it
yet) — at GRCh38 scale that avoids ~17 GB of anonymous first-touch,
which the JAX package's TPU host served at ~10-50 MB/s.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import OCC_INTERVAL
from . import layout_cache, packer


@dataclass
class Chromosome:
    name: str
    length: int
    forward_location: int
    reverse_location: int


class Index:
    """FM-index + reference sequences (host layout).

    Eager fields: primary, L2 (int64[5]), sa_intv, seq_len
    (= 2 * genome_size), genome_size, sad_intv (0 = no dense samples),
    ref_ascii (uint8[2*genome_size] 'A'..'T'), ref_ascii_padded
    (ref_ascii with REF_GUARD 'N' bytes each side; ref_ascii is a view
    into its interior — the native pipeline binds it zero-copy),
    chromosomes, chr_end_keys/chr_end_idx (ChrLocMap equivalent),
    prefix (file prefix this index was loaded from, or None).

    Lazy fields (materialized from the index files on first access):
    bwt (uint8[seq_len] BWT codes, $ row removed), occ
    (int64[(n_blocks+1), 4] checkpoints every OCC_INTERVAL),
    sa_samples (int64[n_sa], entry 0 = -1 sentinel), sad_samples
    (int32/int64[n] dense samples or None), ref_codes
    (uint8[2*genome_size] fwd ++ revcomp codes).
    """

    def __init__(self, *, primary, L2, sa_intv, seq_len, genome_size,
                 ref_ascii, chromosomes=None, chr_end_keys=None,
                 chr_end_idx=None, sad_intv=0, ref_ascii_padded=None,
                 bwt=None, occ=None, sa_samples=None, sad_samples=None,
                 ref_codes=None, lazy=None, prefix=None):
        self.primary = primary
        self.L2 = L2
        self.sa_intv = sa_intv
        self.seq_len = seq_len
        self.genome_size = genome_size
        self.ref_ascii = ref_ascii
        self.ref_ascii_padded = ref_ascii_padded
        self.chromosomes = chromosomes if chromosomes is not None else []
        self.chr_end_keys = chr_end_keys
        self.chr_end_idx = chr_end_idx
        self.sad_intv = sad_intv
        self.prefix = prefix
        self._lazy = dict(lazy or {})
        self._bwt = bwt
        self._occ = occ
        self._sa_samples = sa_samples
        self._sad_samples = sad_samples
        self._ref_codes = ref_codes

    def _materialize(self, name):
        v = getattr(self, "_" + name)
        if v is None:
            fn = self._lazy.pop(name, None)
            if fn is not None:
                v = fn()
                setattr(self, "_" + name, v)
        return v

    def _lazy_prop(name):  # noqa: N805 — descriptor factory
        return property(lambda s: s._materialize(name),
                        lambda s, v: setattr(s, "_" + name, v))

    bwt = _lazy_prop("bwt")
    occ = _lazy_prop("occ")
    sa_samples = _lazy_prop("sa_samples")
    sad_samples = _lazy_prop("sad_samples")
    ref_codes = _lazy_prop("ref_codes")
    del _lazy_prop

    def chr_lower_bound(self, g_pos) -> np.ndarray:
        """Index into chr_end_keys of the first key >= g_pos
        (std::map::lower_bound equivalent)."""
        return np.searchsorted(self.chr_end_keys, g_pos, side="left")


def deinterleave_bwt(payload: np.ndarray, seq_len: int) -> tuple[np.ndarray, np.ndarray]:
    """Split an interleaved .bwt payload into (bwt codes, occ checkpoints).

    The native single-pass splitter serves big genomes (NumPy's
    broadcasting path degrades badly past 2^31 elements — ~15 min for
    a 2.2e9-position text vs seconds in C++); the vectorized NumPy
    body below is the toolchain-free twin."""
    n_blocks = (seq_len + OCC_INTERVAL - 1) // OCC_INTERVAL
    try:
        import ctypes

        from ..native import build as native_build

        lib = native_build.load()
    except Exception:
        lib = None
    if lib is not None and hasattr(lib, "dart_deinterleave_bwt"):
        codes = np.empty(seq_len, dtype=np.uint8)
        occ = np.empty((n_blocks + 1, 4), dtype=np.int64)
        pay = np.ascontiguousarray(payload, dtype=np.uint32)
        lib.dart_deinterleave_bwt(
            pay.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.c_int64(seq_len),
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            occ.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return codes, occ
    wpb = OCC_INTERVAL // 16
    n_words = (seq_len + 15) // 16
    n_full = seq_len // OCC_INTERVAL

    words = np.empty(n_words, dtype=np.uint32)
    occ = np.empty((n_blocks + 1, 4), dtype=np.int64)

    body_len = n_full * (8 + wpb)
    body = payload[:body_len].reshape(n_full, 8 + wpb) if n_full else payload[:0].reshape(0, 8 + wpb)
    occ[:n_full] = body[:, :8].copy().view("<u8").reshape(n_full, 4).astype(np.int64)
    words[: n_full * wpb] = body[:, 8:].reshape(-1)
    pos = body_len
    if n_blocks > n_full:
        occ[n_full] = payload[pos : pos + 8].copy().view("<u8").astype(np.int64)
        pos += 8
        tail = n_words - n_full * wpb
        words[n_full * wpb :] = payload[pos : pos + tail]
        pos += tail
    occ[n_blocks] = payload[pos : pos + 8].copy().view("<u8").astype(np.int64)

    # Unpack words to per-base codes.
    shifts = (np.arange(15, -1, -1, dtype=np.uint32) * 2)[None, :]
    codes = ((words[:, None] >> shifts) & 3).astype(np.uint8).reshape(-1)[:seq_len]
    return codes, occ


# 'N' guard bytes on each side of the padded ascii buffer: the native
# pipeline's continuation probes and splice-motif reads may index a few
# bytes past an alignment at the fwd/RC text boundary (the reference
# allocates TwoGenomeSize+1 and relies on slack); guards make the reads
# defined and never match A/C/G/T. Allocated HERE, at load time, so the
# native pipeline can use the buffer zero-copy instead of re-allocating
# and copying another genome-size array (6.2 GB at GRCh38 scale).
REF_GUARD = 256


def _native_lib():
    try:
        from ..native import build as native_build

        return native_build.load()
    except Exception:
        return None


def _read_pac_payload(pac_path: str, l_pac: int) -> np.ndarray:
    with open(pac_path, "rb") as f:
        data = f.read()
    rem = data[-1]
    n = (len(data) - 2) * 4 + rem if rem else (len(data) - 2) * 4
    assert n == l_pac, (n, l_pac)
    return np.frombuffer(data[: (n + 3) // 4], dtype=np.uint8)


def _derive_codes(pac_path: str, l_pac: int) -> np.ndarray:
    """ref_codes only (fwd ++ revcomp) — the lazy path when ref_ascii
    comes from the .refpad cache."""
    pac = _read_pac_payload(pac_path, l_pac)
    lib = _native_lib()
    if lib is not None and hasattr(lib, "dart_codes_from_pac"):
        import ctypes

        ref_codes = np.empty(2 * l_pac, dtype=np.uint8)
        lib.dart_codes_from_pac(
            pac.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(l_pac),
            ref_codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return ref_codes
    fwd = packer.pac_bytes_to_codes(pac, l_pac)
    rc = (3 - fwd[::-1]).astype(np.uint8)
    return np.concatenate([fwd, rc])


def _derive_ref(pac_path: str, l_pac: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ref_codes, ref_ascii, ref_ascii_padded) from .pac, where
    ref_codes = fwd ++ revcomp codes, ref_ascii = the same as ACGT
    bytes, and ref_ascii is a view into ref_ascii_padded's interior
    (REF_GUARD 'N' bytes on each side).

    The native single-pass derivation avoids ~4x genome-size NumPy
    temporaries (decisive at GRCh38 scale in a degraded host-fault
    window); the NumPy body below is the toolchain-free twin."""
    pac = _read_pac_payload(pac_path, l_pac)
    padded = np.empty(2 * l_pac + 2 * REF_GUARD, dtype=np.uint8)
    padded[:REF_GUARD] = ord("N")
    padded[2 * l_pac + REF_GUARD:] = ord("N")
    ref_ascii = padded[REF_GUARD:2 * l_pac + REF_GUARD]
    lib = _native_lib()
    if lib is not None and hasattr(lib, "dart_ref_from_pac"):
        import ctypes

        ref_codes = np.empty(2 * l_pac, dtype=np.uint8)
        lib.dart_ref_from_pac(
            pac.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(l_pac),
            ref_codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ref_ascii.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return ref_codes, ref_ascii, padded
    fwd = packer.pac_bytes_to_codes(pac, l_pac)
    rc = (3 - fwd[::-1]).astype(np.uint8)
    ref_codes = np.concatenate([fwd, rc])
    ref_ascii[:] = np.frombuffer(b"ACGT", dtype=np.uint8)[ref_codes]
    return ref_codes, ref_ascii, padded


def _bwt_occ_thunks(prefix: str, seq_len: int):
    """Shared memoized loader for (bwt, occ) — they split out of one
    .bwt payload pass, so materializing either materializes both."""
    box: dict = {}

    def get(which):
        if not box:
            with open(prefix + ".bwt", "rb") as f:
                data = f.read()
            payload = np.frombuffer(data[40:], dtype="<u4")
            box["bwt"], box["occ"] = deinterleave_bwt(payload, seq_len)
        return box[which]

    return (lambda: get("bwt")), (lambda: get("occ"))


def _sa_thunk(prefix: str, seq_len: int, sa_intv: int):
    def get():
        with open(prefix + ".sa", "rb") as f:
            sdata = f.read()
        n_sa = (seq_len + sa_intv) // sa_intv
        sa_samples = np.empty(n_sa, dtype=np.int64)
        # Row 0 is the $ row; a locate walk that passes it needs
        # steps-1, hence the -1 sentinel (bwt_index.cpp:31).
        sa_samples[0] = -1
        sa_samples[1:] = np.frombuffer(
            sdata[56:], dtype="<u8", count=n_sa - 1).astype(np.int64)
        return sa_samples

    return get


def _sad_thunk(prefix: str, dt: str):
    def get():
        with open(prefix + ".sad", "rb") as f:
            sdd = f.read()
        n_sad = int(np.frombuffer(sdd[:24], dtype="<u8")[2])
        sad_samples = np.frombuffer(sdd[24:], dtype=dt, count=n_sad).copy()
        sad_samples[0] = -1  # $ row sentinel, as with .sa
        return sad_samples

    return get


def load_index(prefix: str) -> Index:
    import os

    # .bwt header (payload is lazy: bwt/occ materialize on first use)
    with open(prefix + ".bwt", "rb") as f:
        header = np.frombuffer(f.read(40), dtype="<u8")
    primary = int(header[0])
    L2 = np.zeros(5, dtype=np.int64)
    L2[1:] = header[1:5].astype(np.int64)
    seq_len = int(L2[4])
    lazy = {}
    lazy["bwt"], lazy["occ"] = _bwt_occ_thunks(prefix, seq_len)

    # .sa header
    with open(prefix + ".sa", "rb") as f:
        sheader = np.frombuffer(f.read(56), dtype="<u8")
    sa_intv = int(sheader[5])
    lazy["sa_samples"] = _sa_thunk(prefix, seq_len, sa_intv)

    # .sad header (optional dense samples, builder.write_sad_file)
    sad_intv = 0
    if os.path.exists(prefix + ".sad"):
        with open(prefix + ".sad", "rb") as f:
            magic, intv, _n = np.frombuffer(f.read(24), dtype="<u8")
        if magic in (0x44415344, 0x44415345):  # "DSAD" i4 / "ESAD" i8
            sad_intv = int(intv)
            lazy["sad_samples"] = _sad_thunk(
                prefix, "<i4" if magic == 0x44415344 else "<i8")

    # .ann / .pac — the padded ascii text comes from the disk-backed
    # layout cache when present (file-backed faults are ~78x faster
    # than anonymous first-touch on the TPU host; see layout_cache)
    l_pac, _seed, contigs = packer.read_ann(prefix + ".ann")
    assert 2 * l_pac == seq_len
    ref_pad = None
    if layout_cache.eligible(seq_len):
        ref_pad, _h = layout_cache.load_array(
            prefix, "refpad", {"l_pac": l_pac, "guard": REF_GUARD})
    ref_codes = None
    if ref_pad is not None:
        ref_ascii = ref_pad[REF_GUARD:2 * l_pac + REF_GUARD]
        import functools

        lazy["ref_codes"] = functools.partial(
            _derive_codes, prefix + ".pac", l_pac)
    else:
        ref_codes, ref_ascii, ref_pad = _derive_ref(prefix + ".pac", l_pac)
        if layout_cache.eligible(seq_len):
            layout_cache.save_array(prefix, "refpad", ref_pad,
                                    {"l_pac": l_pac, "guard": REF_GUARD})

    chromosomes: list[Chromosome] = []
    keys = []
    idxs = []
    total = 0
    for i, c in enumerate(contigs):
        fwd_loc = total
        total += c.length
        rev_loc = seq_len - total
        chromosomes.append(Chromosome(c.name, c.length, fwd_loc, rev_loc))
        keys.append(fwd_loc + c.length - 1)
        idxs.append(i)
        keys.append(rev_loc + c.length - 1)
        idxs.append(i)
    order = np.argsort(np.asarray(keys, dtype=np.int64), kind="stable")
    chr_end_keys = np.asarray(keys, dtype=np.int64)[order]
    chr_end_idx = np.asarray(idxs, dtype=np.int64)[order]

    return Index(
        primary=primary,
        L2=L2,
        sa_intv=sa_intv,
        seq_len=seq_len,
        genome_size=l_pac,
        ref_codes=ref_codes,
        ref_ascii=ref_ascii,
        ref_ascii_padded=ref_pad,
        chromosomes=chromosomes,
        chr_end_keys=chr_end_keys,
        chr_end_idx=chr_end_idx,
        sad_intv=sad_intv,
        lazy=lazy,
        prefix=prefix,
    )
