"""FM-index tables for the card, built on the host from an index.

Two layouts, each kept byte-equal to the JAX engine's so that both
engines read the same rows. The narrow one
(``dart_tpu.ops.fm_jax.build_device_layout`` and ``build_merged_table``,
for fwd+rc texts below 2^31), in NumPy:

- one row of 8 uint32 words per 64 BWT bases: the Occ checkpoint of
  each base at the block start, then the 64 bases packed 16 per word,
  first base in the top bits;
- after the ``n_blocks`` Occ rows, from row ``ref_off``: the 2-bit
  packed genome text (fwd ++ revcomp), 16 bases per word, 8 words per
  row, plus one spare row so a 16-base window may read one word past
  the end;
- from row ``sad_off``: the SA samples as int32 bits, 8 per row (the
  dense ``.sad`` samples when the index has them, else the ``.sa``
  ones).

The wide one (``dart_tpu.ops.fm_jax_wide.build_merged_table_wide``,
which any text length may use and texts of 2^31 or more must) keeps
64-bit counts and positions as (lo, hi) uint32 pairs:

- one row of 16 words per 128 BWT bases: [occ lo x4 | occ hi x4 | the
  128 bases, 16 per word];
- the genome, 16 words (256 bases) per row, plus one spare row;
- the SA samples, 8 per row as [lo x8 | hi x8].

Its Occ rows and genome words come from the native single-pass packers
of ``native/layout.cpp`` (NumPy's broadcasting takes tens of
minutes past 2^31 elements); the NumPy bodies are their twins, taken
when the native library does not load.

Range-sharded over ``n`` index devices (``--mesh ...,index=n``), each
layout gains the zero rows of ``dart_tpu``'s sharded layout, so that
the row count divides by ``n``: the narrow one at its end
(``fm_jax.build_merged_table(..., index_shards)``), the wide one at the
end of its Occ region and at its end
(``fm_jax_wide.build_merged_table_wide(idx, n_shards)``), which moves
its ``ref_off`` and ``sad_off``. No kernel reads a padding row.
``ShardedTable`` holds such a table as one tensor per row range.

Texts of ``index.layout_cache.CACHE_MIN_SEQ`` positions or more keep
the merged table in a sidecar next to the index, as ``dart_tpu``'s
engines do (``fm_jax.FMIndexJax``, ``fm_jax_wide.FMIndexJaxWide``):
``.ntab`` (narrow, one shard), ``.wtab`` (wide) and ``.wtab<N>`` (wide
over N shards, repacked from ``.wtab`` when only that one is there),
keyed on ``{seq_len, sa_intv}``, with the same header and bytes, so
that each package reads the other's files. A hit memory-maps the file
and reads nothing of the raw index but its header fields.

Re-implemented here because the JAX modules import ``jax``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..index import layout_cache

BLOCK = 64  # BWT bases per Occ row
BLOCK_W = 128  # BWT bases per wide Occ row
UPLOAD_CHUNK = 64 << 20  # bytes a pinned staging buffer carries to a card


def build_device_layout(idx) -> np.ndarray:
    """The (n_blocks, 8) uint32 Occ rows of the BWT."""
    if idx.seq_len >= 2**31:
        raise ValueError("the narrow FM layout requires seq_len < 2^31")
    n = int(idx.seq_len)
    n_blocks = (n + BLOCK - 1) // BLOCK
    padded = np.zeros(n_blocks * BLOCK, dtype=np.uint8)
    padded[:n] = idx.bwt
    per_block = np.stack(
        [(padded.reshape(n_blocks, BLOCK) == c).sum(axis=1)
         for c in range(4)], axis=1).astype(np.int64)
    occ_start = np.zeros((n_blocks, 4), dtype=np.int64)
    np.cumsum(per_block[:-1], axis=0, out=occ_start[1:])
    words = _pack16(padded).reshape(n_blocks, 4)
    return np.concatenate([occ_start.astype(np.uint32), words], axis=1)


def _pad_rows(a: np.ndarray, n_shards: int) -> np.ndarray:
    """``a`` with zero rows appended up to a multiple of n_shards."""
    r = (-a.shape[0]) % n_shards
    if r == 0:
        return a
    return np.concatenate([a, np.zeros((r,) + a.shape[1:], a.dtype)])


def build_merged_table(idx, blocks: np.ndarray, samples: np.ndarray,
                       index_shards: int = 1):
    """Append the packed genome rows and the SA-sample rows to the Occ
    rows, and zero rows up to a multiple of ``index_shards``. Returns
    (table, ref_off, sad_off)."""
    n_blocks = blocks.shape[0]
    seq_len = int(idx.seq_len)
    n_words = (seq_len + 15) // 16
    n_wrows = -(-n_words // 8) + 1  # +1: a window may read row + 1
    codes = np.zeros(n_wrows * 8 * 16, dtype=np.uint8)
    codes[:seq_len] = np.minimum(idx.ref_codes, 3)
    ref_rows = _pack16(codes).reshape(n_wrows, 8)
    n_srows = -(-samples.shape[0] // 8)
    sad_rows = np.zeros(n_srows * 8, dtype=np.int32)
    sad_rows[: samples.shape[0]] = samples
    sad_rows = sad_rows.view(np.uint32).reshape(n_srows, 8)
    ref_off = n_blocks
    sad_off = n_blocks + n_wrows
    table = np.concatenate([blocks, ref_rows, sad_rows])
    return _pad_rows(table, index_shards), ref_off, sad_off


def _pack16(codes: np.ndarray) -> np.ndarray:
    """2-bit codes (length a multiple of 16) -> uint32 words, 16 codes
    per word, first code in the top bits."""
    w = codes.reshape(-1, 16).astype(np.uint64)
    shifts = np.arange(15, -1, -1, dtype=np.uint64) * 2
    return (w << shifts).sum(axis=1, dtype=np.uint64).astype(np.uint32)


def _native():
    """The port's native library (built with g++ at first use), or None
    when it does not load; the wide layout functions then take their
    NumPy twins."""
    from ..native import build as native_build

    return native_build.load()


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def build_device_layout_wide(idx) -> np.ndarray:
    """The (n_blocks, 16) uint32 wide Occ rows of the BWT."""
    n = int(idx.seq_len)
    n_blocks = (n + BLOCK_W - 1) // BLOCK_W
    lib = _native()
    if lib is not None:
        out = np.empty((n_blocks, 16), dtype=np.uint32)
        bwt = np.ascontiguousarray(idx.bwt, dtype=np.uint8)
        lib.dart_wide_layout(_ptr(bwt, ctypes.c_uint8), ctypes.c_int64(n),
                             _ptr(out, ctypes.c_uint32))
        return out
    padded = np.zeros(n_blocks * BLOCK_W, dtype=np.uint8)
    padded[:n] = idx.bwt
    per_block = np.stack(
        [(padded.reshape(n_blocks, BLOCK_W) == c).sum(axis=1)
         for c in range(4)], axis=1).astype(np.int64)
    occ_start = np.zeros((n_blocks, 4), dtype=np.int64)
    np.cumsum(per_block[:-1], axis=0, out=occ_start[1:])
    lo, hi = _split64(occ_start)
    return np.concatenate([lo, hi, _pack16(padded).reshape(n_blocks, 8)],
                          axis=1)


def _pack_ref_rows_wide(idx, n_rrows: int) -> np.ndarray:
    """The genome codes (clamped to 3) as (n_rrows, 16) uint32 rows of
    16-base words, zero past the end."""
    n = int(idx.seq_len)
    flat = np.zeros(n_rrows * 16, dtype=np.uint32)
    lib = _native()
    if lib is not None:
        codes = np.ascontiguousarray(idx.ref_codes, dtype=np.uint8)
        lib.dart_pack_codes(_ptr(codes, ctypes.c_uint8), ctypes.c_int64(n),
                            _ptr(flat, ctypes.c_uint32))
    else:
        n_words = (n + 15) // 16
        codes = np.zeros(n_words * 16, dtype=np.uint8)
        codes[:n] = np.minimum(idx.ref_codes, 3)
        flat[:n_words] = _pack16(codes)
    return flat.reshape(n_rrows, 16)


def build_merged_table_wide(idx, n_shards: int = 1):
    """The wide Occ rows, genome rows and SA-sample rows in one table;
    sharded over n_shards > 1, zero rows pad the Occ region and the
    whole table to multiples of n_shards. Returns (table (rows, 16)
    uint32, ref_off, sad_off)."""
    blocks = _pad_rows(build_device_layout_wide(idx), n_shards)
    n_blocks = blocks.shape[0]
    n_words = (int(idx.seq_len) + 15) // 16
    n_rrows = -(-n_words // 16) + 1  # +1: a window may read row + 1
    samples = (idx.sad_samples if idx.sad_intv
               else idx.sa_samples).astype(np.int64)
    n_srows = -(-samples.shape[0] // 8)
    pad = np.zeros(n_srows * 8, dtype=np.int64)
    pad[: samples.shape[0]] = samples
    lo, hi = _split64(pad)
    sad_rows = np.concatenate([lo.reshape(n_srows, 8),
                               hi.reshape(n_srows, 8)], axis=1)
    table = np.concatenate([blocks, _pack_ref_rows_wide(idx, n_rrows),
                            sad_rows])
    return _pad_rows(table, n_shards), n_blocks, n_blocks + n_rrows


def _split64(v: np.ndarray):
    """int64 array -> its (lo, hi) uint32 halves."""
    u = np.asarray(v, dtype=np.int64).view(np.uint64)
    return ((u & 0xFFFFFFFF).astype(np.uint32),
            (u >> np.uint64(32)).astype(np.uint32))


def tables_from_index(idx, wide: bool = False, index_shards: int = 1) -> dict:
    """Everything the kernels read, as NumPy arrays and ints: the merged
    ``table`` ((rows, 8) uint32 narrow, (rows, 16) wide; rows a multiple
    of ``index_shards``), ``L2`` (5,) (int32 narrow, int64 wide),
    ``primary``, ``sa_intv`` (the interval of the samples in the
    table), ``ref_off``, ``sad_off``, ``seq_len``, ``wide``,
    ``index_shards`` and ``cache``: how the layout cache served the
    table ("hit", a read-only memmap; "repack", from ``.wtab``; "miss",
    built and saved; None where the cache does not apply)."""
    sa_intv = int(idx.sad_intv) if idx.sad_intv else int(idx.sa_intv)
    seq_len = int(idx.seq_len)
    meta = {"seq_len": seq_len, "sa_intv": sa_intv}
    if wide:
        kind = "wtab" if index_shards == 1 else f"wtab{index_shards}"
    else:
        kind = "ntab"
    use_cache = (bool(getattr(idx, "prefix", None))
                 and (wide or index_shards == 1)
                 and layout_cache.eligible(seq_len))
    table = how = None
    if use_cache:
        table, h = layout_cache.load_array(idx.prefix, kind, meta)
        if table is not None:
            ref_off, sad_off, how = int(h["ref_off"]), int(h["sad_off"]), "hit"
        elif wide and index_shards > 1:
            rep = _repack_from_cache(idx.prefix, index_shards, meta)
            if rep is not None:
                (table, ref_off, sad_off), how = rep, "repack"
    if table is None:
        if wide:
            table, ref_off, sad_off = build_merged_table_wide(idx,
                                                              index_shards)
        else:
            samples = (idx.sad_samples if idx.sad_intv
                       else idx.sa_samples).astype(np.int32)
            table, ref_off, sad_off = build_merged_table(
                idx, build_device_layout(idx), samples, index_shards)
        if use_cache:
            layout_cache.save_array(idx.prefix, kind, table, dict(
                meta, ref_off=int(ref_off), sad_off=int(sad_off)))
            how = "miss"
    L2 = np.asarray(idx.L2).astype(np.int64 if wide else np.int32)
    return {"table": table, "L2": L2, "primary": int(idx.primary),
            "sa_intv": sa_intv, "ref_off": int(ref_off),
            "sad_off": int(sad_off), "seq_len": seq_len,
            "wide": bool(wide), "index_shards": int(index_shards),
            "cache": how}


def _repack_from_cache(prefix: str, n_shards: int, meta: dict):
    """The wide table over n_shards made from the cached ``.wtab``
    (``fm_jax_wide.FMIndexJaxWide._repack_sharded_from_cache``): zero
    rows at the end of the Occ region and at the end, which move
    ``ref_off`` and ``sad_off``; saved as ``.wtab<n_shards>``. Returns
    (table, ref_off, sad_off), or None when ``.wtab`` misses too."""
    base, h = layout_cache.load_array(prefix, "wtab", meta)
    if base is None:
        return None
    ref_off, sad_off = int(h["ref_off"]), int(h["sad_off"])
    pad1 = (-ref_off) % n_shards
    n_rows = base.shape[0] + pad1
    out = np.zeros((n_rows + (-n_rows) % n_shards, base.shape[1]),
                   base.dtype)
    out[:ref_off] = base[:ref_off]
    out[ref_off + pad1:n_rows] = base[ref_off:]
    ref_off, sad_off = ref_off + pad1, sad_off + pad1
    layout_cache.save_array(prefix, f"wtab{n_shards}", out,
                            dict(meta, ref_off=ref_off, sad_off=sad_off))
    return out, ref_off, sad_off


def to_device(tables: dict, device, shard_devices=None) -> dict:
    """The same dict with ``table`` as an int32 tensor on ``device``
    (its uint32 words keep their bits), or, given ``shard_devices``
    (one per index shard), as a ``ShardedTable`` of one allocation on
    each; and ``L2`` as a tensor of its own type on ``device``. A
    read-only table (the layout cache's memmap) is copied, never
    aliased: on the CPU whole, to a card through ``upload``."""
    out = dict(tables)
    words = np.ascontiguousarray(tables["table"]).view(np.int32)
    if shard_devices is None:
        out["table"] = upload(words, device)
    else:
        rows = words.shape[0] // len(shard_devices)
        out["table"] = ShardedTable([
            upload(words[s * rows:(s + 1) * rows], d, copy=True)
            for s, d in enumerate(shard_devices)])
    out["L2"] = torch.from_numpy(tables["L2"]).to(device)
    return out


def upload(words: np.ndarray, device, copy: bool = False) -> torch.Tensor:
    """A contiguous int32 array as a tensor on ``device``. On the CPU it
    aliases a writable array unless ``copy``, and copies a read-only
    one. To a card a writable array goes in one copy; a read-only one
    (a memmap of the layout cache) goes UPLOAD_CHUNK bytes at a time
    through two pinned staging buffers, read from the page cache, so
    that no anonymous copy of the whole table is made on the host."""
    device = torch.device(device)
    if device.type != "cuda":
        if copy or not words.flags.writeable:
            words = np.array(words)
        return torch.from_numpy(words)
    if words.flags.writeable:
        return torch.from_numpy(words).to(device, copy=True)
    out = torch.empty(words.shape, dtype=torch.int32, device=device)
    src, dst = words.reshape(-1), out.view(-1)
    step = UPLOAD_CHUNK // 4
    bufs = [torch.empty(min(step, src.size), dtype=torch.int32,
                        pin_memory=True) for _ in range(2)]
    done = [None, None]
    with torch.cuda.device(device):
        for i, a in enumerate(range(0, src.size, step)):
            b, j = min(a + step, src.size), i % 2
            if done[j] is not None:
                done[j].synchronize()  # its last copy has left the buffer
            bufs[j].numpy()[:b - a] = src[a:b]
            dst[a:b].copy_(bufs[j][:b - a], non_blocking=True)
            done[j] = torch.cuda.Event()
            done[j].record()
        torch.cuda.current_stream(device).synchronize()
    return out


class ShardedTable:
    """A merged table range-sharded by row: ``shards[s]`` holds rows
    [s * rows, (s + 1) * rows), each a tensor of its own, on any device.
    Indexing with a 1-d tensor of row numbers gathers from each shard
    the rows that fall in it, on that shard's device, and returns them
    on the device of the row numbers, in their order; the shards are
    never put back together. ``shape`` and ``device`` (the first
    shard's) are what the plain versions of ``ops.fm_plain`` read."""

    def __init__(self, shards):
        self.shards = list(shards)
        self.rows = self.shards[0].shape[0]
        if any(t.shape != self.shards[0].shape for t in self.shards):
            raise ValueError("the shards of a table have one shape")
        self.shape = (self.rows * len(self.shards), self.shards[0].shape[1])
        self.device = self.shards[0].device
        self.dtype = self.shards[0].dtype

    def __getitem__(self, rows: torch.Tensor) -> torch.Tensor:
        rows = rows.long()
        if rows.numel() and not bool(((rows >= 0)
                                      & (rows < self.shape[0])).all()):
            raise IndexError(f"a row outside the table's {self.shape[0]}")
        sid = torch.div(rows, self.rows, rounding_mode="floor")
        out = torch.empty((rows.shape[0], self.shape[1]), dtype=self.dtype,
                          device=rows.device)
        for s, shard in enumerate(self.shards):
            sel = (sid == s).nonzero().squeeze(1)
            if sel.numel():
                local = (rows[sel] - s * self.rows).to(shard.device)
                out[sel] = shard[local].to(rows.device)
        return out
