"""FM-index tables for the card, built in NumPy from a host index.

The layout is the one the JAX engine gathers from
(``dart_tpu.ops.fm_jax.build_device_layout`` and
``build_merged_table``), kept byte-equal so that both engines read the
same rows:

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

Re-implemented here because the JAX module imports ``jax``.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 64  # BWT bases per Occ row


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


def build_merged_table(idx, blocks: np.ndarray, samples: np.ndarray):
    """Append the packed genome rows and the SA-sample rows to the Occ
    rows. Returns (table, ref_off, sad_off)."""
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
    return np.concatenate([blocks, ref_rows, sad_rows]), ref_off, sad_off


def _pack16(codes: np.ndarray) -> np.ndarray:
    """2-bit codes (length a multiple of 16) -> uint32 words, 16 codes
    per word, first code in the top bits."""
    w = codes.reshape(-1, 16).astype(np.uint64)
    shifts = np.arange(15, -1, -1, dtype=np.uint64) * 2
    return (w << shifts).sum(axis=1, dtype=np.uint64).astype(np.uint32)


def tables_from_index(idx) -> dict:
    """Everything the kernels read, as NumPy arrays and ints: the merged
    ``table`` (rows, 8) uint32, ``L2`` (5,) int32, ``primary``,
    ``sa_intv`` (the interval of the samples in the table), ``ref_off``,
    ``sad_off`` and ``seq_len``."""
    sa_intv = int(idx.sad_intv) if idx.sad_intv else int(idx.sa_intv)
    samples = (idx.sad_samples if idx.sad_intv
               else idx.sa_samples).astype(np.int32)
    table, ref_off, sad_off = build_merged_table(
        idx, build_device_layout(idx), samples)
    return {"table": table, "L2": np.asarray(idx.L2).astype(np.int32),
            "primary": int(idx.primary), "sa_intv": sa_intv,
            "ref_off": int(ref_off), "sad_off": int(sad_off),
            "seq_len": int(idx.seq_len)}


def to_device(tables: dict, device) -> dict:
    """The same dict with ``table`` and ``L2`` as int32 tensors on
    ``device`` (the table's uint32 words keep their bits)."""
    out = dict(tables)
    out["table"] = torch.from_numpy(
        np.ascontiguousarray(tables["table"]).view(np.int32)).to(device)
    out["L2"] = torch.from_numpy(tables["L2"]).to(device)
    return out
