"""Seeding: tile each read with forward maximal exact matches.

Reference: IdentifySeedPairs (AlignmentCandidates.cpp:181-215) — scan
positions left to right, take the MEM at each, jump past accepted
seeds (len >= 16 and occurrences <= MaxDupNum), else advance by one.

The whole scan runs as a batched device automaton (one lane per read,
the engine's seed scan, ``seed_scan_kernel`` of csrc/fm_kernels.cu on a
card) returning a compact per-read seed table; a second batched pass
locates every occurrence of every accepted seed. Engines without the
automaton reuse seed_reads_from_all_walks: MEM walks from every
position + a host replay of the jump sequence. Both paths produce
identical seed lists.
"""

from __future__ import annotations

import numpy as np

from ..constants import MIN_SEED_LEN
from ..spans import span
from .structs import SeedPair


def build_codes_matrix(reads) -> tuple[np.ndarray, np.ndarray]:
    R = len(reads)
    L = max((r.rlen for r in reads), default=1)
    codes = np.full((R, L), 4, dtype=np.uint8)
    rlens = np.zeros(R, dtype=np.int32)
    for i, r in enumerate(reads):
        codes[i, : r.rlen] = r.codes
        rlens[i] = r.rlen
    return codes, rlens


def all_walk_tasks(codes: np.ndarray, rlens: np.ndarray):
    """The MEM-walk tasks of seed_reads_from_all_walks: one from every
    position of each read (walks beyond rlen-14 are wasted but ignored
    by the replay), read-major, L bases each, valid up to the read's
    end -> (chars, valid), (R * L, L)."""
    R, L = codes.shape
    # sliding windows, no Python loops
    padded = np.concatenate([codes, np.full((R, L), 4, dtype=np.uint8)], axis=1)
    windows = np.lib.stride_tricks.sliding_window_view(padded, L, axis=1)[:, :L, :]
    chars = np.ascontiguousarray(windows).reshape(R * L, L)
    ii = np.arange(L, dtype=np.int32)
    valid = (ii[None, :, None] + ii[None, None, :]) < rlens[:, None, None]
    return chars, valid.reshape(R * L, L)


def seed_reads_from_all_walks(engine, codes: np.ndarray, rlens: np.ndarray,
                              max_dup_num: int):
    """Reference scan replay over precomputed all-position MEM walks.
    Returns the same (n, rpos, slen, k0, freq) tables as the device
    automaton."""
    R, L = codes.shape
    lens, x0, freq = engine.mem_walks(*all_walk_tasks(codes, rlens))
    lens = lens.reshape(R, L)
    x0 = x0.reshape(R, L)
    freq = freq.reshape(R, L)
    accepted = (freq <= max_dup_num) & (lens >= MIN_SEED_LEN)

    S = L // 16 + 2
    n_out = np.zeros(R, dtype=np.int32)
    rpos_out = np.zeros((R, S), dtype=np.int32)
    len_out = np.zeros((R, S), dtype=np.int32)
    k0_out = np.zeros((R, S), dtype=np.int64)
    freq_out = np.zeros((R, S), dtype=np.int32)
    for r in range(R):
        end_pos = int(rlens[r]) - 13
        pos = 0
        while pos < end_pos:
            if codes[r, pos] > 3:
                pos += 1
                continue
            if accepted[r, pos]:
                s = n_out[r]
                rpos_out[r, s] = pos
                len_out[r, s] = lens[r, pos]
                k0_out[r, s] = x0[r, pos]
                freq_out[r, s] = freq[r, pos]
                n_out[r] += 1
                pos += int(lens[r, pos])
            else:
                pos += 1
    return n_out, rpos_out, len_out, k0_out, freq_out


def submit_chunk(engine, reads):
    """Phase 1 of whole-chunk seeding: pack the chunk into the device
    transfer layout and dispatch the first automaton round WITHOUT
    syncing, so the caller can overlap this chunk's device pass with
    host work on the previous chunk (the aligner analogue of the
    reference's producer/consumer pool, with the device's stream as
    the buffer). Returns an opaque job for finish_chunk."""
    if hasattr(engine, "seed_submit_packed") and hasattr(reads, "seq_blob"):
        from .native_chunk import pack_reads_strided

        with span("dart.seed.pack"):
            lens = np.diff(reads.seq_off)
            L = int(lens.max()) if len(reads) else 1
            n_with_n = None
            if L < 65536:
                Lp = max(32, -(-L // 32) * 32)
                words = Lp // 16
                Rp = engine._pad_up(len(reads), engine._min_bucket)
                # [packed codes | rlen] and the N mask, which
                # seed_submit_packed joins into one transfer buffer
                buf = np.zeros((Rp, words + 1), dtype=np.uint32)
                nmask = np.zeros((Rp, words // 2), dtype=np.uint32)
                has_n = np.zeros(Rp, dtype=np.uint8)
                n_with_n = pack_reads_strided(
                    reads.seq_blob, reads.seq_off, len(reads), words,
                    buf[:, :words], nmask, buf.view(np.int32)[:, words],
                    has_n)
        if n_with_n is not None:
            job = engine.seed_submit_packed(
                buf, nmask, has_n, n_with_n, len(reads), Lp, L)
            return ("seed_job", job, len(reads))
    # generic path (NumPy engine, ReadItem chunks, very long reads, or
    # no native library): compute everything eagerly
    return ("eager", _seed_occurrence_tables_eager(engine, reads), None)


def finish_chunk(engine, job, on_wait=None):
    """Phase 2: sync the device rounds and expand the per-seed tables
    into flat per-occurrence tables (see seed_occurrence_tables).
    on_wait (optional) fires once, right after this chunk's LAST
    device round has been dispatched — the point where the caller
    should submit the NEXT chunk's first seed round. (Dispatching it
    earlier would queue it AHEAD of this chunk's remaining rounds on
    the device stream and delay this chunk's completion.)"""
    kind, payload, n_reads = job
    if kind == "eager":
        return payload
    n, rpos, slen, k0, freq = engine.seed_finish(payload)
    return _expand_occurrences(engine, n, rpos, slen, k0, freq, n_reads,
                               on_wait=on_wait)


def seed_occurrence_tables(engine, reads):
    """Whole-chunk seeding: two batched device passes producing flat
    per-occurrence tables for the native pipeline. Returns
    (occ_off (R+1,), occ_rpos, occ_len, occ_gpos) where records
    [occ_off[r], occ_off[r+1]) belong to read r (unsorted; the consumer
    sorts by (gPos, rPos) as the reference does after IdentifySeedPairs).
    """
    return finish_chunk(engine, submit_chunk(engine, reads))


def _seed_occurrence_tables_eager(engine, reads):
    if hasattr(reads, "codes_matrix"):
        codes, rlens = reads.codes_matrix()
    else:
        codes, rlens = build_codes_matrix(reads)
    n, rpos, slen, k0, freq = engine.seed_reads(codes, rlens)
    return _expand_occurrences(engine, n, rpos, slen, k0, freq, len(reads))


def _expand_occurrences(engine, n, rpos, slen, k0, freq, n_reads,
                        on_wait=None):
    # host work under dart.seed.expand spans; the locate's copies (the
    # engine's dart.seed.sync spans) and on_wait run between them
    with span("dart.seed.expand"):
        S = rpos.shape[1]
        valid = np.arange(S)[None, :] < n[:, None]
        # freq == -1 marks a "direct" seed (fast-extension path): unique
        # occurrence, genome position already in the k0 slot
        direct_seed = (valid & (freq < 0)).ravel()
        freq_v = np.where(valid, np.where(freq < 0, 1, freq),
                          0).astype(np.int64)
        occ_per_seed = freq_v.ravel()
        total = int(occ_per_seed.sum())
        occ_off = np.zeros(n_reads + 1, dtype=np.int64)
        np.cumsum(freq_v.sum(axis=1), out=occ_off[1:])
        if total:
            starts = np.repeat(k0.ravel().astype(np.int64), occ_per_seed)
            cum = np.zeros(occ_per_seed.shape[0] + 1, dtype=np.int64)
            np.cumsum(occ_per_seed, out=cum[1:])
            within = (np.arange(total, dtype=np.int64)
                      - np.repeat(cum[:-1], occ_per_seed))
            rows = starts + within
            direct_occ = np.repeat(direct_seed, occ_per_seed)
            occ_gpos = np.empty(total, dtype=np.int64)
            occ_gpos[direct_occ] = rows[direct_occ]  # = gpos + within(0)
            nd = ~direct_occ
            located = rows[nd]
    if total == 0:
        if on_wait is not None:
            on_wait()
        z = np.empty(0, dtype=np.int64)
        return occ_off, z, z, z
    if located.shape[0]:
        if hasattr(engine, "locate_submit"):
            loc_job = engine.locate_submit(located)
            if on_wait is not None:
                on_wait()  # next chunk's seed round queues BEHIND this
                on_wait = None
            gpos = engine.locate_finish(loc_job)
        else:
            gpos = engine.locate(located)
    if on_wait is not None:
        on_wait()
    with span("dart.seed.expand"):
        if located.shape[0]:
            occ_gpos[nd] = gpos
        occ_rpos = np.repeat(rpos.ravel(), occ_per_seed)
        occ_len = np.repeat(slen.ravel(), occ_per_seed)
    return occ_off, occ_rpos, occ_len, occ_gpos


def identify_seed_pairs_chunk(engine, reads, max_dup_num: int) -> list[list[SeedPair]]:
    """Produce the reference's per-read seed lists for a chunk using two
    batched device passes (seed scan, then occurrence locates)."""
    if not reads:
        return []
    codes, rlens = build_codes_matrix(reads)
    n, rpos, slen, k0, freq = engine.seed_reads(codes, rlens)

    # flatten all occurrences for one batched locate (freq == -1 =
    # direct seed: gPos already in the k0 slot)
    rows_list = []
    for r in range(len(reads)):
        for s in range(int(n[r])):
            if int(freq[r, s]) >= 0:
                rows_list.append(np.arange(int(k0[r, s]),
                                           int(k0[r, s]) + int(freq[r, s]),
                                           dtype=np.int64))
    all_rows = np.concatenate(rows_list) if rows_list else np.empty(0, dtype=np.int64)
    locs = engine.locate(all_rows) if all_rows.shape[0] else all_rows

    out: list[list[SeedPair]] = [[] for _ in reads]
    off = 0
    for r in range(len(reads)):
        seeds = out[r]
        for s in range(int(n[r])):
            p = int(rpos[r, s])
            ln = int(slen[r, s])
            f = int(freq[r, s])
            if f < 0:
                g = int(k0[r, s])
                seeds.append(SeedPair(rPos=p, gPos=g, rLen=ln, gLen=ln,
                                      PosDiff=g - p, bSimple=True))
                continue
            for j in range(f):
                g = int(locs[off + j])
                seeds.append(SeedPair(rPos=p, gPos=g, rLen=ln, gLen=ln,
                                      PosDiff=g - p, bSimple=True))
            off += f
        seeds.sort(key=lambda sp: (sp.gPos, sp.rPos))
    return out
