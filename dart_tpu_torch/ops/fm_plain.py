"""Plain PyTorch versions of the FM-index kernels.

These are the yardsticks of ``csrc/fm_kernels.cu``: the same inputs,
the same output layout, bit for bit. They run the JAX engines'
algorithms (``dart_tpu.ops.fm_jax._seed_scan_kernel`` with plain
one-character or K-mer-table walk init, ``_locate_kernel`` and
``build_lut``, and their wide forms in ``fm_jax_wide``; and
``_mem_walks_kernel``, narrow only) as masked loops
over lanes: every live lane takes one automaton step per loop
iteration, and finished lanes are dropped from the working set as they
pile up.

Each function reads either table layout of ``ops.layout``, told apart
by the row width: narrow rows are 8 words (Occ rows of 64 BWT bases,
genome rows of 128 bases, samples as int32), wide rows 16 words (Occ
rows of 128 bases with lo/hi counts, genome rows of 256 bases, samples
as lo/hi pairs). CPU PyTorch carries everything as int64 already, so
the wide layout needs no other arithmetic.

The engine takes them only for tensors on the CPU; on a CUDA device it
launches the kernels. CPU PyTorch has no shifts, complement, addition
or comparisons on ``torch.uint32``, so 32-bit words are carried as
int64 masked to 32 bits wherever a shift or complement could carry
bits past bit 31.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
EVEN = 0x55555555
# parents extended at once by lut_build_plain: bounds its temporaries
# (~200 MB of int64 fields at 128 bases a row)
LUT_CHUNK = 1 << 18


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 tensor holding uint32 bits -> int64 with the unsigned value."""
    return t.long() & M32


def _fields(v: torch.Tensor, n: int) -> torch.Tensor:
    """(N, W) 32-bit words (int64) -> (N, W * n) fields of 32/n bits,
    first field from the top bits."""
    bits = 32 // n
    sh = torch.arange(32 - bits, -1, -bits, device=v.device)
    return ((v[..., None] >> sh) & ((1 << bits) - 1)).flatten(-2)


def _is_wide(table: torch.Tensor) -> bool:
    return table.shape[1] == 16


def _occ_shift(table: torch.Tensor) -> int:
    """log2 of the BWT bases per Occ row: 64 narrow, 128 wide."""
    return 7 if _is_wide(table) else 6


def _split_row(cols: torch.Tensor):
    """A gathered Occ row (N, 8 | 16) as (Occ counts at the row start
    (N, 4), BWT words (N, 4 | 8))."""
    if cols.shape[1] == 16:
        return cols[:, :4] | (cols[:, 4:8] << 32), cols[:, 8:]
    return cols[:, :4], cols[:, 4:]


def _sample_at(cols: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """SA sample i (0..7) of each gathered sample row: int32 bits
    narrow, a [lo x8 | hi x8] pair wide."""
    if cols.shape[1] == 16:
        return _gather1(cols, i) | (_gather1(cols, 8 + i) << 32)
    return _i32(_gather1(cols, i))


def _occ4_cols(cols: torch.Tensor, kk: torch.Tensor) -> torch.Tensor:
    """Occ(kk, c) for c = 0..3 from the gathered rows: (N, 8 | 16) words
    as int64, kk (N,) already adjusted for the primary row. -> (N, 4)."""
    occ, words = _split_row(cols)
    bases = _fields(words, 16)                        # (N, 64 | 128)
    upto = (torch.arange(bases.shape[1], device=kk.device)
            <= (kk & (bases.shape[1] - 1))[:, None])
    hit = bases[:, :, None] == torch.arange(4, device=kk.device)
    return occ + (hit & upto[:, :, None]).sum(dim=1)


def _i32(v: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit values (int64) -> their int32 meaning (int64)."""
    return torch.where(v >= 2**31, v - 2**32, v)


def _gather1(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return t.gather(1, i[:, None]).squeeze(1)


def _backward_ext(L2, x0, x1, x2, tk, tl, primary: int):
    """One backward-search extension of the bidirectional interval
    (BWT_Search) by each base ci = 0..3, from Occ at x1 - 1 (tk) and at
    x1 - 1 + x2 (tl): (starts, new x1, widths), each (N, 4)."""
    w = tl - tk
    adj = ((x1 <= primary) & (x1 + x2 - 1 >= primary)).long()
    s3 = x0 + adj
    s2 = s3 + w[:, 3]
    s1 = s2 + w[:, 2]
    s0 = s1 + w[:, 1]
    return (torch.stack([s0, s1, s2, s3], dim=1),
            L2[:4][None, :] + 1 + tk, w)


def _occ_at(table, q: torch.Tensor, primary: int) -> torch.Tensor:
    """Occ of all four bases in stored BWT [0, q] (bwt_occ4) -> (N, 4)."""
    kk = (q - (q >= primary).long()).clamp(min=0)
    return _occ4_cols(_u32(table[kk >> _occ_shift(table)]), kk)


def _lut_rows(lut: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """(x0, x1, x2) of K-mer table rows as (N, 3) int64: narrow rows
    are [x0, x1, x2, 0] uint32 bits, wide rows three int64."""
    if lut.dtype == torch.int64:
        return lut[key]
    return _u32(lut[key][:, :3])


def lut_build_plain(table: torch.Tensor, L2: torch.Tensor, *, primary: int,
                    K: int) -> torch.Tensor:
    """The K-mer walk-state table (``fm_jax.build_lut``,
    ``fm_jax_wide.build_lut_wide``): for each K-mer (key = base-4, first
    base most significant) the bidirectional interval after the walk
    from its first base has taken its other K - 1 bases, or all zeros if
    the walk died. Built level by level, each level extending every
    parent by each base, ``LUT_CHUNK`` parents at a time.
    -> (4^K, 4) int32 [x0, x1, x2, 0] on a narrow table, (4^K, 3) int64
    [x0, x1, x2] on a wide one (the bytes of ``build_lut_wide``'s
    (4^K, 6) uint32 [lo, hi] rows)."""
    L2 = L2.long()
    c = torch.arange(4, device=table.device)
    x0, x1, x2 = L2[c] + 1, L2[3 - c] + 1, L2[c + 1] - L2[c]
    for _ in range(K - 1):
        parts = []
        for s in range(0, x0.numel(), LUT_CHUNK):
            e = s + LUT_CHUNK
            p0, p1, p2 = x0[s:e], x1[s:e], x2[s:e]
            alive = p2 > 0
            q1 = torch.where(alive, p1 - 1, 0)
            tk = _occ_at(table, q1, primary)
            tl = _occ_at(table, torch.where(alive, q1 + p2, 0), primary)
            starts, nx1, w = _backward_ext(L2, p0, p1, p2, tk, tl, primary)
            # child 4i + b extends parent i by base b: column ci = 3 - b
            ok = alive[:, None] & (w.flip(1) > 0)
            parts.append([torch.where(ok, v.flip(1), 0).reshape(-1)
                          for v in (starts, nx1, w)])
        x0, x1, x2 = (torch.cat([p[j] for p in parts]) for j in range(3))
    if _is_wide(table):
        return torch.stack([x0, x1, x2], dim=1)
    return torch.stack([x0, x1, x2, torch.zeros_like(x0)],
                       dim=1).to(torch.int32)


def mem_walks_plain(table: torch.Tensor, L2: torch.Tensor,
                    chars: torch.Tensor, valid: torch.Tensor, *,
                    primary: int, steps: torch.Tensor | None = None):
    """Forward MEM walks (``fm_jax._mem_walks_kernel``, BWT_Search), one
    task per row of ``chars`` (W, L) uint8 codes and ``valid`` (W, L)
    bool: from the interval of the first base, extend by each following
    base until one is invalid, is N (> 3) or extends to width 0; a
    stopped walk stays stopped. -> (lens, x0, x2), each (W,) int32:
    the bases taken (0 for a task that never starts) and the last
    interval's start and width. A task that never starts keeps the
    interval of its clipped first base ``min(c, 3)``. Column by column
    over the live tasks only.

    ``steps``, a (W,) int64 tensor on ``chars``' device, receives each
    task's extension steps: the pairs of dependent Occ-row loads a
    thread that walks the task makes (its successful extensions, and
    the one that found width 0)."""
    L2 = L2.long()
    ch = chars.long()
    c0 = ch[:, 0].clamp(max=3)
    x0, x1, x2 = L2[c0] + 1, L2[3 - c0] + 1, L2[c0 + 1] - L2[c0]
    started = valid[:, 0] & (ch[:, 0] <= 3)
    lens = started.long()
    n_steps = torch.zeros_like(lens)
    live = started.nonzero().squeeze(1)
    for j in range(1, ch.shape[1]):
        c = ch[live, j]
        ok = valid[live, j] & (c <= 3)
        live, c = live[ok], c[ok]
        if live.numel() == 0:
            break
        n_steps[live] += 1
        a0, a1, a2 = x0[live], x1[live], x2[live]
        tk = _occ_at(table, a1 - 1, primary)
        tl = _occ_at(table, a1 - 1 + a2, primary)
        starts, nx1, w = _backward_ext(L2, a0, a1, a2, tk, tl, primary)
        ci = (3 - c)[:, None]
        wi = w.gather(1, ci).squeeze(1)
        up = wi > 0
        live = live[up]
        x0[live] = starts.gather(1, ci).squeeze(1)[up]
        x1[live] = nx1.gather(1, ci).squeeze(1)[up]
        x2[live] = wi[up]
        lens[live] += 1
    if steps is not None:
        steps.copy_(n_steps)
    return lens.int(), x0.int(), x2.int()


def locate_plain(table: torch.Tensor, L2: torch.Tensor, rows: torch.Tensor,
                 *, primary: int, sa_intv: int, sad_off: int,
                 lf_steps: torch.Tensor | None = None) -> torch.Tensor:
    """SA positions of BWT ``rows`` (bwt_sa): LF-walk each row to a
    sampled row (``primary`` maps to row 0), then add the sample read
    from the table's sample rows. -> (N,) int32 narrow, int64 wide.

    ``lf_steps``, an (N,) int64 tensor on ``rows``' device, receives
    each row's LF steps: the dependent Occ-row loads a thread that walks
    the row makes before it reads the sample."""
    L2 = L2.long()
    sh = _occ_shift(table)
    k = rows.long().clone()
    steps = torch.zeros_like(k)
    while True:
        act = ((k % sa_intv) != 0).nonzero().squeeze(1)
        if act.numel() == 0:
            break
        ka = k[act]
        kk = (ka - (ka >= primary).long()).clamp(min=0)
        x = ka - (ka > primary).long()
        occ, words = _split_row(_u32(table[kk >> sh]))
        bases = _fields(words, 16)
        # x and kk share a row (they differ only at k == primary)
        c = _gather1(bases, x & ((1 << sh) - 1))
        upto = (torch.arange(1 << sh, device=k.device)
                <= (kk & ((1 << sh) - 1))[:, None])
        n_c = _gather1(occ, c) + ((bases == c[:, None]) & upto).sum(dim=1)
        k[act] = torch.where(ka == primary, 0, L2[c] + n_c)
        steps[act] += 1
    if lf_steps is not None:
        lf_steps.copy_(steps)
    srow = k // sa_intv
    sample = _sample_at(_u32(table[sad_off + (srow >> 3)]), srow & 7)
    return (steps + sample).to(torch.int64 if _is_wide(table)
                               else torch.int32)


def seed_scan_plain(table: torch.Tensor, L2: torch.Tensor, buf: torch.Tensor,
                    *, words: int, S: int, primary: int, sa_intv: int,
                    sad_off: int, ref_off: int, seq_len: int,
                    max_dup: int, lut: torch.Tensor | None = None,
                    lut_k: int = 0,
                    loads: torch.Tensor | None = None) -> torch.Tensor:
    """The reference seeding scan (IdentifySeedPairs), one lane per read.

    ``buf`` (R, words + words/2 + 1) int32 holds each read as
    [2-bit codes, 16 per word, top first | N bits, 32 per word, top
    first | rlen]. Returns (R, 1 + 4S) rows
    [n | rpos x S | len x S | k0 x S | freq x S], int32 on a narrow
    table and int64 on a wide one; a seed found by the
    locate-and-compare path has freq -1 and its genome position in k0.

    With a K-mer table ``lut`` (``lut_build_plain``) a walk starts K
    bases in: the key is the top 2K bits of the code window at ``pos``;
    the entry is dead if the window holds an N or runs past the read,
    and a dead entry advances ``pos`` by one, as the walk it stands for
    would have (it dies before K < 16 bases, so its seed is rejected).

    ``loads``, an (R, 5) int64 tensor on ``buf``'s device, counts for
    each read the dependent loads a one-thread-per-read kernel makes,
    one a step that reads the table, by kind: extension steps (two Occ
    rows each), locate steps (an LF row or a sample), compare steps (a
    window's genome words), K-mer table entries read at walk starts;
    and in its last column the walks started.
    """
    dev = buf.device
    R = buf.shape[0]
    nw = words // 2
    L = words * 16
    L2 = L2.long()
    W = table.shape[1]
    sh = _occ_shift(table)
    gsh = sh + 1  # log2 of the genome bases per row: 128 | 256
    use_lut = lut is not None and lut_k > 0
    b = _u32(buf)
    # one zero column past the read's words, for 2-word windows
    rw = torch.cat([b[:, :words], b.new_zeros((R, 1))], dim=1)
    nmw = torch.cat([b[:, words:words + nw], b.new_zeros((R, 1))], dim=1)
    # N bits in the code-word layout (2 bits per base), for compare
    e = torch.stack([nmw[:, :nw] >> 16, nmw[:, :nw] & 0xFFFF],
                    dim=2).reshape(R, words)
    e = (e | (e << 8)) & 0x00FF00FF
    e = (e | (e << 4)) & 0x0F0F0F0F
    e = (e | (e << 2)) & 0x33333333
    e = (e | (e << 1)) & EVEN
    nwd = torch.cat([e | (e << 1), b.new_zeros((R, 1))], dim=1)
    rl = buf[:, -1].long()

    out = torch.zeros((R, 1 + 4 * S), dtype=torch.int64, device=dev)
    ids = torch.arange(R, device=dev)
    end_pos = (rl - 13).clamp(min=0)
    z = torch.zeros(R, dtype=torch.int64, device=dev)
    pos, cur, x0, x1, x2, n, mode, lk, steps, gbase = (z.clone()
                                                       for _ in range(10))
    done = pos >= end_pos
    while True:
        n_done = int(done.sum())
        if n_done == ids.numel():
            break
        if n_done * 4 >= ids.numel():
            keep = (~done).nonzero().squeeze(1)
            (ids, rw, nmw, nwd, rl, end_pos, pos, cur, x0, x1, x2, n, mode,
             lk, steps, gbase, done) = (t[keep] for t in (
                 ids, rw, nmw, nwd, rl, end_pos, pos, cur, x0, x1, x2, n,
                 mode, lk, steps, gbase, done))
        act = ~done
        initing = act & (cur == pos)
        working = act & (cur > pos)
        scanning = working & (mode == 0)
        # an interval narrowed to one occurrence starts its LF walk now
        to_loc = scanning & (x2 == 1) & (cur < rl)
        scanning = scanning & ~to_loc
        locating = (working & (mode == 1)) | to_loc
        comparing = working & (mode == 2)
        lk_e = torch.where(to_loc, x0, lk)
        st_e = torch.where(to_loc, 0, steps)

        # the character at cur (== pos for initing lanes)
        sc = cur.clamp(max=L - 1)
        ch = (_gather1(rw, sc >> 4) >> ((~sc & 15) << 1)) & 3
        nbit = (_gather1(nmw, sc >> 5) >> (31 - (sc & 31))) & 1
        amb = (cur >= rl) | (nbit != 0)
        cs = torch.where(amb, 3, ch)
        if use_lut:
            # the K-mer at pos: top 2K bits of the 32-bit code window
            bo = (sc & 15) << 1
            w1 = _gather1(rw, sc >> 4)
            w2 = _gather1(rw, (sc >> 4) + 1)
            win = torch.where(bo == 0, w1,
                              ((w1 << bo) & M32) | (w2 >> (32 - bo)))
            no = sc & 31
            n1 = _gather1(nmw, sc >> 5)
            n2 = _gather1(nmw, (sc >> 5) + 1)
            nwin = torch.where(no == 0, n1,
                               ((n1 << no) & M32) | (n2 >> (32 - no)))
            bad = ((nwin >> (32 - lut_k)) != 0) | (cur + lut_k > rl)
            key = torch.where(initing & ~bad, win >> (32 - 2 * lut_k), 0)
            ent = _lut_rows(lut, key)
            i_x0, i_x1 = ent[:, 0], ent[:, 1]
            i_x2 = torch.where(bad, 0, ent[:, 2])
            init_ok = i_x2 > 0
            jump = lut_k
            lut_read = initing & ~bad
        else:
            i_x0 = L2[cs] + 1
            i_x1 = L2[3 - cs] + 1
            i_x2 = L2[cs + 1] - L2[cs]
            init_ok = ~amb
            jump = 1
            lut_read = torch.zeros_like(initing)

        if loads is not None:
            loads.index_add_(0, ids, torch.stack(
                [scanning, locating, comparing, lut_read, initing], 1).long())

        # the rows each mode reads
        q1 = torch.where(scanning, x1 - 1, torch.where(locating, lk_e, 0))
        q2 = torch.where(scanning, x1 - 1 + x2, 0)
        kkA = (q1 - (q1 >= primary).long()).clamp(min=0)
        kkB = (q2 - (q2 >= primary).long()).clamp(min=0)
        loc_hit = locating & ((lk_e % sa_intv) == 0)
        goff = gbase + cur
        gsafe = torch.where(comparing, goff, 0)
        rowA = torch.where(comparing, ref_off + (gsafe >> gsh),
                           torch.where(loc_hit,
                                       sad_off + ((lk_e // sa_intv) >> 3),
                                       kkA >> sh))
        rowB = torch.where(comparing, ref_off + (gsafe >> gsh) + 1,
                           kkB >> sh)
        colsA = _u32(table[rowA])
        colsB = _u32(table[rowB])
        occA = _occ4_cols(colsA, kkA)
        occB = _occ4_cols(colsB, kkB)

        # scan: one backward-search extension (BWT_Search)
        starts, nx1, w = _backward_ext(L2, x0, x1, x2, occA, occB, primary)
        ci = 3 - cs
        wi = _gather1(w, ci)
        can_extend = scanning & ~amb & (wi > 0)
        scan_end = scanning & ~can_extend

        # locate: one LF step, or read the sample at a sampled row
        loc_step = locating & ~loc_hit
        xx = lk_e - (lk_e > primary).long()
        bwt_words = _split_row(colsA)[1]
        word = _gather1(bwt_words, (xx >> 4) & (bwt_words.shape[1] - 1))
        cbit = (word >> ((~xx & 15) << 1)) & 3
        lk_next = torch.where(lk_e == primary, 0,
                              L2[cbit] + _gather1(occA, cbit))
        g_abs = st_e + _sample_at(colsA, (lk_e // sa_intv) & 7)

        # compare: up to 16 bases of read against genome
        jw = (gsafe >> 4) & (W - 1)
        gw1 = _gather1(colsA, jw)
        gw2 = torch.where(jw < W - 1,
                          _gather1(colsA, (jw + 1).clamp(max=W - 1)),
                          colsB[:, 0])
        aoff = (gsafe & 15) << 1
        gw = torch.where(aoff == 0, gw1,
                         ((gw1 << aoff) & M32) | (gw2 >> (32 - aoff)))
        qw = cur >> 4
        i1 = qw.clamp(max=words)
        i2 = (qw + 1).clamp(max=words)
        boff = (cur & 15) << 1
        rw1, rw2 = _gather1(rw, i1), _gather1(rw, i2)
        nm1, nm2 = _gather1(nwd, i1), _gather1(nwd, i2)
        rwin = torch.where(boff == 0, rw1,
                           ((rw1 << boff) & M32) | (rw2 >> (32 - boff)))
        nwin = torch.where(boff == 0, nm1,
                           ((nm1 << boff) & M32) | (nm2 >> (32 - boff)))
        v = (gw ^ rwin) | nwin
        # leading equal bases: the first nonzero 2-bit field of v
        diff = _fields(v[:, None], 16) != 0
        matched16 = torch.where(diff.any(dim=1), diff.int().argmax(dim=1), 16)
        avail = torch.minimum((rl - cur).clamp(max=16), seq_len - goff)
        matched = torch.minimum(matched16, avail.clamp(min=0))
        cur_c = cur + torch.where(comparing, matched, 0)
        cmp_end = comparing & ((matched < 16) | (cur_c >= rl)
                               | (gbase + cur_c >= seq_len))

        # seed end: accept (len >= 16, occurrences <= max_dup) and jump
        any_end = scan_end | cmp_end
        length = torch.where(cmp_end, cur_c, cur) - pos
        acc = ((scan_end & (x2 <= max_dup)) | cmp_end) & (length >= 16)
        n = n + acc.long()
        out[ids[acc], 0] = n[acc]
        a = (acc & (n <= S)).nonzero().squeeze(1)  # seeds past S are counted
        lane, slot = ids[a], n[a] - 1
        out[lane, 1 + slot] = pos[a]
        out[lane, 1 + S + slot] = length[a]
        out[lane, 1 + 2 * S + slot] = torch.where(cmp_end, gbase + pos, x0)[a]
        out[lane, 1 + 3 * S + slot] = torch.where(cmp_end, -1, x2)[a]

        new_pos = torch.where(any_end, torch.where(acc, pos + length, pos + 1),
                              torch.where(initing & ~init_ok, pos + 1, pos))
        init_now = initing & init_ok
        new_cur = torch.where(
            can_extend, cur + 1,
            torch.where(init_now, cur + jump,
                        torch.where(comparing & ~cmp_end, cur_c,
                                    torch.where(locating, cur, new_pos))))
        x0 = torch.where(can_extend, _gather1(starts, ci),
                         torch.where(init_now, i_x0, x0))
        x1 = torch.where(can_extend, _gather1(nx1, ci),
                         torch.where(init_now, i_x1, x1))
        x2 = torch.where(can_extend, wi, torch.where(init_now, i_x2, x2))
        mode = torch.where(loc_hit, 2, torch.where(
            to_loc, 1, torch.where(any_end, 0, mode)))
        lk = torch.where(locating, torch.where(loc_step, lk_next, lk_e), lk)
        steps = torch.where(locating,
                            torch.where(loc_step, st_e + 1, st_e), steps)
        gbase = torch.where(loc_hit, g_abs - pos, gbase)
        pos, cur = new_pos, new_cur
        done = done | (pos >= end_pos)
    return out if _is_wide(table) else out.to(torch.int32)
