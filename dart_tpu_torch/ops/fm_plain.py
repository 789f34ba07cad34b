"""Plain PyTorch versions of the two FM-index kernels.

These are the yardsticks of ``csrc/fm_kernels.cu``: the same inputs,
the same output layout, bit for bit. They run the JAX engine's
algorithm (``dart_tpu.ops.fm_jax._seed_scan_kernel`` with plain
one-character walk init, and ``_locate_kernel``) as masked loops over
lanes: every live lane takes one automaton step per loop iteration,
and finished lanes are dropped from the working set as they pile up.

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


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 tensor holding uint32 bits -> int64 with the unsigned value."""
    return t.long() & M32


def _fields(v: torch.Tensor, n: int) -> torch.Tensor:
    """(N, W) 32-bit words (int64) -> (N, W * n) fields of 32/n bits,
    first field from the top bits."""
    bits = 32 // n
    sh = torch.arange(32 - bits, -1, -bits, device=v.device)
    return ((v[..., None] >> sh) & ((1 << bits) - 1)).flatten(-2)


def _occ4_cols(cols: torch.Tensor, kk: torch.Tensor) -> torch.Tensor:
    """Occ(kk, c) for c = 0..3 from the gathered rows: (N, 8) words as
    int64, kk (N,) already adjusted for the primary row. -> (N, 4)."""
    bases = _fields(cols[:, 4:], 16)                        # (N, 64)
    upto = torch.arange(64, device=kk.device) <= (kk & 63)[:, None]
    hit = bases[:, :, None] == torch.arange(4, device=kk.device)
    return cols[:, :4] + (hit & upto[:, :, None]).sum(dim=1)


def _i32(v: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit values (int64) -> their int32 meaning (int64)."""
    return torch.where(v >= 2**31, v - 2**32, v)


def _gather1(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return t.gather(1, i[:, None]).squeeze(1)


def locate_plain(table: torch.Tensor, L2: torch.Tensor, rows: torch.Tensor,
                 *, primary: int, sa_intv: int, sad_off: int) -> torch.Tensor:
    """SA positions of BWT ``rows`` (bwt_sa): LF-walk each row to a
    sampled row (``primary`` maps to row 0), then add the sample read
    from the table's sample rows. -> (N,) int32."""
    L2 = L2.long()
    k = rows.long().clone()
    steps = torch.zeros_like(k)
    while True:
        act = ((k % sa_intv) != 0).nonzero().squeeze(1)
        if act.numel() == 0:
            break
        ka = k[act]
        kk = (ka - (ka >= primary).long()).clamp(min=0)
        x = ka - (ka > primary).long()
        cols = _u32(table[kk >> 6])
        bases = _fields(cols[:, 4:], 16)
        # x and kk share a row (they differ only at k == primary)
        c = _gather1(bases, x & 63)
        upto = torch.arange(64, device=k.device) <= (kk & 63)[:, None]
        occ = _gather1(cols, c) + ((bases == c[:, None]) & upto).sum(dim=1)
        nxt = L2[c] + occ
        k[act] = torch.where(ka == primary, 0, nxt)
        steps[act] += 1
    srow = k // sa_intv
    sample = _i32(_gather1(_u32(table[sad_off + (srow >> 3)]), srow & 7))
    return (steps + sample).to(torch.int32)


def seed_scan_plain(table: torch.Tensor, L2: torch.Tensor, buf: torch.Tensor,
                    *, words: int, S: int, primary: int, sa_intv: int,
                    sad_off: int, ref_off: int, seq_len: int,
                    max_dup: int) -> torch.Tensor:
    """The reference seeding scan (IdentifySeedPairs), one lane per read.

    ``buf`` (R, words + words/2 + 1) int32 holds each read as
    [2-bit codes, 16 per word, top first | N bits, 32 per word, top
    first | rlen]. Returns (R, 1 + 4S) int32 rows
    [n | rpos x S | len x S | k0 x S | freq x S]; a seed found by the
    locate-and-compare path has freq -1 and its genome position in k0.
    """
    dev = buf.device
    R = buf.shape[0]
    nw = words // 2
    L = words * 16
    L2 = L2.long()
    b = _u32(buf)
    # one zero column past the read's words, for 2-word windows
    rw = torch.cat([b[:, :words], b.new_zeros((R, 1))], dim=1)
    nmw = b[:, words:words + nw]
    # N bits in the code-word layout (2 bits per base), for compare
    e = torch.stack([nmw >> 16, nmw & 0xFFFF], dim=2).reshape(R, words)
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
        i_x0 = L2[cs] + 1
        i_x1 = L2[3 - cs] + 1
        i_x2 = L2[cs + 1] - L2[cs]
        init_ok = ~amb

        # the rows each mode reads
        q1 = torch.where(scanning, x1 - 1, torch.where(locating, lk_e, 0))
        q2 = torch.where(scanning, x1 - 1 + x2, 0)
        kkA = (q1 - (q1 >= primary).long()).clamp(min=0)
        kkB = (q2 - (q2 >= primary).long()).clamp(min=0)
        loc_hit = locating & ((lk_e % sa_intv) == 0)
        goff = gbase + cur
        gsafe = torch.where(comparing, goff, 0)
        rowA = torch.where(comparing, ref_off + (gsafe >> 7),
                           torch.where(loc_hit,
                                       sad_off + ((lk_e // sa_intv) >> 3),
                                       kkA >> 6))
        rowB = torch.where(comparing, ref_off + (gsafe >> 7) + 1, kkB >> 6)
        colsA = _u32(table[rowA])
        colsB = _u32(table[rowB])
        occA = _occ4_cols(colsA, kkA)
        occB = _occ4_cols(colsB, kkB)

        # scan: one backward-search extension (BWT_Search)
        w = occB - occA
        adj = ((x1 <= primary) & (x1 + x2 - 1 >= primary)).long()
        s3 = x0 + adj
        s2 = s3 + w[:, 3]
        s1 = s2 + w[:, 2]
        s0 = s1 + w[:, 1]
        starts = torch.stack([s0, s1, s2, s3], dim=1)
        nx1 = L2[:4][None, :] + 1 + occA
        ci = 3 - cs
        wi = _gather1(w, ci)
        can_extend = scanning & ~amb & (wi > 0)
        scan_end = scanning & ~can_extend

        # locate: one LF step, or read the sample at a sampled row
        loc_step = locating & ~loc_hit
        xx = lk_e - (lk_e > primary).long()
        word = _gather1(colsA, 4 + ((xx >> 4) & 3))
        cbit = (word >> ((~xx & 15) << 1)) & 3
        lk_next = torch.where(lk_e == primary, 0,
                              L2[cbit] + _gather1(occA, cbit))
        g_abs = st_e + _i32(_gather1(colsA, (lk_e // sa_intv) & 7))

        # compare: up to 16 bases of read against genome
        jw = (gsafe >> 4) & 7
        gw1 = _gather1(colsA, jw)
        gw2 = torch.where(jw < 7, _gather1(colsA, (jw + 1).clamp(max=7)),
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
            can_extend | init_now, cur + 1,
            torch.where(comparing & ~cmp_end, cur_c,
                        torch.where(locating, cur, new_pos)))
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
    return out.to(torch.int32)
