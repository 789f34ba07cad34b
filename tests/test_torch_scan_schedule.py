"""The schedule of the seed-scan kernel (``seed_scan_kernel`` in
``dart_tpu_torch/csrc/fm_kernels.cu``), modelled on the CPU, held equal
to the plain version (``fm_plain.seed_scan_plain``, the literal scan).

The kernel runs one read per thread as a state machine whose every step
issues its loads at once, and takes three shortcuts that must change no
output bit: a match narrowed to one occurrence keeps extending beside
its locate (and is rejected as soon as it stops short of 16 bases), the
scan stops at rlen - 15, and a walk rejected at the read's end with
x2 >= 2 ends the scan. No CUDA runs here, so ``model_scan`` follows the
kernel line for line in Python, on the same table and K-mer table; the
card's tests (``chip_smoke.py``) hold the kernel itself to the plain
version. The reads: the toy set's reads with mismatches and N, at K = 0
and K = 8, narrow and wide; repeat reads (the telomeric repeat, the same
with a mismatch in its last base, a tandem repeat, a repeat ending in
unique sequence) at ``max_dup`` 0, 1 and 100. The model also counts its
dependent loads, which must never exceed the plain scan's."""

import numpy as np
import pytest
import torch

from dart_tpu_torch.index import build_index, load_index
from dart_tpu_torch.ops.fm_torch import FMIndexTorch, pack_codes

START, EXTEND, LOCATE, COMPARE, DONE = range(5)
M32 = 0xFFFFFFFF


class Model:
    """The kernel's table reads and arithmetic on one engine's tables."""

    def __init__(self, eng):
        t = eng.table.numpy().view(np.uint32)
        self.wide = eng.wide
        self.t = t
        self.shift = 7 if eng.wide else 6
        self.rw = t.shape[1]  # words a row
        nb = 8 if eng.wide else 4  # BWT words of an Occ row
        words = t[:, self.rw - nb:].astype(np.uint64)
        sh = np.arange(30, -1, -2, dtype=np.uint64)
        self.bases = ((words[:, :, None] >> sh) & 3).astype(
            np.uint8).reshape(t.shape[0], -1)
        self.L2 = [int(v) for v in eng.L2.tolist()]
        self.primary, self.sa_intv = eng.primary, eng.sa_intv
        self.sad_off, self.ref_off = eng.sad_off, eng.ref_off
        self.seq_len, self.max_dup = eng.seq_len, eng.max_dup_num
        self.lut = None if eng.lut is None else eng.lut.numpy()
        self.k = eng.lut_k

    def occ(self, row, c):
        w = self.t[row]
        return int(w[c]) | (int(w[4 + c]) << 32 if self.wide else 0)

    def occ4(self, row, kk):
        take = (kk & ((1 << self.shift) - 1)) + 1
        b = self.bases[row, :take]
        return [self.occ(row, c) + int((b == c).sum()) for c in range(4)]

    def occ_pos(self, q):
        return max(q - (q >= self.primary), 0)

    def extend_rows(self, ra, rb, ci, x):
        x0, x1, x2 = x
        tk = self.occ4(ra, self.occ_pos(x1 - 1))
        tl = self.occ4(rb, self.occ_pos(x1 - 1 + x2))
        w = [tl[c] - tk[c] for c in range(4)]
        if w[ci] <= 0:
            return None
        x0 += int(x1 <= self.primary <= x1 + x2 - 1) + sum(w[ci + 1:])
        return [x0, self.L2[ci] + 1 + tk[ci], w[ci]]

    def lf_row(self, row, k):
        kk = k - (k > self.primary)
        lo = kk & ((1 << self.shift) - 1)
        c = int(self.bases[row, lo])
        return (self.L2[c] + self.occ(row, c)
                + int((self.bases[row, :lo + 1] == c).sum()))

    def word(self, row, w):
        return int(self.t[row, w])

    def sample(self, row, s):
        w = s & 7
        if self.wide:
            return self.word(row, w) | (self.word(row, 8 + w) << 32)
        v = self.word(row, w)
        return v - (1 << 32) if v >= 1 << 31 else v

    def lut_entry(self, key):
        e = [int(v) for v in self.lut[key][:3]]
        return e if self.wide else [v & M32 for v in e]


class Read:
    """One packed read row: [codes | N bits | rlen]."""

    def __init__(self, row, words):
        self.codes = [int(v) & M32 for v in row[:words]] + [0]
        self.nmask = [int(v) & M32 for v in row[words:words + words // 2]]
        self.nmask += [0]
        self.rlen = int(row[-1])

    def base_at(self, i):
        return (self.codes[i >> 4] >> (2 * (15 - (i & 15)))) & 3

    def is_n(self, i):
        return (self.nmask[i >> 5] >> (31 - (i & 31))) & 1

    def code_window(self, i):
        qi, qa = i >> 4, (i & 15) * 2
        w = self.codes[qi]
        return ((w << qa) | (self.codes[qi + 1] >> (32 - qa))) & M32 \
            if qa else w

    def n_window(self, i):
        ni, na = i >> 5, i & 31
        w = self.nmask[ni]
        return ((w << na) | (self.nmask[ni + 1] >> (32 - na))) & M32 \
            if na else w

    def kmer_ok(self, pos, k):
        return (self.n_window(pos) >> (32 - k)) == 0 and pos + k <= self.rlen

    def kmer_key(self, pos, k):
        return self.code_window(pos) >> (32 - 2 * k)

    def match16(self, gw, cur, goff, seq_len):
        x = self.n_window(cur) >> 16
        spread = 0
        for i in range(16):
            if (x >> (15 - i)) & 1:
                spread |= 3 << (2 * (15 - i))
        v = (gw ^ self.code_window(cur)) | spread
        m16 = 16
        for i in range(16):
            if (v >> (2 * (15 - i))) & 3:
                m16 = i
                break
        return min(m16, max(min(16, self.rlen - cur, seq_len - goff), 0))


def model_scan(m: Model, rd: Read, S: int):
    """The kernel's scan of one read: (its output row, its loads)."""
    out = [0] * (1 + 4 * S)
    end_pos = max(rd.rlen - 15, 0)
    st = {"n": 0, "pos": 0, "mode": START}
    cur, ext = 0, False
    x = [0, 0, 0]
    lk = steps = gbase = 0
    npos, want_next, nx = -1, False, [0, 0, 0]
    loads = 0

    def end_walk(length, acc, k0, freq, last):
        n = st["n"]
        if acc:
            if n < S:
                out[1 + n], out[1 + S + n] = st["pos"], length
                out[1 + 2 * S + n], out[1 + 3 * S + n] = k0, freq
            st["n"] += 1
            st["pos"] += length
        else:
            st["pos"] += 1
        st["mode"] = DONE if last else START

    while True:
        ra = rb = rc = None
        key = nkey = None
        sampled = False
        while st["mode"] != DONE:  # 1. settle
            pos, mode = st["pos"], st["mode"]
            if mode == START:
                if pos >= end_pos:
                    st["mode"] = DONE
                    break
                if m.k:
                    if npos == pos:
                        npos = -1
                        if nx[2] == 0:
                            st["pos"] += 1
                            continue
                        x, cur, want_next = list(nx), pos + m.k, True
                        st["mode"] = EXTEND
                        continue
                    if not rd.kmer_ok(pos, m.k):
                        st["pos"] += 1
                        continue
                    key = rd.kmer_key(pos, m.k)
                    break
                if rd.is_n(pos):
                    st["pos"] += 1
                    continue
                c = rd.base_at(pos)
                x = [m.L2[c] + 1, m.L2[3 - c] + 1, m.L2[c + 1] - m.L2[c]]
                cur = pos + 1
                st["mode"] = EXTEND
                continue
            if mode == EXTEND:
                if x[2] == 1 and cur < rd.rlen:
                    lk, steps, ext = x[0], 0, True
                    st["mode"] = LOCATE
                    continue
                if cur < rd.rlen and not rd.is_n(cur):
                    ra = m.occ_pos(x[1] - 1) >> m.shift
                    rb = m.occ_pos(x[1] - 1 + x[2]) >> m.shift
                    break
                length = cur - pos
                acc = x[2] <= m.max_dup and length >= 16
                end_walk(length, acc, x[0], x[2],
                         not acc and cur == rd.rlen and x[2] >= 2)
                continue
            if mode == LOCATE:
                if ext and not (cur < rd.rlen and not rd.is_n(cur)):
                    ext = False
                if not ext and cur - pos < 16:
                    end_walk(cur - pos, False, 0, 0, False)
                    continue
                sampled = lk % m.sa_intv == 0 or steps > m.seq_len
                if not sampled and lk == m.primary:
                    lk, steps = 0, steps + 1
                    continue
                ra = (m.sad_off + ((lk // m.sa_intv) >> 3) if sampled
                      else (lk - (lk > m.primary)) >> m.shift)
                if ext:
                    rb = m.occ_pos(x[1] - 1) >> m.shift
                    rc = m.occ_pos(x[1] - 1 + x[2]) >> m.shift
                break
            if cur < rd.rlen and gbase + cur < m.seq_len:  # COMPARE
                gi = (gbase + cur) >> 4
                ra, rb = m.ref_off + gi // m.rw, m.ref_off + (gi + 1) // m.rw
                break
            end_walk(cur - pos, cur - pos >= 16, gbase + pos, -1, False)
        if st["mode"] == DONE:
            break
        if m.k and want_next and st["mode"] in (EXTEND, LOCATE):
            # with a walk's first load, the K-mer entry of pos + 1
            want_next, npos, nx = False, st["pos"] + 1, [0, 0, 0]
            if npos < end_pos and rd.kmer_ok(npos, m.k):
                nkey = rd.kmer_key(npos, m.k)
        loads += 1  # 2. one step: its loads all issued at once
        if nkey is not None:
            nx = m.lut_entry(nkey)
        rb = ra if rb is None else rb
        pos, mode = st["pos"], st["mode"]
        if mode == START:  # 3. apply
            e = m.lut_entry(key)
            if e[2] == 0:
                st["pos"] += 1
            else:
                x, cur, want_next = e, pos + m.k, True
                st["mode"] = EXTEND
        elif mode == EXTEND:
            nxt = m.extend_rows(ra, rb, 3 - rd.base_at(cur), x)
            if nxt is not None:
                x, cur = nxt, cur + 1
            else:
                length = cur - pos
                end_walk(length, x[2] <= m.max_dup and length >= 16, x[0],
                         x[2], False)
        elif mode == LOCATE:
            if ext:
                nxt = m.extend_rows(rb, rc, 3 - rd.base_at(cur), x)
                if nxt is not None:
                    x, cur = nxt, cur + 1
                else:
                    ext = False
            if not sampled:
                lk, steps = m.lf_row(ra, lk), steps + 1
            else:
                gbase = steps + m.sample(ra, lk // m.sa_intv) - pos
                if ext:
                    st["mode"] = COMPARE
                else:
                    end_walk(cur - pos, cur - pos >= 16, gbase + pos, -1,
                             False)
        else:
            goff = gbase + cur
            gi, ga = goff >> 4, (goff & 15) * 2
            gw = m.word(ra, gi % m.rw)
            if ga:
                gw = ((gw << ga) | (m.word(rb, (gi + 1) % m.rw)
                                    >> (32 - ga))) & M32
            mt = rd.match16(gw, cur, goff, m.seq_len)
            cur += mt
            if mt < 16 or cur >= rd.rlen or gbase + cur >= m.seq_len:
                end_walk(cur - pos, cur - pos >= 16, gbase + pos, -1, False)
    out[0] = st["n"]
    return out, loads


def check(eng, codes, rlens):
    """The model's output equal to the plain scan's, read by read; its
    loads never more than the plain scan's. Returns both loads, read by
    read."""
    buf, nmask, Lp = pack_codes(codes, rlens)
    words = Lp // 16
    S = FMIndexTorch.seed_slots(Lp, int(rlens.max()))
    host = np.concatenate([buf[:, :words], nmask, buf[:, words:]], axis=1)
    t = torch.from_numpy(host.view(np.int32))
    kinds = torch.zeros((len(rlens), 5), dtype=torch.int64)
    want = eng.plain_seed_scan(t, words, S, loads=kinds).numpy()
    plain_loads = kinds[:, :4].sum(1).numpy()
    m = Model(eng)
    model_loads = np.zeros(len(rlens), np.int64)
    for r in range(len(rlens)):
        got, model_loads[r] = model_scan(m, Read(host[r], words), S)
        np.testing.assert_array_equal(np.array(got), want[r],
                                      err_msg=f"read {r}")
    assert (model_loads <= plain_loads).all()
    return model_loads, plain_loads


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def toy(golden_dir):
    return load_index(str(golden_dir / "index" / "toy"))


@pytest.fixture(scope="module")
def repeat_index(tmp_path_factory):
    """The telomeric repeat, then unique sequence from a seed."""
    d = tmp_path_factory.mktemp("schedrep")
    rng = np.random.default_rng(7)
    seq = ("TTAGGG" * 2000)[:12000] + "".join(rng.choice(list("ACGT"),
                                                         12000))
    (d / "rep.fa").write_text(">rep\n" + "\n".join(
        seq[i:i + 70] for i in range(0, len(seq), 70)) + "\n")
    build_index(str(d / "rep.fa"), str(d / "rep"))
    return load_index(str(d / "rep"))


def toy_reads(idx, n=48, L=100, seed=3):
    """Genome reads with 3% substitutions, N bases among them, and a few
    short ones."""
    rng = np.random.default_rng(seed)
    codes = np.stack([idx.ref_codes[p:p + L] for p in
                      rng.integers(0, idx.seq_len - L, n)]).astype(np.uint8)
    mut = rng.random(codes.shape) < 0.03
    codes = np.where(mut, rng.integers(0, 5, codes.shape), codes)
    rlens = np.full(n, L, np.int32)
    rlens[:4] = (10, 15, 16, 31)
    return codes.astype(np.uint8), rlens


def repeat_reads(idx, L=64):
    telo = np.tile(np.array([3, 3, 0, 2, 2, 2], np.uint8), L // 6 + 1)[:L]
    last = telo.copy()
    last[-1] = (last[-1] + 1) % 4  # a mismatch in the last base
    tandem = np.tile(np.array([0, 1], np.uint8), L // 2)
    edge = np.concatenate([telo[:L // 2], idx.ref_codes[12000:12000 + L // 2]])
    mid = telo.copy()
    mid[L // 2] = 4  # an N in the middle
    return np.stack([telo, last, tandem, edge, mid]), np.full(5, L, np.int32)


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("lut_k", [0, 8])
def test_schedule_equals_plain_on_toy_reads(toy, wide, lut_k):
    eng = FMIndexTorch(toy, "cpu", lut_k=lut_k, wide=wide)
    model, plain = check(eng, *toy_reads(toy))
    assert model.sum() < plain.sum()  # rejected walks wait for no locate


@pytest.mark.parametrize("max_dup", [0, 1, 100])
@pytest.mark.parametrize("lut_k", [0, 8])
def test_schedule_equals_plain_on_repeat_reads(repeat_index, max_dup,
                                               lut_k):
    eng = FMIndexTorch(repeat_index, "cpu", max_dup_num=max_dup,
                       lut_k=lut_k)
    codes, rlens = repeat_reads(repeat_index)
    model, plain = check(eng, codes, rlens)
    # the telomeric read's walks all reach its end: the first rejected
    # one ends the scan instead of the O(L^2) restarts
    assert model[0] * 20 < plain[0]
