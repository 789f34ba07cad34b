"""The port's FM-index engine: seed scan, SA locate and MEM walks on one
device.

``FMIndexTorch`` serves the engine surface that the seeding code
(``pipeline.seeding``) calls: ``seed_submit_packed`` / ``seed_finish``
for packed chunks, ``seed_reads`` for code matrices, ``locate_submit``
/ ``locate_finish`` / ``locate`` for SA rows, ``_pad_up`` /
``_min_bucket`` for the packer, and ``mem_walks`` for the seeding path
of engines without the scan automaton
(``seeding.seed_reads_from_all_walks``).

One class serves both table layouts of ``ops.layout``: narrow (int32
state, the default below 2^31 text positions) and wide (int64 state,
required from 2^31 on, as ``dart_tpu.ops.fm_jax_wide.FMIndexJaxWide``).
With ``lut_k`` > 0 it builds the K-mer walk-state table at
construction, as a tensor of its own beside the merged table, and every
seed walk starts from it.

Given ``shard_devices`` (the devices of one data group of an
``index`` mesh axis, ``parallel.mesh``), the merged table is
range-sharded by row over them (``layout.ShardedTable``, one allocation
on each) and the kernels run on ``device`` reading every shard: the
``*_sharded`` kernels, whose launches count under names with that
suffix. The K-mer table is built once and kept whole on ``device``.

On a CUDA device every scan, locate, table build and MEM walk launches
the hand-written kernel of ``csrc/fm_kernels.cu`` (or raises); on the
CPU it runs the plain PyTorch version of ``ops.fm_plain``. The MEM walk
is narrow only, as in ``dart_tpu`` (``FMIndexJaxWide`` has none). Each
seed round ships the N mask with the reads, gives every read the
worst-case seed-slot count and runs every lane to its end in one
launch.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from . import build
from .fm_plain import (locate_plain, lut_build_plain, mem_walks_plain,
                       seed_scan_plain)
from .layout import ShardedTable, tables_from_index, to_device

# texts of this many positions or more need the wide (int64) engine
WIDE_MIN_SEQ = 2**31
# the largest K whose K-mer window fits one 32-bit code word
MAX_LUT_K = 15


class FMIndexTorch:
    # no compiled-shape set to keep small: chunks are not padded
    _min_bucket = 1

    def __init__(self, idx, device="cuda", max_dup_num: int = 100,
                 lut_k: int = 0, wide: bool | None = None,
                 shard_devices=None, tables: dict | None = None):
        """``shard_devices``: two or more devices to range-shard the
        table over (None: the whole table on ``device``). ``tables``:
        the host tables of ``layout.tables_from_index`` to upload, made
        for this layout and shard count (None: made here, from the
        layout cache where it applies; ``cache`` says how)."""
        self.device = torch.device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        if self.device.type == "cuda" and self.device.index is None:
            # the card by number, as the shards' tensors name theirs
            self.device = torch.device("cuda", torch.cuda.current_device())
        n_shards = len(shard_devices) if shard_devices else 1
        if not 0 <= lut_k <= MAX_LUT_K:
            raise ValueError(f"lut_k must be in 0..{MAX_LUT_K}, got {lut_k}")
        if wide is None:
            wide = idx.seq_len >= WIDE_MIN_SEQ
        elif not wide and idx.seq_len >= WIDE_MIN_SEQ:
            raise ValueError("a text of 2^31 positions or more needs the "
                             "wide engine")
        self.wide = bool(wide)
        self.idx_dtype = torch.int64 if self.wide else torch.int32
        self.lut_k = int(lut_k)
        self.n_seed_launches = 0
        self.n_locate_launches = 0
        self.n_locate_rows = 0  # rows located by the locate launches
        self.n_lut_launches = 0
        self.n_mem_walks_launches = 0
        t0 = time.perf_counter()
        tabs = tables if tables is not None else tables_from_index(
            idx, wide=self.wide, index_shards=n_shards)
        if tabs["wide"] != self.wide or tabs["index_shards"] != n_shards:
            raise ValueError("tables of another layout or shard count")
        self.primary = tabs["primary"]
        self.sa_intv = tabs["sa_intv"]
        self.ref_off = tabs["ref_off"]
        self.sad_off = tabs["sad_off"]
        self.seq_len = tabs["seq_len"]
        self.cache = tabs["cache"]  # how the layout cache served it
        self.max_dup_num = int(max_dup_num)
        dev = to_device(tabs, self.device,
                        shard_devices if n_shards > 1 else None)
        self.table, self.L2 = dev["table"], dev["L2"]
        self.sharded = isinstance(self.table, ShardedTable)
        if self.sharded:
            if self.table.device != self.device:
                raise ValueError("the first shard lives on the engine's "
                                 "device")
            if self.table.shape[0] >= 2**32:
                raise ValueError("a sharded table has fewer than 2^32 rows")
            if self.device.type == "cuda":
                self._enable_peer_access()
        self._bases, self._bases_of = None, None
        # the kernels' scalar arguments, in csrc's FmParams order: int64
        # for the wide kernels, whose positions pass 2^31
        self._params = np.array(
            [*tabs["L2"].tolist(), self.primary, self.sa_intv, self.sad_off,
             self.ref_off, self.seq_len, self.max_dup_num],
            dtype=np.int64 if self.wide else np.int32)
        self._sync()
        t1 = time.perf_counter()
        # the K-mer table stays out of the merged table: its 4^K rows
        # would spread every other gather over a larger address range
        self.lut = self.build_lut() if self.lut_k else None
        self._sync()
        self.setup_s = {"table": t1 - t0,
                        "lut": time.perf_counter() - t1}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _enable_peer_access(self) -> None:
        """Let the kernels on ``device`` read the shards on other cards;
        raises when a card cannot reach one of them."""
        lib = build.load()
        for d in {t.device for t in self.table.shards}:
            if d != self.device:
                rc = lib.dart_enable_peer_access(self.device.index, d.index)
                if rc != 0:
                    raise RuntimeError(f"{self.device} cannot read {d} "
                                       f"(peer access: CUDA error {rc})")

    @property
    def _tab(self) -> tuple:
        """The kernels' table arguments: the table's address (Flat), or
        the shards' address array and the rows of a shard (Sharded).
        Both are read from the table at each launch, so a table that was
        swapped or moved is never read at its old addresses."""
        if self.sharded:
            ptrs = tuple(t.data_ptr() for t in self.table.shards)
            if ptrs != self._bases_of:
                # the shards' addresses, in a device array for the kernels;
                # kernels still reading the old array finish first
                if self._bases is not None:
                    self._sync()
                self._bases = torch.tensor(ptrs, dtype=torch.int64,
                                           device=self.device)
                self._bases_of = ptrs
            return (self._bases.data_ptr(), self.table.rows)
        return (self.table.data_ptr(),)

    @property
    def _sfx(self) -> str:
        return ("_wide" if self.wide else "") + \
            ("_sharded" if self.sharded else "")

    @property
    def launches(self) -> dict:
        """Launch counts by kernel name (``_wide`` for the wide ones,
        ``_sharded`` for those reading a sharded table; ``mem_walks`` on
        the narrow engine only)."""
        sfx = self._sfx
        out = {f"seed_scan{sfx}": self.n_seed_launches,
               f"locate{sfx}": self.n_locate_launches,
               f"lut_build{sfx}": self.n_lut_launches}
        if not self.wide:
            out[f"mem_walks{sfx}"] = self.n_mem_walks_launches
        return out

    @staticmethod
    def _pad_up(n: int, floor: int = 1) -> int:
        return max(n, floor)

    @staticmethod
    def seed_slots(Lp: int, max_rlen: int) -> int:
        """Worst-case seed count of a read of max_rlen bases: each
        accepted seed advances the scan by >= 16 from a position below
        rlen - 13. Rounded up to even, as the JAX engine's tables are."""
        s = max(1, (max_rlen - 14) // 16 + 1)
        return min(Lp // 16, s + (s & 1))

    # ---- kernels ----

    def _check(self, t: torch.Tensor, ndim: int, dtype=torch.int32) -> None:
        if (t.device != self.table.device or t.dtype != dtype
                or t.dim() != ndim or not t.is_contiguous()):
            raise ValueError(f"expected a contiguous {ndim}-d {dtype} tensor "
                             f"on {self.table.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")

    def _launch(self, name: str, what: str, *args) -> None:
        """Launch kernel ``name`` (its C entry for this engine's layout
        and table access) with the table and the scalar parameters
        before ``args`` and the stream after them, on the engine's card
        (the current card, which a launch needs, may be another one) and
        its current stream; raise on the CUDA error the entry returns."""
        fn = getattr(build.load(), f"dart_fm_{name}{self._sfx}")
        with torch.cuda.device(self.device):
            rc = fn(*self._tab, self._params_ptr(), *args, self._stream())
        if rc != 0:
            raise RuntimeError(f"{what} launch failed: CUDA error {rc}")

    def seed_scan(self, buf: torch.Tensor, words: int, S: int) -> torch.Tensor:
        """Seed tables of the reads in ``buf`` (R, words + words/2 + 1)
        int32 -> (R, 1 + 4S) [n | rpos | len | k0 | freq], int32 narrow
        and int64 wide. Walks start from the K-mer table when the engine
        has one."""
        self._check(buf, 2)
        R = buf.shape[0]
        if buf.shape[1] != words + words // 2 + 1 or words % 2:
            raise ValueError(f"buf width {buf.shape[1]} != packed width of "
                             f"{words} code words")
        if buf.device.type == "cpu":
            return self.plain_seed_scan(buf, words, S)
        out = torch.empty((R, 1 + 4 * S), dtype=self.idx_dtype,
                          device=self.device)
        if R:
            self._launch("seed_scan", "seed scan",
                         self.lut.data_ptr() if self.lut_k else None,
                         self.lut_k, buf.data_ptr(), R, words, S,
                         out.data_ptr())
            self.n_seed_launches += 1
        return out

    def locate_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """SA positions of BWT rows (N,) -> (N,), int32 narrow and int64
        wide."""
        self._check(rows, 1, self.idx_dtype)
        if rows.device.type == "cpu":
            return self.plain_locate(rows)
        out = torch.empty_like(rows)
        if rows.numel():
            self._launch("locate", "locate", rows.data_ptr(), rows.numel(),
                         out.data_ptr())
            self.n_locate_launches += 1
            self.n_locate_rows += rows.numel()
        return out

    def build_lut(self) -> torch.Tensor:
        """The K-mer walk-state table for K = ``lut_k`` (> 0): (4^K, 4)
        int32 [x0, x1, x2, 0] narrow, (4^K, 3) int64 wide. On a CUDA
        device, two kernel launches (the subtrees' roots, then the
        subtrees), one at K = 1 (the roots are the table)."""
        K = self.lut_k
        if self.device.type == "cpu":
            return self.plain_build_lut()
        shape = (4**K, 3) if self.wide else (4**K, 4)
        out = torch.empty(shape, dtype=self.idx_dtype, device=self.device)
        self._launch("lut_build", "LUT build", K, out.data_ptr())
        self.n_lut_launches += 2 if K > 1 else 1
        return out

    def mem_walk_rows(self, chars: torch.Tensor, valid: torch.Tensor):
        """Forward MEM walks of the tasks ``chars`` (W, L >= 1) uint8
        codes (> 3 is N) and ``valid`` (W, L) bool -> (lens, x0, x2),
        each (W,) int32 (see ``fm_plain.mem_walks_plain``). Narrow
        engine only."""
        if self.wide:
            raise NotImplementedError("the wide engine has no MEM walk, as "
                                      "dart_tpu's FMIndexJaxWide has none")
        self._check(chars, 2, torch.uint8)
        self._check(valid, 2, torch.bool)
        W, L = chars.shape
        if valid.shape != chars.shape or L == 0:
            raise ValueError(f"chars {tuple(chars.shape)} and valid "
                             f"{tuple(valid.shape)}: expected one (W, L >= 1) "
                             "shape")
        if chars.device.type == "cpu":
            return self.plain_mem_walks(chars, valid)
        lens, x0, x2 = (torch.empty(W, dtype=torch.int32, device=self.device)
                        for _ in range(3))
        if W:
            self._launch("mem_walks", "MEM walk", chars.data_ptr(),
                         valid.data_ptr(), W, L, lens.data_ptr(),
                         x0.data_ptr(), x2.data_ptr())
            self.n_mem_walks_launches += 1
        return lens, x0, x2

    def _params_ptr(self):
        ct = ctypes.c_int64 if self.wide else ctypes.c_int
        return self._params.ctypes.data_as(ctypes.POINTER(ct))

    def _stream(self) -> int:
        return torch.cuda.current_stream(self.device).cuda_stream

    def plain_seed_scan(self, buf: torch.Tensor, words: int, S: int,
                        loads: torch.Tensor | None = None) -> torch.Tensor:
        """The plain PyTorch version of ``seed_scan`` on any device
        (``loads`` as ``fm_plain.seed_scan_plain`` takes it)."""
        return seed_scan_plain(
            self.table, self.L2, buf, words=words, S=S, primary=self.primary,
            sa_intv=self.sa_intv, sad_off=self.sad_off, ref_off=self.ref_off,
            seq_len=self.seq_len, max_dup=self.max_dup_num, lut=self.lut,
            lut_k=self.lut_k, loads=loads)

    def plain_locate(self, rows: torch.Tensor,
                     lf_steps: torch.Tensor | None = None) -> torch.Tensor:
        """The plain PyTorch version of ``locate_rows`` on any device
        (``lf_steps`` as ``fm_plain.locate_plain`` takes it)."""
        return locate_plain(self.table, self.L2, rows, primary=self.primary,
                            sa_intv=self.sa_intv, sad_off=self.sad_off,
                            lf_steps=lf_steps)

    def plain_build_lut(self) -> torch.Tensor:
        """The plain PyTorch version of ``build_lut`` on any device."""
        return lut_build_plain(self.table, self.L2, primary=self.primary,
                               K=self.lut_k)

    def plain_mem_walks(self, chars: torch.Tensor, valid: torch.Tensor,
                        steps: torch.Tensor | None = None):
        """The plain PyTorch version of ``mem_walk_rows`` on any device
        (``steps`` as ``fm_plain.mem_walks_plain`` takes it)."""
        return mem_walks_plain(self.table, self.L2, chars, valid,
                               primary=self.primary, steps=steps)

    # ---- engine surface of the seeding code ----

    def seed_reads(self, codes: np.ndarray, rlens: np.ndarray):
        """Seed tables of a (R, L) code matrix (codes > 3 are N).
        Returns (n (R,), rpos/len (R, S) int32, k0 (R, S) int64,
        freq (R, S) int32)."""
        R, L = codes.shape
        if L >= 65536:
            raise ValueError("reads must be shorter than 65536 bases")
        buf, nmask, Lp = pack_codes(codes, rlens)
        max_rlen = int(np.max(rlens)) if R else 1
        return self.seed_finish(self.seed_submit_packed(
            buf, nmask, None, 0, R, Lp, max_rlen))

    def seed_submit_packed(self, buf, nmask, has_n, n_with_n: int,
                           nlive: int, Lp: int, max_rlen: int):
        """Start the seed scan of the first ``nlive`` packed reads
        without waiting for it. ``buf`` is (>= nlive, Lp/16 + 1) uint32
        [codes | rlen] and ``nmask`` (>= nlive, Lp/32) uint32, as the
        native packer fills them; ``has_n`` and ``n_with_n`` are not
        needed, since the mask always goes with the reads."""
        words = Lp // 16
        S = self.seed_slots(Lp, max_rlen)
        dev = torch.from_numpy(pack_host(buf, nmask, nlive, words))
        return {"out": self.seed_scan(dev.to(self.device), words, S),
                "S": S}

    def seed_finish(self, job, on_wait=None):
        """Wait for a submitted scan. Returns (n, rpos, len, k0, freq)."""
        o = job["out"].cpu().numpy()
        if on_wait is not None:
            on_wait()
        return self.split_seeds(o, job["S"])

    @staticmethod
    def split_seeds(o: np.ndarray, S: int):
        """The seed-scan rows (R, 1 + 4S) as (n, rpos, len, k0, freq)."""
        return (o[:, 0].astype(np.int32), o[:, 1:1 + S].astype(np.int32),
                o[:, 1 + S:1 + 2 * S].astype(np.int32),
                o[:, 1 + 2 * S:1 + 3 * S].astype(np.int64),
                o[:, 1 + 3 * S:1 + 4 * S].astype(np.int32))

    def locate_submit(self, rows: np.ndarray):
        """Start locating SA rows without waiting; None when empty."""
        if rows.shape[0] == 0:
            return None
        t = torch.from_numpy(np.asarray(
            rows, dtype=np.int64 if self.wide else np.int32))
        return self.locate_rows(t.to(self.device))

    def locate_finish(self, job) -> np.ndarray:
        if job is None:
            return np.empty(0, dtype=np.int64)
        return job.cpu().numpy().astype(np.int64)

    def locate(self, rows: np.ndarray) -> np.ndarray:
        return self.locate_finish(self.locate_submit(rows))

    def mem_walks(self, chars: np.ndarray, valid: np.ndarray):
        """Forward MEM walks of (W, L) tasks given as numpy arrays, as
        ``FMIndexJax.mem_walks`` takes them -> (lens, x0, x2) int64 (W,).
        Narrow engine only."""
        c = torch.from_numpy(np.ascontiguousarray(chars, dtype=np.uint8))
        v = torch.from_numpy(np.ascontiguousarray(valid, dtype=bool))
        out = self.mem_walk_rows(c.to(self.device), v.to(self.device))
        return tuple(t.cpu().numpy().astype(np.int64) for t in out)


def pack_host(buf: np.ndarray, nmask: np.ndarray, nlive: int,
              words: int) -> np.ndarray:
    """The first nlive reads of the native packer's buffers as the seed
    scan's input rows, int32: [codes | N bits | rlen]."""
    return np.concatenate([buf[:nlive, :words], nmask[:nlive],
                           buf[:nlive, words:words + 1]],
                          axis=1).view(np.int32)


def pack_codes(codes: np.ndarray, rlens: np.ndarray):
    """Pack a (R, L) code matrix as the native packer does: 2-bit codes,
    16 per uint32 word, first base in the top bits, with an rlen column
    (buf, (R, Lp/16 + 1)); and a 1-bit N mask, 32 bases per word, top
    first (nmask, (R, Lp/32)). Bases past rlen pack as code 3 with no N
    bit. Returns (buf, nmask, Lp)."""
    R, L = codes.shape
    Lp = max(32, -(-L // 32) * 32)
    words = Lp // 16
    rl = np.asarray(rlens, dtype=np.int32)
    cp = np.full((R, Lp), 4, dtype=np.uint8)
    cp[:, :L] = codes
    in_read = np.arange(Lp, dtype=np.int32)[None, :] < rl[:, None]
    c2 = np.where(in_read, np.minimum(cp, 3), 3).astype(np.uint32)
    isn = ((cp > 3) & in_read).astype(np.uint32)
    buf = np.zeros((R, words + 1), dtype=np.uint32)
    nmask = np.zeros((R, words // 2), dtype=np.uint32)
    for k in range(16):
        buf[:, :words] |= c2[:, k::16] << np.uint32(2 * (15 - k))
    for k in range(32):
        nmask |= isn[:, k::32] << np.uint32(31 - k)
    buf[:, words] = rl.view(np.uint32)
    return buf, nmask, Lp
