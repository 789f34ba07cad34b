"""The FM-index engine over a (data, index) grid of devices: the port of
``dart_tpu.parallel.mesh`` (``--mesh data=N[,index=M]``).

- ``data``: each chunk's reads (seed-scan lanes, locate rows, MEM-walk
  tasks) split into ``data`` contiguous, nearly equal slices, one per
  data group. A slice launches on its group's first device, on the
  group's own stream, without waiting; the ``*_finish`` calls copy the
  slices back and join them in order, so the output order is that of a
  single device. A chunk with fewer reads than groups leaves some
  slices empty; they launch nothing.
- ``index``: within a group the merged table is range-sharded by row
  over the group's ``index`` devices (``ops.layout.ShardedTable``, a
  separate allocation on each), and the ``*_sharded`` kernels on the
  group's first device read every shard, peer to peer across cards.
  The K-mer table is built once per group, whole, on that first device.

``dart_tpu`` hands the same programs to XLA's GSPMD partitioner; here
each group is an ``FMIndexTorch`` of its own, and the split is host
code. With fewer cards than slots, slots go round-robin onto the cards
there are, each with its own allocation and its own stream; on one card
the grid then tests the splitting and the sharded reads, not scaling.
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from ..ops.fm_torch import WIDE_MIN_SEQ, FMIndexTorch, pack_codes, pack_host
from ..ops.layout import tables_from_index


def parse_mesh(spec: str) -> tuple[int, int]:
    """(data, index) of a ``--mesh`` spec such as ``data=4,index=2``,
    read as ``dart_tpu.aligner.make_engine`` reads it (a missing axis
    is 1)."""
    axes = dict(kv.split("=") for kv in spec.split(",") if "=" in kv)
    return int(axes.get("data", 1)), int(axes.get("index", 1))


def make_mesh(n_devices: int, index_shards: int = 1, device="cuda"):
    """A (data, index) grid of ``torch.device``s, ``n_devices`` slots
    with ``index_shards`` a row: a list of ``n_devices // index_shards``
    data groups, each a list of its index devices. On ``cuda`` slot i
    is card (first + i) mod the card count, ``first`` being the index
    of ``device`` (0 for ``cuda``); fewer cards than slots is said on
    stderr, and a CUDA device without a card raises: the grid never
    falls back to the CPU. On ``cpu`` every slot is the CPU."""
    if n_devices < 1 or index_shards < 1 or n_devices % index_shards:
        raise ValueError(f"{n_devices} slots do not split into rows of "
                         f"{index_shards} index shards")
    dev = torch.device(device)
    if dev.type == "cpu":
        slots = [dev] * n_devices
    elif dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for the mesh: pass --device "
                               "cpu to run it on the CPU")
        count = torch.cuda.device_count()
        first = dev.index or 0
        slots = [torch.device("cuda", (first + i) % count)
                 for i in range(n_devices)]
        if count < n_devices:
            print(f"mesh: {n_devices} slots on {count} CUDA device(s), "
                  "placed round-robin", file=sys.stderr)
    else:
        raise ValueError(f"unsupported device {dev}")
    return [slots[g:g + index_shards]
            for g in range(0, n_devices, index_shards)]


class ShardedFMIndexTorch:
    """The engine surface of ``FMIndexTorch`` (``seed_submit_packed`` /
    ``seed_finish``, ``seed_reads``, ``locate_submit`` /
    ``locate_finish`` / ``locate``, ``mem_walks`` on the narrow engine,
    ``_pad_up``, ``_min_bucket``, ``launches``) over a ``make_mesh``
    grid. ``wide`` as ``FMIndexTorch`` takes it (None: from 2^31 text
    positions on)."""

    _min_bucket = 1

    def __init__(self, idx, mesh, max_dup_num: int = 100, lut_k: int = 0,
                 wide: bool | None = None):
        self.mesh = [list(g) for g in mesh]
        n_index = len(self.mesh[0])
        if any(len(g) != n_index for g in self.mesh):
            raise ValueError("every data group has the same index devices")
        if wide is None:
            wide = idx.seq_len >= WIDE_MIN_SEQ
        t0 = time.perf_counter()
        tabs = tables_from_index(idx, wide=wide, index_shards=n_index)
        host_s = time.perf_counter() - t0
        self.groups = [FMIndexTorch(idx, g[0], max_dup_num=max_dup_num,
                                    lut_k=lut_k, wide=wide,
                                    shard_devices=g if n_index > 1 else None,
                                    tables=tabs)
                       for g in self.mesh]
        self._streams = [torch.cuda.Stream(g.device)
                         if g.device.type == "cuda" else None
                         for g in self.groups]
        first = self.groups[0]
        self.wide, self.lut_k = first.wide, first.lut_k
        self.max_dup_num = first.max_dup_num
        self.setup_s = {"table": host_s + sum(g.setup_s["table"]
                                              for g in self.groups),
                        "lut": sum(g.setup_s["lut"] for g in self.groups)}

    @property
    def shape(self) -> dict:
        return {"data": len(self.mesh), "index": len(self.mesh[0])}

    @property
    def slot_launches(self) -> list[dict]:
        """Each data group's launch counts (its kernels run on its first
        device)."""
        return [g.launches for g in self.groups]

    @property
    def launches(self) -> dict:
        """Launch counts by kernel name, summed over the data groups."""
        out: dict = {}
        for g in self.groups:
            for k, v in g.launches.items():
                out[k] = out.get(k, 0) + v
        return out

    @staticmethod
    def _pad_up(n: int, floor: int = 1) -> int:
        return max(n, floor)

    def _slices(self, n: int):
        """(group, its stream, lo, hi) of each nonempty slice of n rows
        split over the data groups (the stream None on the CPU)."""
        G = len(self.groups)
        for g, (eng, stream) in enumerate(zip(self.groups, self._streams)):
            lo, hi = n * g // G, n * (g + 1) // G
            if hi > lo:
                yield eng, stream, lo, hi

    @staticmethod
    def _on(stream):
        """Make ``stream`` current (and its device) for the block."""
        return (torch.cuda.stream(stream) if stream is not None
                else contextlib.nullcontext())

    def _gather(self, parts, empty: np.ndarray) -> np.ndarray:
        """The slices' results, copied back in order, each on its own
        stream; ``empty`` when there were none."""
        out = []
        for stream, t in parts:
            with self._on(stream):
                out.append(t.cpu().numpy())
        return np.concatenate(out) if out else empty

    def seed_submit_packed(self, buf, nmask, has_n, n_with_n: int,
                           nlive: int, Lp: int, max_rlen: int):
        """``FMIndexTorch.seed_submit_packed`` with the first ``nlive``
        reads split over the data groups."""
        words = Lp // 16
        S = FMIndexTorch.seed_slots(Lp, max_rlen)
        host = pack_host(buf, nmask, nlive, words)
        parts = []
        for eng, stream, lo, hi in self._slices(nlive):
            with self._on(stream):
                dev = torch.from_numpy(host[lo:hi]).to(eng.device)
                parts.append((stream, eng.seed_scan(dev, words, S)))
        return {"parts": parts, "S": S}

    def seed_finish(self, job, on_wait=None):
        """Wait for a submitted scan. Returns (n, rpos, len, k0, freq)."""
        S = job["S"]
        o = self._gather(job["parts"], np.zeros((0, 1 + 4 * S), np.int64))
        if on_wait is not None:
            on_wait()
        return FMIndexTorch.split_seeds(o, S)

    def seed_reads(self, codes: np.ndarray, rlens: np.ndarray):
        """Seed tables of a (R, L) code matrix, as
        ``FMIndexTorch.seed_reads`` returns them."""
        R, L = codes.shape
        if L >= 65536:
            raise ValueError("reads must be shorter than 65536 bases")
        buf, nmask, Lp = pack_codes(codes, rlens)
        max_rlen = int(np.max(rlens)) if R else 1
        return self.seed_finish(self.seed_submit_packed(
            buf, nmask, None, 0, R, Lp, max_rlen))

    def locate_submit(self, rows: np.ndarray):
        """Start locating SA rows, split over the data groups, without
        waiting; None when empty."""
        if rows.shape[0] == 0:
            return None
        host = np.asarray(rows, dtype=np.int64 if self.wide else np.int32)
        parts = []
        for eng, stream, lo, hi in self._slices(host.shape[0]):
            with self._on(stream):
                t = torch.from_numpy(host[lo:hi]).to(eng.device)
                parts.append((stream, eng.locate_rows(t)))
        return parts

    def locate_finish(self, job) -> np.ndarray:
        if job is None:
            return np.empty(0, dtype=np.int64)
        return self._gather(job, np.empty(0)).astype(np.int64)

    def locate(self, rows: np.ndarray) -> np.ndarray:
        return self.locate_finish(self.locate_submit(rows))

    def mem_walks(self, chars: np.ndarray, valid: np.ndarray):
        """Forward MEM walks of (W, L) tasks split over the data groups
        -> (lens, x0, x2) int64 (W,). Narrow engine only."""
        c = np.ascontiguousarray(chars, dtype=np.uint8)
        v = np.ascontiguousarray(valid, dtype=bool)
        parts = [[], [], []]
        for eng, stream, lo, hi in self._slices(c.shape[0]):
            with self._on(stream):
                out = eng.mem_walk_rows(
                    torch.from_numpy(c[lo:hi]).to(eng.device),
                    torch.from_numpy(v[lo:hi]).to(eng.device))
            for p, t in zip(parts, out):
                p.append((stream, t))
        return tuple(self._gather(p, np.zeros(0, np.int32)).astype(np.int64)
                     for p in parts)
