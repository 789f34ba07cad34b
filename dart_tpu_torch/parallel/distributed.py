"""Multi-host runs over ``torch.distributed``: the port of
``dart_tpu.parallel.distributed.run_distributed``.

Each process owns a shard of the input (``make_shard_reader``:
record-aligned byte ranges of a plain single-end file, round-robin
chunks of gzip, split or interleaved paired input), aligns
it on its own engine (``aligner.make_engine`` on its device: ``cuda``
is card ``pid`` mod the card count), and writes its own SAM shard with
an index of its chunk offsets, and, with ``--checkpoint``, a resume
cursor beside it. Then the junction tables and the four counters are
gathered from every process, and process 0 merges the shards into the
output in single-process order (SAM, or BAM encoded from the merge) and
writes the merged junction table.

The gathers move host integers only, so the process group is ``gloo``
over TCP (``tcp://{coordinator}``), which needs no card; int64 travels
as int64. Every collective waits at most ``TIMEOUT_S``, so a process
that died cannot hang its peers forever.
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import sys

import torch
import torch.distributed as dist

TIMEOUT_S = 600  # bound on every collective: the slowest shard's lag


# ---------------------------------------------------------- input sharding


def find_record_start(fh, offset: int, fastq: bool) -> int:
    """First record boundary at or after `offset`.

    FASTA: a line starting with '>'. FASTQ: a line starting with '@'
    whose next-next line starts with '+' (disambiguates quality lines
    that begin with '@', GetData.cpp-compatible 4-line records)."""
    if offset == 0:
        return 0
    fh.seek(offset)
    fh.readline()  # skip the (possibly partial) current line
    while True:
        pos = fh.tell()
        line = fh.readline()
        if not line:
            return pos
        if not fastq:
            if line.startswith(b">"):
                return pos
            continue
        if line.startswith(b"@"):
            save = fh.tell()
            fh.readline()
            plus = fh.readline()
            fh.seek(save)
            if plus.startswith(b"+"):
                return pos


def byte_shard(path: str, n_shards: int, shard_id: int,
               fastq: bool) -> tuple[int, int]:
    """[start, end) byte range of this process's shard, record-aligned."""
    size = os.path.getsize(path)
    with open(path, "rb") as fh:
        lo = find_record_start(fh, size * shard_id // n_shards, fastq)
        hi = (find_record_start(fh, size * (shard_id + 1) // n_shards, fastq)
              if shard_id + 1 < n_shards else size)
    return lo, hi


class _RangeFile:
    """File object exposing only [start, end) to the line reader."""

    def __init__(self, path: str, start: int, end: int):
        self.fh = open(path, "rb")
        self.fh.seek(start)
        self.end = end

    def readline(self) -> bytes:
        if self.fh.tell() >= self.end:
            return b""
        return self.fh.readline()

    def close(self):
        self.fh.close()


def shard_reader_class(path1: str, path2, pair_end: bool):
    """The class of ``make_shard_reader``'s reader: ``_StridedReader``
    for gzip, split or interleaved pairs, else ``ChunkReader`` over a
    byte range."""
    from ..io.fastx import ChunkReader

    # pair_end without path2 = interleaved pairs: byte_shard aligns to
    # ANY record boundary, and a shard starting at an odd record index
    # would flip mate parity for its whole range — chunk round-robin
    # keeps pairs intact (chunks round to even counts)
    return (_StridedReader if path1.endswith(".gz") or path2 is not None
            or pair_end else ChunkReader)


def make_shard_reader(path1: str, path2, pair_end: bool, chunk_reads: int,
                      n_shards: int, shard_id: int):
    """ChunkReader over this process's shard. For paired split files the
    shard boundary must cut both mates at the same RECORD index, so
    split files shard by record-synchronized byte ranges computed from
    mate-1 record counts — conservatively implemented as round-robin
    chunk striping (correct for any input)."""
    from ..io.fastx import ChunkReader

    if shard_reader_class(path1, path2, pair_end) is _StridedReader:
        return _StridedReader(ChunkReader(path1, path2, pair_end,
                                          chunk_reads=chunk_reads),
                              n_shards, shard_id)
    reader = ChunkReader(path1, None, pair_end, chunk_reads=chunk_reads)
    lo, hi = byte_shard(path1, n_shards, shard_id, reader.fastq)
    reader.r1.fh.close()
    reader.r1.fh = _RangeFile(path1, lo, hi)
    return reader


class _StridedReader:
    """Round-robin chunk assignment over a full-stream reader."""

    def __init__(self, reader, n_shards: int, shard_id: int):
        self.reader = reader
        self.n = n_shards
        self.k = shard_id
        self.i = 0
        self.fastq = reader.fastq
        self.pair_end = reader.pair_end

    def next_chunk(self):
        while True:
            chunk = self.reader.next_chunk()
            if not chunk:
                return chunk
            if self.i % self.n == self.k:
                self.i += 1
                return chunk
            self.i += 1

    def close(self):
        self.reader.close()


# ---------------------------------------------------------- the run


def rank_device(device, pid: int) -> torch.device:
    """The device of process ``pid``: ``cuda`` is card pid mod the card
    count; any other device (``cuda:N``, ``cpu``) as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        return torch.device("cuda", pid % torch.cuda.device_count())
    return dev


def _allgather(t: torch.Tensor) -> list[torch.Tensor]:
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return out


def _allgather_sj(sj_items: list) -> dict:
    """Merge the processes' junction tables: gather each table, padded
    to the longest, and add the counts of equal junctions, process by
    process in rank order."""
    arr = torch.tensor(sj_items, dtype=torch.int64).reshape(-1, 4)
    ns = [int(n) for n in _allgather(torch.tensor([arr.shape[0]]))]
    merged: dict = {}
    if max(ns) == 0:
        return merged
    pad = torch.zeros((max(ns), 4), dtype=torch.int64)
    pad[:arr.shape[0]] = arr
    for n, tab in zip(ns, _allgather(pad)):
        for g1, g2, t, c in tab[:n].tolist():
            if (g1, g2) in merged:
                merged[(g1, g2)][1] += c
            else:
                merged[(g1, g2)] = [t, c]
    return merged


def held_port():
    """A free TCP port of this host, with a socket bound to it that the
    caller keeps open until the processes it starts on that port are
    done: the kernel hands a bound port to no other socket, and the
    socket does not listen, so the process that binds the port with
    SO_REUSEADDR (torch.distributed's store does) still listens on it.
    Returns (port, socket)."""
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    return s.getsockname()[1], s


def run_distributed(cfg, coordinator: str, nprocs: int, pid: int,
                    device="cuda") -> int:
    """Entry point of one process of a multi-host run."""
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}", world_size=nprocs,
        rank=pid, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        if dist.get_world_size() != nprocs:
            raise RuntimeError(f"torch.distributed formed "
                               f"{dist.get_world_size()} processes, "
                               f"expected {nprocs}")
        _run(cfg, nprocs, pid, rank_device(device, pid))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def _run(cfg, nprocs: int, pid: int, device) -> None:
    from ..aligner import Checkpoint, DartAligner, make_engine
    from ..index import load_index
    from ..pipeline.junctions import write_sj_table

    idx = load_index(cfg.index_prefix)
    aligner = DartAligner(idx, cfg, engine=make_engine(idx, cfg, device))
    if cfg.stats:
        eng = aligner.engine
        kind = "wide" if getattr(eng, "wide", False) else "narrow"
        print(f"[stats] engine {kind}, layout cache "
              f"{getattr(eng, 'cache', None)}", file=sys.stderr)

    shard_sam = f"{cfg.output_file}.shard{pid:04d}"
    files = list(zip(cfg.read_files_1, cfg.read_files_2
                     or [None] * len(cfg.read_files_1)))
    # per file: the chunks' byte offsets in this shard, so that the merge
    # can put strided chunks and file sections back in input order
    shard_meta = {"files": []}

    # this process's checkpoint: the aligner's cursor, counters and
    # junctions, and the shard's offsets so far
    ckpt = Checkpoint(shard_sam, cfg, nprocs=nprocs) if cfg.checkpoint \
        else None
    resume = ckpt and ckpt.resume(
        aligner, files, lambda p1, p2: shard_reader_class(p1, p2,
                                                          cfg.pair_end))
    if resume:
        shard_meta["files"] = resume["files_done"]
    on_written = None
    crash_after = int(os.environ.get("DART_TPU_TEST_CRASH_AFTER_CHUNKS", "0"))
    if ckpt and crash_after:
        def on_written(fst, _n):  # a test's process that dies after N chunks
            if fst["chunks"] >= crash_after:
                raise RuntimeError("injected distributed crash")

    def open_shard(path1, path2):
        return make_shard_reader(path1, path2, cfg.pair_end, cfg.batch_reads,
                                 nprocs, pid)

    with open(shard_sam, "a" if resume else "w") as out:
        def emit(sam, fst):
            out.write(sam.decode("latin-1") if isinstance(sam, bytes)
                      else "\n".join(sam) + ("\n" if sam else ""))
            offs.append(out.tell())
            if ckpt:
                out.flush()
                ckpt.save(aligner, fst, sam_bytes=out.tell(), offs=offs,
                          files_done=shard_meta["files"])

        # one stream per file, drained at its end, so that each file's
        # offsets end with its last chunk
        for fst in aligner.file_states(files, open_shard, resume):
            offs = (resume["offs"] if resume
                    and fst["file_idx"] == resume["file_idx"]
                    else [out.tell()])
            aligner.stream(iter([fst]), emit, on_written)
            shard_meta["files"].append(
                {"strided": isinstance(fst["reader"], _StridedReader),
                 "offsets": offs})

    with open(shard_sam + ".idx", "w") as f:
        json.dump(shard_meta, f)
    if ckpt:
        ckpt.remove()

    # ---- the merge ----
    merged_sj = _allgather_sj([(g1, g2, v[0], v[1]) for (g1, g2), v in
                               sorted(aligner.junction_map().items())])
    c = aligner.counters
    totals = torch.tensor([c["total"], c["unique"], c["unmapped"],
                           c["paired"]], dtype=torch.int64)
    dist.all_reduce(totals)
    if pid != 0:
        return
    aligner.sj_map = merged_sj
    aligner.native = None  # the totals come from the merged map below
    c["total"], c["unique"], c["unmapped"], c["paired"] = totals.tolist()
    _merge_shards(cfg, aligner, nprocs)
    aligner.print_summary(write_sj_table(idx, merged_sj, cfg.sj_file))


def _merge_shards(cfg, aligner, nprocs: int) -> None:
    """Process 0: the shards, in single-process order, into the output.
    A missing shard or index (no shared file system?) raises rather than
    reordering or dropping records."""
    shards, missing = [], []
    for pid in range(nprocs):
        shard = f"{cfg.output_file}.shard{pid:04d}"
        if not (os.path.exists(shard) and os.path.exists(shard + ".idx")):
            missing.append(shard)
            continue
        with open(shard + ".idx") as f:
            shards.append((open(shard, "rb"), json.load(f)))
    if missing:
        raise RuntimeError(
            "cannot merge output shards: missing shard files or .idx "
            "metadata on process 0 (no shared filesystem?): "
            + ", ".join(missing))

    def pieces():
        """Shard byte ranges in single-process order: file sections in
        input order; a strided file's chunk j from shard j % n at local
        index j // n; a byte-range file's shards in order."""
        n_files = max((len(m["files"]) for _, m in shards), default=0)
        for fi in range(n_files):
            if any(m["files"][fi]["strided"] for _, m in shards):
                j = 0
                while True:
                    fh, m = shards[j % len(shards)]
                    offs = m["files"][fi]["offsets"]
                    k = j // len(shards)
                    if k + 1 >= len(offs):
                        break  # the first missing chunk ends the file
                    yield fh, offs[k], offs[k + 1]
                    j += 1
            else:
                for fh, m in shards:
                    offs = m["files"][fi]["offsets"]
                    yield fh, offs[0], offs[-1]

    try:
        if cfg.output_format == 1:
            from ..io.bam import BamWriter

            writer = BamWriter(cfg.output_file, threads=cfg.threads,
                               level=cfg.bam_level)
            writer.write_header(aligner.header_lines())
            for fh, lo, hi in pieces():
                fh.seek(lo)
                for line in fh.read(hi - lo).decode("latin-1").splitlines():
                    if line:
                        writer.write_record(line)
            writer.close()
        else:
            with open(cfg.output_file, "wb") as final:
                for line in aligner.header_lines():
                    final.write(line.encode() + b"\n")
                for fh, lo, hi in pieces():
                    fh.seek(lo)
                    left = hi - lo
                    while left > 0:
                        buf = fh.read(min(left, 1 << 20))
                        if not buf:
                            break
                        final.write(buf)
                        left -= len(buf)
    finally:
        for fh, _ in shards:
            fh.close()
