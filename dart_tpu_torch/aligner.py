"""End-to-end alignment on the port's engine (reference:
Mapping.cpp:579-824).

``DartAligner`` runs the per-chunk flow: the two batched device passes
(seed scan, locates) for the whole chunk, then the host finalization
(the native C++ pipeline, or the Python one of ``pipeline/``). The
native finalize of one chunk runs on a worker thread while the main
thread seeds the next; chunks are written in order, so output is
deterministic and matches the reference at -t 1. ``DartAligner.stream``
is the one chunk loop: ``DartAligner.run``, ``--dist``
(``parallel/distributed.py``) and ``stream.py`` drive it.
``reader_class`` chooses the reader a run opens, and ``Checkpoint``
keeps a run's resume cursor. ``make_engine`` chooses the engine (one
device, or a ``--mesh`` grid of them), and ``run`` wraps a run in
``torch.profiler`` for ``--profile``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import sys
import time

import torch

from . import spans
from .config import DartConfig
from .constants import VERSION_STR
from .index.loader import Index
from .io.fastx import ChunkReader
from .ops.fm_torch import FMIndexTorch
from .parallel.mesh import ShardedFMIndexTorch, make_mesh, parse_mesh
from .pipeline.chaining import generate_alignment_candidates
from .pipeline.finalize import gen_mapping_report
from .pipeline.junctions import merge_sj_maps, update_sj_map, write_sj_table
from .pipeline.pairing import (
    check_paired_alignment_candidates,
    check_paired_final_alignments,
    remove_redundant_candidates,
    remove_unmated_candidates,
)
from .pipeline.report import (
    MAX_MAPQ,
    evaluate_mapq,
    output_paired,
    output_single,
    set_paired_alignment_flag,
    set_single_alignment_flag,
)
from .pipeline.seeding import identify_seed_pairs_chunk


def default_lut_k(device) -> int:
    """The K-mer table's K on ``device``, as ``dart_tpu`` chooses it:
    ``DART_TPU_LUT`` when it holds an int of 0 or more (0: no table);
    unset or negative, 11 on an accelerator (a 67 MB narrow table) and
    none on the CPU, where building the table costs more than it saves.
    A K past ``MAX_LUT_K`` raises when the engine is built."""
    lut_k = int(os.environ.get("DART_TPU_LUT", "-1"))
    if lut_k >= 0:
        return lut_k
    return 11 if torch.device(device).type == "cuda" else 0


def make_engine(idx, cfg: DartConfig, device="cuda", lut_k: int | None = None,
                wide: bool | None = None):
    """The FM-index engine for ``idx`` on ``device``: the wide (int64)
    one when the fwd+rc text has 2^31 positions or more, or when
    ``wide`` forces it; walks start from a K-mer table of
    ``lut_k`` (default ``default_lut_k(device)``). With ``cfg.mesh``
    naming ``data`` or ``index`` above 1, a ``ShardedFMIndexTorch`` over
    ``make_mesh(data * index, index, device)``, as ``dart_tpu``'s
    ``make_engine`` builds its mesh. Raises for a CUDA device without a
    card."""
    if cfg.engine != "auto":
        raise ValueError(f"--engine {cfg.engine} is not an engine of the "
                         "port; choose the device with --device")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the "
                           "plain PyTorch kernels on the CPU")
    if lut_k is None:
        lut_k = default_lut_k(device)
    data_n, index_n = parse_mesh(cfg.mesh)
    if data_n > 1 or index_n > 1:
        return ShardedFMIndexTorch(
            idx, make_mesh(data_n * index_n, index_n, device),
            max_dup_num=cfg.max_dup_num, lut_k=lut_k, wide=wide)
    return FMIndexTorch(idx, device, max_dup_num=cfg.max_dup_num,
                        lut_k=lut_k, wide=wide)


def all_threads():
    """The profiler option that records the ranges of every thread, so
    the finalize worker's too."""
    return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)


def profiled(trace_dir: str, device):
    """``torch.profiler`` over the block (the CPU, and the card on
    ``cuda``), of every thread, its trace written into ``trace_dir`` as
    ``tensorboard_trace_handler`` names it when the block ends: the
    counterpart of the JAX package's ``jax.profiler.trace``."""
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts, experimental_config=all_threads(),
                   on_trace_ready=tensorboard_trace_handler(trace_dir))


def run(idx, cfg: DartConfig, device="cuda", lut_k: int | None = None,
        wide: bool | None = None) -> DartAligner:
    """Align ``cfg``'s reads against ``idx`` on ``device`` (``lut_k`` and
    ``wide`` as ``make_engine`` takes them), under ``torch.profiler``
    when ``cfg.profile_dir`` is set; returns the finished aligner (its
    ``engine`` holds the kernels' launch counts)."""
    aligner = DartAligner(idx, cfg,
                          engine=make_engine(idx, cfg, device, lut_k, wide))
    with (profiled(cfg.profile_dir, device) if cfg.profile_dir
          else contextlib.nullcontext()):
        aligner.run()
    return aligner


WHOLE_FILE_MAX = 8 << 30  # bytes: a larger read file is streamed


def reader_class(native: bool, path1: str, path2=None):
    """The reader class a run opens for ``path1`` (and its mates'
    ``path2``): with the native pipeline, the whole-file readers whose
    native pass (``native/fastx.cpp``) feeds the pipeline blobs, for
    files under ``WHOLE_FILE_MAX`` bytes each; else ``ChunkReader``.
    They cut chunks at different places, so a checkpoint records the
    class and resumes only under the same one."""
    if native and all(p is None or os.path.getsize(p) < WHOLE_FILE_MAX
                      for p in (path1, path2)):
        from .io.fastx_fast import FastChunkReader, FastPairedReader

        return FastChunkReader if path2 is None else FastPairedReader
    return ChunkReader


def open_reads(cfg: DartConfig, native: bool, path1: str, path2=None):
    """``reader_class``'s reader over ``path1`` (and ``path2``) in chunks
    of ``cfg.batch_reads``."""
    cls = reader_class(native, path1, path2)
    if cls is ChunkReader:
        return ChunkReader(path1, path2, cfg.pair_end,
                           chunk_reads=cfg.batch_reads, ramp=False)
    if path2 is None:
        return cls(path1, cfg.pair_end, cfg.batch_reads, ramp=False)
    return cls(path1, path2, cfg.batch_reads, ramp=False)


CKPT_VERSION = 2  # a checkpoint of another layout restarts the run


class Checkpoint:
    """The resume cursor of a run writing ``out``, kept in ``out.ckpt``
    and replaced whole (a tmp file, then ``os.replace``) at each save.
    It resumes only a run that cuts the same chunks into the same
    output: its ``fields`` (layout version, ``--batch``, output format,
    and a driver's own) must be equal. ``saves`` counts its saves."""

    def __init__(self, out: str, cfg: DartConfig, **fields):
        self.out, self.path, self.saves = out, out + ".ckpt", 0
        self.fields = {"version": CKPT_VERSION,
                       "batch_reads": cfg.batch_reads,
                       "output_format": cfg.output_format, **fields}

    def save(self, aligner, fst, **state) -> None:
        """The cursor after ``fst``'s chunks so far, with its reader's
        class, ``aligner``'s counters and junction map, and a driver's
        own ``state`` (``sam_bytes``: the output's length)."""
        state = {**self.fields, "file_idx": fst["file_idx"],
                 "chunks": fst["chunks"],
                 "reader": type(fst["reader"]).__name__,
                 "counters": aligner.counters,
                 "sj": [[g1, g2, v[0], v[1]] for (g1, g2), v in
                        sorted(aligner.junction_map().items())], **state}
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, self.path)
        self.saves += 1

    def resume(self, aligner, files, reader_of) -> dict | None:
        """The saved state, where it resumes this run over ``files``
        [(path1, path2)]: its fields equal, the output still there, and
        ``reader_of(path1, path2)`` the class it recorded for its file.
        Then ``aligner``'s counters and junction map are restored and
        the output is cut back to ``sam_bytes``: past it lies a partial
        chunk (for BAM the offset is a BGZF block boundary, so cut and
        append give a valid stream). Else None: the run starts over."""
        if not (os.path.exists(self.path) and os.path.exists(self.out)):
            return None
        with open(self.path) as f:
            state = json.load(f)
        fi = state.get("file_idx", 0)
        if (any(state.get(k) != v for k, v in self.fields.items())
                or not 0 <= fi < len(files)
                or state.get("reader") != reader_of(*files[fi]).__name__):
            return None
        aligner.counters.update(state["counters"])
        for g1, g2, t, c in state["sj"]:
            aligner.sj_map[(g1, g2)] = [t, c]
        with open(self.out, "r+b") as f:
            f.truncate(state["sam_bytes"])
        return state

    def remove(self) -> None:
        if os.path.exists(self.path):
            os.remove(self.path)


class DartAligner:
    def __init__(self, idx: Index, cfg: DartConfig, engine=None):
        self.idx = idx
        self.cfg = cfg
        self.engine = engine if engine is not None else make_engine(idx, cfg)
        self.sj_map: dict = {}
        self.counters = {"total": 0, "unique": 0, "unmapped": 0, "paired": 0}
        # the stages' self times (spans.KEYS), each second counted once
        # on its thread: the main thread's input_parse_s,
        # device_seed_locate_s, finalize_wait_s and output_s sum to at
        # most wall_s (the run's own wall), and the finalize worker's
        # native_finalize_s is at most wall_s; each sub-stage is at most
        # its stage. device_only_wait_s is the part of
        # device_seed_locate_s spent in chunks' waits, the next chunk's
        # prefetch left out. The native finalize's two phases (written
        # by the worker alone) and the engine's copies and located rows
        # over this run add, as do the reads the native input pass
        # emitted (input_native_reads) and the bytes the BAM writer
        # framed into BGZF members (output_bytes), natively on the -t
        # threads or not (output_native_bytes).
        self.stats = {**dict.fromkeys(spans.KEYS, 0.0),
                      "finalize_parallel_s": 0.0, "finalize_serial_s": 0.0,
                      "dtoh_bytes": 0, "htod_bytes": 0, "locate_rows": 0,
                      "input_native_reads": 0, "output_bytes": 0,
                      "output_native_bytes": 0, "chunks": 0, "wall_s": 0.0}
        self.spans = spans.Spans(self.stats)
        self.worker_spans = spans.Spans(self.stats)  # the finalize worker's
        self._n_parsed = 0  # the ordinal of the next chunk parsed
        self.checkpoint = None  # run's Checkpoint under --checkpoint
        self.native = None
        # -d uses the introspectable single-threaded Python pipeline
        # (the reference forces one thread under -d, Mapping.cpp:757)
        if cfg.native and not cfg.debug:
            try:
                from .pipeline.native_chunk import NativePipeline

                self.native = NativePipeline(idx, cfg)
            except Exception:
                self.native = None

    # ---- per-chunk processing ----

    def process_chunk(self, reads, pair_end: bool, fastq: bool) -> list[str]:
        """One chunk through the Python pipeline of ``pipeline/`` (``-d``,
        ``--no-native``, or no C++ toolchain): its SAM lines."""
        cfg = self.cfg
        idx = self.idx
        seeds_per_read = identify_seed_pairs_chunk(self.engine, reads, cfg.max_dup_num)
        local_sj: dict = {}
        sam: list[str] = []
        counters = self.counters

        if pair_end and len(reads) % 2 == 0:
            for i in range(0, len(reads), 2):
                r1, r2 = reads[i], reads[i + 1]
                av1 = generate_alignment_candidates(idx, cfg, r1.rlen, seeds_per_read[i])
                av2 = generate_alignment_candidates(idx, cfg, r2.rlen, seeds_per_read[i + 1])
                if check_paired_alignment_candidates(av1, av2):
                    remove_unmated_candidates(av1, av2)
                remove_redundant_candidates(av1)
                remove_redundant_candidates(av2)
                gen_mapping_report(idx, cfg, True, r1, av1)
                gen_mapping_report(idx, cfg, False, r2, av2)
                check_paired_final_alignments(cfg, r1, r2)
                set_paired_alignment_flag(r1, r2)
                evaluate_mapq(r1)
                evaluate_mapq(r2)
                if r1.mapq == MAX_MAPQ or (cfg.find_all_junction and r1.score > 0):
                    update_sj_map(idx, cfg.min_intron_size, av1[r1.best_idx], local_sj)
                if r2.mapq == MAX_MAPQ or (cfg.find_all_junction and r2.score > 0):
                    update_sj_map(idx, cfg.min_intron_size, av2[r2.best_idx], local_sj)
            for i in range(0, len(reads), 2):
                output_paired(cfg, idx.chromosomes, reads[i], reads[i + 1], fastq,
                              counters, sam)
        else:
            keep = []
            for i, read in enumerate(reads):
                av = generate_alignment_candidates(idx, cfg, read.rlen, seeds_per_read[i])
                remove_redundant_candidates(av)
                if cfg.debug:
                    from .pipeline.structs import show_candidate_info

                    show_candidate_info(idx, True, read.header, av)
                gen_mapping_report(idx, cfg, True, read, av)
                set_single_alignment_flag(read)
                evaluate_mapq(read)
                if read.mapq == MAX_MAPQ or (cfg.find_all_junction and read.score > 0):
                    update_sj_map(idx, cfg.min_intron_size, av[read.best_idx], local_sj)
                keep.append(read)
            for read in keep:
                output_single(cfg, idx.chromosomes, read, fastq, counters, sam)

        counters["total"] += len(reads)
        merge_sj_maps(self.sj_map, local_sj)
        return sam

    # ---- the chunk loop ----

    def stream(self, files, emit, on_written=None) -> None:
        """Stream every chunk of ``files`` through the engine and the host
        finalize, and write each in order on this thread: the one chunk
        loop of ``run``, ``--dist`` and ``stream.py``.

        ``files`` yields per-file state dicts ({file_idx, reader,
        chunks, pair_end, fastq}, as ``file_states`` makes them);
        ``emit(sam, fst)`` writes one chunk of file ``fst``, whose
        ``chunks`` already counts it (so a checkpoint saved in ``emit``
        is the cursor after it); then ``on_written(fst, n_reads)``, if
        given, runs. Each reader is closed when it is spent.

        With the native pipeline the stages overlap, as the reference's
        reader thread feeds its -t workers (Mapping.cpp:579-681):

        - the card: two chunks stay in flight ahead of the one being
          drained; chunk k's wait parses and submits chunk k+2 once
          chunk k's last device round is queued, so it queues behind;
        - the host: chunk k's native finalize runs on one worker thread
          while this thread drains chunk k+1's seeding.

        Chunk k is written before chunk k+1 is handed to the worker, so
        the worker is idle whenever ``emit`` and ``on_written`` run (a
        checkpoint sees whole counters and junction map), and the call
        returns with every chunk written. The stream spans all of
        ``files`` (the reference's pool never drains between libraries
        either, main.cpp:142-151). Without the native pipeline (``-d``,
        ``--no-native``) each chunk goes through ``process_chunk`` and
        is written in turn.

        Spans (spans.STAGES): the loop under dart.stream; chunk k's
        parse under dart.input#k; natively, its submit under
        dart.seed.submit#k, its drain under dart.chunk#k, which then
        waits for chunk k-1's finalize (dart.finalize.wait) and writes
        it (dart.output; for the last chunk, k itself too), and its
        finalize under the worker's dart.finalize#k."""
        sp = self.spans
        chunks = self._parsed(files)
        with sp.active(), sp("dart.stream"):
            if self.native is not None:
                self._stream_native(chunks, emit, on_written)
                return
            for fst, reads in chunks:
                sam = self.process_chunk(reads, fst["pair_end"], fst["fastq"])
                self._write_chunk(fst, len(reads), sam, emit, on_written)

    def _stream_native(self, chunks, emit, on_written) -> None:
        """``stream``'s loop with the native pipeline (its docstring)."""
        from concurrent.futures import ThreadPoolExecutor

        from .pipeline.seeding import finish_chunk, submit_chunk

        sp = self.spans
        k = self.stats["chunks"]  # the ordinal of the next chunk drained

        def parse_submit():
            fst, reads = next(chunks, (None, None))
            if not reads:
                return None
            with sp("dart.seed.submit", self._n_parsed - 1):
                return fst, reads, submit_chunk(self.engine, reads)

        def write(fst, reads, finalized):
            # finalized: the worker's future, which raises what it raised
            with sp("dart.finalize.wait", self.stats["chunks"]):
                sam = finalized.result()
            self._write_chunk(fst, len(reads), sam, emit, on_written)

        with ThreadPoolExecutor(1, "dart-finalize") as worker:
            cur = parse_submit()
            pending = parse_submit() if cur else None  # chunk k+1
            held = None  # the chunk on the worker: write's args
            while cur:
                fst, reads, job = cur
                nxt = []

                def prefetch():
                    with sp("dart.prefetch", self._n_parsed):
                        nxt.append(parse_submit())

                with sp("dart.chunk", k):
                    with sp("dart.seed.finish"):
                        occ = finish_chunk(self.engine, job, on_wait=prefetch)
                    if not nxt:  # eager jobs never call the hook
                        prefetch()
                    cur, pending = pending, nxt[0]
                    if held:
                        write(*held)
                    held = (fst, reads, worker.submit(
                        self._finalize, k, reads, fst["pair_end"],
                        fst["fastq"], occ))
                    if not cur:
                        write(*held)
                k += 1

    def _finalize(self, k: int, reads, pair_end: bool, fastq: bool, occ):
        """Chunk k's native finalize, on the worker thread under its own
        recorder's dart.finalize#k: the chunk's SAM bytes. It writes
        ``counters``, ``native_finalize_s`` and the finalize's phase
        times, and calls nothing of torch but a profiler's range while
        one records."""
        wsp = self.worker_spans
        with wsp.active(), wsp("dart.finalize", k):
            return self.native.process_chunk(
                reads, pair_end and len(reads) % 2 == 0, fastq, *occ,
                self.counters, self.stats)

    def _write_chunk(self, fst, n: int, sam, emit, on_written) -> None:
        """Write the next chunk in order, k, of ``n`` reads of file
        ``fst``: ``emit`` it under dart.output#k, then ``on_written``."""
        k = self.stats["chunks"]
        fst["chunks"] += 1
        with self.spans("dart.output", k):
            emit(sam, fst)
        self.stats["chunks"] += 1
        if on_written is not None:
            on_written(fst, n)

    def _parsed(self, files):
        """The chunks of ``files`` in order, as (fst, reads), each parsed
        (the first file's reader made too) under a dart.input#k span;
        each reader is closed when it is spent."""
        fst = None
        started = False
        while True:
            with self.spans("dart.input", self._n_parsed):
                if not started:
                    fst, started = next(files, None), True
                while fst is not None:
                    reads = fst["reader"].next_chunk()
                    if reads:
                        break
                    fst["reader"].close()
                    fst = next(files, None)
            if fst is None:
                return
            self._n_parsed += 1
            if hasattr(reads, "seq_blob"):  # a BlobChunk: native/fastx.cpp
                self.stats["input_native_reads"] += len(reads)
            yield fst, reads

    def file_states(self, files, open_reader=None, resume=None):
        """Per-file state for ``stream`` of ``files``, [(path1, path2)],
        each reader opened under dart.input.open by ``open_reader(path1,
        path2)`` (default: ``open_reads``, the run's choice). With
        ``resume`` (a ``Checkpoint.resume`` state) the files before its
        ``file_idx`` are skipped and that file's first ``chunks`` chunks
        read past (the readers cut chunks deterministically)."""
        if open_reader is None:
            open_reader = functools.partial(open_reads, self.cfg,
                                            self.native is not None)
        for file_idx, (path1, path2) in enumerate(files):
            done = 0
            if resume is not None:
                if file_idx < resume["file_idx"]:
                    continue
                if file_idx == resume["file_idx"]:
                    done = resume["chunks"]
            with spans.span("dart.input.open"):
                reader = open_reader(path1, path2)
            for _ in range(done):
                reader.next_chunk()
            yield {"file_idx": file_idx, "reader": reader, "chunks": done,
                   "pair_end": reader.pair_end, "fastq": reader.fastq}

    def header_lines(self) -> list[str]:
        lines = [f"@PG\tID:Dart\tPN:Dart\tVN:{VERSION_STR}"]
        for c in self.idx.chromosomes:
            lines.append(f"@SQ\tSN:{c.name}\tLN:{c.length}")
        return lines

    def junction_map(self) -> dict:
        """The junction map so far: any resumed state (``sj_map``) and the
        native context's accumulation, added."""
        merged = {k: list(v) for k, v in self.sj_map.items()}
        if self.native is not None:
            for g1, g2, t, c in self.native.sj_items():
                key = (int(g1), int(g2))
                if key in merged:
                    merged[key][1] += int(c)
                else:
                    merged[key] = [int(t), int(c)]
        return merged

    # ---- full run ----

    def run(self, out_stream=None, on_written=None) -> None:
        """Align every ``-f`` file into ``cfg.output_file`` (or
        ``out_stream``) and ``cfg.sj_file`` through ``stream``, resuming
        from the output's checkpoint under ``--checkpoint``;
        ``on_written`` as ``stream`` takes it."""
        cfg = self.cfg
        files = list(zip(cfg.read_files_1, cfg.read_files_2
                         or [None] * len(cfg.read_files_1)))
        ckpt = self.checkpoint = (Checkpoint(cfg.output_file, cfg)
                                  if cfg.checkpoint else None)
        resume = None
        if ckpt is not None and out_stream is None:
            resume = ckpt.resume(self, files, functools.partial(
                reader_class, self.native is not None))
        own = out_stream is None
        writer = None
        if own and cfg.output_format == 1:
            from .io.bam import BamWriter

            # a resumed writer appends, and its header sets the
            # reference map only
            writer = BamWriter(cfg.output_file, append=resume is not None,
                               threads=cfg.threads, level=cfg.bam_level)
        elif own:
            # binary: the native pipeline emits ready SAM bytes; a text
            # stream would force a decode+encode round trip per chunk
            out_stream = open(cfg.output_file, "wb" if resume is None
                              else "ab")
        import io as _io

        text_out = out_stream is not None and isinstance(out_stream,
                                                         _io.TextIOBase)
        start = time.perf_counter()
        counts0 = self._engine_counts()
        if writer is not None:
            writer.write_header(self.header_lines())
        elif resume is None:
            text = "".join(line + "\n" for line in self.header_lines())
            out_stream.write(text if text_out else text.encode("latin-1"))
        saved = {"t": 0.0}

        def emit(sam, fst):
            if isinstance(sam, bytes):
                if writer is not None:
                    writer.write_sam_bytes(sam)
                elif text_out:
                    out_stream.write(sam.decode("latin-1"))
                else:
                    out_stream.write(sam)
            elif writer is not None:
                for line in sam:
                    writer.write_record(line)
            else:
                text = "\n".join(sam) + ("\n" if sam else "")
                out_stream.write(text if text_out
                                 else text.encode("latin-1"))
            if not cfg.silent:
                print(f"\r{self.counters['total']} "
                      f"{'paired-end' if fst['pair_end'] else 'singled-end'} tags processed "
                      f"in {int(time.perf_counter() - start)} seconds...",
                      end="", file=sys.stderr)
            if ckpt is not None and (
                    cfg.ckpt_interval_s <= 0
                    or time.time() - saved["t"] >= cfg.ckpt_interval_s):
                if writer is not None:
                    off = writer.flush_boundary()
                else:
                    out_stream.flush()
                    off = out_stream.tell()
                ckpt.save(self, fst, sam_bytes=off)
                saved["t"] = time.time()

        self.stream(self.file_states(files, resume=resume), emit, on_written)
        with self.spans.active(), self.spans("dart.tail"):
            if own:
                if writer is not None:
                    writer.close()
                    self.stats["output_bytes"] += writer.bgzf.deflated_bytes
                    self.stats["output_native_bytes"] += \
                        writer.bgzf.native_bytes
                else:
                    out_stream.close()
            self.sj_map = self.junction_map()
            n_sj = write_sj_table(self.idx, self.sj_map, cfg.sj_file)
        if ckpt is not None:
            ckpt.remove()
        if not cfg.silent:
            print("", file=sys.stderr)
        for key, n in self._engine_counts().items():
            self.stats[key] += n - counts0[key]
        wall = self.stats["wall_s"] = time.perf_counter() - start
        if cfg.stats:
            self._print_stats(wall)
        self.print_summary(n_sj)

    def _engine_counts(self) -> dict:
        """The engine's byte and row counters under their stats keys
        (0 for an engine that has none). The engine may serve other
        aligners, so a run keeps the change over itself."""
        return {key: getattr(self.engine, attr, 0) for key, attr in
                (("dtoh_bytes", "dtoh_bytes"), ("htod_bytes", "htod_bytes"),
                 ("locate_rows", "n_locate_rows"))}

    def _print_stats(self, wall: float) -> None:
        s = self.stats
        n = max(self.counters["total"], 1)
        print(f"[stats] wall {wall:.2f}s, {s['chunks']} chunks, "
              f"{self.counters['total'] / max(wall, 1e-9):.0f} reads/s",
              file=sys.stderr)
        print(f"[stats] input {s['input_parse_s']:.2f}s (open "
              f"{s['input_open_s']:.2f}s; {s['input_native_reads']} reads "
              f"native) | device seed+locate "
              f"{s['device_seed_locate_s']:.2f}s (pack {s['seed_pack_s']:.2f}s,"
              f" sync {s['device_sync_s']:.2f}s, expand "
              f"{s['seed_expand_s']:.2f}s; stall {s['device_only_wait_s']:.2f}s)"
              f" | native finalize {s['native_finalize_s']:.2f}s (parallel "
              f"{s['finalize_parallel_s']:.2f}s, serial "
              f"{s['finalize_serial_s']:.2f}s; waited "
              f"{s['finalize_wait_s']:.2f}s) | output {s['output_s']:.2f}s "
              f"(encode {s['output_encode_s']:.2f}s, deflate "
              f"{s['output_deflate_s']:.2f}s; {s['output_native_bytes']} of "
              f"{s['output_bytes']} BGZF bytes native)", file=sys.stderr)
        print(f"[stats] copies {s['dtoh_bytes'] / n:.1f} B/read to the host, "
              f"{s['htod_bytes'] / n:.1f} B/read to the device; "
              f"{s['locate_rows'] / n:.3f} located rows/read", file=sys.stderr)

    def print_summary(self, n_sj: int) -> None:
        c = self.counters
        total = c["total"]
        if total == 0:
            return

        def pct(x):
            return int(10000 * (x / total) + 0.5) / 100.0

        mapped = total - c["unmapped"]
        out = sys.stdout
        if self.cfg.pair_end or self.cfg.read_files_2:
            print(f"\t# of total mapped reads = {mapped} (sensitivity = {pct(mapped):.2f}%)"
                  f"\n\t# of paired sequences = {c['paired']} ({pct(c['paired']):.2f}%)", file=out)
        else:
            print(f"\t# of total mapped reads = {mapped} (sensitivity = {pct(mapped):.2f}%)", file=out)
        print(f"\t# of unique mapped reads = {c['unique']} ({pct(c['unique']):.2f}%)", file=out)
        if not self.cfg.unique_only:
            multi = mapped - c["unique"]
            print(f"\t# of multiple mapped reads = {multi} ({pct(multi):.2f}%)", file=out)
        print(f"\t# of unmapped reads = {c['unmapped']} ({pct(c['unmapped']):.2f}%)", file=out)
        print(f"\t# of splice junctions = {n_sj} (file: {self.cfg.sj_file})", file=out)
        print(f"\tAlignment output: {self.cfg.output_file}\n", file=out)
