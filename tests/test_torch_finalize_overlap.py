"""The stream loop's finalize worker (``DartAligner.stream``, native)
on the CPU: chunk k's native finalize runs on one thread of its own while
the main thread drains chunk k+1's seeding, and chunks are written in order
on the main thread with the worker idle.

The toy golden index and reads in chunks of ``BATCH`` (five of
``spliced.fa``'s 600 reads; the plain CPU engine takes ~0.6 s a chunk).
Each run goes through ``bounded``, and every wait on an event has a
timeout, so that no test can hang: a run that does not end within
``RUN_S`` fails."""

import contextlib
import io
import json
import os
import sys
import threading

import pytest
import torch

from dart_tpu_torch import cli
from dart_tpu_torch.aligner import DartAligner, make_engine
from dart_tpu_torch.index import load_index
from dart_tpu_torch.pipeline import seeding

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
GOLD = os.path.join(HERE, "golden")
TOY = os.path.join(GOLD, "index", "toy")
BATCH = 128
CHUNKS = 5  # spliced.fa's 600 reads: 4 x 128 + 88
RUN_S = 300  # a run's limit
WAIT_S = 60  # an event's limit


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def idx():
    return load_index(TOY)


def bounded(fn, *a):
    """``fn(*a)`` on a thread of its own, its result or its exception;
    fails where it runs past RUN_S."""
    out = {}

    def call():
        try:
            out["value"] = fn(*a)
        except BaseException as e:  # handed to the caller
            out["error"] = e

    t = threading.Thread(target=call, daemon=True)
    t.start()
    t.join(RUN_S)
    assert not t.is_alive(), f"the run did not end within {RUN_S} s"
    if "error" in out:
        raise out["error"]
    return out["value"]


def aligner_of(idx, argv, hook=None) -> DartAligner:
    cfg = cli.parse_args(argv)
    aligner = DartAligner(idx, cfg, engine=make_engine(idx, cfg, "cpu"))
    if hook is not None:
        hook(aligner)
    return aligner


def run(aligner, on_written=None) -> DartAligner:
    def go():
        with contextlib.redirect_stdout(io.StringIO()):
            aligner.run(on_written=on_written)
        return aligner

    return bounded(go)


def spliced_argv(tmp_path, tag, files=1, extra=()):
    return ["-i", TOY, *["-f", os.path.join(DATA, "spliced.fa")] * files,
            "-o", str(tmp_path / f"{tag}.sam"),
            "-j", str(tmp_path / f"{tag}.tab"), "-silent", "--batch",
            str(BATCH), *extra]


def workers():
    return [t for t in threading.enumerate()
            if t.name.startswith("dart-finalize")]


def test_finalize_runs_on_one_worker_thread(idx, tmp_path):
    """Every chunk's finalize runs on one thread, not the caller's."""
    seen = []

    def hook(aligner):
        orig = aligner.native.process_chunk

        def on_thread(*a, **kw):
            seen.append(threading.get_ident())
            return orig(*a, **kw)

        aligner.native.process_chunk = on_thread

    callers = []

    def go():
        callers.append(threading.get_ident())
        aligner = aligner_of(idx, spliced_argv(tmp_path, "t"), hook)
        with contextlib.redirect_stdout(io.StringIO()):
            aligner.run()
        return aligner

    aligner = bounded(go)
    assert len(seen) == CHUNKS == aligner.stats["chunks"]
    assert len(set(seen)) == 1 and seen[0] != callers[0]
    assert not workers()


def test_finalize_of_a_chunk_overlaps_the_next_chunks_seeding(
        idx, tmp_path, monkeypatch):
    """Chunk 0's finalize holds until chunk 1's seeding finish has
    started, and is still running when it starts."""
    started, finishing = threading.Event(), threading.Event()
    state = {"finalizing": False, "calls": 0}
    orig_finish = seeding.finish_chunk

    def finish_chunk(*a, **kw):
        state["calls"] += 1
        if state["calls"] == 2:  # chunk 1's
            assert started.wait(WAIT_S)
            state["overlapped"] = state["finalizing"]
            finishing.set()
        return orig_finish(*a, **kw)

    monkeypatch.setattr(seeding, "finish_chunk", finish_chunk)

    def hook(aligner):
        orig = aligner.native.process_chunk
        calls = [0]

        def held(*a, **kw):
            calls[0] += 1
            if calls[0] == 1:
                state["finalizing"] = True
                started.set()
                state["waited"] = finishing.wait(WAIT_S)
                out = orig(*a, **kw)
                state["finalizing"] = False
                return out
            return orig(*a, **kw)

        aligner.native.process_chunk = held

    aligner = run(aligner_of(idx, spliced_argv(tmp_path, "o"), hook))
    assert state["waited"] and state["overlapped"]
    assert aligner.stats["chunks"] == CHUNKS
    with open(os.path.join(GOLD, "c3_spliced.sam"), "rb") as f:
        assert (tmp_path / "o.sam").read_bytes() == f.read()


@pytest.mark.parametrize("call", [1, 3, CHUNKS])
def test_worker_exception_comes_out_of_run(call, idx, tmp_path):
    """A finalize that raises on the worker ends ``run`` with its
    error, with the worker gone, in the first, a middle and the last
    chunk."""
    def hook(aligner):
        orig, calls = aligner.native.process_chunk, [0]

        def flaky(*a, **kw):
            calls[0] += 1
            if calls[0] == call:
                raise RuntimeError("injected crash")
            return orig(*a, **kw)

        aligner.native.process_chunk = flaky

    aligner = aligner_of(idx, spliced_argv(tmp_path, "x"), hook)
    with pytest.raises(RuntimeError, match="injected crash"):
        run(aligner)
    assert aligner.stats["chunks"] == call - 1
    assert not workers()


def test_checkpoint_counts_the_written_chunks(idx, tmp_path):
    """Saving every chunk over two files: at every checkpoint save the
    counters hold the reads of the chunks written and no more, and no
    finalize runs; chunk k's finalize starts after chunk k-1's save.
    ``on_written`` runs after each chunk's save, so it sees the save
    and the checkpoint it wrote."""
    saves, written, running, starts = [], [0], [0], []
    ckpt = tmp_path / "c.sam.ckpt"

    def hook(aligner):
        proc = aligner.native.process_chunk

        def finalizing(*a, **kw):
            starts.append(aligner.checkpoint.saves)
            running[0] += 1
            try:
                return proc(*a, **kw)
            finally:
                running[0] -= 1

        aligner.native.process_chunk = finalizing

    def on_written(fst, n):
        written[0] += n
        state = json.loads(ckpt.read_text())
        saves.append((state["counters"]["total"], written[0], running[0],
                      aligner.checkpoint.saves))

    aligner = aligner_of(
        idx, spliced_argv(tmp_path, "c", files=2,
                          extra=["--checkpoint", "--ckpt-interval", "0"]),
        hook)
    run(aligner, on_written)
    assert len(saves) == 2 * CHUNKS == aligner.stats["chunks"]
    assert all(total == done and not busy for total, done, busy, _ in saves)
    assert [n for *_, n in saves] == list(range(1, 2 * CHUNKS + 1))
    assert starts == list(range(2 * CHUNKS))
    assert saves[-1][0] == 2 * 600
    assert not ckpt.exists()


class Writers(dict):
    """A stats dict that records the threads writing each key."""

    def __init__(self, stats):
        super().__init__(stats)
        self.by: dict = {}

    def __setitem__(self, key, value):
        self.by.setdefault(key, set()).add(threading.get_ident())
        super().__setitem__(key, value)


def test_each_stats_key_has_one_writer_under_stress(idx, tmp_path):
    """Two aligners at once, with the interpreter switching threads
    every 10 µs: every run writes its stats keys from one thread each
    (the finalize's from the worker, the rest from the main thread),
    and counts and writes every read once."""
    def one(a):
        with contextlib.redirect_stdout(io.StringIO()):
            a.run()
        return a, threading.get_ident()

    runs = []
    for tag in ("s0", "s1"):  # engines built one at a time
        a = aligner_of(idx, spliced_argv(tmp_path, tag))
        a.stats = a.spans.stats = a.worker_spans.stats = Writers(a.stats)
        runs.append(a)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        done, threads = [], []
        for a in runs:
            t = threading.Thread(target=lambda a=a: done.append(one(a)),
                                 daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(RUN_S)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert len(done) == 2
    worker_keys = {"native_finalize_s", "finalize_parallel_s",
                   "finalize_serial_s"}
    with open(os.path.join(GOLD, "c3_spliced.sam"), "rb") as f:
        want = f.read()
    for a, main in done:
        assert a.counters["total"] == 600
        assert a.stats["chunks"] == CHUNKS
        assert all(len(ts) == 1 for ts in a.stats.by.values())
        assert {k for k, ts in a.stats.by.items() if main not in ts} \
            == worker_keys
        with open(a.cfg.output_file, "rb") as f:
            assert f.read() == want


def test_one_call_leaves_nothing_in_flight(idx, tmp_path):
    """``stream`` over one file, as a ``--dist`` shard calls it, returns
    with every chunk written and counted and its worker gone; a second
    call goes on from there."""
    aligner = aligner_of(idx, spliced_argv(tmp_path, "d"))
    parts = []

    def one_file():
        files = aligner.file_states([(os.path.join(DATA, "spliced.fa"),
                                      None)])
        aligner.stream(files, lambda sam, fst: parts.append(sam))
        return (aligner.stats["chunks"], aligner.counters["total"],
                len(parts), workers())

    assert bounded(one_file) == (CHUNKS, 600, CHUNKS, [])
    assert bounded(one_file) == (2 * CHUNKS, 1200, 2 * CHUNKS, [])
    with open(os.path.join(GOLD, "c3_spliced.sam"), "rb") as f:
        body = b"".join(ln for ln in f.read().splitlines(True)
                        if not ln.startswith(b"@"))
    assert b"".join(parts) == body * 2


@pytest.mark.parametrize("fmt", ["sam", "bam"])
def test_finalize_wait_within_the_wall(fmt, idx, tmp_path):
    """``finalize_wait_s`` is the main thread's: at least 0 and within
    the wall, with its other stages; the worker's finalize is within
    the wall too."""
    argv = ["-i", TOY, "-f", os.path.join(DATA, "pe_1.fq"), "-f2",
            os.path.join(DATA, "pe_2.fq"), "-mis", "5",
            "-bo" if fmt == "bam" else "-o", str(tmp_path / f"w.{fmt}"),
            "-j", str(tmp_path / "w.tab"), "-silent", "--batch", str(BATCH)]
    s = run(aligner_of(idx, argv)).stats
    assert s["chunks"] == CHUNKS
    assert 0 <= s["finalize_wait_s"] <= s["wall_s"]
    assert s["input_parse_s"] + s["device_seed_locate_s"] \
        + s["finalize_wait_s"] + s["output_s"] <= s["wall_s"]
    assert 0 < s["native_finalize_s"] <= s["wall_s"]


@pytest.mark.parametrize("golden, inputs, flags", [
    ("c5_pe", ["-f", "pe_1.fq", "-f2", "pe_2.fq"], ["-mis", "5"]),
    ("c7_pe_inter", ["-f", "pe_inter.fq"], ["-p", "-mis", "5"]),
    ("c4_spliced_mm", ["-f", "spliced_mm.fq"], ["-mis", "5", "-all_sj"]),
], ids=["pe", "pe_inter", "spliced_all_sj"])
def test_multi_chunk_runs_equal_the_goldens(golden, inputs, flags, idx,
                                            tmp_path):
    """Paired runs (two files, and interleaved) and a single-end
    ``-all_sj`` run in chunks of BATCH reads write the goldens' SAM
    and junctions.tab byte for byte."""
    argv = ["-i", TOY, *[a if a.startswith("-") else os.path.join(DATA, a)
                         for a in inputs], *flags,
            "-o", str(tmp_path / "g.sam"), "-j", str(tmp_path / "g.tab"),
            "-silent", "--batch", str(BATCH)]
    aligner = run(aligner_of(idx, argv))
    assert aligner.stats["chunks"] >= 2
    for ext, got in (("sam", "g.sam"), ("junctions.tab", "g.tab")):
        with open(os.path.join(GOLD, f"{golden}.{ext}"), "rb") as f:
            assert (tmp_path / got).read_bytes() == f.read(), ext
