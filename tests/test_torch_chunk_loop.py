"""The seams of the port's one chunk loop (``DartAligner.stream``) on the
CPU: the one reader choice (``aligner.reader_class``) that both the run
and its checkpoint take, a checkpoint of another layout that restarts
the run, and ``on_written``, which sees every chunk once, in order, on
the main thread, after its checkpoint.

The toy golden index; runs cut their reads into small chunks (the plain
CPU engine takes ~0.6 s a chunk of 128 reads)."""

import contextlib
import io
import json
import os
import threading

import pytest
import torch

from dart_tpu_torch import cli
from dart_tpu_torch.aligner import (DartAligner, make_engine, open_reads,
                                    reader_class)
from dart_tpu_torch.index import load_index
from dart_tpu_torch.io.fastx import ChunkReader
from dart_tpu_torch.io.fastx_fast import FastChunkReader, FastPairedReader

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
GOLD = os.path.join(HERE, "golden")
TOY = os.path.join(GOLD, "index", "toy")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def idx():
    return load_index(TOY)


def aligner_of(idx, argv) -> DartAligner:
    cfg = cli.parse_args(argv)
    return DartAligner(idx, cfg, engine=make_engine(idx, cfg, "cpu"))


def run(aligner, on_written=None) -> DartAligner:
    with contextlib.redirect_stdout(io.StringIO()):
        aligner.run(on_written=on_written)
    return aligner


class Stop(Exception):
    """Ends a run after its first chunk."""


INPUTS = {"single": ["se_exact.fa"], "paired": ["pe_1.fq", "pe_2.fq"]}


@pytest.mark.parametrize("size", ["under", "over"])
@pytest.mark.parametrize("shape", ["single", "paired"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_the_run_opens_the_reader_its_checkpoint_records(
        native, shape, size, idx, tmp_path, monkeypatch):
    """Native or not, single or paired, files under or over the
    whole-file readers' limit (their size faked): ``reader_class`` picks
    the whole-file readers only natively and under the limit, the run
    opens that reader, and its checkpoint records that class."""
    paths = [os.path.join(DATA, p) for p in INPUTS[shape]]
    if size == "over":
        real = os.path.getsize
        monkeypatch.setattr(os.path, "getsize", lambda p: (
            9 << 30 if p in paths else real(p)))
    want = (ChunkReader if not native or size == "over" else
            FastChunkReader if shape == "single" else FastPairedReader)
    path2 = paths[1] if shape == "paired" else None
    assert reader_class(native, paths[0], path2) is want

    argv = ["-i", TOY, "-f", paths[0], *(["-f2", path2] if path2 else []),
            "-mis", "5", "-o", str(tmp_path / "r.sam"),
            "-j", str(tmp_path / "r.tab"), "-silent", "--batch", "16",
            "--checkpoint", *([] if native else ["--no-native"])]
    aligner = aligner_of(idx, argv)
    assert (aligner.native is not None) == native
    seen = []

    def on_written(fst, n):
        ckpt = json.loads((tmp_path / "r.sam.ckpt").read_text())
        seen.append((type(fst["reader"]), ckpt["reader"]))
        raise Stop

    with pytest.raises(Stop):
        run(aligner, on_written)
    assert seen == [(want, want.__name__)]
    reader = open_reads(aligner.cfg, native, paths[0], path2)
    reader.close()
    assert type(reader) is want


def crashed_run(idx, argv, call):
    """``argv``'s run with its native finalize raising on its call-th
    chunk, as a process that dies there."""
    aligner = aligner_of(idx, argv)
    orig, calls = aligner.native.process_chunk, [0]

    def flaky(*a, **kw):
        calls[0] += 1
        if calls[0] == call:
            raise RuntimeError("injected crash")
        return orig(*a, **kw)

    aligner.native.process_chunk = flaky
    with pytest.raises(RuntimeError, match="injected crash"):
        run(aligner)


def test_a_checkpoint_without_a_version_restarts_the_run(idx, tmp_path):
    """A checkpoint in the layout of the port before ``Checkpoint`` (no
    ``version``, the first-chunk ramp's fields) does not resume: the
    rerun starts over and writes the golden output, although the output
    before the checkpoint's offset was overwritten."""
    out = tmp_path / "v.sam"
    argv = ["-i", TOY, "-f", os.path.join(DATA, "spliced.fa"), "-o",
            str(out), "-j", str(tmp_path / "v.tab"), "-silent", "--batch",
            "256", "--checkpoint"]
    crashed_run(idx, argv, 2)
    ckpt = tmp_path / "v.sam.ckpt"
    state = json.loads(ckpt.read_text())
    assert state.pop("version") and state["chunks"] == 1
    state.update(ramp_reads=0, ramp_first_file_only=True)
    ckpt.write_text(json.dumps(state))
    with open(out, "r+b") as f:  # a resume would keep these bytes
        f.write(b"#" * state["sam_bytes"])

    aligner = run(aligner_of(idx, argv))
    assert aligner.stats["chunks"] == 3  # 256 + 256 + 88 reads
    assert out.read_bytes() == open(os.path.join(GOLD, "c3_spliced.sam"),
                                    "rb").read()
    assert (tmp_path / "v.tab").read_bytes() == open(
        os.path.join(GOLD, "c3_spliced.junctions.tab"), "rb").read()
    assert not ckpt.exists()


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_on_written_sees_every_chunk_once_after_its_checkpoint(
        native, idx, tmp_path):
    """Two files saved every chunk: ``on_written`` is called once a
    chunk, in order, on the thread that runs ``run``, each time after
    the chunk's checkpoint (one more save, whose cursor and counters
    are the chunk's); the output is the golden's records twice."""
    argv = ["-i", TOY, *["-f", os.path.join(DATA, "spliced.fa")] * 2,
            "-o", str(tmp_path / "w.sam"), "-j", str(tmp_path / "w.tab"),
            "-silent", "--batch", "256", "--checkpoint", "--ckpt-interval",
            "0", *([] if native else ["--no-native"])]
    aligner = aligner_of(idx, argv)
    seen = []

    def on_written(fst, n):
        ckpt = json.loads((tmp_path / "w.sam.ckpt").read_text())
        seen.append((threading.get_ident(), fst["file_idx"], fst["chunks"],
                     n, aligner.checkpoint.saves, ckpt["file_idx"],
                     ckpt["chunks"], ckpt["counters"]["total"],
                     aligner.stats["chunks"]))

    run(aligner, on_written)
    sizes = [256, 256, 88]
    want, total = [], 0
    for fi in range(2):
        for c, n in enumerate(sizes, 1):
            total += n
            i = len(want) + 1
            want.append((threading.get_ident(), fi, c, n, i, fi, c, total,
                         i))
    assert seen == want
    body = [ln for ln in open(os.path.join(GOLD, "c3_spliced.sam"), "rb")
            if not ln.startswith(b"@")]
    got = (tmp_path / "w.sam").read_bytes().splitlines(True)
    assert [ln for ln in got if not ln.startswith(b"@")] == body * 2
