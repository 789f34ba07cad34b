"""Long-stream paths of the port on the CPU (``dart_tpu_torch.stream``,
``DartAligner.run`` over several ``-f`` files): the toy golden c3's
reads (``spliced.fa``, 600 reads) as three files at ``--batch 256``, so
that each file is cut into three chunks (256, 256, 88). The stream is
c3's SAM records three times with its junction counts tripled; a run
crashed in the second file resumes from its checkpoint to the
uninterrupted output, also when the last save lags the crash, and
through ``stream.crash_and_resume`` in the third file; the stream
module logs every chunk and ends with its summary line; and
``check_stream`` refuses a changed record or junction count."""

import contextlib
import gc
import gzip
import io
import json
import shutil

import pytest
import torch

from dart_tpu_torch import stream
from dart_tpu_torch.aligner import DartAligner, make_engine
from dart_tpu_torch.cli import parse_args
from dart_tpu_torch.index import load_index

N_FILES, BATCH, PER_FILE = 3, 256, 600
CHUNKS_A_FILE = 3  # 256 + 256 + 88 reads


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain kernels run many small ops; with the test workers
    sharing the cores, more intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_toy(golden_dir):
    return load_index(str(golden_dir / "index" / "toy"))


def argv(golden_dir, data_dir, out, tab, fmt="sam", n=N_FILES, extra=()):
    return ["-i", str(golden_dir / "index" / "toy"), "-f",
            *[str(data_dir / "spliced.fa")] * n,
            "-bo" if fmt == "bam" else "-o", str(out), "-j", str(tab),
            "-silent", "--batch", str(BATCH), *extra]


def align(idx, args, hook=None) -> DartAligner:
    """``dart-tpu-torch args --device cpu`` through a ``DartAligner`` that
    ``hook`` may change before its run."""
    cfg = parse_args(args)
    aligner = DartAligner(idx, cfg, engine=make_engine(idx, cfg, "cpu"))
    if hook is not None:
        hook(aligner)
    with contextlib.redirect_stdout(io.StringIO()):
        aligner.run()
    return aligner


def crash_in_call(call: int):
    """A hook whose aligner's native pipeline raises on its call-th
    chunk, as a process that dies there."""
    def hook(aligner):
        orig, calls = aligner.native.process_chunk, [0]

        def flaky(*a, **kw):
            calls[0] += 1
            if calls[0] == call:
                raise RuntimeError("injected crash")
            return orig(*a, **kw)

        aligner.native.process_chunk = flaky
    return hook


@pytest.fixture(scope="module")
def whole(port_toy, golden_dir, data_dir, tmp_path_factory):
    """Uninterrupted --checkpoint streams of three files, SAM and BAM,
    and a one-file BAM run: {fmt: (alignments, junctions.tab)}."""
    d = tmp_path_factory.mktemp("whole")
    out = {}
    for tag, fmt, n in (("sam", "sam", N_FILES), ("bam", "bam", N_FILES),
                        ("one_bam", "bam", 1)):
        paths = (d / f"{tag}.{fmt}", d / f"{tag}.tab")
        a = align(port_toy, argv(golden_dir, data_dir, *paths, fmt, n,
                                 ["--checkpoint"]))
        assert a.stats["chunks"] == n * CHUNKS_A_FILE
        assert not (d / f"{tag}.{fmt}.ckpt").exists()
        out[tag] = tuple(map(str, paths))
    return out


def test_three_files_are_the_golden_three_times(whole, golden_dir):
    """The header once, then c3's records three times in order;
    junctions.tab has c3's rows with every count times three."""
    gold = (golden_dir / "c3_spliced.sam").read_bytes().splitlines(True)
    head = [ln for ln in gold if ln.startswith(b"@")]
    body = gold[len(head):]
    assert open(whole["sam"][0], "rb").read() == b"".join(
        head + body * N_FILES)
    rows = [ln.split("\t") for ln in
            (golden_dir / "c3_spliced.junctions.tab").read_text()
            .splitlines()]
    assert open(whole["sam"][1]).read().splitlines() == [
        "\t".join([*r[:3], str(int(r[3]) * N_FILES)]) for r in rows]


@pytest.mark.parametrize("fmt", ["sam", "bam"])
def test_check_stream_accepts_the_stream(fmt, whole, golden_dir):
    one = ((str(golden_dir / "c3_spliced.sam"),
            str(golden_dir / "c3_spliced.junctions.tab"))
           if fmt == "sam" else whole["one_bam"])
    got = stream.check_stream(whole[fmt], one, N_FILES, fmt)
    assert got["junctions"] == 11 and got["file_bytes"] > 0
    with pytest.raises(AssertionError, match="records of file 3"):
        stream.check_stream(whole[fmt], one, N_FILES + 1, fmt)


@pytest.mark.parametrize("what", ["sam_record", "bam_record", "junction"])
def test_check_stream_refuses_a_change(what, whole, golden_dir, tmp_path):
    """One record of the third file with one base changed, or one
    junction count off by one, is refused."""
    fmt = "bam" if what == "bam_record" else "sam"
    aln, tab = (tmp_path / f"s.{fmt}", tmp_path / "s.tab")
    shutil.copy(whole[fmt][0], aln)
    shutil.copy(whole[fmt][1], tab)
    one = ((str(golden_dir / "c3_spliced.sam"),
            str(golden_dir / "c3_spliced.junctions.tab"))
           if fmt == "sam" else whole["one_bam"])
    stream.check_stream((str(aln), str(tab)), one, N_FILES, fmt)
    if what == "junction":
        rows = tab.read_text().splitlines()
        r = rows[5].split("\t")
        rows[5] = "\t".join([*r[:3], str(int(r[3]) + 1)])
        tab.write_text("".join(ln + "\n" for ln in rows))
        match = "row 5 of 11"
    elif fmt == "sam":
        lines = aln.read_bytes().splitlines(True)
        i = len(lines) - 10  # a record of the third file
        f = lines[i].split(b"\t")
        f[9] = bytes([f[9][0] ^ (ord("A") ^ ord("C"))]) + f[9][1:]
        lines[i] = b"\t".join(f)
        aln.write_bytes(b"".join(lines))
        match = "records of file 2"
    else:
        raw = bytearray(gzip.decompress(aln.read_bytes()))
        raw[-40] ^= 1  # inside the last record's sequence or qualities
        aln.write_bytes(gzip.compress(bytes(raw)))
        match = "records of file 2"
    with pytest.raises(AssertionError, match=match):
        stream.check_stream((str(aln), str(tab)), one, N_FILES, fmt)


@pytest.mark.parametrize("fmt", ["sam", "bam"])
@pytest.mark.parametrize("interval", ["0", "3600"],
                         ids=["every_chunk", "lagging"])
def test_crash_in_second_file_resumes(fmt, interval, port_toy, whole,
                                      golden_dir, data_dir, tmp_path):
    """The run dies in the second chunk of the second file (the fifth
    chunk); rerun, it resumes from its checkpoint. Saving every chunk,
    the cursor is the first chunk of the second file; at a
    --ckpt-interval longer than the run, only the first chunk was
    saved, so the resume re-does the first file's last two chunks and
    the second file's first. Either way the outputs equal the uninterrupted
    stream's: byte for byte, but for a lagging BAM its records (its
    checkpoints flushed the BGZF blocks at other places)."""
    paths = (tmp_path / f"r.{fmt}", tmp_path / "r.tab")
    args = argv(golden_dir, data_dir, *paths, fmt,
                extra=["--checkpoint", "--ckpt-interval", interval])
    with pytest.raises(RuntimeError, match="injected crash"):
        align(port_toy, args, crash_in_call(CHUNKS_A_FILE + 2))
    gc.collect()  # the crashed run's writer goes, as with its process
    ckpt = json.loads((tmp_path / f"r.{fmt}.ckpt").read_text())
    cursor = (1, 1) if interval == "0" else (0, 1)
    assert (ckpt["file_idx"], ckpt["chunks"]) == cursor
    assert ckpt["counters"]["total"] == cursor[0] * PER_FILE + \
        cursor[1] * BATCH
    resumed = align(port_toy, args)
    done = cursor[0] * CHUNKS_A_FILE + cursor[1]
    assert resumed.stats["chunks"] == N_FILES * CHUNKS_A_FILE - done
    assert not (tmp_path / f"r.{fmt}.ckpt").exists()
    assert paths[1].read_bytes() == open(whole[fmt][1], "rb").read()
    got, want = paths[0].read_bytes(), open(whole[fmt][0], "rb").read()
    if fmt == "bam" and interval != "0":
        got, want = gzip.decompress(got), gzip.decompress(want)
    assert got == want


@pytest.mark.parametrize("fmt", ["sam", "bam"])
def test_crash_and_resume_in_a_later_file(fmt, port_toy, whole, golden_dir,
                                          data_dir, tmp_path):
    """``stream.crash_and_resume``: the three-file stream dies in the
    second chunk of its third file, with no chunk finished since the
    last save, and its rerun resumes from the checkpoint after that
    file's first chunk to the uninterrupted stream's outputs, byte for
    byte."""
    out, tab = tmp_path / f"c.{fmt}", tmp_path / "c.tab"
    cfg = parse_args(argv(golden_dir, data_dir, out, tab, fmt, n=1,
                          extra=["--checkpoint"]))
    got = stream.crash_and_resume(port_toy, cfg, N_FILES, "cpu",
                                  make_engine(port_toy, cfg, "cpu"),
                                  PER_FILE, file_idx=2, chunk=2)
    assert (got["file"], got["file_chunk"], got["redone"]) == (2, 2, 0)
    assert got["crashed"] == 2 * CHUNKS_A_FILE + 2
    assert (got["ckpt"]["file_idx"], got["ckpt"]["chunks"]) == (2, 1)
    assert got["ckpt"]["counters"]["total"] == 2 * PER_FILE + BATCH
    assert got["resumed"]["chunks"] == CHUNKS_A_FILE - 1
    assert tab.read_bytes() == open(whole[fmt][1], "rb").read()
    assert out.read_bytes() == open(whole[fmt][0], "rb").read()


def test_stream_module_logs_each_chunk(golden_dir, data_dir, tmp_path,
                                       capsys):
    """``python -m dart_tpu_torch.stream --device cpu``: a warm pass
    into the one-file outputs, one log line a chunk, and the summary
    line with the documented keys; the stream passes check_stream
    against its own one-file run and against the golden."""
    out, tab = tmp_path / "s.sam", tmp_path / "s.tab"
    args = argv(golden_dir, data_dir, out, tab, n=1,
                extra=["--checkpoint", "--files", "2", "--device", "cpu"])
    assert stream.main(args) == 0
    cap = capsys.readouterr()
    chunks = [ln for ln in cap.err.splitlines() if ln.startswith("[chunk")]
    assert len(chunks) == 2 * CHUNKS_A_FILE
    assert [int(ln.split()[3]) for ln in chunks] == [0] * 3 + [1] * 3
    summary = json.loads(cap.out.strip().splitlines()[-1])
    for key in ("config", "total_reads", "wall_s", "reads_per_sec", "chunks",
                "median_rate_first_quarter", "median_rate_last_quarter",
                "rate_drift", "rss_mb_start", "rss_mb_end", "checkpoint",
                "ckpt_interval_s", "median_rate_after_file_1",
                "rss_mb_by_file", "rss_mb_per_file", "launches"):
        assert key in summary, key
    assert summary["total_reads"] == 2 * PER_FILE
    assert summary["chunks"] == 2 * CHUNKS_A_FILE
    assert len(summary["rss_mb_by_file"]) == 2
    assert summary["device"] == "cpu" and summary["checkpoint"]
    one = stream.one_file_paths(parse_args(["-o", str(out), "-j", str(tab)]))
    assert one == (str(tmp_path / "s.one.sam"), str(tmp_path / "s.one.tab"))
    stream.check_stream((str(out), str(tab)), one, 2)
    stream.check_stream((str(out), str(tab)),
                        (str(golden_dir / "c3_spliced.sam"),
                         str(golden_dir / "c3_spliced.junctions.tab")), 2)


def test_stream_module_raises_without_a_card(golden_dir, data_dir, tmp_path,
                                             monkeypatch):
    """The default device is cuda; with no card it raises, and nothing
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = argv(golden_dir, data_dir, tmp_path / "s.sam", tmp_path / "s.tab",
                n=1, extra=["--files", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream.main(args)
    assert not (tmp_path / "s.one.sam").exists()


MiB = 1 << 20


@pytest.mark.parametrize("procs, pid, want", [
    ([(7, 5 * MiB), (9, 3 * MiB)], 9, 3 * MiB),  # this pid among others
    ([(123456, 644 * MiB)], 9, 644 * MiB),  # one process, numbered otherwise
    ([(7, 5 * MiB), (8, 3 * MiB)], 9, None),  # several, none of them this
    ([(9, stream.NVML_NA)], 9, None),  # NVML has no count
    ([], 9, None),
    (None, 9, None),  # NVML did not answer
], ids=["pid", "alone", "others", "no_count", "empty", "no_nvml"])
def test_own_bytes(procs, pid, want):
    assert stream.own_bytes(procs, pid) == want


def chunk_records(n=8, used=700 * MiB, own=644 * MiB, reserved=126 * MiB,
                  at=None):
    """n synthetic per-chunk records of ``run_stream``, flat but for the
    card fields in ``at`` ({chunk: {field: value}})."""
    recs = []
    for i in range(n):
        card = {"allocated": 40 * MiB, "reserved": reserved, "used": used,
                "own": own}
        card.update((at or {}).get(i, {}))
        recs.append({"file": i // 2, "reads": 100, "card": card})
    return recs


@pytest.mark.parametrize("at, error", [
    ({}, None),
    # another process takes 520 MiB of the card for a moment: reported
    ({5: {"used": 1220 * MiB}}, None),
    # the reserve grows to chunk 3's and back: the last is no larger
    ({0: {"reserved": 106 * MiB}, 4: {"reserved": 146 * MiB}}, None),
    # this process's own bytes grow past the slack, outside the allocator
    ({6: {"own": 744 * MiB, "used": 800 * MiB}}, "moved 100.0 MiB"),
    ({7: {"own": None}}, "chunk 7: NVML gave no count"),
    ({7: {"reserved": 128 * MiB}}, "reserve grew 2097152 bytes"),
], ids=["flat", "other_process", "reserve_back", "own_grew", "no_nvml",
        "reserve_grew"])
def test_hold_card(at, error):
    """``hold_card`` holds the reserve after the last chunk to the
    third's and this process's own bytes within the slack from the
    third chunk on; the card's used bytes, which count other processes,
    it reports."""
    recs = chunk_records(at=at)
    if error is not None:
        with pytest.raises(AssertionError, match=error):
            stream.hold_card(recs)
        return
    held = stream.hold_card(recs)
    moved = 520 * MiB if 5 in at else 0
    assert held == {"reserve_grew": 0, "own_moved": 0, "used_moved": moved,
                    "used_moves_past_slack": int(moved > 0)}


def test_hold_card_needs_three_chunks():
    with pytest.raises(ValueError, match="2 chunks"):
        stream.hold_card(chunk_records(2))
