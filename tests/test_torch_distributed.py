"""Multi-host runs of the port (``dart_tpu_torch.parallel.distributed``):
two local ``dart-tpu-torch --device cpu`` processes joined by
``torch.distributed`` (gloo over TCP) align byte-range or round-robin
shards of the input and merge them into the single-process output, in
the pattern of tests/test_distributed.py: the goldens (-all_sj's merged
junction table and -m's multiple alignments among them), BAM output, and
a resume from per-process checkpoints after an injected crash. Each
pair of processes is killed if it outlives its time limit."""

import json
import os
import subprocess
import sys

import pytest

from dart_tpu_torch.parallel.distributed import held_port

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
DATA = os.path.join(HERE, "data")
GOLD = os.path.join(HERE, "golden")
TIMEOUT_S = 300  # one pair of processes; a few seconds each when well


def run_pair(args, env_extra=None):
    """Two ranks of ``dart-tpu-torch ... --device cpu`` on a port held
    for them (``held_port``: bound here until both are done, so that no
    other socket of the host is handed it meanwhile); returns their
    (return codes, stderr). Both are killed when either outlives
    TIMEOUT_S."""
    port, hold = held_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"  # the two ranks share the test's cores
    env.update(env_extra or {})
    procs = [subprocess.Popen(
        [sys.executable, "-m", "dart_tpu_torch.cli", *args, "--device", "cpu",
         "--dist-coordinator", f"127.0.0.1:{port}", "--dist-nprocs", "2",
         "--dist-pid", str(pid)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for pid in range(2)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=TIMEOUT_S)[1].decode())
    finally:
        hold.close()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], errs


@pytest.mark.parametrize("reads,golden,extra", [
    ("se_exact.fa", "c1_se_exact", []),
    ("spliced.fa", "c3_spliced", []),
    # a split gz pair and interleaved pairs take the round-robin
    # (strided) shards, several chunks to each process
    ("pe_1.fq.gz", "c6_pe_gz", ["-f2", "{DATA}/pe_2.fq.gz", "-mis", "5",
                                "--batch", "64"]),
    ("pe_inter.fq", "c7_pe_inter", ["-p", "-mis", "5", "--batch", "64"]),
    # -all_sj: every shard's junction rows merge into one table; -m:
    # every alignment of a multi-mapped read, in the merged order
    ("spliced_mm.fq", "c4_spliced_mm", ["-mis", "5", "-all_sj"]),
    ("se_exact.fa", "c8_multi", ["-m"]),
])
def test_two_process_run_matches_golden(tmp_path, reads, golden, extra):
    out, sj = tmp_path / "out.sam", tmp_path / "junctions.tab"
    rcs, errs = run_pair(
        ["-i", os.path.join(GOLD, "index", "toy"), "-f",
         os.path.join(DATA, reads), "-o", str(out), "-j", str(sj), "-silent",
         *[a.format(DATA=DATA) for a in extra]])
    assert rcs == [0, 0], errs[0][-2000:] + errs[1][-2000:]
    assert out.read_bytes() == open(os.path.join(GOLD, f"{golden}.sam"),
                                    "rb").read()
    assert sj.read_bytes() == open(
        os.path.join(GOLD, f"{golden}.junctions.tab"), "rb").read()


def test_two_process_bam_output(tmp_path):
    """``-bo``: process 0 encodes the merged shards as BAM, whose
    records are the golden SAM's."""
    from test_bam import decode_bam

    out = tmp_path / "out.bam"
    rcs, errs = run_pair(
        ["-i", os.path.join(GOLD, "index", "toy"), "-f",
         os.path.join(DATA, "spliced.fa"), "-bo", str(out), "-j",
         str(tmp_path / "junctions.tab"), "-silent", "--batch", "64"])
    assert rcs == [0, 0], errs[0][-2000:] + errs[1][-2000:]
    golden = [ln for ln in open(os.path.join(GOLD, "c3_spliced.sam"))
              if not ln.startswith("@")]
    _, _, records = decode_bam(str(out))
    assert len(records) == len(golden)
    for rec, line in zip(records, golden):
        f = line.rstrip("\n").split("\t")
        assert rec["name"] == f[0] and rec["flag"] == int(f[1])
        assert rec["pos"] == int(f[3]) and rec["cigar"] == f[5]


def test_two_process_checkpoint_resume(tmp_path):
    """Both processes fail after two chunks (the injected crash); the
    rerun resumes each shard from its checkpoint and gives the golden
    output, and leaves no checkpoint behind."""
    out, sj = tmp_path / "out.sam", tmp_path / "junctions.tab"
    args = ["-i", os.path.join(GOLD, "index", "toy"), "-f",
            os.path.join(DATA, "spliced.fa"), "-o", str(out), "-j", str(sj),
            "-silent", "--batch", "64", "--checkpoint"]
    rcs, errs = run_pair(args, {"DART_TPU_TEST_CRASH_AFTER_CHUNKS": "2"})
    assert all(rc != 0 for rc in rcs), "the crash hook did not fire"
    assert "injected distributed crash" in errs[0]
    assert os.path.exists(str(out) + ".shard0000.ckpt")
    assert os.path.exists(str(out) + ".shard0001.ckpt")

    rcs, errs = run_pair(args)
    assert rcs == [0, 0], errs[0][-2000:] + errs[1][-2000:]
    assert not os.path.exists(str(out) + ".shard0000.ckpt")
    assert out.read_bytes() == open(os.path.join(GOLD, "c3_spliced.sam"),
                                    "rb").read()
    assert sj.read_bytes() == open(
        os.path.join(GOLD, "c3_spliced.junctions.tab"), "rb").read()


def test_two_process_pre_version_checkpoint_restarts(tmp_path):
    """Checkpoints in the layout of the port before ``Checkpoint`` (no
    ``version``, ``bytes`` for the shard's length, no output format or
    reader) do not resume: the rerun starts every shard over and gives
    the golden output, although each shard's bytes before its
    checkpoint's offset were overwritten."""
    out, sj = tmp_path / "out.sam", tmp_path / "junctions.tab"
    args = ["-i", os.path.join(GOLD, "index", "toy"), "-f",
            os.path.join(DATA, "spliced.fa"), "-o", str(out), "-j", str(sj),
            "-silent", "--batch", "64", "--checkpoint"]
    rcs, errs = run_pair(args, {"DART_TPU_TEST_CRASH_AFTER_CHUNKS": "2"})
    assert all(rc != 0 for rc in rcs), "the crash hook did not fire"
    for pid in range(2):
        shard = f"{out}.shard{pid:04d}"
        with open(shard + ".ckpt") as f:
            state = json.load(f)
        assert state.pop("version")
        del state["output_format"], state["reader"]
        state["bytes"] = state.pop("sam_bytes")
        with open(shard + ".ckpt", "w") as f:
            json.dump(state, f)
        with open(shard, "r+b") as f:  # a resume would keep these bytes
            f.write(b"#" * state["bytes"])

    rcs, errs = run_pair(args)
    assert rcs == [0, 0], errs[0][-2000:] + errs[1][-2000:]
    assert not os.path.exists(str(out) + ".shard0000.ckpt")
    assert out.read_bytes() == open(os.path.join(GOLD, "c3_spliced.sam"),
                                    "rb").read()
    assert sj.read_bytes() == open(
        os.path.join(GOLD, "c3_spliced.junctions.tab"), "rb").read()


@pytest.mark.parametrize("files,extra", [
    # plain single-end files: byte-range shards
    (["spliced.fa", "se_exact.fa"], ["-mis", "5"]),
    # interleaved pairs: round-robin (strided) shards
    (["pe_inter.fq", "pe_inter.fq"], ["-p", "-mis", "5"]),
], ids=["byte_range", "strided"])
def test_two_process_run_of_two_files_equals_one_process(tmp_path, files,
                                                         extra):
    """Two ``-f`` files through two processes: the merged SAM and
    junctions.tab are byte-equal to one process's run of the same
    files and flags."""
    import contextlib
    import io

    import torch

    from dart_tpu_torch.aligner import DartAligner, make_engine
    from dart_tpu_torch.cli import parse_args
    from dart_tpu_torch.index import load_index

    args = ["-i", os.path.join(GOLD, "index", "toy"),
            *[a for f in files for a in ("-f", os.path.join(DATA, f))],
            *extra, "-silent", "--batch", "256"]
    one = (tmp_path / "one.sam", tmp_path / "one.tab")
    cfg = parse_args([*args, "-o", str(one[0]), "-j", str(one[1])])
    idx = load_index(cfg.index_prefix)
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks: the test workers share the cores
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            DartAligner(idx, cfg, engine=make_engine(idx, cfg, "cpu")).run()
    finally:
        torch.set_num_threads(n)
    two = (tmp_path / "two.sam", tmp_path / "two.tab")
    rcs, errs = run_pair([*args, "-o", str(two[0]), "-j", str(two[1])])
    assert rcs == [0, 0], errs[0][-2000:] + errs[1][-2000:]
    assert two[0].read_bytes() == one[0].read_bytes()
    assert two[1].read_bytes() == one[1].read_bytes()


def test_world_size_is_checked(monkeypatch):
    """A process group of another size than ``--dist-nprocs`` raises
    before any work, and the group is torn down."""
    import torch.distributed as dist

    from dart_tpu.config import DartConfig
    from dart_tpu_torch.parallel import distributed

    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    monkeypatch.setattr(dist, "get_world_size", lambda: 3)
    monkeypatch.setattr(dist, "destroy_process_group",
                        lambda: calls.append("destroyed"))
    with pytest.raises(RuntimeError, match="formed 3 processes, expected 2"):
        distributed.run_distributed(DartConfig(), "127.0.0.1:1", 2, 0, "cpu")
    args, kw = calls[0]
    assert args == ("gloo",) and kw["init_method"] == "tcp://127.0.0.1:1"
    assert kw["world_size"] == 2 and kw["rank"] == 0
    assert 0 < kw["timeout"].total_seconds() <= distributed.TIMEOUT_S
    assert calls[-1] == "destroyed"


def test_rank_device():
    from dart_tpu_torch.parallel.distributed import rank_device

    assert str(rank_device("cpu", 1)) == "cpu"
    assert str(rank_device("cuda:1", 0)) == "cuda:1"
