"""Multi-host runs of the port (``dart_tpu_torch.parallel.distributed``):
two local ``dart-tpu-torch --device cpu`` processes joined by
``torch.distributed`` (gloo over TCP) align byte-range or round-robin
shards of the input and merge them into the single-process output, in
the pattern of tests/test_distributed.py: the goldens (-all_sj's merged
junction table and -m's multiple alignments among them), BAM output, and
a resume from per-process checkpoints after an injected crash. Each
pair of processes is killed if it outlives its time limit."""

import os
import socket
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
DATA = os.path.join(HERE, "data")
GOLD = os.path.join(HERE, "golden")
TIMEOUT_S = 300  # one pair of processes; a few seconds each when well


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_pair(args, env_extra=None):
    """Two ranks of ``dart-tpu-torch ... --device cpu`` on a fresh port;
    returns their (return codes, stderr). Both are killed when either
    outlives TIMEOUT_S."""
    port = _free_port()
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
