"""Output paths of the port's own ``DartAligner`` and ``DartConfig`` on
its engine (FMIndexTorch on the CPU): BAM output, and checkpoint/resume
after a crash mid-stream. ``dart_tpu`` appears only as what the BAM
bytes are compared with."""

import pytest
import torch

import dart_tpu.aligner
import dart_tpu.config
from dart_tpu_torch.aligner import DartAligner
from dart_tpu_torch.config import DartConfig
from dart_tpu_torch.index import load_index
from dart_tpu_torch.ops.fm_torch import FMIndexTorch


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
    """The toy index as the port's own loader reads it."""
    return load_index(str(golden_dir / "index" / "toy"))


@pytest.mark.parametrize("reads", [["spliced.fa"], ["pe_1.fq", "pe_2.fq"]])
def test_bam_equal_to_numpy_engine(reads, toy_index, port_toy, data_dir,
                                   tmp_path, capsys):
    """The port's BAM bytes equal those of dart_tpu's aligner on its
    NumPy engine on the same reads (whose records tests/test_bam.py
    holds against the goldens)."""
    out = {}
    for who in ("port", "numpy"):
        cfg = DartConfig() if who == "port" else dart_tpu.config.DartConfig()
        cfg.read_files_1 = [str(data_dir / reads[0])]
        cfg.read_files_2 = [str(data_dir / r) for r in reads[1:]]
        cfg.max_mismatch = 5
        cfg.output_format = 1
        cfg.output_file = str(tmp_path / f"{who}.bam")
        cfg.sj_file = str(tmp_path / f"{who}.tab")
        cfg.silent = True
        if who == "numpy":
            cfg.engine = "numpy"
            dart_tpu.aligner.DartAligner(toy_index, cfg).run()
        else:
            DartAligner(port_toy, cfg,
                        engine=FMIndexTorch(port_toy, device="cpu")).run()
        out[who] = ((tmp_path / f"{who}.bam").read_bytes(),
                    (tmp_path / f"{who}.tab").read_bytes())
    assert out["port"][0][:4] == b"\x1f\x8b\x08\x04"  # BGZF
    assert out["port"] == out["numpy"]


def _cfg(data_dir, tmp_path):
    cfg = DartConfig()
    cfg.read_files_1 = [str(data_dir / "spliced.fa")]
    cfg.output_file = str(tmp_path / "out.sam")
    cfg.sj_file = str(tmp_path / "junctions.tab")
    cfg.batch_reads = 256
    cfg.checkpoint = True
    cfg.silent = True
    return cfg


def test_resume_after_interrupt(port_toy, data_dir, golden_dir, tmp_path,
                                capsys):
    """A run that dies in its third chunk resumes from its checkpoint
    and ends with the golden SAM and junction table
    (tests/test_checkpoint.py, on the port's engine)."""
    al = DartAligner(port_toy, _cfg(data_dir, tmp_path),
                     engine=FMIndexTorch(port_toy, device="cpu"))
    calls = {"n": 0}
    orig = al.native.process_chunk

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected crash")
        return orig(*a, **kw)

    al.native.process_chunk = flaky
    with pytest.raises(RuntimeError):
        al.run()
    assert (tmp_path / "out.sam.ckpt").exists()

    al2 = DartAligner(port_toy, _cfg(data_dir, tmp_path),
                      engine=FMIndexTorch(port_toy, device="cpu"))
    al2.run()
    assert (tmp_path / "out.sam").read_text() == \
        (golden_dir / "c3_spliced.sam").read_text()
    assert (tmp_path / "junctions.tab").read_text() == \
        (golden_dir / "c3_spliced.junctions.tab").read_text()
    assert not (tmp_path / "out.sam.ckpt").exists()
    assert al2.counters["total"] == 600
