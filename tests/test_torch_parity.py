"""The slice as a whole: the nine golden configs aligned by the port's
own ``DartAligner`` and ``DartConfig`` on its engine (FMIndexTorch on
the CPU, which runs the plain PyTorch kernels) and its own native
pipeline, on the index as the port's loader reads it, give SAM and
junctions.tab byte-equal to the reference binary's goldens."""

import io

import pytest
import torch

from dart_tpu_torch import cli
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


CONFIGS = {  # tests/test_parity.py
    "c1_se_exact": dict(r1=["se_exact.fa"]),
    "c2_se_mm": dict(r1=["se_mm.fq"], mis=5),
    "c3_spliced": dict(r1=["spliced.fa"]),
    "c4_spliced_mm": dict(r1=["spliced_mm.fq"], mis=5, all_sj=True),
    "c5_pe": dict(r1=["pe_1.fq"], r2=["pe_2.fq"], mis=5),
    "c6_pe_gz": dict(r1=["pe_1.fq.gz"], r2=["pe_2.fq.gz"], mis=5),
    "c7_pe_inter": dict(r1=["pe_inter.fq"], p=True, mis=5),
    "c8_multi": dict(r1=["se_exact.fa"], m=True),
    "c9_unique": dict(r1=["se_mm.fq"], unique=True, mis=5),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_golden_parity_on_port_engine(name, port_toy, data_dir, golden_dir,
                                      tmp_path, capsys):
    spec = CONFIGS[name]
    cfg = DartConfig()
    cfg.read_files_1 = [str(data_dir / f) for f in spec["r1"]]
    cfg.read_files_2 = [str(data_dir / f) for f in spec.get("r2", [])]
    cfg.max_mismatch = spec.get("mis", 0)
    cfg.pair_end = spec.get("p", False)
    cfg.multi_hit = spec.get("m", False)
    cfg.unique_only = spec.get("unique", False)
    cfg.find_all_junction = spec.get("all_sj", False)
    cfg.sj_file = str(tmp_path / f"{name}.tab")
    cfg.output_file = str(tmp_path / f"{name}.sam")
    cfg.silent = True
    engine = FMIndexTorch(port_toy, device="cpu")
    aligner = DartAligner(port_toy, cfg, engine=engine)
    assert aligner.native is not None
    out = io.StringIO()
    aligner.run(out_stream=out)
    assert out.getvalue() == (golden_dir / f"{name}.sam").read_text()
    assert (tmp_path / f"{name}.tab").read_text() == \
        (golden_dir / f"{name}.junctions.tab").read_text()


def test_cli_on_cpu_matches_golden(data_dir, golden_dir, tmp_path, capsys):
    sam, tab = tmp_path / "o.sam", tmp_path / "o.tab"
    rc = cli.main(["-i", str(golden_dir / "index" / "toy"), "-f",
                   str(data_dir / "pe_1.fq"), "-f2", str(data_dir / "pe_2.fq"),
                   "-mis", "5", "-o", str(sam), "-j", str(tab), "-silent",
                   "--device", "cpu"])
    assert rc == 0
    assert sam.read_bytes() == (golden_dir / "c5_pe.sam").read_bytes()
    assert tab.read_bytes() == (golden_dir / "c5_pe.junctions.tab").read_bytes()


def test_cli_refuses_cuda_without_a_card(data_dir, golden_dir, tmp_path,
                                         capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-i", str(golden_dir / "index" / "toy"), "-f",
                  str(data_dir / "se_exact.fa"), "-o",
                  str(tmp_path / "o.sam"), "-j", str(tmp_path / "o.tab"),
                  "-silent"])
    assert cli.main(["--device"]) == 1
