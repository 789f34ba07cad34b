"""``dart-tpu-torch`` (``dart_tpu_torch.cli``) on the CPU: the evaluator
subcommands equal ``dart-tpu``'s, the port's own usage lines, ``--mesh``
runs equal to the goldens, and ``--profile`` writing a
``torch.profiler`` trace."""

import gzip
import json

import pytest
import torch

from dart_tpu import cli as dart_tpu_cli
from dart_tpu_torch import cli


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain kernels run many small ops; with the test workers
    sharing the cores, more intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FLUX_SAM = [
    "@SQ\tSN:chr1\tLN:1000",
    "chr1:100-250W1\t0\tchr1\t120\t50\t100M\t*\t0\t0\tAC\tII",
    "chr2:100-250W2\t0\tchr1\t120\t50\t100M\t*\t0\t0\tAC\tII",
    "chr1:100-250W3\t0\tchr1\t120\t0\t100M\t*\t0\t0\tAC\tII",
    "chr1:100-250W4\t4\t*\t0\t0\t*\t*\t0\t0\tAC\tII",
    "chr1:100-250W5\t0\tchr1\t500\t50\t100M\t*\t0\t0\tAC\tII",
]


def eval_argv(which, data_dir, golden_dir, tmp_path):
    """The inputs of tests/test_evaluation.py for each subcommand."""
    if which == "eva":
        return ["eva", str(golden_dir / "c3_spliced.sam"),
                str(data_dir / "toy.fa")]
    if which == "fluxeva":
        sam = tmp_path / "flux.sam"
        sam.write_text("\n".join(FLUX_SAM) + "\n")
        return ["fluxeva", str(sam)]
    truth = tmp_path / "junctions.txt"
    rows = []
    for line in (data_dir / "toy_genes.txt").read_text().splitlines():
        chrom, exs = line.split("\t")
        exons = [tuple(map(int, p.split("-"))) for p in exs.split(",")]
        rows += [f"{chrom}\t{b1 + 1}\t{a2}"
                 for (_, b1), (a2, _) in zip(exons, exons[1:])]
    truth.write_text("\n".join(rows) + "\n")
    return ["sjeva", str(golden_dir / "c3_spliced.junctions.tab"),
            str(truth)]


@pytest.mark.parametrize("which", ["eva", "fluxeva", "sjeva"])
def test_evaluators_equal_dart_tpu(which, data_dir, golden_dir, tmp_path,
                                   capsys):
    """``dart-tpu-torch eva|fluxeva|sjeva ...`` runs ``dart_tpu``'s
    evaluators: the same stdout and exit code as ``dart-tpu``."""
    argv = eval_argv(which, data_dir, golden_dir, tmp_path)
    got_rc = cli.main(list(argv))
    got = capsys.readouterr().out
    want_rc = dart_tpu_cli.main(list(argv))
    want = capsys.readouterr().out
    assert (got_rc, got) == (want_rc, want)
    assert got_rc == 0 and got.strip()
    assert "Unknown parameter" not in got


def test_usage_names_the_ports_own_flags(capsys):
    """The usage lines describe the port's ``--device``, ``--mesh``,
    ``--profile`` and ``--dist-*`` flags, not the JAX package's."""
    assert cli.main(["-h"]) == 0
    out = capsys.readouterr().out
    for flag in ("--device", "--mesh", "--profile", "--dist-coordinator",
                 "--dist-nprocs", "--dist-pid", "torch.profiler",
                 "torch.distributed", "-max_intron"):
        assert flag in out, flag
    assert "jax" not in out.lower() and "--engine" not in out
    assert out.count("Extensions:") == 1


def test_unknown_flag_prints_the_ports_usage(capsys):
    assert cli.main(["-i", "x", "--bogus"]) == 1
    cap = capsys.readouterr()
    assert "Unknown parameter: --bogus" in cap.err
    assert "torch.profiler" in cap.out and "jax" not in cap.out.lower()


GOLDEN_FLAGS = {
    "c3_spliced": ["-f", "spliced.fa"],
    "c5_pe": ["-f", "pe_1.fq", "-f2", "pe_2.fq", "-mis", "5"],
}


@pytest.mark.parametrize("name", sorted(GOLDEN_FLAGS))
def test_cli_mesh_matches_golden(name, data_dir, golden_dir, tmp_path,
                                 capsys):
    """``--device cpu --mesh data=2,index=2`` reproduces the golden SAM
    and junction table."""
    flags = [str(data_dir / f) if f.endswith((".fa", ".fq")) else f
             for f in GOLDEN_FLAGS[name]]
    rc = cli.main(["-i", str(golden_dir / "index" / "toy"), *flags,
                   "-o", str(tmp_path / "o.sam"), "-j",
                   str(tmp_path / "o.tab"), "-silent", "--device", "cpu",
                   "--mesh", "data=2,index=2"])
    assert rc == 0, capsys.readouterr().err
    assert (tmp_path / "o.sam").read_bytes() == \
        (golden_dir / f"{name}.sam").read_bytes()
    assert (tmp_path / "o.tab").read_bytes() == \
        (golden_dir / f"{name}.junctions.tab").read_bytes()


def test_profile_writes_a_trace(data_dir, golden_dir, tmp_path, capsys):
    """``--profile DIR`` writes one ``torch.profiler`` trace of the run
    into DIR (a few reads keep the CPU trace small), and the alignment
    is that of the run without it."""
    reads = tmp_path / "r.fa"
    reads.write_text("".join((data_dir / "se_exact.fa").read_text()
                             .splitlines(keepends=True)[:4]))
    sams = []
    for prof in (["--profile", str(tmp_path / "trace")], []):
        sam = tmp_path / f"o{len(sams)}.sam"
        assert cli.main(["-i", str(golden_dir / "index" / "toy"), "-f",
                         str(reads), "-o", str(sam), "-j",
                         str(tmp_path / "o.tab"), "-silent", "--device",
                         "cpu", *prof]) == 0
        sams.append(sam.read_bytes())
    assert sams[0] == sams[1] and sams[0].count(b"\n@") >= 1
    traces = list((tmp_path / "trace").iterdir())
    assert len(traces) == 1 and ".pt.trace.json" in traces[0].name
    raw = traces[0].read_bytes()
    if traces[0].name.endswith(".gz"):
        raw = gzip.decompress(raw)
    events = json.loads(raw)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
