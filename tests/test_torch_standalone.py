"""The port's own host code, held against ``dart_tpu``'s, of which it is
a copy: no module of ``dart_tpu_torch`` and no line of ``chip_smoke.py``
imports ``dart_tpu`` (read with ``ast``, so that imports in branches the
CPU never runs count too); ``dart-tpu-torch index`` writes the index
files that ``dart_tpu``'s builder writes, and the reference's; the nine
goldens through the port's pure-Python host pipeline (``--no-native``);
and the two packages' native libraries, loaded in one process, writing
the same SAM bytes."""

import ast
import io
import pathlib

import pytest
import torch

import dart_tpu.aligner
import dart_tpu.native.build
from dart_tpu.index import build_index as dart_tpu_build_index
from dart_tpu_torch import aligner, cli
from dart_tpu_torch.config import DartConfig
from dart_tpu_torch.index import load_index
from dart_tpu_torch.native import build as native_build
from dart_tpu_torch.ops.fm_torch import FMIndexTorch

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dart_tpu_imports(source: str, name: str) -> list:
    """The lines of ``source`` (the text of file ``name``) that import
    ``dart_tpu`` or a module of it."""
    hits = []
    for node in ast.walk(ast.parse(source, name)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names = [node.module or ""]
        else:
            continue
        if any(n == "dart_tpu" or n.startswith("dart_tpu.") for n in names):
            hits.append(f"{name}:{node.lineno}")
    return hits


def test_no_module_of_the_port_imports_dart_tpu():
    files = sorted((ROOT / "dart_tpu_torch").rglob("*.py"))
    assert len(files) > 30
    hits = [h for f in files + [ROOT / "chip_smoke.py"]
            for h in dart_tpu_imports(f.read_text(), str(f.relative_to(ROOT)))]
    assert hits == []
    # the check itself finds such lines, in a branch and at any depth
    probe = ("import os\ndef f():\n    if os.sep:\n"
             "        from dart_tpu.index import x\nimport dart_tpu\n"
             "from dart_tpu_torch import cli\nfrom . import dart_tpu\n")
    assert sorted(dart_tpu_imports(probe, "p.py")) == ["p.py:4", "p.py:5"]


def test_index_files_equal_dart_tpus(data_dir, golden_dir, tmp_path, capsys):
    assert cli.main(["index", str(data_dir / "toy.fa"),
                     str(tmp_path / "port")]) == 0
    dart_tpu_build_index(str(data_dir / "toy.fa"), str(tmp_path / "ref"))
    exts = sorted(p.suffix for p in tmp_path.glob("ref.*"))
    assert {".bwt", ".sa", ".pac", ".ann", ".amb"} <= set(exts)
    for ext in exts:
        got = (tmp_path / f"port{ext}").read_bytes()
        assert got == (tmp_path / f"ref{ext}").read_bytes(), ext
        gold = golden_dir / "index" / f"toy{ext}"
        if gold.exists():
            assert got == gold.read_bytes(), ext


GOLDEN = {  # tests/test_parity.py's nine configs, as CLI flags
    "c1_se_exact": ["-f", "se_exact.fa"],
    "c2_se_mm": ["-f", "se_mm.fq", "-mis", "5"],
    "c3_spliced": ["-f", "spliced.fa"],
    "c4_spliced_mm": ["-f", "spliced_mm.fq", "-mis", "5", "-all_sj"],
    "c5_pe": ["-f", "pe_1.fq", "-f2", "pe_2.fq", "-mis", "5"],
    "c6_pe_gz": ["-f", "pe_1.fq.gz", "-f2", "pe_2.fq.gz", "-mis", "5"],
    "c7_pe_inter": ["-f", "pe_inter.fq", "-p", "-mis", "5"],
    "c8_multi": ["-f", "se_exact.fa", "-m"],
    "c9_unique": ["-f", "se_mm.fq", "-unique", "-mis", "5"],
}


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_goldens_through_the_python_pipeline(name, data_dir, golden_dir,
                                             tmp_path, capsys):
    flags = [str(data_dir / f) if f.endswith((".fa", ".fq", ".gz")) else f
             for f in GOLDEN[name]]
    sam, tab = tmp_path / "o.sam", tmp_path / "o.tab"
    assert cli.main(["-i", str(golden_dir / "index" / "toy"), *flags, "-o",
                     str(sam), "-j", str(tab), "-silent", "--device", "cpu",
                     "--no-native"]) == 0
    assert sam.read_bytes() == (golden_dir / f"{name}.sam").read_bytes()
    assert tab.read_bytes() == \
        (golden_dir / f"{name}.junctions.tab").read_bytes()


def test_both_native_libraries_in_one_process(data_dir, golden_dir, tmp_path,
                                              capsys):
    """Each package builds and loads its own native library, under its
    own name; both loaded at once, their pipelines on the same engine
    write the same SAM bytes."""
    port_lib, ref_lib = native_build.load(), dart_tpu.native.build.load()
    assert port_lib is not None and ref_lib is not None
    assert port_lib._name != ref_lib._name
    assert "libdart_torch_native" in port_lib._name
    idx = load_index(str(golden_dir / "index" / "toy"))
    engine = FMIndexTorch(idx, "cpu")
    out = {}
    for who, module in (("port", aligner), ("dart_tpu", dart_tpu.aligner)):
        cfg = DartConfig()
        cfg.read_files_1 = [str(data_dir / "pe_1.fq")]
        cfg.read_files_2 = [str(data_dir / "pe_2.fq")]
        cfg.max_mismatch, cfg.silent = 5, True
        cfg.sj_file = str(tmp_path / f"{who}.tab")
        al = module.DartAligner(idx, cfg, engine=engine)
        assert al.native is not None
        buf = io.StringIO()
        al.run(out_stream=buf)
        out[who] = (buf.getvalue(), (tmp_path / f"{who}.tab").read_bytes())
    assert out["port"] == out["dart_tpu"]
    assert out["port"][0] == (golden_dir / "c5_pe.sam").read_text()
