"""dart_tpu_torch stands alone: in a fresh interpreter where any attempt
to import ``jax``, the JAX package ``dart_tpu``, the root ``bench.py`` or
``tools/make_fixtures.py`` is recorded and refused, the port imports (its gap DP, entry step, device grid and
multi-host modules among the rest), aligns golden configs on one device
(through the native and the pure-Python host pipeline, SAM and BAM) and
one on a ``--mesh data=2,index=2`` grid, builds an index, runs ``eva``,
runs the entry step and a batch of gap DPs, streams a golden's reads
twice through ``dart_tpu_torch.stream`` (which, without a card, refuses
its default ``cuda``), runs ``dart_tpu_torch.bench`` on a config of the
toy index on the CPU (its default ``cuda`` refused too), and no attempt
was made.
The outputs are then held here, where ``dart_tpu`` may be imported,
against the goldens and against ``dart_tpu``'s own."""

import contextlib
import io
import json
import pathlib
import subprocess
import sys
import textwrap

from dart_tpu import cli as dart_tpu_cli
from dart_tpu.aligner import DartAligner
from dart_tpu.config import DartConfig

SCRIPT = textwrap.dedent("""
    import contextlib, importlib.abc, io, json, sys

    attempts = []

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "dart_tpu", "bench",
                                      "make_fixtures"):
                attempts.append(name)
                raise ModuleNotFoundError(f"refused here: {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    import dart_tpu_torch, dart_tpu_torch.aligner, dart_tpu_torch.cli
    import dart_tpu_torch.entry, dart_tpu_torch.ops.nw_torch
    import dart_tpu_torch.parallel.mesh, dart_tpu_torch.parallel.distributed
    import dart_tpu_torch.evaluation, dart_tpu_torch.io.bam
    import dart_tpu_torch.stream, dart_tpu_torch.bench
    import os
    import torch
    from dart_tpu_torch.cli import main
    from dart_tpu_torch.entry import entry
    from dart_tpu_torch.ops.nw_torch import nw_align_batch

    torch.set_num_threads(1)

    gold, data, out = sys.argv[1:4]
    toy = gold + "/index/toy"
    rc = main(["-i", toy, "-f", data + "/spliced_mm.fq", "-mis", "5",
               "-all_sj", "-o", out + "/o.sam", "-j", out + "/o.tab",
               "-silent", "--device", "cpu"])
    rc_py = main(["-i", toy, "-f", data + "/se_mm.fq", "-mis", "5",
                  "-o", out + "/p.sam", "-j", out + "/p.tab", "-silent",
                  "--device", "cpu", "--no-native"])
    rc_bam = main(["-i", toy, "-f", data + "/spliced.fa", "-bo",
                   out + "/b.bam", "-j", out + "/b.tab", "-silent",
                   "--device", "cpu"])
    rc_mesh = main(["-i", toy, "-f", data + "/spliced.fa",
                    "-o", out + "/m.sam", "-j", out + "/m.tab", "-silent",
                    "--device", "cpu", "--mesh", "data=2,index=2"])
    rc_index = main(["index", data + "/toy.fa", out + "/idx"])
    stream_args = ["-i", toy, "-f", data + "/spliced.fa", "-o",
                   out + "/st.sam", "-j", out + "/st.tab", "-silent",
                   "--files", "2"]
    with contextlib.redirect_stdout(io.StringIO()):
        rc_stream = dart_tpu_torch.stream.main([*stream_args, "--device",
                                                "cpu"])
    bench = dart_tpu_torch.bench
    bench.CONFIGS["toy"] = {
        "prefix": toy, "reads": (bench.head_fastq(data + "/se_mm.fq", 40, out),
                                 None),
        "n_reads": 40, "paired": False, "bam": False, "passes": 3,
        "flags": ["-mis", "5"]}
    os.environ["DART_TPU_BENCH_DIR"] = out + "/bench"
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        rc_bench = bench.main(["--configs", "toy", "--device", "cpu"])
    no_card_raises = True
    if not torch.cuda.is_available():
        for fn, args in ((dart_tpu_torch.stream.main, stream_args),
                         (bench.main, ["--configs", "toy"])):
            try:
                fn(args)
                no_card_raises = False
            except RuntimeError:
                pass
    eva = io.StringIO()
    with contextlib.redirect_stdout(eva):
        rc_eva = main(["eva", gold + "/c3_spliced.sam", data + "/toy.fa"])
    step, args = entry("cpu")
    got = step(*args)
    same = all(bool((g == w).all()) for g, w in zip(got, step.plain(*args)))
    aligned = nw_align_batch([(b"AACCGG", b"AACGG"), (b"", b"ACG")], "cpu")
    root = os.path.realpath(os.getcwd())

    def of_root_tools(mod):  # the root bench.py or a module of tools/
        f = os.path.realpath(getattr(mod, "__file__", None) or "/")
        return (f == os.path.join(root, "bench.py")
                or f.startswith(os.path.join(root, "tools") + os.sep))

    loaded = sorted(m for m, mod in list(sys.modules.items())
                    if m.split(".")[0] in ("jax", "jaxlib", "dart_tpu")
                    or of_root_tools(mod))
    print(json.dumps({"rc": [rc, rc_py, rc_bam, rc_mesh, rc_index, rc_eva,
                             rc_stream, rc_bench],
                      "no_card_raises": no_card_raises,
                      "attempts": attempts, "loaded": loaded,
                      "eva": eva.getvalue(), "entry_same": same,
                      "entry_accepted": int((got[2] >= 0).sum()),
                      "aligned": [[a.decode(), b.decode()]
                                  for a, b in aligned]}))
""")


def test_port_never_imports_jax(golden_dir, data_dir, tmp_path):
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(golden_dir), str(data_dir),
         str(tmp_path)], capture_output=True, text=True, timeout=300,
        cwd=pathlib.Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    eva = got.pop("eva")
    assert got.pop("entry_accepted") > 0
    assert got == {"rc": [0] * 8, "no_card_raises": True,
                   "attempts": [], "loaded": [],
                   "entry_same": True,
                   "aligned": [["AACCGG", "-AACGG"], ["---", "ACG"]]}

    def same(a, b):
        assert (tmp_path / a).read_bytes() == (golden_dir / b).read_bytes()

    for out, gold in (("o", "c4_spliced_mm"), ("p", "c2_se_mm"),
                      ("m", "c3_spliced")):
        same(f"{out}.sam", f"{gold}.sam")
        same(f"{out}.tab", f"{gold}.junctions.tab")
    same("b.tab", "c3_spliced.junctions.tab")
    gold = (golden_dir / "c2_se_mm.sam").read_text().splitlines()
    assert (tmp_path / "bench" / "toy" / "tpu.sam").read_text().splitlines() \
        == [ln for ln in gold if ln[0] == "@"] + \
        [ln for ln in gold if ln[0] != "@"][:40]
    for ext in (".bwt", ".sa", ".pac", ".ann", ".amb"):
        same(f"idx{ext}", f"index/toy{ext}")
    from dart_tpu_torch.stream import check_stream

    check_stream((str(tmp_path / "st.sam"), str(tmp_path / "st.tab")),
                 (str(golden_dir / "c3_spliced.sam"),
                  str(golden_dir / "c3_spliced.junctions.tab")), 2)

    # the BAM bytes and the eva report equal dart_tpu's own
    cfg = DartConfig()
    cfg.read_files_1 = [str(data_dir / "spliced.fa")]
    cfg.output_format, cfg.silent, cfg.engine = 1, True, "numpy"
    cfg.output_file = str(tmp_path / "want.bam")
    cfg.sj_file = str(tmp_path / "want.tab")
    from dart_tpu.index import load_index

    DartAligner(load_index(str(golden_dir / "index" / "toy")), cfg).run()
    assert (tmp_path / "b.bam").read_bytes() == \
        (tmp_path / "want.bam").read_bytes()
    want = io.StringIO()
    with contextlib.redirect_stdout(want):
        dart_tpu_cli.main(["eva", str(golden_dir / "c3_spliced.sam"),
                           str(data_dir / "toy.fa")])
    assert eva == want.getvalue() and eva.strip()
