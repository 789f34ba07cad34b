"""dart_tpu_torch never imports JAX: in a fresh interpreter where any
attempt to import jax is recorded and refused, the port imports (its
gap DP, entry step, device grid and multi-host modules among the
rest), aligns a golden config on one device and another on a
``--mesh data=2,index=2`` grid, and a batch of gap DPs, and no attempt
was made."""

import json
import pathlib
import subprocess
import sys
import textwrap

SCRIPT = textwrap.dedent("""
    import importlib.abc, json, sys

    attempts = []

    class NoJax(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name == "jax" or name.startswith(("jax.", "jaxlib")):
                attempts.append(name)
                raise ModuleNotFoundError(f"jax is refused here: {name}")
            return None

    sys.meta_path.insert(0, NoJax())
    import dart_tpu_torch, dart_tpu_torch.aligner, dart_tpu_torch.cli
    import dart_tpu_torch.entry, dart_tpu_torch.ops.nw_torch
    import dart_tpu_torch.parallel.mesh, dart_tpu_torch.parallel.distributed
    import torch
    from dart_tpu_torch.cli import main
    from dart_tpu_torch.ops.nw_torch import nw_align_batch

    torch.set_num_threads(1)

    gold, data, out = sys.argv[1:4]
    rc = main(["-i", gold + "/index/toy", "-f", data + "/spliced_mm.fq",
               "-mis", "5", "-all_sj", "-o", out + "/o.sam",
               "-j", out + "/o.tab", "-silent", "--device", "cpu"])
    rc_mesh = main(["-i", gold + "/index/toy", "-f", data + "/spliced.fa",
                    "-o", out + "/m.sam", "-j", out + "/m.tab", "-silent",
                    "--device", "cpu", "--mesh", "data=2,index=2"])
    aligned = nw_align_batch([(b"AACCGG", b"AACGG"), (b"", b"ACG")], "cpu")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                    ("jax", "jaxlib"))
    print(json.dumps({"rc": rc, "rc_mesh": rc_mesh, "attempts": attempts,
                      "loaded": loaded,
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
    assert got == {"rc": 0, "rc_mesh": 0, "attempts": [], "loaded": [],
                   "aligned": [["AACCGG", "-AACGG"], ["---", "ACG"]]}
    assert (tmp_path / "o.sam").read_bytes() == \
        (golden_dir / "c4_spliced_mm.sam").read_bytes()
    assert (tmp_path / "o.tab").read_bytes() == \
        (golden_dir / "c4_spliced_mm.junctions.tab").read_bytes()
    assert (tmp_path / "m.sam").read_bytes() == \
        (golden_dir / "c3_spliced.sam").read_bytes()
    assert (tmp_path / "m.tab").read_bytes() == \
        (golden_dir / "c3_spliced.junctions.tab").read_bytes()
