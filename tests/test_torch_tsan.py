"""The port's native thread pool under ThreadSanitizer: the counterpart
of tests/test_tsan.py for ``dart_tpu_torch``.

``DART_TPU_TSAN=1`` makes ``dart_tpu_torch/native/build.py`` build
``libdart_torch_native_tsan`` with -fsanitize=thread (an artifact of its
own, so the production library is untouched); the CLI then aligns the
toy golden c3's reads at ``-t 4 --device cpu`` with libtsan preloaded.
A data race in the finalize pool (native/pipeline.cpp's -t path)
prints a "WARNING: ThreadSanitizer" report and, through halt_on_error,
fails the run. Skips where libtsan is missing."""

import glob
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _libtsan():
    for pat in ("/usr/lib/gcc/x86_64-linux-gnu/*/libtsan.so",
                "/usr/lib/x86_64-linux-gnu/libtsan.so.*"):
        hits = sorted(glob.glob(pat))
        if hits:
            return hits[0]
    return None


def test_port_thread_pool_race_free(tmp_path):
    libtsan = _libtsan()
    if libtsan is None:
        pytest.skip("libtsan not available")
    env = dict(os.environ)
    env["DART_TPU_TSAN"] = "1"
    env["LD_PRELOAD"] = libtsan
    env["TSAN_OPTIONS"] = "halt_on_error=1 exitcode=66"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["PYTHONMALLOC"] = "malloc"  # pymalloc confuses tsan interceptors
    env["OMP_NUM_THREADS"] = "1"
    out = tmp_path / "out.sam"
    cmd = [sys.executable, "-m", "dart_tpu_torch.cli",
           "-i", os.path.join(HERE, "golden", "index", "toy"),
           "-f", os.path.join(HERE, "data", "spliced.fa"),
           "-t", "4", "--device", "cpu",
           "-o", str(out), "-j", str(tmp_path / "j.tab"), "-silent"]
    p = subprocess.run(cmd, env=env, capture_output=True, timeout=600)
    err = p.stderr.decode(errors="replace")
    assert "WARNING: ThreadSanitizer" not in err, err[-4000:]
    assert p.returncode == 0, err[-4000:]
    # the sanitized native library ran (not the Python pipeline), and
    # its output is the golden's
    lib = os.path.join(REPO, "dart_tpu_torch", "_build")
    assert glob.glob(os.path.join(lib, "libdart_torch_native_tsan*"))
    assert out.read_bytes() == open(
        os.path.join(HERE, "golden", "c3_spliced.sam"), "rb").read()
