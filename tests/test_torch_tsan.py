"""The port's native thread pool under ThreadSanitizer: the counterpart
of tests/test_tsan.py for ``dart_tpu_torch``.

``DART_TPU_TSAN=1`` makes ``dart_tpu_torch/native/build.py`` build
``libdart_torch_native_tsan`` with -fsanitize=thread (an artifact of its
own, so the production library is untouched); the CLI then aligns the
toy golden c3's reads at ``-t 4 --device cpu`` with libtsan preloaded.
A data race in the finalize pool (native/pipeline.cpp's -t path)
prints a "WARNING: ThreadSanitizer" report and, through halt_on_error,
fails the run. The BAM writer's threads (native/bamenc.cpp's encoder
ranges and native/bgzf.cpp's deflate) run the same way on a stream of
many blocks. Skips where libtsan is missing."""

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


def _tsan_env():
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
    return env


def test_port_thread_pool_race_free(tmp_path):
    env = _tsan_env()
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


BAM_SCRIPT = """
import sys
from dart_tpu_torch.io import bam
assert bam._native().deflate is not None
lines = open(sys.argv[2], "rb").read().splitlines(keepends=True)
header = [x.decode().rstrip() for x in lines if x.startswith(b"@")]
body = [x for x in lines if not x.startswith(b"@")] * 12
w = bam.BamWriter(sys.argv[1], threads=4)
w.write_header(header)
n = len(body) // 3 + 1
for i in range(0, len(body), n):
    w.write_sam_bytes(b"".join(body[i:i + n]))
w.close()
print(w.bgzf.native_bytes)
"""


def test_bam_writer_threads_race_free(tmp_path):
    """BamWriter at -t 4 on some twenty blocks: its encoder's ranges and
    its deflate's blocks on their threads, with no race reported."""
    env = _tsan_env()
    p = subprocess.run([sys.executable, "-c", BAM_SCRIPT,
                        str(tmp_path / "out.bam"),
                        os.path.join(HERE, "golden", "c5_pe.sam")],
                       env=env, capture_output=True, timeout=600)
    err = p.stderr.decode(errors="replace")
    assert "WARNING: ThreadSanitizer" not in err, err[-4000:]
    assert p.returncode == 0, err[-4000:]
    assert int(p.stdout.split()[-1]) >= 10 * 65280
