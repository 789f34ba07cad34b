"""The CUDA kernels of dart_tpu_torch on the card, held exactly against
their plain PyTorch versions on the same device tensors, and a golden
config aligned on the card. Marked ``cuda``: they skip without a CUDA
device. On a machine with one: ``pytest -m cuda tests/test_torch_cuda.py``.
"""

import io

import numpy as np
import pytest
import torch

from dart_tpu.aligner import DartAligner
from dart_tpu.config import DartConfig
from dart_tpu_torch.ops.fm_torch import FMIndexTorch, pack_codes

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def gpu_engine(toy_index):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return FMIndexTorch(toy_index, device="cuda")


def test_locate_kernel_equals_plain(gpu_engine, toy_index):
    rows = torch.arange(toy_index.seq_len, dtype=torch.int32, device="cuda")
    got = gpu_engine.locate_rows(rows)
    torch.testing.assert_close(got, gpu_engine.plain_locate(rows),
                               rtol=0, atol=0)
    assert gpu_engine.n_locate_launches == 1


def test_seed_scan_kernel_equals_plain(gpu_engine, toy_index):
    rng = np.random.default_rng(4)
    R, L = 512, 100
    starts = rng.integers(0, toy_index.seq_len - L, R)
    codes = np.stack([toy_index.ref_codes[p:p + L] for p in starts])
    mut = rng.random((R, L)) < 0.03
    codes = np.where(mut, rng.integers(0, 5, (R, L)), codes).astype(np.uint8)
    rlens = np.full(R, L, dtype=np.int32)
    rlens[::9] = rng.integers(0, 14, len(rlens[::9]))
    buf, nmask, Lp = pack_codes(codes, rlens)
    words = Lp // 16
    S = gpu_engine.seed_slots(Lp, L)
    t = torch.from_numpy(np.concatenate(
        [buf[:, :words], nmask, buf[:, words:]], axis=1).view(np.int32)).cuda()
    got = gpu_engine.seed_scan(t, words, S)
    torch.testing.assert_close(got, gpu_engine.plain_seed_scan(t, words, S),
                               rtol=0, atol=0)
    assert gpu_engine.n_seed_launches == 1


def test_golden_on_card(gpu_engine, toy_index, data_dir, golden_dir,
                        tmp_path, capsys):
    cfg = DartConfig()
    cfg.read_files_1 = [str(data_dir / "spliced_mm.fq")]
    cfg.max_mismatch = 5
    cfg.find_all_junction = True
    cfg.sj_file = str(tmp_path / "o.tab")
    cfg.output_file = str(tmp_path / "o.sam")
    cfg.silent = True
    engine = FMIndexTorch(toy_index, device="cuda")
    out = io.StringIO()
    DartAligner(toy_index, cfg, engine=engine).run(out_stream=out)
    assert out.getvalue() == (golden_dir / "c4_spliced_mm.sam").read_text()
    assert (tmp_path / "o.tab").read_text() == \
        (golden_dir / "c4_spliced_mm.junctions.tab").read_text()
    # every seed of this set is found by locate-and-compare inside the
    # scan, so no SA rows are left for the locate kernel
    assert engine.n_seed_launches == 1 and engine.n_locate_launches == 0
