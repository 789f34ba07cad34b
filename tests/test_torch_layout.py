"""The port's FM tables (dart_tpu_torch.ops.layout) are byte-equal to
the JAX engine's merged table, so both engines gather the same rows."""

import numpy as np
import pytest
import torch

from dart_tpu.ops.fm_jax import build_device_layout, build_merged_table
from dart_tpu_torch.ops import layout


@pytest.fixture(scope="module")
def built_index(tmp_path_factory, data_dir):
    """The toy genome indexed by dart_tpu's builder, which adds dense
    SA samples (.sad) that the golden BWA-format index lacks."""
    from dart_tpu.index import build_index, load_index

    prefix = str(tmp_path_factory.mktemp("built") / "toy")
    build_index(str(data_dir / "toy.fa"), prefix)
    return load_index(prefix)


def _jax_tables(idx):
    samples = (idx.sad_samples if idx.sad_intv
               else idx.sa_samples).astype(np.int32)
    return build_merged_table(idx, build_device_layout(idx), samples)


@pytest.mark.parametrize("which", ["golden", "built"])
def test_tables_byte_equal_to_jax_layout(which, toy_index, built_index):
    idx = toy_index if which == "golden" else built_index
    assert bool(idx.sad_intv) == (which == "built")
    tabs = layout.tables_from_index(idx)
    merged, ref_off, sad_off = _jax_tables(idx)
    assert tabs["table"].dtype == merged.dtype == np.uint32
    assert tabs["table"].tobytes() == merged.tobytes()
    assert (tabs["ref_off"], tabs["sad_off"]) == (ref_off, sad_off)
    assert tabs["sa_intv"] == (idx.sad_intv or idx.sa_intv)
    assert tabs["primary"] == idx.primary and tabs["seq_len"] == idx.seq_len
    np.testing.assert_array_equal(tabs["L2"], idx.L2.astype(np.int32))


def test_occ_rows_count_the_bwt(toy_index):
    """Each Occ row holds the base counts of the BWT before its block
    and the block's 64 bases, 16 per word, first base in the top bits."""
    blocks = layout.build_device_layout(toy_index)
    bwt = toy_index.bwt
    rng = np.random.default_rng(3)
    for b in rng.integers(0, blocks.shape[0] - 1, 20):
        start = int(b) * 64
        for c in range(4):
            assert int(blocks[b, c]) == int((bwt[:start] == c).sum())
        words = blocks[b, 4:].astype(np.uint64)
        got = [(int(words[i // 16]) >> (30 - 2 * (i % 16))) & 3
               for i in range(64)]
        assert got == bwt[start:start + 64].tolist()


def test_to_device_keeps_bits(toy_index):
    tabs = layout.tables_from_index(toy_index)
    dev = layout.to_device(tabs, "cpu")
    assert dev["table"].dtype == torch.int32
    assert dev["table"].numpy().view(np.uint32).tobytes() == \
        tabs["table"].tobytes()
    assert dev["L2"].tolist() == tabs["L2"].tolist()
    assert dev["ref_off"] == tabs["ref_off"]


@pytest.mark.parametrize("packer", ["native", "numpy"])
@pytest.mark.parametrize("which", ["golden", "built"])
def test_wide_table_byte_equal_to_jax_layout(which, packer, toy_index,
                                             built_index, monkeypatch):
    """The wide table, from the native packers and from their NumPy
    twins, is byte-equal to fm_jax_wide.build_merged_table_wide."""
    from dart_tpu.ops.fm_jax_wide import build_merged_table_wide

    idx = toy_index if which == "golden" else built_index
    if packer == "numpy":
        monkeypatch.setattr(layout, "_native", lambda: None)
    else:
        assert layout._native() is not None
    tabs = layout.tables_from_index(idx, wide=True)
    merged, ref_off, sad_off = build_merged_table_wide(idx)
    assert tabs["table"].dtype == np.uint32 and tabs["table"].shape[1] == 16
    assert tabs["table"].tobytes() == merged.tobytes()
    assert (tabs["ref_off"], tabs["sad_off"]) == (ref_off, sad_off)
    assert tabs["wide"] and tabs["L2"].dtype == np.int64
    np.testing.assert_array_equal(tabs["L2"], idx.L2)


def test_wide_occ_rows_count_the_bwt(toy_index):
    """Each wide Occ row holds the 64-bit base counts before its block
    as (lo, hi) halves and the block's 128 bases, 16 per word."""
    blocks = layout.build_device_layout_wide(toy_index)
    bwt = toy_index.bwt
    rng = np.random.default_rng(5)
    for b in rng.integers(0, blocks.shape[0] - 1, 20):
        start = int(b) * 128
        for c in range(4):
            assert int(blocks[b, c]) | (int(blocks[b, 4 + c]) << 32) == \
                int((bwt[:start] == c).sum())
        words = blocks[b, 8:].astype(np.uint64)
        got = [(int(words[i // 16]) >> (30 - 2 * (i % 16))) & 3
               for i in range(128)]
        assert got == bwt[start:start + 128].tolist()
