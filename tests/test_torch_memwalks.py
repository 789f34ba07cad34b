"""The port's MEM walks (FMIndexTorch.mem_walks, fm_plain.mem_walks_plain)
on the CPU, held exactly against dart_tpu's JAX engine
(FMIndexJax.mem_walks, which runs fm_jax._mem_walks_kernel) and NumPy
engine; the seeding path that runs them
(seeding.seed_reads_from_all_walks) against the port's own seed scan;
and the port's entry() step against __graft_entry__.entry()'s."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from dart_tpu.ops.fm_jax import FMIndexJax
from dart_tpu.ops.fm_numpy import FMIndexNumpy
from dart_tpu.pipeline.seeding import (_expand_occurrences,
                                       seed_reads_from_all_walks)
from dart_tpu_torch.entry import entry
from dart_tpu_torch.ops.fm_torch import FMIndexTorch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port(toy_index):
    return FMIndexTorch(toy_index, device="cpu")


def walk_tasks(idx, seed: int, W: int = 1500, L: int = 64):
    """Tasks cut from the genome with substitutions and N bases (3%),
    invalid tails on a third of them, and tasks that never start (first
    base N, or invalid)."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, idx.seq_len - L, W)
    chars = np.stack([idx.ref_codes[p:p + L] for p in starts])
    mut = rng.random((W, L)) < 0.03
    chars = np.where(mut, rng.integers(0, 5, (W, L)), chars).astype(np.uint8)
    cut = np.where(rng.random(W) < 0.33, rng.integers(0, L, W), L)
    valid = np.arange(L)[None, :] < cut[:, None]
    chars[::17, 0] = 4
    valid[::13, 0] = False
    return chars, valid


def test_mem_walks_equal_jax_and_numpy(port, toy_index):
    chars, valid = walk_tasks(toy_index, 11)
    got = port.mem_walks(chars, valid)
    jx = FMIndexJax(toy_index, lut_k=0).mem_walks(chars, valid)
    npy = FMIndexNumpy(toy_index).mem_walk_batch(chars, valid)
    for name, g, j, n in zip(("lens", "x0", "x2"), got, jx, npy):
        assert g.dtype == np.int64 and g.shape == (len(chars),)
        np.testing.assert_array_equal(g, j, err_msg=name)
        np.testing.assert_array_equal(g, n, err_msg=name)
    lens = got[0]
    assert (lens == 0).sum() >= len(chars) // 13  # tasks that never start
    assert (lens == chars.shape[1]).any() and ((lens > 1) & (lens < 40)).any()


def test_mem_walk_rows_is_the_plain_version(port, toy_index):
    chars, valid = walk_tasks(toy_index, 12, W=300)
    c, v = torch.from_numpy(chars), torch.from_numpy(valid)
    got = port.mem_walk_rows(c, v)
    for g, w in zip(got, port.plain_mem_walks(c, v)):
        assert g.dtype == torch.int32
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert port.launches["mem_walks"] == 0  # no kernel on the CPU
    with pytest.raises(ValueError):
        port.mem_walk_rows(c.long(), v)
    with pytest.raises(ValueError):
        port.mem_walk_rows(c, v[:, :10].contiguous())


def test_wide_engine_has_no_mem_walks(toy_index):
    wide = FMIndexTorch(toy_index, "cpu", wide=True)
    chars, valid = walk_tasks(toy_index, 13, W=8)
    with pytest.raises(NotImplementedError):
        wide.mem_walks(chars, valid)
    with pytest.raises(NotImplementedError):
        wide.mem_walk_rows(torch.from_numpy(chars), torch.from_numpy(valid))
    assert "mem_walks" not in wide.launches


def expanded(engine, seeds, n_reads):
    """Per read, the sorted (gpos, rpos, len) occurrences of the seed
    tables, and the occurrence offsets."""
    n, rpos, slen, k0, freq = seeds
    occ_off, o_rpos, o_len, o_gpos = _expand_occurrences(
        engine, n, rpos, slen, k0, freq, n_reads)
    per_read = [sorted(zip(o_gpos[a:b].tolist(), o_rpos[a:b].tolist(),
                           o_len[a:b].tolist()))
                for a, b in zip(occ_off[:-1], occ_off[1:])]
    return occ_off, per_read


def test_seeding_from_walks_equals_seed_scan(port, toy_index):
    rng = np.random.default_rng(14)
    R, L = 48, 100
    starts = rng.integers(0, toy_index.seq_len - L, R)
    codes = np.stack([toy_index.ref_codes[p:p + L] for p in starts])
    mut = rng.random((R, L)) < 0.02
    codes = np.where(mut, rng.integers(0, 5, (R, L)), codes).astype(np.uint8)
    rlens = np.full(R, L, np.int32)
    rlens[::7] = rng.integers(10, L, len(rlens[::7]))
    walks = seed_reads_from_all_walks(port, codes, rlens, port.max_dup_num)
    scan = port.seed_reads(codes, rlens)
    got_off, got = expanded(port, walks, R)
    want_off, want = expanded(port, scan, R)
    np.testing.assert_array_equal(got_off, want_off)
    assert got == want
    assert got_off[-1] > R  # every read seeds; repeats add occurrences


def test_entry_step_equals_graft_entry():
    fn, args = __graft_entry__.entry()
    want = [np.asarray(x) for x in jax.jit(fn)(*args)]
    step, targs = entry("cpu")
    got = step(*targs)
    for name, g, w in zip(("lens", "x2", "locs"), got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    for g, p in zip(got, step.plain(*targs)):
        torch.testing.assert_close(g, p, rtol=0, atol=0)
    with pytest.raises(ValueError):
        step(targs[0].clone(), *targs[1:])
