"""The port's batched gap DP (dart_tpu_torch.ops.nw_torch / nw_plain) on
the CPU, where it runs the plain PyTorch version of its kernel, held
exactly against dart_tpu: the traceback planes word for word against the
Pallas kernel (``nw_pallas._nw_batch_device`` in interpret mode), and
the gapped strings against ``nw_pallas.nw_align_batch`` and the host
C++ DP ``nw_align`` that production calls."""

import contextlib
import io
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dart_tpu.constants import NT4_TABLE
from dart_tpu.ops import nw_pallas
from dart_tpu.ops.nw_numpy import nw_align
from dart_tpu_torch.aligner import DartAligner, make_engine
from dart_tpu_torch.cli import parse_args
from dart_tpu_torch.index import load_index
from dart_tpu_torch.ops import nw_torch
from dart_tpu_torch.ops.nw_plain import nw_plain
from dart_tpu_torch.ops.nw_torch import (nw_align_batch, nw_planes,
                                         pack_pairs, recording_host_dp)


def fuzz_pairs(seed: int, n: int = 32):
    """n pairs with sides of 0..127 bases (0 and 127 among them), upper
    and lower case, N in about one pair of three, half of them similar
    sides (a shifted copy with a few substitutions)."""
    rng = random.Random(seed)
    pairs = [(b"", b"ACG"), (b"ACG", b""), (b"", b""),
             (b"ACGTN" * 25 + b"AC", b"acgtn" * 25 + b"ac")]
    while len(pairs) < n:
        m = rng.choice([0, 1, 127, rng.randrange(128), rng.randrange(30)])
        k = rng.choice([0, 127, rng.randrange(128), rng.randrange(30)])
        alpha = "ACGTNacgtn" if rng.random() < 0.35 else "ACGTacgt"
        s1 = "".join(rng.choice(alpha) for _ in range(m)).encode()
        if s1 and rng.random() < 0.5:
            s2 = bytearray((s1 * 3)[rng.randrange(3):][:k])
            for _ in range(rng.randrange(6)):
                if s2:
                    s2[rng.randrange(len(s2))] = ord(rng.choice("ACGT"))
            s2 = bytes(s2)
        else:
            s2 = "".join(rng.choice(alpha) for _ in range(k)).encode()
        pairs.append((s1, s2))
    return pairs


def pallas_planes(pairs):
    """_nw_batch_device's planes of the pairs, on inputs built as
    nw_pallas.nw_align_batch builds them (batch padded to TB = 8)."""
    B = len(pairs)
    Bp = -(-B // nw_pallas.TB) * nw_pallas.TB
    L = nw_pallas.LANES
    c1 = np.full((Bp, L), 4, np.int32)
    c2r = np.full((Bp, 3 * L), 5, np.int32)
    mn = np.zeros((Bp, 2), np.int32)
    for k, (s1, s2) in enumerate(pairs):
        c1[k, :len(s1)] = NT4_TABLE[np.frombuffer(s1, np.uint8)]
        b = NT4_TABLE[np.frombuffer(s2, np.uint8)]
        c2r[k, 2 * L - len(s2):2 * L] = b[::-1]
        mn[k] = (len(s1), len(s2))
    out = nw_pallas._nw_batch_device(jnp.asarray(c1), jnp.asarray(c2r),
                                     jnp.asarray(mn), interpret=True)
    return np.asarray(out)[:B]


@pytest.fixture(scope="module")
def golden_pairs(data_dir, golden_dir, tmp_path_factory):
    """Every pair that the port's Python pipeline (its engine on the CPU,
    cfg.native = False) hands its host DP on goldens c4_spliced_mm and
    c5_pe, whose SAM it still writes byte-equal to the golden."""
    out = tmp_path_factory.mktemp("nw")
    toy = load_index(str(golden_dir / "index" / "toy"))
    runs = {"c4_spliced_mm": ["-f", "spliced_mm.fq", "-mis", "5", "-all_sj"],
            "c5_pe": ["-f", "pe_1.fq", "-f2", "pe_2.fq", "-mis", "5"]}
    pairs = []
    for name, flags in runs.items():
        flags = [str(data_dir / f) if f.endswith(".fq") else f for f in flags]
        cfg = parse_args(["-i", str(golden_dir / "index" / "toy"), *flags,
                          "-o", str(out / f"{name}.sam"), "-j",
                          str(out / f"{name}.tab"), "-silent"])
        cfg.native = False
        with recording_host_dp() as rec, \
                contextlib.redirect_stdout(io.StringIO()):
            DartAligner(toy, cfg, engine=make_engine(toy, cfg, "cpu")).run()
        assert (out / f"{name}.sam").read_bytes() == \
            (golden_dir / f"{name}.sam").read_bytes()
        pairs += rec
    return pairs


def test_recorded_pairs(golden_pairs):
    assert len(golden_pairs) == 364
    assert max(max(len(a), len(b)) for a, b in golden_pairs) <= 127


FUZZ_SEED = 20261016


def test_nw_plain_planes_equal_pallas():
    pairs = fuzz_pairs(FUZZ_SEED)
    assert {0, 127} <= {len(s) for p in pairs for s in p}
    c1, c2, mn = (torch.from_numpy(a) for a in pack_pairs(pairs))
    got = nw_plain(c1, c2, mn)
    assert got.dtype == torch.int32 and got.shape == (len(pairs), 32, 128)
    np.testing.assert_array_equal(got.numpy(), pallas_planes(pairs))


@pytest.mark.parametrize("which", ["fuzz", "quirk", "goldens"])
def test_nw_align_batch_equals_pallas_and_host(which, golden_pairs):
    pairs = {"fuzz": lambda: fuzz_pairs(FUZZ_SEED),
             "quirk": lambda: [(b"AACCGG", b"AACGG")],
             "goldens": lambda: golden_pairs}[which]()
    got = nw_align_batch(pairs, "cpu")
    assert got == nw_pallas.nw_align_batch(pairs, interpret=True)
    assert got == [nw_align(s1, s2) for s1, s2 in pairs]
    if which == "quirk":
        assert got == [(b"AACCGG", b"-AACGG")]


def test_nw_align_batch_edges():
    assert nw_align_batch([], "cpu") == []
    assert nw_align_batch([(b"", b"ACG")], "cpu") == [(b"---", b"ACG")]
    for pair in [(b"A" * 128, b"C"), (b"C", b"A" * 128)]:
        with pytest.raises(ValueError):
            nw_align_batch([pair], "cpu")


def test_nw_planes_checks_its_inputs():
    c1, c2, mn = (torch.from_numpy(a)
                  for a in pack_pairs([(b"AC", b"A"), (b"G", b"GT")]))
    n0 = nw_torch.launches["nw"]
    nw_planes(c1, c2, mn)
    assert nw_torch.launches["nw"] == n0  # the CPU runs the plain version
    for bad in (c1.long(), c1[:, :64], c1.t().contiguous().t(),
                torch.cat([c1, c1])):
        with pytest.raises(ValueError):
            nw_planes(bad, c2, mn)
    with pytest.raises(ValueError):
        nw_planes(c1, c2, mn[:, :1].contiguous())
