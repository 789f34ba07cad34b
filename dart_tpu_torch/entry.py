"""The port's counterpart of ``__graft_entry__.entry()``: one forward
step of the seeding pipeline on the toy index.

``entry(device)`` returns ``(forward_step, example_args)``. The step
runs the MEM walks (K8) over a batch of (read, start) tasks, accepts a
walk that occurs at most 100 times and is at least 16 bases long,
locates the accepted walks' first occurrences (K2), and returns
``(lens, x2, locs)``, each (W,) int32, with ``locs`` -1 where a walk
was not accepted. The arguments are the merged table and L2 of
``ops.layout`` on ``device`` and the task batch (chars (W, L) uint8,
valid (W, L) bool), made with numpy from ``__graft_entry__``'s seed.

``dryrun_multichip`` is not ported yet: it waits for the multi-GPU
engine (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from dart_tpu.index import load_index

from .ops.fm_torch import FMIndexTorch

TOY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests", "golden", "index", "toy")
MAX_FREQ = 100     # a walk is accepted with at most this many occurrences
MIN_LEN = 16       # ... and at least this many bases


def example_batch(idx, n_tasks: int = 256, L: int = 96):
    """``n_tasks`` tasks of L genome bases from random positions
    (``__graft_entry__._example_batch``, same seed): (chars, valid)."""
    rng = np.random.default_rng(1)
    chars = np.full((n_tasks, L), 4, dtype=np.uint8)
    valid = np.zeros((n_tasks, L), dtype=bool)
    for t in range(n_tasks):
        pos = int(rng.integers(0, idx.seq_len - L - 1))
        chars[t] = idx.ref_codes[pos:pos + L]
        valid[t] = True
    return chars, valid


class ForwardStep:
    """The forward step on one engine (``entry``'s): call it with the
    engine's own table and L2 and a task batch on its device;
    ``plain`` runs the same step through the plain PyTorch versions.
    The engine's launch counts record the step's kernels."""

    def __init__(self, engine: FMIndexTorch):
        self.engine = engine

    def __call__(self, table, L2, chars, valid):
        return self._run(table, L2, chars, valid, plain=False)

    def plain(self, table, L2, chars, valid):
        return self._run(table, L2, chars, valid, plain=True)

    def _run(self, table, L2, chars, valid, plain: bool):
        eng = self.engine
        if table is not eng.table or L2 is not eng.L2:
            raise ValueError("the step runs on its engine's own table and "
                             "L2 (entry()'s example_args)")
        walk = eng.plain_mem_walks if plain else eng.mem_walk_rows
        locate = eng.plain_locate if plain else eng.locate_rows
        lens, x0, x2 = walk(chars, valid)
        accepted = (x2 <= MAX_FREQ) & (lens >= MIN_LEN)
        locs = locate(torch.where(accepted, x0, 0))
        return lens, x2, torch.where(accepted, locs, -1)


def entry(device="cuda"):
    """(forward_step, example_args) on the toy index, with the tables
    and the task batch on ``device``."""
    idx = load_index(TOY)
    eng = FMIndexTorch(idx, device)
    chars, valid = example_batch(idx)
    args = (eng.table, eng.L2, torch.from_numpy(chars).to(eng.device),
            torch.from_numpy(valid).to(eng.device))
    return ForwardStep(eng), args
