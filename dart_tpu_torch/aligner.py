"""Alignment on the port's engine.

The orchestration is ``dart_tpu.aligner.DartAligner`` itself, which
takes an injected engine; this module only chooses that engine.
"""

from __future__ import annotations

import torch

from dart_tpu.aligner import DartAligner
from dart_tpu.config import DartConfig

from .ops.fm_torch import FMIndexTorch


def make_engine(idx, cfg: DartConfig, device="cuda") -> FMIndexTorch:
    """The FM-index engine for ``idx`` on ``device``. Raises for what the
    port does not run yet, and for a CUDA device without a card."""
    if cfg.engine != "auto":
        raise ValueError(f"--engine {cfg.engine} is not an engine of the "
                         "port; choose the device with --device")
    if idx.seq_len >= 2**31:
        raise NotImplementedError("genomes with fwd+rc text >= 2^31 need "
                                  "the wide engine, not ported yet")
    if cfg.mesh:
        raise NotImplementedError("--mesh is not ported yet")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the "
                           "plain PyTorch kernels on the CPU")
    return FMIndexTorch(idx, device, max_dup_num=cfg.max_dup_num)


def run(idx, cfg: DartConfig, device="cuda") -> DartAligner:
    """Align ``cfg``'s reads against ``idx`` on ``device``; returns the
    finished aligner (its ``engine`` holds the kernels' launch counts)."""
    if cfg.profile_dir:
        raise NotImplementedError("--profile is not ported yet")
    if cfg.dist_nprocs > 1:
        raise NotImplementedError("multi-host runs are not ported yet")
    aligner = DartAligner(idx, cfg, engine=make_engine(idx, cfg, device))
    aligner.run()
    return aligner
