"""Alignment on the port's engine.

The orchestration is ``dart_tpu.aligner.DartAligner`` itself, which
takes an injected engine; this module only chooses that engine.
"""

from __future__ import annotations

import torch

from dart_tpu.aligner import DartAligner
from dart_tpu.config import DartConfig

from .ops.fm_torch import FMIndexTorch


def default_lut_k(device) -> int:
    """The K-mer table's K on ``device``, as ``dart_tpu`` chooses it: 11
    on an accelerator (a 67 MB narrow table), none on the CPU, where
    building the table costs more than it saves."""
    return 11 if torch.device(device).type == "cuda" else 0


def make_engine(idx, cfg: DartConfig, device="cuda", lut_k: int | None = None,
                wide: bool | None = None) -> FMIndexTorch:
    """The FM-index engine for ``idx`` on ``device``: the wide (int64)
    one when the fwd+rc text has 2^31 positions or more, or when
    ``wide`` forces it; walks start from a K-mer table of
    ``lut_k`` (default ``default_lut_k(device)``). Raises for what the
    port does not run yet, and for a CUDA device without a card."""
    if cfg.engine != "auto":
        raise ValueError(f"--engine {cfg.engine} is not an engine of the "
                         "port; choose the device with --device")
    if cfg.mesh:
        raise NotImplementedError("--mesh is not ported yet")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the "
                           "plain PyTorch kernels on the CPU")
    if lut_k is None:
        lut_k = default_lut_k(device)
    return FMIndexTorch(idx, device, max_dup_num=cfg.max_dup_num,
                        lut_k=lut_k, wide=wide)


def run(idx, cfg: DartConfig, device="cuda", lut_k: int | None = None,
        wide: bool | None = None) -> DartAligner:
    """Align ``cfg``'s reads against ``idx`` on ``device`` (``lut_k`` and
    ``wide`` as ``make_engine`` takes them); returns the finished
    aligner (its ``engine`` holds the kernels' launch counts)."""
    if cfg.profile_dir:
        raise NotImplementedError("--profile is not ported yet")
    if cfg.dist_nprocs > 1:
        raise NotImplementedError("multi-host runs are not ported yet")
    aligner = DartAligner(idx, cfg,
                          engine=make_engine(idx, cfg, device, lut_k, wide))
    aligner.run()
    return aligner
