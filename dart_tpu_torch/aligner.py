"""Alignment on the port's engine.

The orchestration is ``dart_tpu.aligner.DartAligner`` itself, which
takes an injected engine; this module chooses that engine (one device,
or a ``--mesh`` grid of them) and wraps the run in ``torch.profiler``
for ``--profile``.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from dart_tpu.aligner import DartAligner
from dart_tpu.config import DartConfig

from .ops.fm_torch import FMIndexTorch
from .parallel.mesh import ShardedFMIndexTorch, make_mesh, parse_mesh


def default_lut_k(device) -> int:
    """The K-mer table's K on ``device``, as ``dart_tpu`` chooses it: 11
    on an accelerator (a 67 MB narrow table), none on the CPU, where
    building the table costs more than it saves."""
    return 11 if torch.device(device).type == "cuda" else 0


def make_engine(idx, cfg: DartConfig, device="cuda", lut_k: int | None = None,
                wide: bool | None = None):
    """The FM-index engine for ``idx`` on ``device``: the wide (int64)
    one when the fwd+rc text has 2^31 positions or more, or when
    ``wide`` forces it; walks start from a K-mer table of
    ``lut_k`` (default ``default_lut_k(device)``). With ``cfg.mesh``
    naming ``data`` or ``index`` above 1, a ``ShardedFMIndexTorch`` over
    ``make_mesh(data * index, index, device)``, as ``dart_tpu``'s
    ``make_engine`` builds its mesh. Raises for a CUDA device without a
    card."""
    if cfg.engine != "auto":
        raise ValueError(f"--engine {cfg.engine} is not an engine of the "
                         "port; choose the device with --device")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the "
                           "plain PyTorch kernels on the CPU")
    if lut_k is None:
        lut_k = default_lut_k(device)
    data_n, index_n = parse_mesh(cfg.mesh)
    if data_n > 1 or index_n > 1:
        return ShardedFMIndexTorch(
            idx, make_mesh(data_n * index_n, index_n, device),
            max_dup_num=cfg.max_dup_num, lut_k=lut_k, wide=wide)
    return FMIndexTorch(idx, device, max_dup_num=cfg.max_dup_num,
                        lut_k=lut_k, wide=wide)


def profiled(trace_dir: str, device):
    """``torch.profiler`` over the block (the CPU, and the card on
    ``cuda``), its trace written into ``trace_dir`` as
    ``tensorboard_trace_handler`` names it when the block ends: the
    counterpart of ``jax.profiler.trace(trace_dir)``."""
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts,
                   on_trace_ready=tensorboard_trace_handler(trace_dir))


def run(idx, cfg: DartConfig, device="cuda", lut_k: int | None = None,
        wide: bool | None = None) -> DartAligner:
    """Align ``cfg``'s reads against ``idx`` on ``device`` (``lut_k`` and
    ``wide`` as ``make_engine`` takes them), under ``torch.profiler``
    when ``cfg.profile_dir`` is set; returns the finished aligner (its
    ``engine`` holds the kernels' launch counts)."""
    engine = make_engine(idx, cfg, device, lut_k, wide)
    # DartAligner.run would open a jax.profiler trace for profile_dir
    aligner = DartAligner(idx, dataclasses.replace(cfg, profile_dir=""),
                          engine=engine)
    with (profiled(cfg.profile_dir, device) if cfg.profile_dir
          else contextlib.nullcontext()):
        aligner.run()
    return aligner
