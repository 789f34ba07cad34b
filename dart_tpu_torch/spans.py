"""Spans of the stream loop: named stretches of the host thread that feed
``DartAligner.stats`` and, while ``torch.profiler`` records, its trace.

A span has a stage name (``STAGES``), the ordinal ``k`` of the chunk it
belongs to (its parent's where not given), a start and an end; its
parent is the span open around it on the same thread. Each stage
belongs to one layer and feeds the ``stats`` keys the table gives it.
Time runs on ``time.perf_counter_ns`` (CLOCK_MONOTONIC, the clock the
native library's ``steady_clock`` reads) and is charged, between one
open or close and the next, to the innermost open span's keys and to
the keys of the spans around it of the same layer, up to the first span
of another layer or of none. So ``dart.input.open`` counts inside
``input_parse_s``, while the prefetch inside a chunk's wait (a span of
no layer) counts under input and seeding and never under the wait's
``device_only_wait_s``.

While the profiler records, each span is also a
``torch.profiler.record_function`` range named ``<stage>#<k>``, on the
profiler's clock beside the card's kernels and copies. With no profiler
recording none is entered: a span then costs two clock reads and an add
a key. Spans are kept nowhere else. A span on another thread than the
profiler's enters its range too, which a profiler of all threads
records.

A ``Spans`` recorder keeps one stack of open spans, so it serves one
thread: the aligner's main thread has one, and its finalize worker
another, both adding to the aligner's ``stats`` under keys of their
own. ``active`` makes a recorder the calling thread's for a block, so
that the seeding code, the engine and the BAM writer below the aligner
open spans through ``span``, which does nothing where no recorder is
active.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

# stage -> (layer, the stats keys it feeds); a stage of no layer feeds
# none and cuts its inner spans off from the keys of those around it
STAGES = {
    "dart.stream": (None, ()),
    "dart.chunk": (None, ()),
    "dart.prefetch": (None, ()),
    "dart.tail": (None, ()),
    "dart.input": ("input", ("input_parse_s",)),
    "dart.input.open": ("input", ("input_open_s",)),
    "dart.seed.submit": ("seeding", ("device_seed_locate_s",)),
    "dart.seed.finish": ("seeding", ("device_seed_locate_s",
                                     "device_only_wait_s")),
    "dart.seed.pack": ("seeding", ("seed_pack_s",)),
    "dart.seed.sync": ("seeding", ("device_sync_s",)),
    "dart.seed.expand": ("seeding", ("seed_expand_s",)),
    "dart.finalize": ("finalize", ("native_finalize_s",)),
    "dart.finalize.wait": ("finalize", ("finalize_wait_s",)),
    "dart.output": ("output", ("output_s",)),
    "dart.output.encode": ("output", ("output_encode_s",)),
    "dart.output.deflate": ("output", ("output_deflate_s",)),
}
KEYS = tuple(dict.fromkeys(k for _, keys in STAGES.values() for k in keys))

_ACTIVE = threading.local()


class Spans:
    """The span recorder of one aligner, adding to its ``stats``."""

    def __init__(self, stats: dict):
        self.stats = stats
        self._open: list = []  # (stage, layer, keys, k), outermost first
        self._t = 0

    def _charge(self) -> None:
        now = time.perf_counter_ns()
        if self._open:
            s = (now - self._t) * 1e-9
            for key in self._open[-1][2]:
                self.stats[key] += s
        self._t = now

    def __call__(self, stage: str, k: int | None = None) -> "_Span":
        return _Span(self, stage, k)

    @contextlib.contextmanager
    def active(self):
        """This recorder as the calling thread's for the block."""
        prev = getattr(_ACTIVE, "spans", None)
        _ACTIVE.spans = self
        try:
            yield self
        finally:
            _ACTIVE.spans = prev


class _Span:
    __slots__ = ("rec", "stage", "k", "_range")

    def __init__(self, rec: Spans, stage: str, k):
        self.rec, self.stage, self.k, self._range = rec, stage, k, None

    def __enter__(self):
        rec = self.rec
        rec._charge()
        layer, keys = STAGES[self.stage]
        if rec._open:
            _, p_layer, p_keys, p_k = rec._open[-1]
            if self.k is None:
                self.k = p_k
            if layer is not None and layer == p_layer:
                keys = keys + tuple(x for x in p_keys if x not in keys)
        rec._open.append((self.stage, layer, keys, self.k))
        if profiling():
            name = self.stage if self.k is None else f"{self.stage}#{self.k}"
            self._range = torch.profiler.record_function(name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        try:
            if self._range is not None:
                self._range.__exit__(*exc)
        finally:
            self.rec._charge()
            self.rec._open.pop()


def profiling() -> bool:
    """Whether a ``torch.profiler`` records: one enabled for the calling
    thread, or one started on any thread (a profiler of all threads is
    enabled for none)."""
    return (torch._C._autograd._profiler_enabled()
            or torch.autograd.profiler._is_profiler_enabled)


def span(stage: str, k: int | None = None):
    """A span of ``stage`` on the calling thread's active recorder; a
    context that does nothing where none is active."""
    rec = getattr(_ACTIVE, "spans", None)
    return contextlib.nullcontext() if rec is None else rec(stage, k)
