"""What a ``torch.profiler`` trace of the window says of the card.

A copy of ``dart_tpu_torch.bench.trace_summary``, reading the Chrome
trace that ``profile.export_chrome_trace`` writes: the device's busy
time (the union of its kernels, copies and fills), the traced window,
time by device operation, and the longest idle gaps, each named by the
host activity the trace shows around it.
"""

from __future__ import annotations

import gzip
import json
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def kernel_name(name: str) -> str:
    """A traced kernel's template name, without its namespace and
    parameter list."""
    m = re.search(r"\w+_kernel(<[^(]*>)?", name)
    return m.group(0) if m else name[:60]


def summary(path: str, top: int = TOP) -> dict:
    """``busy_s`` and ``window_s`` (first to last traced event),
    ``kernel_s`` and ``copy_s`` (summed), ``device_ops`` (the ``top``
    device operations by summed time: [name, seconds]) and ``idle_gaps``
    (the ``top`` longest gaps in which no device operation ran: [the
    host activity, seconds], named by the shortest traced CPU event that
    covers the gap, else ``after <the last CPU event to start before
    it>``, with the share of the gap that traced CPU events cover)."""
    with (gzip.open if path.endswith(".gz") else open)(path, "rb") as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not events:
        return {}
    busy: list[list[float]] = []
    for e in sorted(dev, key=lambda e: e["ts"]):
        lo, hi = e["ts"], e["ts"] + e["dur"]
        if busy and lo <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], hi)
        else:
            busy.append([lo, hi])
    start = min(e["ts"] for e in events)
    stop = max(e["ts"] + e["dur"] for e in events)
    edges = [start, *(x for b in busy for x in b), stop]
    gaps = sorted(((lo, hi) for lo, hi in zip(edges[::2], edges[1::2])
                   if hi > lo), key=lambda g: g[0] - g[1])[:top]
    cpu = [e for e in events if e.get("cat") not in DEVICE_CATS
           and not str(e.get("cat", "")).startswith("gpu_")
           and not (e["ts"] <= start and e["ts"] + e["dur"] >= stop)]

    def name(lo, hi) -> str:
        inner = [e for e in cpu if e["ts"] <= lo and e["ts"] + e["dur"] >= hi]
        before = [e for e in cpu if e["ts"] < lo]
        covered, end = 0.0, lo
        for a, b in sorted((max(lo, e["ts"]), min(hi, e["ts"] + e["dur"]))
                           for e in cpu):
            if b > max(a, end):
                covered += b - max(a, end)
                end = b
        what = (min(inner, key=lambda e: e["dur"])["name"] if inner else
                "after " + (max(before, key=lambda e: e["ts"])["name"]
                            if before else "the window's start"))
        where = ("at the start" if lo == start else "at the end"
                 if hi == stop else "between device operations")
        return (f"{what[:80]} ({where}, {100 * covered / (hi - lo):.1f}% "
                "traced on the host)")

    ops: dict = {}
    kernel = copy = 0.0
    for e in dev:
        k = kernel_name(e["name"]) if e["cat"] == "kernel" else e["name"]
        ops[k] = ops.get(k, 0.0) + e["dur"] / 1e6
        if e["cat"] == "kernel":
            kernel += e["dur"] / 1e6
        elif e["cat"] == "gpu_memcpy":
            copy += e["dur"] / 1e6
    return {"busy_s": sum(hi - lo for lo, hi in busy) / 1e6,
            "window_s": (stop - start) / 1e6,
            "kernel_s": kernel, "copy_s": copy,
            "device_ops": [[k, s] for k, s in
                           sorted(ops.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[name(lo, hi), (hi - lo) / 1e6]
                          for lo, hi in gaps]}
