"""The seed scan's device time over the window (every operation whose
kernel name starts with ``seed_scan_kernel``: the narrow and the wide
template alike), in milliseconds a million reads. None where the trace
names no such operation."""


def read(run):
    t = run["trace"]
    if not t:
        return None
    s = sum(sec for name, sec in t.get("device_ops", [])
            if name.startswith("seed_scan_kernel"))
    return 1e3 * s / (run["reads"] / 1e6) if s else None
