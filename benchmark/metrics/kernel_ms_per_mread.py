"""The card's kernels, summed over the traced window, in milliseconds a
million reads."""


def read(run):
    t = run["trace"]
    if not t or not t.get("kernel_s"):
        return None
    return 1e3 * t["kernel_s"] / (run["reads"] / 1e6)
