"""The card's copies (host to device and back), summed over the traced
window, in milliseconds a million reads."""


def read(run):
    t = run["trace"]
    if not t or not t.get("copy_s"):
        return None
    return 1e3 * t["copy_s"] / (run["reads"] / 1e6)
