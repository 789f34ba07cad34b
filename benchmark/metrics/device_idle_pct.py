"""The share of the traced window in which no kernel, copy or fill ran
on the card."""


def read(run):
    t = run["trace"]
    if not t or not t.get("window_s") or not t.get("busy_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
