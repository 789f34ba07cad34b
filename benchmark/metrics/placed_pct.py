"""The share of the window's reads whose primary record lies at its
origin (``refcheck``: FluxEva's rule, MAPQ 0 and unmapped not placed)."""


def read(run):
    return run["check"]["placed_pct"]
