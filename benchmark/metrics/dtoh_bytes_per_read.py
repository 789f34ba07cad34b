"""``DartAligner.stats["dtoh_bytes"]`` over the window, in bytes a read:
the engine's copies from the card to the host over the window (the scan's
tables and the located positions).
None where the program has no such key."""


def read(run):
    v = run["stats"].get("dtoh_bytes")
    return None if v is None else v / run["reads"]
