"""``DartAligner.stats["locate_rows"]`` over the window, in rows a read:
the suffix-array rows the engine located over the window.
None where the program has no such key."""


def read(run):
    v = run["stats"].get("locate_rows")
    return None if v is None else v / run["reads"]
