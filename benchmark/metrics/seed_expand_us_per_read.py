"""``DartAligner.stats["seed_expand_s"]`` over the window, in microseconds a
read: the seeding layer's host work on the scan's tables (``dart.seed.expand``
spans: ``split_seeds``, the occurrence expansion and the row gather).
None where the program has no such key."""


def read(run):
    v = run["stats"].get("seed_expand_s")
    return None if v is None else 1e6 * v / run["reads"]
