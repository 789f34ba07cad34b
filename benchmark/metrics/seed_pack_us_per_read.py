"""``DartAligner.stats["seed_pack_s"]`` over the window, in microseconds a
read: the seeding layer's host pack of each chunk (``dart.seed.pack``
spans: ``pack_reads_strided``, ``pack_host``).
None where the program has no such key."""


def read(run):
    v = run["stats"].get("seed_pack_s")
    return None if v is None else 1e6 * v / run["reads"]
