"""``DartAligner.stats["device_sync_s"]`` over the window, in microseconds a
read: the seeding layer's blocking copies to and from the card
(``dart.seed.sync`` spans: the scan's and the locate's uploads and downloads).
None where the program has no such key."""


def read(run):
    v = run["stats"].get("device_sync_s")
    return None if v is None else 1e6 * v / run["reads"]
