"""``DartAligner.stats["device_only_wait_s"]`` over the window, in microseconds a
read: the seeding layer's wait for the card alone, the next chunk's prefetch left out."""


def read(run):
    return 1e6 * run["stats"]["device_only_wait_s"] / run["reads"]
