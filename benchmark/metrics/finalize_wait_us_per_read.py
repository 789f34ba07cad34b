"""``DartAligner.stats["finalize_wait_s"]`` over the window, in microseconds a
read: the main thread's time blocked on the finalize worker (the part of the
native finalize that the main thread's parse and seeding did not hide).
None where the program has no such key."""


def read(run):
    v = run["stats"].get("finalize_wait_s")
    return None if v is None else 1e6 * v / run["reads"]
