"""``DartAligner.stats["finalize_parallel_s"]`` over the window, in microseconds a
read: the native finalize's parallel compute phase on its ``-t`` threads, as
``dart_pipe_chunk`` times it.
None where the program has no such key."""


def read(run):
    v = run["stats"].get("finalize_parallel_s")
    return None if v is None else 1e6 * v / run["reads"]
