"""``DartAligner.stats["finalize_serial_s"]`` over the window, in microseconds a
read: the native finalize's serial phase (junctions and the SAM text of every
record, one thread), as ``dart_pipe_chunk`` times it.
None where the program has no such key."""


def read(run):
    v = run["stats"].get("finalize_serial_s")
    return None if v is None else 1e6 * v / run["reads"]
