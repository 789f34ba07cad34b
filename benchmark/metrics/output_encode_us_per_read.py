"""``DartAligner.stats["output_encode_s"]`` over the window, in microseconds a
read: the output layer's native SAM to BAM encode (``dart.output.encode``).
None where the program has no such key."""


def read(run):
    v = run["stats"].get("output_encode_s")
    return None if v is None else 1e6 * v / run["reads"]
