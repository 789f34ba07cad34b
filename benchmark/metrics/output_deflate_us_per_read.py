"""``DartAligner.stats["output_deflate_s"]`` over the window, in microseconds a
read: the output layer's BGZF deflate on the ``-t`` pool and the file write
(``dart.output.deflate``).
None where the program has no such key."""


def read(run):
    v = run["stats"].get("output_deflate_s")
    return None if v is None else 1e6 * v / run["reads"]
