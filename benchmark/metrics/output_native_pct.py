"""``DartAligner.stats["output_native_bytes"]`` over
``stats["output_bytes"]`` in the window, in percent: the share of the BAM
writer's BGZF bytes that the native deflate framed on the ``-t`` threads.
None where the program has no such key or framed no BGZF byte."""


def read(run):
    total = run["stats"].get("output_bytes")
    if not total:
        return None
    return 100.0 * run["stats"]["output_native_bytes"] / total
