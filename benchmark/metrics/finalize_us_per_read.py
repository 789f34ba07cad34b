"""``DartAligner.stats["native_finalize_s"]`` over the window, in microseconds a
read: the native finalize (chaining, gap DP, SAM text)."""


def read(run):
    return 1e6 * run["stats"]["native_finalize_s"] / run["reads"]
