"""``DartAligner.stats["input_parse_s"]`` over the window, in microseconds a
read: the input layer's parse of the read files (``io/fastx_fast.py``)."""


def read(run):
    return 1e6 * run["stats"]["input_parse_s"] / run["reads"]
