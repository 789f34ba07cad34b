"""``DartAligner.stats["output_s"]`` over the window, in microseconds a
read: the output layer: BGZF-compressed BAM (``io/bam.py``, ``native/bamenc.cpp``)."""


def read(run):
    return 1e6 * run["stats"]["output_s"] / run["reads"]
