"""``DartAligner.stats["input_open_s"]`` over the window, in microseconds a
read: the input layer's reader set-ups (the whole-file read, gunzip and
record index of each file, ``dart.input.open`` spans), a part of
``input_parse_s``.
None where the program has no such key."""


def read(run):
    v = run["stats"].get("input_open_s")
    return None if v is None else 1e6 * v / run["reads"]
