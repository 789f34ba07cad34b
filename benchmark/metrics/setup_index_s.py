"""Seconds to load the cached index (``index.load_index``)."""


def read(run):
    return run["setup"]["index_load_s"]
