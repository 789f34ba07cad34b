"""Seconds to build and upload the engine's FM table
(``FMIndexTorch.setup_s["table"]``, ``ops/layout.py``)."""


def read(run):
    return run["setup"]["table_s"]
