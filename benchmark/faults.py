"""Faults planted under the timed path, and the control.

Each is applied where the output is produced: the SAM text of every
chunk as the native pipeline hands it on (``chunk_fault``, before the
sink or the BAM encoder sees it), or ``junctions.tab`` as the run leaves
it (``table_fault``). The harness's ``--fault NAME`` plants one; the
benchmark's own runs plant none.

- ``ungapped`` is the control: an aligner that skips closing the gaps
  between its seeds and reports each mapped read as one ungapped match
  at the position it found (every CIGAR becomes ``<read length>M``,
  clips and gaps dropped). It breaks the configuration's guarantee that
  every record replays against the genome with the edits it reports.
- ``moved``: the first mapped record's POS moved by 7 bases.
- ``cigar``: the first mapped record's CIGAR given a deletion halfway.
- ``seq``: one base of the first mapped record's SEQ changed.
- ``half``: every chunk's records after its first half left out.
- ``unmapped``: every record written as unmapped (flag 0x4, no place,
  no CIGAR, no mate place; SEQ and the other flags kept).
- ``nm0``: every record's NM written as 0.
- ``row``: the junction row with the largest count dropped.
- ``table``: the junction table left as it started, empty (a step that
  returns its state unchanged).
"""

from __future__ import annotations

import re


def _mapped(f: list) -> bool:
    return len(f) > 10 and not int(f[1]) & 4


def ungapped(sam: bytes) -> bytes:
    out = []
    for line in sam.split(b"\n"):
        f = line.split(b"\t")
        if _mapped(f):
            f[5] = b"%dM" % len(f[9])
            line = b"\t".join(f)
        out.append(line)
    return b"\n".join(out)


class _First:
    """Alters the first mapped record it sees, once in the run."""

    def __init__(self, alter):
        self.alter = alter
        self.done = False

    def __call__(self, sam: bytes) -> bytes:
        if self.done:
            return sam
        lines = sam.split(b"\n")
        for k, line in enumerate(lines):
            f = line.split(b"\t")
            if _mapped(f):
                self.alter(f)
                lines[k] = b"\t".join(f)
                self.done = True
                break
        return b"\n".join(lines)


def _move(f):
    f[3] = b"%d" % (int(f[3]) + 7)


def _cigar(f):
    n = len(f[9])
    f[5] = b"%dM1D%dM" % (n // 2, n - n // 2)


def _seq(f):
    s = bytearray(f[9])
    s[len(s) // 2] = ord("A") if s[len(s) // 2] != ord("A") else ord("C")
    f[9] = bytes(s)


def half(sam: bytes) -> bytes:
    lines = [x for x in sam.split(b"\n") if x]
    return b"".join(x + b"\n" for x in lines[:len(lines) // 2])


def unmapped(sam: bytes) -> bytes:
    out = []
    for line in sam.split(b"\n"):
        f = line.split(b"\t")
        if len(f) > 10:
            flag = int(f[1]) & ~0x32 | 0x4 | (0x8 if int(f[1]) & 1 else 0)
            f[1:9] = [b"%d" % flag, b"*", b"0", b"0", b"*", b"*", b"0",
                      b"0"]
            line = b"\t".join(f[:11])
        out.append(line)
    return b"\n".join(out)


def nm0(sam: bytes) -> bytes:
    return re.sub(rb"\tNM:i:\d+", b"\tNM:i:0", sam)


def drop_row(path: str) -> None:
    with open(path) as f:
        rows = f.readlines()
    if rows:
        rows.remove(max(rows, key=lambda r: int(r.split()[3])))
    with open(path, "w") as f:
        f.writelines(rows)


def empty_table(path: str) -> None:
    open(path, "w").close()


def chunk_fault(name: str):
    """The transform of each chunk's SAM text for fault ``name``, or
    None."""
    return {"ungapped": lambda: ungapped, "moved": lambda: _First(_move),
            "cigar": lambda: _First(_cigar), "seq": lambda: _First(_seq),
            "half": lambda: half, "unmapped": lambda: unmapped,
            "nm0": lambda: nm0}.get(name, lambda: None)()


def table_fault(name: str):
    """What fault ``name`` does to ``junctions.tab`` after the run, or
    None."""
    return {"row": drop_row, "table": empty_table}.get(name)


NAMES = ("ungapped", "moved", "cigar", "seq", "half", "unmapped", "nm0",
         "row", "table")
