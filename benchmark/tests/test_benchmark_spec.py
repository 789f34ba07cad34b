"""``BENCHMARK.json`` and the files it names: the required keys and
characters, and a file for every name."""

import json
import os
import re

import pytest

import benchtoy

ROOT = benchtoy.REPO
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes():
    assert set(BENCH) == KEYS["top"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(PATH.fullmatch(p) for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(line(w) for w in BENCH["command"])
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[part]:
            extra = {"workloads"} if part == "end_to_end" else set()
            assert KEYS[part] <= set(e) <= KEYS[part] | extra, e["name"]


@pytest.mark.parametrize("part", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units_use_the_allowed_characters(part):
    names = [e["name"] for e in BENCH[part]]
    assert len(set(names)) == len(names)
    for e in BENCH[part]:
        assert NAME.fullmatch(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.fullmatch(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and part != "end_to_end" and part != "per_layer":
                assert line(e[key]), (e["name"], key)
        if part == "per_layer":
            assert line(e["layer"])
        if part == "workloads":
            assert NAME.fullmatch(e["config"]) and NAME.fullmatch(
                e["traffic"])
            assert e["chips"] in (1, 4)
        if part == "configs":
            assert all(NAME.fullmatch(k) for k in e["reduced"])
            assert len(e["reduced"]) <= 16


def test_every_name_has_its_file():
    d = os.path.join(ROOT, "benchmark")
    cells = {w["name"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert set(c["reduced"]) == set(cfg["reduced"])
    for w in BENCH["workloads"]:
        assert os.path.exists(os.path.join(d, "traffic",
                                           w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(d, "limits", w["name"] + ".json"))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert os.path.exists(os.path.join(d, "metrics", m["name"] + ".py"))
        assert set(m.get("workloads", [])) <= cells
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_each_cell_reports_setup_another_metric_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", []) for m in
                   BENCH["per_layer"])


def test_no_intron_is_longer_than_the_aligner_chains():
    # the aligner chains seeds less than -max_intron apart (default
    # 500,000), so a longer intron would never be spliced
    for c in BENCH["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        genes = cfg["genome"].get("genes")
        if genes:
            flags = cfg["flags"]
            most = int(flags[flags.index("-max_intron") + 1]) \
                if "-max_intron" in flags else 500000
            assert genes["introns"]["most"] < most, c["name"]
