"""``benchmark/run.py`` as a checkout runs it: without the cards a
cell asks for, and in a directory that holds only the benchmark, it
exits with another code than 0 and prints no result; on a card
(``-m cuda``) a short run of each cell is correct."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import benchtoy

REPO = benchtoy.REPO
with open(os.path.join(REPO, "BENCHMARK.json")) as f:
    BENCH = json.load(f)


def run(cwd, *args, timeout=1200):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", *args], cwd=cwd,
        capture_output=True, text=True, timeout=timeout)


def has_card():
    import torch

    return torch.cuda.is_available()


@pytest.fixture
def no_card():
    if has_card():
        pytest.skip("a CUDA device is present")


@pytest.fixture
def card():
    if not has_card():
        pytest.skip("needs a CUDA device")


def test_without_a_card_no_result(no_card):
    out = run(REPO, "--workload", BENCH["workloads"][0]["name"], "--seed",
              "1", "--seconds", "1", "--trace", "0", timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    for p in BENCH["paths"]:
        shutil.copytree(os.path.join(REPO, p), tmp_path / p,
                        ignore=shutil.ignore_patterns("cache",
                                                      "__pycache__"))
    out = run(str(tmp_path), "--workload", BENCH["workloads"][0]["name"],
              "--seed", "1", "--seconds", "1", "--trace", "0", timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_short_run_on_the_card_is_correct(card, cell):
    out = run(REPO, "--workload", cell, "--seed", str(2**31 + 9),
              "--seconds", "3", "--trace", "0")
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
