"""A configuration with ``"processes": 2`` and ``"genome_of": "toy"``,
added to a temporary copy as files and entries, run through
``dist.run_cell`` as two processes over gloo on the CPU (on a card
with ``-m cuda``): correct, its work counted once, its ``stats``
summed over the processes, the control and a table fault caught in the
merged output, a worker killed early ending the run at once, BAM output
and a cell that asks for fewer cards than it runs processes refused,
and a shard pass that would time the program's own set-up
refused."""

import json
import mmap
import os
import signal
import subprocess
import sys
import time

import pytest

import benchtoy
from benchmark import dist

SEED = 2**31 + 303
N = 2
DIST = dict({k: v for k, v in benchtoy.TOY.items() if k != "genome"},
            name="toy_dist2", genome_of="toy", processes=N)
CELLS = {"toy_dist2_pe_sam": "toy_pe_sam", "toy_dist2_pe_bam": "toy_pe_bam"}
ONE_CARD = "toy_dist2_one_card"


def add_dist(root):
    """The toy multi-process configuration and its cells, as files and
    entries, in the copy at ``root``."""
    d = os.path.join(root, "benchmark")
    with open(os.path.join(d, "configs", "toy_dist2.json"), "w") as f:
        json.dump(DIST, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "toy_dist2", "source": "CPU tests",
                             "file": "benchmark/configs/toy_dist2.json",
                             "reduced": [], "why": "CPU tests"})
    for name, traffic in CELLS.items():
        with open(os.path.join(d, "limits", name + ".json"), "w") as f:
            json.dump(benchtoy.LIMITS, f)
        bench["workloads"].append({"name": name, "config": "toy_dist2",
                                   "traffic": traffic, "chips": N,
                                   "why": "CPU tests"})
    # a cell of two processes that asks for one card
    with open(os.path.join(d, "limits", ONE_CARD + ".json"), "w") as f:
        json.dump(benchtoy.LIMITS, f)
    bench["workloads"].append({"name": ONE_CARD, "config": "toy_dist2",
                               "traffic": "toy_pe_sam", "chips": 1,
                               "why": "CPU tests"})
    for m in bench["per_layer"]:
        if m["name"] == "toy_chunks":
            m["workloads"] += list(CELLS)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return add_dist(benchtoy.make_root(str(tmp_path_factory.mktemp("dist"))))


def values(res):
    return {k: c["value"] for k, c in res["checks"].items()}


def test_a_two_process_cell_runs_correct(root):
    res = dist.run_cell(root, "toy_dist2_pe_sam", SEED, 0.5, False,
                           "cpu")
    assert res["correct"], res["checks"]
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "builds", "checks"]
    assert set(res["metrics"]) == {"reads_per_s", "placed_pct", "setup_s"}
    # every listed file once: 1,024 pairs a file
    assert res["attempted"] % (2 * 1024) == 0 and res["failed"] == 0
    assert res["device"]["count"] == N
    assert 80 < res["metrics"]["placed_pct"]["value"] <= 100


def test_the_traced_run_sums_the_processes(root, monkeypatch):
    seen = []
    combine = dist.combine

    def spy(workers):
        seen.append((workers, combine(workers)))
        return seen[-1][1]

    monkeypatch.setattr(dist, "combine", spy)
    res = dist.run_cell(root, "toy_dist2_pe_sam", SEED + 1, 0.5, True,
                           "cpu")
    assert res["correct"], res["checks"]
    # the summed stats are the sum of the workers' files, key by key
    [(workers, joined)] = seen
    assert len(workers) == N
    for key, v in joined["stats"].items():
        assert v == sum(w["stats"][key] for w in workers), key
    # chunks of 1,024 reads, each in one process's stats: the sum over
    # the processes counts every chunk of the window once
    assert res["metrics"]["toy_chunks"]["value"] == res["attempted"] // 1024
    assert "breakdown" in res and list(res)[-1] == "checks"


def test_a_multi_process_cell_writes_sam(root):
    # judge reads the merged output as SAM text: a BAM cell is refused
    # before any worker starts
    with pytest.raises(ValueError, match="writes SAM"):
        dist.run_cell(root, "toy_dist2_pe_bam", SEED, 0.5, False, "cpu")


def test_a_cell_asks_for_a_card_a_process(root):
    with pytest.raises(ValueError, match="asks for 1 card"):
        dist.run_cell(root, ONE_CARD, SEED, 0.5, False, "cpu")


def test_a_shard_pass_that_times_its_own_set_up_raises(monkeypatch):
    # a _run that no longer reaches load_index, make_engine and
    # DartAligner through their modules would build its own in the window
    from dart_tpu_torch.parallel import distributed

    monkeypatch.setattr(distributed, "_run", lambda cfg, n, k, dev: None)
    with pytest.raises(RuntimeError, match="its own set-up"):
        dist.shard_pass(object(), object(), None, 1, 0, "cpu")


def test_combine_sums_stats_and_traces():
    def worker(k, base):
        return {"stats": {"input_parse_s": base, "chunks": k + 1},
                "setup": {"index_load_s": base, "warm_s": 2 * base},
                "card": k,
                "trace": {"busy_s": base, "window_s": 10.0,
                          "kernel_s": base / 2, "copy_s": base / 4,
                          "device_ops": [["seed_scan_kernel", base],
                                         [f"op{k}", 1.0]],
                          "idle_gaps": [["dart.stream (x)", base]]}}

    workers = [worker(0, 1.0), worker(1, 3.0)]
    got = dist.combine(workers)
    assert got["stats"] == {"input_parse_s": 4.0, "chunks": 3}
    assert got["setup"] == {"index_load_s": 3.0, "warm_s": 6.0}
    t = got["trace"]
    assert (t["busy_s"], t["window_s"], t["kernel_s"], t["copy_s"]) == \
        (4.0, 20.0, 2.0, 1.0)
    assert t["device_ops"][0] == ["seed_scan_kernel", 4.0]
    assert t["idle_gaps"] == [["card1: dart.stream (x)", 3.0],
                              ["card0: dart.stream (x)", 1.0]]
    assert dist.combine([dict(w, trace=None) for w in workers])[
        "trace"] is None


@pytest.mark.parametrize("step", [7, 1 << 26])
def test_sam_blocks_cut_every_per_records(tmp_path, monkeypatch, step):
    monkeypatch.setattr(dist, "STEP", step)
    head = b"@PG\tID:Dart\n@SQ\tSN:chrT\tLN:9\n"
    recs = [b"r%d\t0\tchrT\t1\n" % i for i in range(10)]
    path = tmp_path / "x.sam"
    path.write_bytes(head + b"".join(recs))
    with open(path, "rb") as f, \
            mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        got = [mm[lo:hi] for lo, hi in dist.sam_blocks(mm, 4)]
    assert got == [b"".join(recs[:4]), b"".join(recs[4:8]),
                   b"".join(recs[8:])]


@pytest.mark.parametrize("fault,number", [("ungapped", "nm_off_ppm"),
                                          ("row", "sj_rows_off")])
def test_a_fault_is_caught_in_the_merged_output(root, fault, number):
    # ungapped, the control, is planted in every worker; row on the
    # merged junctions.tab
    res = dist.run_cell(root, "toy_dist2_pe_sam", SEED + 2, 0.5, False,
                           "cpu", fault)
    assert not res["correct"]
    assert values(res)[number] > res["checks"][number]["limit"]


def workers_of(root):
    """The pids of the running workers started from ``root``."""
    found = []
    for pid in os.listdir("/proc"):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read()
            if b"benchmark.dist" in cmd and \
                    os.readlink(f"/proc/{pid}/cwd") == root:
                found.append(int(pid))
        except (OSError, ValueError):
            continue
    return found


def test_a_killed_worker_ends_the_run_at_once(root):
    code = ("import sys; from benchmark import dist; "
            "print(dist.run_cell(sys.argv[1], 'toy_dist2_pe_sam', "
            f"{SEED + 3}, 5, False, 'cpu'))")
    t = time.time()
    run = subprocess.Popen([sys.executable, "-c", code, root],
                           cwd=benchtoy.REPO, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        while not workers_of(root) and run.poll() is None \
                and time.time() - t < 120:
            time.sleep(0.02)
        victims = workers_of(root)
        assert victims, "no worker started"
        os.kill(victims[0], signal.SIGKILL)
        out, err = run.communicate(timeout=120)
    finally:
        if run.poll() is None:
            run.kill()
            run.wait()
    assert run.returncode != 0
    assert "{" not in out
    assert "failed, exit codes" in err
    # well inside gloo's 600 s, and no worker left behind
    assert time.time() - t < 120
    assert workers_of(root) == []


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_a_two_process_cell_on_the_card(card, root):
    res = dist.run_cell(root, "toy_dist2_pe_sam", SEED + 4, 2, True,
                           "cuda")
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["count"] == N
    assert res["device"]["busy_s"] > 0
