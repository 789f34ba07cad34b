"""The port's counterparts of ``__graft_entry__``'s two entry points.

``entry(device)`` returns ``(forward_step, example_args)``: one forward
step of the seeding pipeline on the toy index. The step runs the MEM
walks (K8) over a batch of (read, start) tasks, accepts a walk that
occurs at most 100 times and is at least 16 bases long, locates the
accepted walks' first occurrences (K2), and returns ``(lens, x2,
locs)``, each (W,) int32, with ``locs`` -1 where a walk was not
accepted. The arguments are the merged table and L2 of ``ops.layout``
on ``device`` and the task batch (chars (W, L) uint8, valid (W, L)
bool), made with numpy from ``__graft_entry__``'s seed.

``dryrun_multichip(n_devices, device)`` runs the sharded engine
(``parallel.mesh``) over an ``n_devices`` (data, index) grid, index=2
where ``n_devices`` is even: MEM walks and locates on the index-sharded
table, the seed scan equal to the replicated data-parallel run, the
wide engine on the same grid equal to the narrow one (``dryrun_toy``,
the toy-scale part); then a 4 Mbp genome whose largest placed shard is
at most 75% of its table, with a whole ``DartAligner`` run byte-equal
between the sharded and the replicated engine (``overflow_proof``);
then the scaling lines (``scaling_curve``); and, where a genome of
GRCh38's class is indexed (``giant_index``), its wide table sharded
(``giant_proof``). With fewer cards than slots the slots share the
cards (``mesh.make_mesh``), and the scaling lines then time slots that
share one card, not cards.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from .index import load_index
from .ops.fm_torch import FMIndexTorch

TOY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests", "golden", "index", "toy")
MAX_FREQ = 100     # a walk is accepted with at most this many occurrences
MIN_LEN = 16       # ... and at least this many bases


def example_batch(idx, n_tasks: int = 256, L: int = 96):
    """``n_tasks`` tasks of L genome bases from random positions
    (``__graft_entry__._example_batch``, same seed): (chars, valid)."""
    rng = np.random.default_rng(1)
    chars = np.full((n_tasks, L), 4, dtype=np.uint8)
    valid = np.zeros((n_tasks, L), dtype=bool)
    for t in range(n_tasks):
        pos = int(rng.integers(0, idx.seq_len - L - 1))
        chars[t] = idx.ref_codes[pos:pos + L]
        valid[t] = True
    return chars, valid


class ForwardStep:
    """The forward step on one engine (``entry``'s): call it with the
    engine's own table and L2 and a task batch on its device;
    ``plain`` runs the same step through the plain PyTorch versions.
    The engine's launch counts record the step's kernels."""

    def __init__(self, engine: FMIndexTorch):
        self.engine = engine

    def __call__(self, table, L2, chars, valid):
        return self._run(table, L2, chars, valid, plain=False)

    def plain(self, table, L2, chars, valid):
        return self._run(table, L2, chars, valid, plain=True)

    def _run(self, table, L2, chars, valid, plain: bool):
        eng = self.engine
        if table is not eng.table or L2 is not eng.L2:
            raise ValueError("the step runs on its engine's own table and "
                             "L2 (entry()'s example_args)")
        walk = eng.plain_mem_walks if plain else eng.mem_walk_rows
        locate = eng.plain_locate if plain else eng.locate_rows
        lens, x0, x2 = walk(chars, valid)
        accepted = (x2 <= MAX_FREQ) & (lens >= MIN_LEN)
        locs = locate(torch.where(accepted, x0, 0))
        return lens, x2, torch.where(accepted, locs, -1)


def entry(device="cuda"):
    """(forward_step, example_args) on the toy index, with the tables
    and the task batch on ``device``."""
    idx = load_index(TOY)
    eng = FMIndexTorch(idx, device)
    chars, valid = example_batch(idx)
    args = (eng.table, eng.L2, torch.from_numpy(chars).to(eng.device),
            torch.from_numpy(valid).to(eng.device))
    return ForwardStep(eng), args


# ---- dryrun_multichip ----


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def _same(got, want, what: str) -> None:
    for a, b in zip(got, want):
        _require(np.array_equal(np.asarray(a), np.asarray(b)),
                 f"{what}: the sharded run differs")


def _shares_cards(mesh) -> bool:
    slots = [d for g in mesh for d in g]
    return len(set(slots)) < len(slots)


def index_shards_for(n_devices: int) -> int:
    """The dry run's index axis: 2 on an even grid, else 1."""
    return 2 if n_devices % 2 == 0 and n_devices >= 2 else 1


def dryrun_multichip(n_devices: int, device="cuda",
                     work: str | None = None) -> dict:
    """Every part of the dry run (module docstring) on an ``n_devices``
    grid on ``device``; returns each part's results. ``work`` holds
    the 4 Mbp genome, its index and reads (default: a directory under
    the temporary directory)."""
    res = {"toy": dryrun_toy(n_devices, device)}
    index_shards = index_shards_for(n_devices)
    if index_shards > 1:
        res["overflow"] = overflow_proof(n_devices, index_shards, device,
                                         work)
    res["scaling"] = scaling_curve(n_devices, device)
    giant = giant_index()
    if giant:
        try:
            res["giant"] = giant_proof(n_devices, giant, device)
        except Exception as e:  # noqa: BLE001 -- evidence, not a gate
            print(f"giant-table shard proof FAILED (core dryrun above "
                  f"unaffected): {type(e).__name__}: {e}")
            res["giant"] = {"failed": f"{type(e).__name__}: {e}"}
    return res


def dryrun_toy(n_devices: int, device="cuda") -> dict:
    """The toy-scale part: MEM walks and locates on the index-sharded
    engine, its seed scan equal to the replicated data-parallel run's,
    the wide engine on the same grid equal to it too. Returns the
    engines' launch counts and the seed count."""
    from .aligner import default_lut_k
    from .parallel.mesh import ShardedFMIndexTorch, make_mesh

    idx = load_index(TOY)
    lut_k = default_lut_k(device)
    index_shards = index_shards_for(n_devices)
    mesh = make_mesh(n_devices, index_shards, device)
    fm = ShardedFMIndexTorch(idx, mesh, lut_k=lut_k)
    chars, valid = example_batch(idx, n_tasks=64, L=32)
    lens, x0, freq = fm.mem_walks(chars, valid)
    accepted = (freq <= MAX_FREQ) & (lens >= MIN_LEN)
    locs = fm.locate(np.where(accepted, x0, 0).astype(np.int64))
    _require(lens.shape == (64,), "MEM walks: one length a task")
    _require(bool((locs[accepted] >= 0).all()),
             "an accepted exact walk located no genome position")

    fm_dp = ShardedFMIndexTorch(idx, make_mesh(n_devices, 1, device),
                                lut_k=lut_k)
    codes, _ = example_batch(idx, n_tasks=32, L=64)
    rlens = np.full(32, 64, np.int32)
    want = fm_dp.seed_reads(codes, rlens)
    _same(fm.seed_reads(codes, rlens), want, "seed scan on the "
          f"index={index_shards} table")
    n_seeds = want[0]
    _require(bool((n_seeds >= 1).all()), "an exact read found no seed")

    wide = ShardedFMIndexTorch(idx, mesh, lut_k=lut_k, wide=True)
    _require(np.array_equal(wide.seed_reads(codes, rlens)[0], n_seeds),
             "the wide engine's seed counts differ")
    print(f"dryrun_multichip ok: mesh={fm.shape} on {device}; automaton on "
          f"index={index_shards} sharded table matches replicated "
          f"({int(n_seeds.sum())} seeds over {n_devices} slots); wide "
          "engine agrees on the full data x index mesh")
    return {"mesh": fm.shape, "seeds": int(n_seeds.sum()),
            "accepted": int(accepted.sum()), "launches": fm.launches,
            "launches_wide": wide.launches,
            "launches_replicated": fm_dp.launches}


def _write_genome(path: str, n: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), n)
    with open(path, "wb") as f:
        f.write(b">chr1\n")
        f.write(bytes(seq) + b"\n")


def _write_reads(idx, path: str, n: int, seed: int) -> None:
    """n reads of 100 bases from random genome positions, 1%
    substitutions (``__graft_entry__``'s overflow reads)."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "w") as f:
        for i in range(n):
            p = int(rng.integers(0, idx.genome_size - 100))
            s = idx.ref_codes[p:p + 100].copy()
            mut = rng.random(100) < 0.01
            s[mut] = (s[mut] + rng.integers(1, 4, int(mut.sum()),
                                            dtype=np.uint8)) % 4
            f.write(f"@r{i}\n{bytes(bases[np.minimum(s, 3)]).decode()}"
                    f"\n+\n{'I' * 100}\n")


def overflow_proof(n_devices: int, index_shards: int, device="cuda",
                   work: str | None = None) -> dict:
    """A 4 Mbp genome's merged table over ``index_shards`` range shards:
    the largest placed shard is at most 75% of the table (the cap one
    device is given), and a whole ``DartAligner`` run over 256 reads
    (seed, chain, finalize, SAM and junctions) is byte-equal between the
    sharded and the replicated engine."""
    from .aligner import DartAligner, default_lut_k
    from .config import DartConfig
    from .index import build_index
    from .parallel.mesh import ShardedFMIndexTorch, make_mesh

    work = work or os.path.join(tempfile.gettempdir(),
                                "dart_tpu_torch_dryrun_4mbp")
    os.makedirs(work, exist_ok=True)
    prefix = os.path.join(work, "idx")
    if not os.path.exists(prefix + ".bwt"):
        fa = os.path.join(work, "genome.fa")
        _write_genome(fa, 4_000_000, seed=11)
        build_index(fa, prefix)
    idx = load_index(prefix)
    fq = os.path.join(work, "reads.fq")
    if not os.path.exists(fq):
        _write_reads(idx, fq, 256, seed=12)

    lut_k = default_lut_k(device)
    fm = ShardedFMIndexTorch(idx, make_mesh(n_devices, index_shards, device),
                             lut_k=lut_k)
    shards = fm.groups[0].table.shards
    tab_bytes = sum(t.nbytes for t in shards)
    shard_bytes = max(t.nbytes for t in shards)
    cap = int(tab_bytes * 0.75)  # one device may hold < 75% of the table
    _require(tab_bytes > cap, "the table must overflow the per-device cap")
    _require(shard_bytes <= cap, f"placed shard {shard_bytes} B exceeds the "
             f"{cap} B device cap")
    print(f"overflow sharding ok: merged table {tab_bytes / 1e6:.1f} MB "
          f"> per-device cap {cap / 1e6:.1f} MB; largest placed shard "
          f"{shard_bytes / 1e6:.1f} MB fits ({index_shards} range shards)")

    def run(engine, tag):
        cfg = DartConfig()
        cfg.max_mismatch = 5
        cfg.silent = True
        cfg.read_files_1 = [fq]
        cfg.output_file = os.path.join(work, f"out_{tag}.sam")
        cfg.sj_file = os.path.join(work, f"sj_{tag}.tab")
        DartAligner(idx, cfg, engine).run()
        with open(cfg.output_file) as f, open(cfg.sj_file) as g:
            return f.read(), g.read()

    got = run(fm, "sharded")
    rep = ShardedFMIndexTorch(idx, make_mesh(n_devices, 1, device),
                              lut_k=lut_k)
    want = run(rep, "replicated")
    _require(got == want, "sharded-index pipeline output diverged")
    n_rec = sum(1 for ln in got[0].splitlines() if not ln.startswith("@"))
    print(f"full pipeline behind sharded seeding ok: {n_rec} SAM records "
          "byte-identical to the replicated-index run")
    return {"table_bytes": tab_bytes, "shard_bytes": shard_bytes,
            "records": n_rec, "launches": fm.launches}


def scaling_curve(n_devices: int, device="cuda") -> list[dict]:
    """Seed scan and 4,096 locates of a fixed set of reads (100 bases,
    ``DART_TPU_SCALING_READS``, default 4,096) on data-parallel grids of
    1, 2, 4 and ``n_devices`` slots on the toy index: warm (first call)
    and steady seconds and reads/s. Slots that share a card measure the
    split of the batch, not scaling."""
    from .aligner import default_lut_k
    from .parallel.mesh import ShardedFMIndexTorch, make_mesh

    idx = load_index(TOY)
    R = int(os.environ.get("DART_TPU_SCALING_READS", "4096"))
    L = 100
    rng = np.random.default_rng(5)
    codes = np.empty((R, L), dtype=np.uint8)
    for i in range(R):
        p = int(rng.integers(0, idx.genome_size - L))
        codes[i] = idx.ref_codes[p:p + L]
    rlens = np.full(R, L, np.int32)
    out = []
    for nd in sorted({1, 2, min(4, n_devices), n_devices}):
        mesh = make_mesh(nd, 1, device)
        eng = ShardedFMIndexTorch(idx, mesh, lut_k=default_lut_k(device))
        t0 = time.perf_counter()
        n, _, _, k0, fr = eng.seed_reads(codes, rlens)
        rows = k0[fr >= 1].ravel().astype(np.int64)[:4096]
        eng.locate(rows)
        warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng.seed_reads(codes, rlens)
        eng.locate(rows)
        dt = time.perf_counter() - t0
        out.append({"slots": nd, "shared": _shares_cards(mesh),
                    "reads_per_s": R / dt, "steady_s": dt, "warm_s": warm})
    shared = any(r["shared"] for r in out)
    print(f"scaling curve: fixed total work ({R} reads x {L} bp, seed + "
          f"locate) split over N data slots on {device}"
          + (" -- slots SHARE a device here, so this measures the split of "
             "the batch, not scaling" if shared or device == "cpu" else ""))
    for r in out:
        print(f"  slots={r['slots']}: per-slot batch {R // r['slots']} "
              f"reads: {r['reads_per_s']:,.0f} reads/s total "
              f"({r['steady_s']:.4f} s steady, {r['warm_s']:.4f} s first "
              "call)")
    return out


def giant_index() -> str | None:
    """The prefix of a GRCh38-class index to shard, where one exists:
    ``DART_TPU_GIANT_INDEX``, else ``$DART_TPU_BENCH_DIR/grch38_pe_bam/
    idx`` when its layout cache (``.wtab``) is there, as
    ``__graft_entry__`` finds it; None with ``DART_TPU_GIANT_DRYRUN=0``."""
    if os.environ.get("DART_TPU_GIANT_DRYRUN", "1") == "0":
        return None
    giant = os.environ.get("DART_TPU_GIANT_INDEX")
    bench_dir = os.environ.get("DART_TPU_BENCH_DIR")
    if giant is None and bench_dir:
        cand = os.path.join(bench_dir, "grch38_pe_bam", "idx")
        if os.path.exists(cand + ".wtab"):
            giant = cand
    return giant


def _read_fq_codes(path: str, n: int, L: int = 100):
    """The first n reads of a FASTQ file as (codes (n, L) uint8, lens)."""
    from .constants import NT4_TABLE

    codes = np.full((n, L), 4, dtype=np.uint8)
    lens = np.zeros(n, dtype=np.int32)
    with open(path, "rb") as f:
        for i in range(n):
            f.readline()
            seq = f.readline().strip()
            if not seq:
                return codes[:i], lens[:i]
            m = min(len(seq), L)
            codes[i, :m] = np.minimum(NT4_TABLE[np.frombuffer(seq[:m],
                                                              np.uint8)], 4)
            lens[i] = m
            f.readline()
            f.readline()
    return codes, lens


def giant_proof(n_devices: int, prefix: str, device="cuda",
                min_gib: float = 1.0) -> dict:
    """A wide table of ``min_gib`` GiB or more range-sharded over the
    grid: every shard at most its share of the table, and the seed scan
    of 48 reads and 1,024 locates on it (the seeds' rows, then random
    ones) equal to the single-device engine's. The result says how the
    layout cache served the sharded table (``cache``)."""
    from .parallel.mesh import ShardedFMIndexTorch, make_mesh

    t00 = time.perf_counter()
    idx = load_index(prefix)
    index_shards = min(4, n_devices) if n_devices % 4 == 0 else n_devices
    sharded = ShardedFMIndexTorch(idx, make_mesh(n_devices, index_shards,
                                                 device), wide=True)
    shards = sharded.groups[0].table.shards
    tab_gb = sum(t.nbytes for t in shards) / 2**30
    shard_gb = max(t.nbytes for t in shards) / 2**30
    _require(tab_gb >= min_gib, f"the giant proof needs a table of "
             f"{min_gib} GiB or more")
    _require(shard_gb <= tab_gb / index_shards + 0.01,
             "a shard holds more than its share")
    print(f"giant wide table sharded: seq_len={idx.seq_len:,} merged table "
          f"{tab_gb:.2f} GiB over index={index_shards} -> largest placed "
          f"shard {shard_gb:.2f} GiB, layout cache {sharded.cache} "
          f"[{time.perf_counter() - t00:.0f} s]")
    fq = os.path.join(os.path.dirname(prefix), "reads_100000_1.fq")
    if os.path.exists(fq):
        codes, rlens = _read_fq_codes(fq, 48)
    else:
        rng = np.random.default_rng(31)
        codes = np.stack([idx.ref_codes[p:p + 100] for p in
                          rng.integers(0, idx.genome_size - 100, 48)])
        rlens = np.full(48, 100, np.int32)
    got = sharded.seed_reads(codes, rlens)
    rows = got[3][got[4] >= 1].ravel().astype(np.int64)[:1024]
    # where the scan located every seed itself, random rows make the rest
    rows = np.concatenate([rows, np.random.default_rng(32).integers(
        1, idx.seq_len, 1024 - len(rows), dtype=np.int64)])
    got_locs = sharded.locate(rows)
    sharded_cache = sharded.cache
    del sharded
    single = FMIndexTorch(idx, device, wide=True)
    _same(got, single.seed_reads(codes, rlens), "giant seed scan")
    _same([got_locs], [single.locate(rows)], "giant locate")
    n_seeds = int(np.asarray(got[0]).sum())
    print(f"giant shard bit-equality ok: {len(rlens)} reads, {n_seeds} seeds "
          f"+ {len(rows)} located positions identical on the sharded and the "
          "single-device table")
    return {"table_gib": tab_gb, "shard_gib": shard_gb, "seeds": n_seeds,
            "cache": sharded_cache, "single_cache": single.cache}
