"""Aligner configuration mirroring the reference CLI defaults
(Dart's src/main.cpp:101-117) flag-for-flag."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class DartConfig:
    index_prefix: str = ""
    read_files_1: list[str] = field(default_factory=list)
    read_files_2: list[str] = field(default_factory=list)
    output_file: str = "output.sam"
    output_format: int = 0  # 0: sam, 1: bam
    bam_level: int = 1      # BGZF zlib level; 1 favors the one-core
    # host (deflate ~halves PE+BAM wall at htslib's default 6); the
    # BAM record content is level-independent (--bam-level)
    sj_file: str = "junctions.tab"
    threads: int = 4
    max_gaps: int = 5
    max_dup_num: int = 100          # clamp [100, 10000] (main.cpp:176-177)
    max_intron_size: int = 500000   # clamp >= 100000 when set (main.cpp:187)
    min_intron_size: int = 5
    max_mismatch: int = 0           # -mis; reference default is 0 (global zero-init)
    pair_end: bool = False          # -p interleaved pairs
    multi_hit: bool = False         # -m
    unique_only: bool = False       # -unique
    find_all_junction: bool = False # -all_sj
    silent: bool = False
    debug: bool = False
    # extensions (not in the reference)
    engine: str = "auto"            # the port has one engine, chosen by
                                    # --device; any other value is refused
    batch_reads: int = 65536  # device batch; output-invariant; 2+
                              # chunks per 100k reads overlap host work
    mesh: str = ""            # --mesh data=N[,index=M] device grid
    native: bool = True       # C++ host pipeline (fallback: pure Python)
    checkpoint: bool = False  # per-chunk cursor persistence + resume
    # minimum seconds between checkpoint saves (0 = save every chunk).
    # A durable save (json + atomic rename) costs a fraction of a
    # second; long streams throttle it so a crash re-does at most
    # ckpt_interval_s of work instead of paying the save per chunk
    ckpt_interval_s: float = 0.0
    stats: bool = False       # per-stage timing report on stderr
    profile_dir: str = ""     # write a torch.profiler trace here
    # multi-host run (torch.distributed); nprocs > 1 activates
    dist_coordinator: str = "127.0.0.1:49178"
    dist_nprocs: int = 1
    dist_pid: int = 0
