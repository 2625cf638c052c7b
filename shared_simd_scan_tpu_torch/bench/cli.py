"""Benchmark CLI (the reference's src/main.cpp:12-103), on the card.

Usage (the reference's positional convention, ``_`` = default):

    python -m shared_simd_scan_tpu_torch.bench [data_size] [repetitions] [bench] [args]

    data_size    packed payload bytes (suffixes k/m/g), default 500m
    repetitions  timing trials, default 5
    bench        memory | decompression | scan | sharedscan | pack |
                 linear | member | conj | aggregate | histogram |
                 scaling | all
    args         sharedscan/linear/member/aggregate/scaling: predicate
                 count k (default 8); conj: column count m (default 2);
                 histogram: key count k (default: full domain, <= 4096)

With no arguments the default suite runs, with sharedscan at data_size/8,
as the reference does with none (main.cpp:75-102).  ``--width=W`` (default
9) sets the packed width.  ``scaling`` runs the sharded shared scan at
data_size/8 a device over meshes of 1, 2, 4, ... of the machine's cards.

Every bench runs on the CUDA card; without one the CLI exits with 1.
"""
from __future__ import annotations

import subprocess
import sys

import torch

from shared_simd_scan_tpu_torch.bench import harness

BENCHES = ("memory", "decompression", "scan", "sharedscan", "pack", "linear", "member", "conj",
           "aggregate", "histogram", "scaling", "all")


def parse_size(s: str) -> int:
    """'512m' / '64k' / '2g' / plain bytes -> int."""
    s = s.lower()
    mult = 1
    if s and s[-1] in "kmg":
        mult = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}[s[-1]]
        s = s[:-1]
    return int(s) * mult


def parse_args(argv: list[str]) -> tuple[int, int, str | None, list[str], int]:
    """argv -> (data_size, reps, bench or None, bench args, width); raises
    ValueError on a malformed size, count or width."""
    argv = list(argv)
    width = harness.DEFAULT_WIDTH
    for a in list(argv):
        if a.startswith("--width="):
            width = int(a.split("=", 1)[1])
            argv.remove(a)
    data_size = harness.DEFAULT_DATA_SIZE
    reps = harness.DEFAULT_REPETITIONS
    bench, bench_args = None, []
    if argv and argv[0] != "_":
        data_size = parse_size(argv[0])
    if len(argv) > 1 and argv[1] != "_":
        reps = int(argv[1])
    if len(argv) > 2:
        bench, bench_args = argv[2], argv[3:]
    return data_size, reps, bench, bench_args, width


def _usage() -> str:
    return __doc__


def _card() -> str:
    """Card 0 as nvidia-smi names it, with its power limit."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, check=True, timeout=60)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(0)}, power limit not read (nvidia-smi failed)"


def _run(bench: str, bench_args: list[str], data_size: int, reps: int, width: int) -> None:
    def arg(default):
        return int(bench_args[0]) if bench_args else default

    if bench in ("all", None):
        suite = {"memory": lambda: harness.bench_memory(data_size, reps),
                 "decompression": lambda: harness.bench_decompression(data_size, reps, width),
                 "scan": lambda: harness.bench_scan(data_size, reps, width),
                 "sharedscan": lambda: harness.bench_shared_scan(data_size // 8, reps, 8, width),
                 "pack": lambda: harness.bench_pack(data_size, reps, width)}
        if bench is None:  # no arguments: the reference's four
            del suite["pack"]
        for name, run in suite.items():
            print(f"## {name}")
            run()
    elif bench == "memory":
        harness.bench_memory(data_size, reps)
    elif bench == "decompression":
        harness.bench_decompression(data_size, reps, width)
    elif bench == "scan":
        harness.bench_scan(data_size, reps, width)
    elif bench == "sharedscan":
        harness.bench_shared_scan(data_size, reps, arg(8), width)
    elif bench == "pack":
        harness.bench_pack(data_size, reps, width)
    elif bench == "linear":
        harness.bench_linear(data_size, reps, arg(8), width)
    elif bench == "member":
        harness.bench_member(data_size, reps, arg(8), width)
    elif bench == "conj":
        harness.bench_conj(data_size, reps, arg(2), width)
    elif bench == "aggregate":
        harness.bench_aggregate(data_size, reps, arg(8), width)
    elif bench == "scaling":
        from shared_simd_scan_tpu_torch.bench.scaling import bench_scaling

        bench_scaling(data_size // 8, reps, arg(8), width)
    else:
        harness.bench_histogram(data_size, reps, arg(None), width)


def main(argv: list[str] | None = None) -> int:
    try:
        data_size, reps, bench, bench_args, width = parse_args(
            sys.argv[1:] if argv is None else argv)
    except ValueError as e:
        print(_usage())
        print(f"error: {e}", file=sys.stderr)
        return 1
    if bench is not None and bench not in BENCHES:
        print(_usage())
        print(f"error: unknown bench '{bench}'", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("error: no CUDA device (torch.cuda.is_available() is false); the benchmark runs "
              "only on the card", file=sys.stderr)
        return 1
    print(f"# shared_simd_scan_tpu_torch bench on {_card()} "
          f"({torch.cuda.device_count()} device(s)); width={width}, "
          f"data_size={data_size}, reps={reps}")
    if bench is None:
        print(_usage())
    _run(bench, bench_args, data_size, reps, width)
    return 0
