"""Runs of the harness on the CPU at a tiny size, each in a process of its
own (as the benchmark runs), with the look for a card skipped."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ROWS = {"simdscan_9bit": 10007, "ssb_sf100": 50021}
CONTRACT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}

_CODE = """
import sys
sys.path.insert(0, {root!r})
from scanbench import harness
{setup}
sys.exit(harness.main({argv!r}, device="cpu", rows={rows}, bench_file={bench}))
"""


def rehearse(workload: str, *, seconds: float = 1.0, trace: int = 0, seed: int = 2147483659,
             extra=(), setup: str = "", bench: Path | None = None, rows: int | None = None):
    """-> (exit code, stdout, stderr) of one CPU run of ``workload``."""
    config = workload.split(".")[0]
    argv = ["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace), *extra]
    code = _CODE.format(root=str(ROOT), setup=setup, argv=argv, rows=rows or ROWS[config],
                        bench=repr(str(bench)) if bench else None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    return proc.returncode, proc.stdout, proc.stderr


def last_line(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])
