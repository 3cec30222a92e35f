"""Without a CUDA card the command fails and prints no result: it never
falls back to the CPU."""

import os
import subprocess
import sys
from pathlib import Path


ROOT = Path(__file__).resolve().parents[2]


def test_run_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")  # no card, also on a machine with one
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "pix2pix-train-b16",
                           "--seed", "3000000019", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr
