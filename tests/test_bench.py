"""Smoke test of bench.py's measurement contract: one JSON line with the
identity gate, stage seconds and the device it ran on (here the CPU,
asked for explicitly with JAX_PLATFORMS=cpu)."""

import json
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_bench_json_contract_cpu():
    env = dict(os.environ,
               JAX_PLATFORMS="cpu",
               BENCH_GLEN="100000", BENCH_NREADS="20",
               BENCH_VARIANTS="0", BENCH_REPEATS="1")
    r = subprocess.run([sys.executable, str(REPO / "bench.py")],
                       env=env, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    line = r.stdout.strip().splitlines()[-1]
    out = json.loads(line)
    assert "error" not in out, out
    assert out["las_identical_to_reference"] is True
    assert out["value"] > 0
    assert out["platform"] == "cpu"
    assert out["device_count"] >= 1
    assert "align" in out["stage_seconds"]
    assert out["vs_baseline"] > 0
