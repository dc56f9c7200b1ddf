"""On the card: a short run of every cell, traced and untraced, prints a
correct result line of the contract's shape (``python -m pytest -m cuda
portbench/tests``; skipped without a card)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

REPO = Path(harness.__file__).resolve().parents[1]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_short_run_on_the_card(card, workload, trace):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload, "--seed", str(2**31 + 99),
                          "--seconds", "2", "--trace", str(trace)], cwd=REPO, capture_output=True, text=True,
                         timeout=360)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    kinds = BENCH["per_layer"] if trace else BENCH["end_to_end"]
    want = {m["name"] for m in kinds if workload in m.get("workloads", [workload])}
    assert want <= set(line["metrics"])
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert all(v["value"] <= 105 for k, v in line["metrics"].items() if k.endswith("_roofline"))
