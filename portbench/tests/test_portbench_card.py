"""The control at each cell's own size, on the card (skips without one):
`run.py --calibrate 3` reads the check's numbers for the program and for the
reference in the precision below the configuration's, on three seeds. The
program must pass every limit and the control must fail one on every seed.
On the card: `python -m pytest portbench/tests/test_portbench_card.py -q`
(about 2 minutes a cell)."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [c["name"] for c in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_and_the_program_passes_at_full_size(card, cell):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed", str(2 ** 31 + 7),
                          "--seconds", "20", "--calibrate", "3"], capture_output=True, text=True, cwd=ROOT,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    limits = json.loads((ROOT / "portbench" / "workloads" / f"{cell}.json").read_text())["correct"]["limits"]
    rows = [json.loads(line) for line in out.stdout.splitlines() if line.startswith('{"seed"')]
    assert len(rows) == 3
    for row in rows:
        assert row["failed"] == 0 and row["judged"] >= 1
        assert all(v <= limits[k] for k, v in row["program"].items()), row
        assert any(v > limits[k] for k, v in row["control"].items() if k in limits), row
