"""The check that decides `correct`, on the CPU at the tiny configuration:
the reference agrees with the port through each cell's whole run, a token
altered where the engine produces it makes `correct` false, the control
(the reference in float8 activations) reads far above the program, and the
runs load nothing of JAX."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 4242


def _run(cell, seconds=5.0, control=False):
    return harness.run_cell(tiny.tiny_res(cell), SEED, seconds, False, "cpu", time.perf_counter(), control=control)


@pytest.mark.parametrize("cell", ["tts06b.xvec.solo", "tts17b.customvoice.solo", "tts06b.xvec.open_cb8"])
def test_each_cell_served_and_judged_correct(cell):
    out = _run(cell, seconds=6.0)
    checks, w = out["checks"], out["window"]
    assert checks["judged"] >= 1 and checks["tokens"] > 100, checks
    assert checks["correct"], checks
    assert harness.attempted_failed(w)[1] == 0 and w["captures_in_window"] == 0


def test_a_token_altered_where_it_is_produced_is_caught(monkeypatch):
    """The talker's next codebook-0 token, moved to another acoustic id inside
    the engine every second draw, is served; the check must see it."""
    from faster_qwen3_tts_tpu_torch.engine import core

    orig = core.sample_logits
    calls = [0]

    def altered(logits, *a, **k):
        tok = orig(logits, *a, **k)
        calls[0] += 1
        if calls[0] % 2 == 0:
            tok = torch.where(tok < 2048, (tok + 1024) % 2048, tok)
        return tok

    monkeypatch.setattr(core, "sample_logits", altered)
    out = _run("tts06b.xvec.solo", seconds=8.0)
    assert calls[0] > 0 and out["checks"]["judged"] >= 1
    assert not out["checks"]["correct"]
    assert out["checks"]["numbers"]["talker_gap"]["value"] > out["checks"]["numbers"]["talker_gap"]["limit"]


def test_the_control_reads_far_above_the_program():
    c = _run("tts06b.xvec.solo", control=True)["checks"]
    program = {k: d["value"] for k, d in c["numbers"].items()}
    ctl = c["control"]
    assert max(ctl["talker_gap"] / max(program["talker_gap"], 1e-3),
               ctl["predictor_gap"] / max(program["predictor_gap"], 1e-3)) >= 3.0, (program, ctl)


FRESH = textwrap.dedent("""
    import json, sys, time
    sys.path.insert(0, {root!r})
    from portbench import harness
    from portbench.tests import tiny
    out = harness.run_cell(tiny.tiny_res("tts06b.xvec.solo"), 5, 1.0, False, "cpu", time.perf_counter())
    print(json.dumps(harness.forbidden_modules()))
""")


def test_a_run_loads_nothing_of_jax():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", FRESH.format(root=str(ROOT))], capture_output=True, text=True,
                         env=env, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import portbench.reference.model, portbench.maker; "
            "print([m for m in sys.modules if m.split('.')[0].startswith('faster_qwen3_tts_tpu')])" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_the_measurement_path_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "tts06b.xvec.solo", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, env=env,
                         timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
