"""`device_overlap_pct.*`: the share of the device operations' time that
ran beside another operation, from the two sums `taps.reduce_trace` takes
over one event list."""
from __future__ import annotations

from pathlib import Path

import pytest

from portbench import harness, taps

ROOT = Path(__file__).resolve().parents[2]
NAMES = ["device_overlap_pct.solo", "device_overlap_pct.cb8"]


def _metric(name):
    return harness.load_module(ROOT / "portbench" / "metrics" / f"{name}.py")


@pytest.mark.parametrize("name", NAMES)
def test_overlap_of_a_chained_trace(name):
    # K5 ends at 10 us; the next K2 starts at 6 us beside it and ends at 20; a copy after a gap
    dev = [("add_rms_norm_kernel", 0.0, 10.0), ("int8_gemv_kernel<1>", 6.0, 20.0), ("copy", 30.0, 36.0)]
    r = taps.reduce_trace(dev, [], window_s=40e-6)
    assert _metric(name).read({"trace": r}) == pytest.approx(100 * 4 / 30)


@pytest.mark.parametrize("name", NAMES)
def test_no_overlap_one_kernel_after_another(name):
    dev = [("add_rms_norm_kernel", 0.0, 10.0), ("int8_gemv_kernel<1>", 10.0, 20.0), ("copy", 21.0, 22.0)]
    assert _metric(name).read({"trace": taps.reduce_trace(dev, [], window_s=30e-6)}) == pytest.approx(0.0)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read(name):
    assert _metric(name).read({"trace": None}) is None
    assert _metric(name).read({}) is None
    assert _metric(name).read({"trace": taps.reduce_trace([], [], window_s=1.0)}) is None


@pytest.mark.parametrize("name", NAMES)
def test_each_resolves_for_its_cells(name):
    cells = {"device_overlap_pct.solo": {"tts17b.customvoice.solo", "tts06b.xvec.solo"},
             "device_overlap_pct.cb8": {"tts06b.xvec.open_cb8"}}[name]
    for cell in ("tts17b.customvoice.solo", "tts06b.xvec.solo", "tts06b.xvec.open_cb8"):
        assert (name in [m["name"] for m in harness.resolve(cell)["per_layer"]]) == (cell in cells)
