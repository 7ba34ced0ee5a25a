"""The port's logging helpers against the JAX package's: `format_timing`
gives the same line, `suppress_platform_warnings` quiets torch's loggers and
warnings inside its block and restores them on exit, and
`enable_profiler_trace` (the counterpart of `jax.profiler.trace`) writes a
Chrome trace of a tiny CPU generation, with the port's spans of its window on
their own row, on the profiler's clock."""
import dataclasses
import json
import logging
import warnings

import numpy as np
import pytest
import torch

from faster_qwen3_tts_tpu.utils import logging_utils as jax_logging
from faster_qwen3_tts_tpu_torch import weights
from faster_qwen3_tts_tpu_torch.config import tiny_test_config
from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS
from faster_qwen3_tts_tpu_torch.utils import logging_utils, trace
from faster_qwen3_tts_tpu_torch.utils.tokenizer import ByteTokenizer, PromptTokenizer

torch.set_num_threads(1)


@pytest.mark.parametrize("timing", [{}, {"steps": 25, "prefill_ms": 40.0, "decode_s": 0.5, "ms_per_step": 20.0}])
def test_format_timing_equals_jax(timing):
    assert logging_utils.format_timing(timing) == jax_logging.format_timing(timing)


def test_suppress_platform_warnings_restores_levels_on_exit():
    torch_log = logging.getLogger("torch")
    before = {name: logging.getLogger(name).level for name in logging_utils._PLATFORM_LOGGERS}
    torch_log.setLevel(logging.DEBUG)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with logging_utils.suppress_platform_warnings():
                assert all(logging.getLogger(n).level == logging.ERROR for n in logging_utils._PLATFORM_LOGGERS)
                warnings.warn_explicit("loader chatter", UserWarning, "x.py", 1, module="torch.cuda")
                warnings.warn("kept", RuntimeWarning)
            warnings.warn_explicit("after the block", UserWarning, "x.py", 1, module="torch.cuda")
        assert [str(w.message) for w in caught] == ["kept", "after the block"]
        assert torch_log.level == logging.DEBUG
        assert all(logging.getLogger(n).level == before[n] for n in logging_utils._PLATFORM_LOGGERS[1:])
    finally:
        torch_log.setLevel(before["torch"])


def test_enable_profiler_trace_writes_a_chrome_trace(tmp_path):
    cfg = dataclasses.replace(tiny_test_config(), tts_bos_token_id=300, tts_eos_token_id=301,
                              tts_pad_token_id=302)
    model = FasterQwen3TTS(weights.init_all(cfg, dtype=torch.float32, device="cpu"), cfg,
                           PromptTokenizer(ByteTokenizer()), max_seq_len=64)
    model.device_chunk = 2  # frames a chunk: a short window to profile
    with logging_utils.enable_profiler_trace(str(tmp_path / "trace")) as prof:
        (wav,), sr = model.generate_voice_clone("Hi.", "English", xvec_only=True, max_new_tokens=2, seed=0,
                                                voice_clone_prompt={"ref_spk_embedding": [np.ones(2048, np.float32)]})
    assert sr == 24000 and wav.size > 0
    files = list((tmp_path / "trace").glob("trace-*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("aten::" in n for n in names), sorted(names)[:20]
    assert prof.key_averages()


def test_enable_profiler_trace_adds_the_spans_of_its_window(tmp_path):
    a = torch.randn(64, 64)
    with trace.span("before"):
        pass
    with logging_utils.enable_profiler_trace(str(tmp_path / "trace")):
        with trace.span("outer", rid=3, value=2):
            torch.mm(a, a)
    (path,) = (tmp_path / "trace").glob("trace-*.json")
    events = json.loads(path.read_text())["traceEvents"]
    mine = [e for e in events if e.get("tid") == "fq3t" and e.get("ph") == "X"]
    assert [e["name"] for e in mine] == ["outer"]  # the window's spans only
    (outer,), (mm,) = mine, [e for e in events if e.get("name") == "aten::mm"]
    assert outer["cat"] == "fq3t" and outer["args"]["rid"] == 3 and outer["args"]["value"] == 2
    assert outer["ts"] - 1000 <= mm["ts"] <= outer["ts"] + outer["dur"] + 1000  # microseconds, within 1 ms
    assert mm["ts"] + mm["dur"] <= outer["ts"] + outer["dur"] + 1000
