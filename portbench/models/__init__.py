"""A configuration's model module, found by the configuration file's `model`
key: `portbench/models/<model>.py`, `qwen3_tts` where the key is absent.

Everything of the benchmark that depends on the model's architecture goes
through its module, so that a configuration of another architecture comes
as a configuration file and a module beside the others, with no edit to the
harness, the judge, the taps or the readers. A module provides:

- `make_tree(cfg, seed, device)`: the parameter tree drawn from the seed on
  the device, in the port's layout and in the types it is served in;
  `quantize(tree)`: the port's parameters of that tree, as the
  configuration serves them (the one call into the program);
- `Reference(tree, cfg)`: the plain float32 reference, with
  `logits(inputs, frames, act)` -> (talker logits [T + 1, V], code
  predictor logits [T, codebooks - 1, Vp]), `decode(codes)` and
  `stream_audio(frames, chunk_frames, tf32=False, inputs=None)`;
- `processed(logits, cb0, cfg, sampling)`: the talker's logits after the
  program's processing, for the judge's greedy gap;
- the yardstick: `frame_launches(cfg, B)` and `prefill_launches(cfg, B)`
  (K2 launches as (rows, in, out)), `frame_flops(cfg, context)`,
  `window_flops(cfg, frames)`, `prompt_rows(req)`;
- `k2_bytes(rows, in, out)`: the bytes of each kernel whose roofline the
  benchmark reports.
"""
from __future__ import annotations

import importlib
import re
from typing import Any, Dict

DEFAULT = "qwen3_tts"
_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")


def of(cfg: Dict[str, Any]):
    """The model module of a configuration file's dict."""
    name = cfg.get("model", DEFAULT)
    if not _NAME.match(name):
        raise ValueError(f"model {name!r}: a model module's name is a Python identifier")
    return importlib.import_module(f"{__name__}.{name}")
