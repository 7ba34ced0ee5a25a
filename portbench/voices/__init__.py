"""A traffic mix's kind of voice, found by its `voice_kind` parameter:
`portbench/voices/<kind>.py`. Where the parameter is absent the kind is
inferred: a mix that lists `speakers` is `speaker`, any other `xvector`.

A kind is what differs between voice prompts, so that a mix of another kind
comes as a file beside the others, with no edit to the traffic generator,
the drivers or the judge. A kind module provides:

- `KEY`: the request's key that names its voice (`voice`, `speaker`), and
  `labels(params)`: the labels `traffic/mix.py` deals to the requests in
  turn (its random stream does not depend on the kind);
- `draw(params, seed, cfg)`: the mix's voices, drawn from the seed by a
  generator of the kind's own;
- `program(voices, req)`: the keyword arguments of the program's call that
  carry the request's voice (`voice_clone_prompt`, `ref_text`, `speaker`);
- `reference(voices, req)`: the reference's inputs for the voice (beside
  the text and language);
- `extra_prompt_rows(params)`: the prompt rows the kind adds to the model
  module's `prompt_rows`;
- `HOST_VOCODER`: whether a batcher lane of this kind stays on its host
  vocoder for its whole stream (no window vocode of its on the device).
"""
from __future__ import annotations

import importlib
import re
from typing import Any, Dict

_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")


def kind_name(params: Dict[str, Any]) -> str:
    return params.get("voice_kind") or ("speaker" if params.get("speakers") else "xvector")


def of(params: Dict[str, Any]):
    """The kind module of a mix's traffic parameters."""
    name = kind_name(params)
    if not _NAME.match(name):
        raise ValueError(f"voice_kind {name!r}: a kind's name is a Python identifier")
    return importlib.import_module(f"{__name__}.{name}")
