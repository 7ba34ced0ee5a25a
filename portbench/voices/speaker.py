"""A preset speaker (CustomVoice): a voice is the name of one of the
configuration's speakers, whose codec embedding is the prompt's speaker row."""
from __future__ import annotations

from typing import Any, Dict, List

KEY = "speaker"
HOST_VOCODER = False


def labels(params: Dict[str, Any]) -> List[str]:
    return list(params["speakers"])


def draw(params: Dict[str, Any], seed: int, cfg: Dict[str, Any]) -> List[str]:
    return list(params["speakers"])


def program(voices, req: Dict[str, Any]) -> Dict[str, Any]:
    return {"speaker": req["speaker"]}


def reference(voices, req: Dict[str, Any]) -> Dict[str, Any]:
    return {"speaker": req["speaker"]}


def extra_prompt_rows(params: Dict[str, Any]) -> int:
    return 0
