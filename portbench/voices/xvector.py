"""x-vector voice clone: a voice is a 2048-d speaker embedding drawn from the
seed (`maker.voices`), the prompt's speaker row; the first text token sits in
the prompt and lanes move to the device's window vocode at 24 frames."""
from __future__ import annotations

from typing import Any, Dict, List

from portbench import maker

KEY = "voice"
HOST_VOCODER = False


def labels(params: Dict[str, Any]) -> List[int]:
    return list(range(params["voices"]))


def draw(params: Dict[str, Any], seed: int, cfg: Dict[str, Any]) -> list:
    return [v for v in maker.voices(seed, params.get("voices", 1), "cpu").numpy()]


def program(voices, req: Dict[str, Any]) -> Dict[str, Any]:
    return {"voice_clone_prompt": {"ref_spk_embedding": [voices[req["voice"]]], "x_vector_only_mode": [True],
                                   "icl_mode": [False], "ref_code": [None]}}


def reference(voices, req: Dict[str, Any]) -> Dict[str, Any]:
    return {"xvector": voices[req["voice"]]}


def extra_prompt_rows(params: Dict[str, Any]) -> int:
    return 0
