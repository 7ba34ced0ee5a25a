"""A tiny configuration and cell for the benchmark's CPU tests."""
from __future__ import annotations

import copy
import dataclasses
import json

from portbench import harness

SPEAKERS = {"aiden": 2180, "serena": 2181, "dylan": 2182, "eric": 2183, "ono": 2184, "sohee": 2185, "uma": 2186,
            "vivian": 2187, "ryan": 2188}
DIALECT = {"dylan": "beijing_dialect", "eric": "sichuan_dialect"}


def tiny_cfg(model_type: str = "base") -> dict:
    """The port's miniature full-stack geometry, as a configuration file's dict."""
    from faster_qwen3_tts_tpu_torch.config import tiny_test_config

    d = json.loads(json.dumps(dataclasses.asdict(tiny_test_config(model_type)), default=dict))
    d.update(tts_bos_token_id=300, tts_eos_token_id=301, tts_pad_token_id=302)
    if model_type == "custom_voice":
        d["talker"]["spk_id"] = dict(SPEAKERS)
        d["talker"]["spk_is_dialect"] = {k: DIALECT.get(k, False) for k in SPEAKERS}
    return d


def tiny_res(cell: str, rate: float = 2.0) -> dict:
    """resolve() of a committed cell with the tiny configuration in its place."""
    res = harness.resolve(cell)
    res = copy.deepcopy(res)
    model_type = "custom_voice" if "customvoice" in cell else "base"
    res["cfg"] = tiny_cfg(model_type)
    w = res["workload"]
    w["entry"].update(max_seq_len=512, warm_frames=4)
    w["traffic_params"].update(median_frames=6, min_frames=4, max_frames=8)
    if "rate" in w:
        w["rate"] = rate
    return res
