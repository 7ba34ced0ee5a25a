"""In-context voice clone (ICL): a voice is a reference clip's codec codes,
its transcript and its x-vector. The prompt holds the reference block (the
transcript's text rows over codec_bos and the reference frames' embeddings)
in place of the first text token, the whole text is fed a frame at a time,
and a batcher lane stays on its host vocoder, which prepends the reference
codes until the stream has 24 frames of its own.

Each of the mix's `voices` has `ref_frames` frames of codes, uniform over the
codec's codebooks, and a transcript of ceil(ref_frames / frames_per_token)
bytes of the traffic generator's letters, both from a generator of this
kind's own; its x-vector is the x-vector kind's voice of the same index."""
from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np

from portbench.voices import xvector

KEY = "voice"
HOST_VOCODER = True
_LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz     ", dtype=np.uint8)


def labels(params: Dict[str, Any]) -> List[int]:
    return list(range(params["voices"]))


def draw(params: Dict[str, Any], seed: int, cfg) -> List[Dict[str, Any]]:
    xvs = xvector.draw(params, seed, cfg)
    rng = np.random.default_rng((int(seed) + 104729) % (2 ** 63))
    c = cfg["codec"]
    T, nbytes = params["ref_frames"], math.ceil(params["ref_frames"] / params.get("frames_per_token", 3.2))
    out = []
    for xv in xvs:
        codes = rng.integers(0, c["codebook_size"], (T, c["num_quantizers"]), dtype=np.int64).astype(np.int32)
        text = "A" + bytes(rng.choice(_LETTERS, nbytes)).decode("ascii")[1:]
        out.append({"xvector": xv, "ref_code": codes, "ref_text": text})
    return out


def program(voices, req: Dict[str, Any]) -> Dict[str, Any]:
    v = voices[req["voice"]]
    return {"voice_clone_prompt": {"ref_spk_embedding": [v["xvector"]], "x_vector_only_mode": [False],
                                   "icl_mode": [True], "ref_code": [v["ref_code"]]},
            "ref_text": v["ref_text"]}


def reference(voices, req: Dict[str, Any]) -> Dict[str, Any]:
    v = voices[req["voice"]]
    return {"xvector": v["xvector"], "ref_code": v["ref_code"], "ref_text": v["ref_text"]}


def extra_prompt_rows(params: Dict[str, Any]) -> int:
    """The reference block's ref_frames + 1 rows take the place of the first
    text token's row."""
    return params["ref_frames"]
