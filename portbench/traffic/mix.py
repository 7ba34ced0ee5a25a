"""The general traffic generator: a cell's mix parameters and a seed -> requests.

Every seed gets the same multiset of sizes (and, in an open loop, of gaps
between arrivals) in another order, so runs with different seeds do the
same work: output lengths are the quantiles (i + 0.5) / n of a lognormal
clipped to [lo, hi], dealt in rounds that take one length from each of 8
strata, so every prefix of 8k requests holds the same mix. Gaps are the
quantiles of an exponential at the offered rate, shuffled. Texts are ASCII
letters and spaces, ceil(frames / frames_per_token) bytes (one id each under
the byte tokenizer). Voices are the labels of the mix's kind of voice
(`portbench/voices`: x-vector or ICL voice indices, preset speakers) dealt
evenly.
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import Any, Dict, List

import numpy as np

from portbench import voices as voice_kinds

_STRATA = 8
_LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz     ", dtype=np.uint8)


def _stratified_order(sorted_values: np.ndarray, rng) -> np.ndarray:
    strata = [rng.permutation(s) for s in np.array_split(sorted_values, _STRATA)]
    out = []
    for r in range(max(len(s) for s in strata)):
        for k in rng.permutation(len(strata)):
            if r < len(strata[k]):
                out.append(strata[k][r])
    return np.asarray(out)


def frames(mix: Dict[str, Any], n: int, rng) -> np.ndarray:
    """n output lengths in frames, stratified lognormal quantiles."""
    nd = NormalDist()
    q = [mix["median_frames"] * math.exp(mix["sigma"] * nd.inv_cdf((i + 0.5) / n)) for i in range(n)]
    sizes = np.clip(np.rint(q), mix["min_frames"], mix["max_frames"]).astype(np.int64)
    return _stratified_order(np.sort(sizes), rng)


def arrivals(rate: float, n: int, seconds: float, rng) -> np.ndarray:
    """n arrival offsets in [0, seconds): shuffled exponential quantile gaps
    at `rate`, scaled so that the last one falls inside the window."""
    gaps = rng.permutation(np.array([-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)]))
    t = np.cumsum(gaps)
    return t * (seconds * (n - 0.5) / n) / t[-1]


def make(mix: Dict[str, Any], seed: int, n: int) -> List[Dict[str, Any]]:
    """n requests: {index, frames (the max_new_tokens), text, language, and
    the kind's key: voice (an index into the mix's voices) or speaker (a
    preset name)}."""
    rng = np.random.default_rng(int(seed))
    lengths = frames(mix, n, rng)
    per = mix.get("frames_per_token", 3.2)
    kind = voice_kinds.of(mix)
    voices = kind.labels(mix)
    dealt = rng.permutation(np.arange(n) % len(voices))
    out = []
    for i in range(n):
        nbytes = math.ceil(int(lengths[i]) / per)
        text = bytes(rng.choice(_LETTERS, nbytes)).decode("ascii")
        text = "A" + text[1:]  # never starts with a space
        req = {"index": i, "frames": int(lengths[i]), "text": text, "language": mix.get("language", "English")}
        req[kind.KEY] = voices[dealt[i]]
        out.append(req)
    return out
