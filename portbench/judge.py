"""Whether what the window served is correct: the served tokens and audio
against the plain reference (`reference/model.py`).

Once the window has closed and the program is freed, a sample of the
requests the window finished (the longest one, and others drawn from the
seed, `JUDGED` in all) goes to the reference with its prompt inputs and its
served frames. Per request:

- talker_gap: at every codebook-0 position (and, where the stream ended on
  EOS, at the position after its last frame, for EOS), how far the served
  token's logit lies below the reference's best, both after the program's
  logit processing (repetition penalty over the tokens served before, the
  control band suppressed, EOS suppressed before min_new_tokens). Greedy
  tokens: 0 up to rounding.
- predictor_gap (greedy code predictor): the same at codebooks 1-15;
  predictor_topk_excess (a code predictor that samples top-k): how far the
  served token lies below the reference's k-th best logit, since a sampled
  token must come from the top k.
- audio_err: the largest difference between a served sample and the
  reference's, every chunk by the streaming window rule.
- audio_len_mismatch: chunks whose sample count differs from the rule's.

The control (`--calibrate`) reads the same numbers for the reference in the
precision below the configuration's: activations in float8 (the token that
precision puts first, judged against the float32 reference; for a sampling
code predictor the worst token of that precision's top k), the codec with
TF32 on.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from . import maker
from .reference import model as ref_lib

JUDGED = 16
TOP_K = 50  # the code predictor's top-k when it samples (the port's default)


def sample(records: List[Dict[str, Any]], seed: int, n: int = JUDGED) -> List[Dict[str, Any]]:
    done = [r for r in records if r["finished"] and sum(c[2] for c in r["chunks"]) > 0]
    if not done:
        return []
    longest = max(done, key=lambda r: sum(c[2] for c in r["chunks"]))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng(int(seed) + 17)
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[i] for i in sorted(pick)]


def _processed(logits: torch.Tensor, cb0: torch.Tensor, cfg, sampling) -> torch.Tensor:
    """The talker's logits [T + 1, V] after the program's processing for the
    greedy pick of each position (row t picks frame t's codebook-0 token)."""
    V, eos = cfg["talker"]["vocab_size"], cfg["talker"]["codec_eos_token_id"]
    rp, min_new = sampling.get("repetition_penalty", 1.05), sampling.get("min_new_tokens", 2)
    n = logits.shape[0]
    onehot = torch.nn.functional.one_hot(cb0.long(), V).bool()  # [T, V]
    seen = torch.zeros(n, V, dtype=torch.bool, device=logits.device)
    if cb0.numel():
        seen[1:] = onehot.cumsum(0)[: n - 1].bool()
    if rp != 1.0:
        logits = torch.where(seen, torch.where(logits > 0, logits / rp, logits * rp), logits)
    ids = torch.arange(V, device=logits.device)
    logits = torch.where(((ids >= V - 1024) & (ids != eos))[None], ref_lib._NEG, logits)
    early = (torch.arange(n, device=logits.device) < min_new)[:, None] & (ids == eos)[None]
    return torch.where(early, ref_lib._NEG, logits)


def _gap(ref: torch.Tensor, tokens: torch.Tensor) -> float:
    """Largest gap of `tokens` below the best of `ref` [..., V]."""
    if not tokens.numel():
        return 0.0
    return float((ref.max(-1).values - ref.gather(-1, tokens.long()[..., None])[..., 0]).max())


def request_inputs(rec, voices) -> Dict[str, Any]:
    req = rec["req"]
    out = {"text": req["text"], "language": req["language"]}
    if "speaker" in req:
        out["speaker"] = req["speaker"]
    else:
        out["xvector"] = voices[req["voice"]]
    return out


def check(window, cfg, workload, seed: int, device, control: bool = False) -> Dict[str, Any]:
    """-> {"numbers": {name: {value, limit}}, "correct": bool, "judged": n,
    "tokens": n, and with control the control's numbers}."""
    sampling = workload["sampling"]
    greedy_pred = sampling.get("subtalker_dosample") is False
    recs = sample(window["records"], seed)
    ref = ref_lib.Reference(maker.make_tree(cfg, seed, device), cfg)
    voices = [v for v in maker.voices(seed, workload["traffic_params"].get("voices", 1), "cpu").numpy()]
    eos = cfg["talker"]["codec_eos_token_id"]
    num = {"talker_gap": 0.0, "predictor_gap" if greedy_pred else "predictor_topk_excess": 0.0,
           "audio_err": 0.0, "audio_len_mismatch": 0.0}
    ctl = {"talker_gap": 0.0, "predictor_gap": 0.0, "audio_err": 0.0}
    tokens = 0
    with torch.no_grad():
        for rec in recs:
            frames = torch.as_tensor(np.concatenate(rec["frames"]), device=ref.device)
            steps = [c[2] for c in rec["chunks"]]
            inputs = request_inputs(rec, voices)
            tl, pl = ref.logits(inputs, frames)
            T = frames.shape[0]
            proc = _processed(tl, frames[:, 0], cfg, sampling)
            served0 = frames[:, 0]
            rows = T
            if rec["eos"]:
                served0, rows = torch.cat([served0, served0.new_tensor([eos])]), T + 1
            num["talker_gap"] = max(num["talker_gap"], _gap(proc[:rows], served0))
            if greedy_pred:
                num["predictor_gap"] = max(num["predictor_gap"], _gap(pl, frames[:, 1:]))
            else:
                kth = pl.topk(TOP_K, dim=-1).values[..., -1]
                served = pl.gather(-1, frames[:, 1:].long()[..., None])[..., 0]
                num["predictor_topk_excess"] = max(num["predictor_topk_excess"], float((kth - served).max()))
            tokens += rows + 15 * T
            want = ref.stream_audio(frames, steps)
            for got, exp in zip(rec["audio"], want):
                if len(got) != exp.shape[0]:
                    num["audio_len_mismatch"] += 1
                elif len(got):
                    num["audio_err"] = max(num["audio_err"], float(np.abs(got - exp.cpu().numpy()).max()))
            if control:
                cl, cp = ref.logits(inputs, frames, act=ref_lib.fp8_rows)
                cproc = _processed(cl, frames[:, 0], cfg, sampling)
                ctl["talker_gap"] = max(ctl["talker_gap"], _gap(proc[:T], cproc[:T].argmax(-1)))
                ctl["predictor_gap"] = max(ctl["predictor_gap"], _gap(pl, cp.argmax(-1)))
                if not greedy_pred:  # the worst token the control's top k could give
                    worst = pl.gather(-1, cp.topk(TOP_K, dim=-1).indices).min(-1).values
                    kth = pl.topk(TOP_K, dim=-1).values[..., -1]
                    ctl["predictor_topk_excess"] = max(ctl.get("predictor_topk_excess", 0.0),
                                                       float((kth - worst).max()))
                low = ref.stream_audio(frames, steps, tf32=True)
                for exp, lo in zip(want, low):
                    if exp.numel():
                        ctl["audio_err"] = max(ctl["audio_err"], float((exp - lo).abs().max()))
    limits = workload["correct"]["limits"]
    numbers = {k: {"value": v, "limit": limits.get(k)} for k, v in num.items()}
    ok = bool(recs) and all(d["limit"] is not None and d["value"] <= d["limit"] for d in numbers.values())
    out = {"numbers": numbers, "correct": ok, "judged": len(recs), "tokens": tokens}
    if control:
        out["control"] = ctl
    del ref
    return out
