"""Whether what the window served is correct: the served tokens and audio
against the plain reference of the configuration's model module
(`portbench/models`; Qwen3-TTS's is `reference/model.py`).

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
  reference's, every chunk by the streaming window rule (for an ICL voice,
  with the reference codes prepended until 24 frames exist, as the host
  vocoder does).
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

from . import models, voices as voice_kinds
from .reference.model import fp8_rows

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


def _gap(ref: torch.Tensor, tokens: torch.Tensor) -> float:
    """Largest gap of `tokens` below the best of `ref` [..., V]."""
    if not tokens.numel():
        return 0.0
    return float((ref.max(-1).values - ref.gather(-1, tokens.long()[..., None])[..., 0]).max())


def request_inputs(rec, voices, kind) -> Dict[str, Any]:
    """The reference's inputs for a served request: its text and language,
    and its voice as the mix's kind of voice gives it."""
    req = rec["req"]
    return {"text": req["text"], "language": req["language"], **kind.reference(voices, req)}


def check(window, cfg, workload, seed: int, device, control: bool = False) -> Dict[str, Any]:
    """-> {"numbers": {name: {value, limit}}, "correct": bool, "judged": n,
    "tokens": n, and with control the control's numbers}."""
    sampling = workload["sampling"]
    greedy_pred = sampling.get("subtalker_dosample") is False
    recs = sample(window["records"], seed)
    mod = models.of(cfg)
    ref = mod.Reference(mod.make_tree(cfg, seed, device), cfg)
    kind = voice_kinds.of(workload["traffic_params"])
    voices = kind.draw(workload["traffic_params"], seed, cfg)
    eos = cfg["talker"]["codec_eos_token_id"]
    num = {"talker_gap": 0.0, "predictor_gap" if greedy_pred else "predictor_topk_excess": 0.0,
           "audio_err": 0.0, "audio_len_mismatch": 0.0}
    ctl = {"talker_gap": 0.0, "predictor_gap": 0.0, "audio_err": 0.0}
    tokens = 0
    with torch.no_grad():
        for rec in recs:
            frames = torch.as_tensor(np.concatenate(rec["frames"]), device=ref.device)
            steps = [c[2] for c in rec["chunks"]]
            inputs = request_inputs(rec, voices, kind)
            tl, pl = ref.logits(inputs, frames)
            T = frames.shape[0]
            proc = mod.processed(tl, frames[:, 0], cfg, sampling)
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
            tokens += rows + pl.shape[1] * T
            want = ref.stream_audio(frames, steps, inputs=inputs)
            for got, exp in zip(rec["audio"], want):
                if len(got) != exp.shape[0]:
                    num["audio_len_mismatch"] += 1
                elif len(got):
                    num["audio_err"] = max(num["audio_err"], float(np.abs(got - exp.cpu().numpy()).max()))
            if control:
                cl, cp = ref.logits(inputs, frames, act=fp8_rows)
                cproc = mod.processed(cl, frames[:, 0], cfg, sampling)
                ctl["talker_gap"] = max(ctl["talker_gap"], _gap(proc[:T], cproc[:T].argmax(-1)))
                ctl["predictor_gap"] = max(ctl["predictor_gap"], _gap(pl, cp.argmax(-1)))
                if not greedy_pred:  # the worst token the control's top k could give
                    worst = pl.gather(-1, cp.topk(TOP_K, dim=-1).indices).min(-1).values
                    kth = pl.topk(TOP_K, dim=-1).values[..., -1]
                    ctl["predictor_topk_excess"] = max(ctl.get("predictor_topk_excess", 0.0),
                                                       float((kth - worst).max()))
                low = ref.stream_audio(frames, steps, tf32=True, inputs=inputs)
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
