"""Qwen3-TTS: a dense Qwen3 talker, a code predictor over 15 codebooks and a
causal convolution codec. The default model module (`portbench/models`):
it hands out the benchmark's tree maker (`maker.py`), reference
(`reference/model.py`) and yardstick (`shapes.py`) as they are."""
from __future__ import annotations

import torch

from portbench import maker, shapes
from portbench.reference import model as ref_lib

make_tree = maker.make_tree
Reference = ref_lib.Reference

frame_launches = shapes.frame_launches
prefill_launches = shapes.prefill_launches
frame_flops = shapes.frame_flops
window_flops = shapes.window_flops
prompt_rows = shapes.prompt_rows
k2_bytes = shapes.k2_bytes


def quantize(tree):
    """The tree's talker and code predictor projections in Q8_0, by the port."""
    from faster_qwen3_tts_tpu_torch.ops import quant

    return quant.quantize_model_params(tree, "int8")


def processed(logits: torch.Tensor, cb0: torch.Tensor, cfg, sampling) -> torch.Tensor:
    """The talker's logits [T + 1, V] after the program's processing for the
    greedy pick of each position (row t picks frame t's codebook-0 token):
    the repetition penalty over the tokens served before, the control band
    suppressed, EOS suppressed before min_new_tokens."""
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
