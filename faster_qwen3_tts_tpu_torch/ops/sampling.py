"""Sampling ops: the port of faster_qwen3_tts_tpu/ops/sampling.py.

Same order of operations (HF order): suppress mask -> extra suppress ->
(argmax if greedy) -> temperature -> top-k -> top-p -> categorical draw.

The draw is split in two steps: `transform_logits` (everything up to the
draw) and `argmax(logits + gumbel)`. `jax.random.categorical(key, l)` is
exactly `argmax(l + jax.random.gumbel(key, l.shape))`, so feeding both
packages the same Gumbel noise gives the same tokens. The port draws its
noise from an explicit `torch.Generator`; it cannot reproduce JAX's key
schedule, so without shared noise the two agree only on greedy paths.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """The JAX package's SamplingParams (its module imports jax), same
    fields and defaults."""

    temperature: float = 0.9
    top_k: int = 50
    top_p: float = 1.0
    do_sample: bool = True
    repetition_penalty: float = 1.05


def apply_repetition_penalty(
    logits: torch.Tensor, seen_mask: torch.Tensor, repetition_penalty: float
) -> torch.Tensor:
    """HF repetition penalty over the tokens marked in `seen_mask` [..., V]."""
    if repetition_penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, logits / repetition_penalty, logits * repetition_penalty)
    return torch.where(seen_mask, penalized, logits)


def _mask_top_k(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    # drop what is below the k-th value: ties at the k-th value are kept
    k = min(top_k, logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, _NEG_INF, logits)


def _mask_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    # HF: remove once the cumulative probability exceeds top_p, keep the top token
    remove = cum > top_p
    remove[..., 0] = False
    threshold = torch.where(remove, torch.inf, sorted_logits).amin(dim=-1, keepdim=True)
    return torch.where(logits < threshold, _NEG_INF, logits)


def transform_logits(
    logits: torch.Tensor,
    params: SamplingParams,
    suppress_mask: Optional[torch.Tensor] = None,
    suppress_extra: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Everything `sample_logits` does before its draw, in f32. For a greedy
    configuration only the suppress masks apply."""
    logits = logits.float()
    if suppress_mask is not None:
        logits = torch.where(suppress_mask, _NEG_INF, logits)
    if suppress_extra is not None:
        logits = torch.where(suppress_extra, _NEG_INF, logits)
    if not params.do_sample:
        return logits
    logits = logits / params.temperature
    if params.top_k > 0:
        logits = _mask_top_k(logits, params.top_k)
    if params.top_p < 1.0:
        logits = _mask_top_p(logits, params.top_p)
    return logits


def gumbel_noise(shape, generator: torch.Generator, device: torch.device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), u uniform in [tiny, 1), from
    `generator` (as jax.random.gumbel). It is never +inf, so a token masked
    to -1e30 can never win the draw."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))


def sample_logits(
    logits: torch.Tensor,
    params: SamplingParams,
    suppress_mask: Optional[torch.Tensor] = None,
    suppress_extra: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Token ids [...] (int32) from logits [..., V].

    A sampling configuration draws with `noise` when given (tests feed the
    JAX key's Gumbel noise) and otherwise from `generator`."""
    logits = transform_logits(logits, params, suppress_mask, suppress_extra)
    if params.do_sample:
        if noise is None:
            noise = gumbel_noise(logits.shape, generator, logits.device)
        logits = logits + noise
    return torch.argmax(logits, dim=-1).to(torch.int32)


def make_suppress_mask(vocab_size: int, eos_id: int, device=None) -> torch.Tensor:
    """The top-1024 control ids except EOS are never sampled."""
    ids = torch.arange(vocab_size, device=device)
    return (ids >= max(0, vocab_size - 1024)) & (ids != eos_id)
