"""Independent parity decode: per step, growing caches, eager float32.

Port of faster_qwen3_tts_tpu/engine/parity.py: a second implementation of
the whole decode that shares only the weights, the config, the sampling ops
(`ops/sampling.py`) and `engine.generate.predictor_sampling` with the
engine. RMSNorm, RoPE, GQA attention, the K/V bookkeeping, the sliding
windows, the predictor loop and the talker-input embedding are re-derived
here from the model definition; this module imports neither
`models/layers.py` nor `engine/core.py`, nor any kernel wrapper, so a fault
injected into the engine makes the token comparison fail.

Its execution is the opposite of the engine's on purpose: one Python step a
frame, K/V lists per layer grown by `torch.cat`, no padding, no kernels,
float32 throughout, on the model's device (the JAX version runs numpy on the
host). Every weight is dequantized to float32 once, when the path is set up
(`quant.dequantize`), so it is the yardstick of int8, int4 and mixed
deployments alike.

Sampling noise comes from a `torch.Generator` on that device seeded as the
engine seeds its own, drawn in the engine's order: the first token after the
prefill, then per frame the code predictor's 15 draws and the next token's.
So with float32 weights on one device a sampled stream equals the engine's,
not only a greedy one.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Generator, List, Optional, Tuple

import numpy as np
import torch

from faster_qwen3_tts_tpu_torch.config import PredictorConfig, Qwen3TTSConfig, TalkerConfig

from ..ops.quant import dequantize
from ..ops.sampling import SamplingParams, make_suppress_mask, sample_logits


def _rms(w: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    var = (x * x).mean(dim=-1, keepdim=True)
    return w * (x / torch.sqrt(var + eps))


def _rope(x: torch.Tensor, pos0: int, theta: float) -> torch.Tensor:
    """x [S, H, D] rotated at positions pos0.. (HF 'cat' layout)."""
    S, _, D = x.shape
    half = D // 2
    f32 = dict(dtype=torch.float32, device=x.device)
    inv = 1.0 / (theta ** (torch.arange(half, **f32) / half))
    ang = (pos0 + torch.arange(S, **f32))[:, None] * inv[None, :]  # [S, half]
    cos = torch.cos(torch.cat([ang, ang], dim=-1))[:, None, :]
    sin = torch.sin(torch.cat([ang, ang], dim=-1))[:, None, :]
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin


class _Stack:
    """One decoder stack (talker or predictor) evaluated step by step with a
    growing K/V list per layer. Its weights come in the engine's stacked
    layout ([L, ...]) and are dequantized, then split per layer, here."""

    def __init__(self, stacked, final_norm, num_heads, num_kv, head_dim, eps, theta,
                 sliding_window=None, layer_types=None):
        mats = {k: dequantize(v) for k, v in stacked.items()}  # dequantize before indexing
        L = mats["wq"].shape[0]
        self.layers = [{k: v[i] for k, v in mats.items()} for i in range(L)]
        self.final_norm = dequantize(final_norm)
        self.nh, self.nkv, self.hd = num_heads, num_kv, head_dim
        self.eps, self.theta = eps, theta
        # per-layer sliding windows (None: full attention), from the config's
        # layer_types, independently of models/layers.py
        if sliding_window is None:
            self.windows = [None] * L
        elif layer_types is None:
            self.windows = [sliding_window] * L
        else:
            self.windows = [sliding_window if t == "sliding_attention" else None for t in layer_types]
        self.reset()

    def reset(self) -> None:
        """Forget the sequence: empty K/V lists, position 0."""
        self.k: List[Optional[torch.Tensor]] = [None] * len(self.layers)  # per layer [T, nkv, hd]
        self.v: List[Optional[torch.Tensor]] = [None] * len(self.layers)
        self.pos = 0  # next rope position

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [S, hidden] float32, appended to the sequence so far -> final-normed
        hidden states [S, hidden]."""
        S = x.shape[0]
        rep = self.nh // self.nkv
        qpos = self.pos + torch.arange(S, device=x.device)[:, None]
        for i, lp in enumerate(self.layers):
            h = _rms(lp["ln1"], x, self.eps)
            q = (h @ lp["wq"]).reshape(S, self.nh, self.hd)
            k = (h @ lp["wk"]).reshape(S, self.nkv, self.hd)
            v = (h @ lp["wv"]).reshape(S, self.nkv, self.hd)
            q = _rope(_rms(lp["q_norm"], q, self.eps), self.pos, self.theta)
            k = _rope(_rms(lp["k_norm"], k, self.eps), self.pos, self.theta)
            self.k[i] = k if self.k[i] is None else torch.cat([self.k[i], k], dim=0)
            self.v[i] = v if self.v[i] is None else torch.cat([self.v[i], v], dim=0)
            kk = torch.repeat_interleave(self.k[i], rep, dim=1)  # [T, nh, hd]: query head h reads kv head h // rep
            vv = torch.repeat_interleave(self.v[i], rep, dim=1)
            T = kk.shape[0]
            scores = torch.einsum("shd,thd->hst", q, kk) * (self.hd ** -0.5)  # [nh, S, T]
            kv_pos = torch.arange(T, device=x.device)[None, :]
            allowed = kv_pos <= qpos  # [S, T]
            if self.windows[i] is not None:
                # HF sliding rule: a kv slot is seen iff kv_pos > q_pos - window
                allowed = allowed & (kv_pos > qpos - self.windows[i])
            scores = torch.where(allowed[None], scores, torch.full_like(scores, -1e30))
            scores = scores - scores.amax(dim=-1, keepdim=True)
            probs = torch.exp(scores)
            probs = probs / probs.sum(dim=-1, keepdim=True)
            attn = torch.einsum("hst,thd->shd", probs, vv).reshape(S, -1)
            x = x + attn @ lp["wo"]
            h = _rms(lp["ln2"], x, self.eps)
            gate = h @ lp["w_gate"]
            up = h @ lp["w_up"]
            x = x + (gate / (1.0 + torch.exp(-gate)) * up) @ lp["w_down"]
        self.pos += S
        return _rms(self.final_norm, x, self.eps)


class _Predictor:
    """The code predictor's float32 weights, dequantized once, and its stack."""

    def __init__(self, pred_params, pcfg: PredictorConfig):
        self.cfg = pcfg
        self.stack = _Stack(
            pred_params["layers"], pred_params["final_norm"], pcfg.num_attention_heads,
            pcfg.num_key_value_heads, pcfg.head_dim, pcfg.rms_norm_eps, pcfg.rope_theta,
            sliding_window=pcfg.sliding_window, layer_types=pcfg.layer_types,
        )
        self.w = dequantize(pred_params["mtp_proj"]["w"])
        self.b = dequantize(pred_params["mtp_proj"]["b"])
        self.embeds = dequantize(pred_params["codec_embeds"])  # [15, vocab, talker_hidden]
        self.heads = dequantize(pred_params["lm_heads"])  # [15, pred_hidden, vocab]


def _draw(logits: torch.Tensor, sampling: SamplingParams, generator: torch.Generator,
          suppress=None, extra=None) -> int:
    """One token from logits [V], drawing [1, V] noise as the engine does at B = 1."""
    return int(sample_logits(logits[None], sampling, suppress, extra, generator=generator)[0])


def _predict_codebooks_parity(pred: _Predictor, past_hidden: torch.Tensor, tok_embed: torch.Tensor,
                              generator: torch.Generator, sampling: SamplingParams) -> List[int]:
    """The 15-codebook loop, one fresh sequence a frame. past_hidden /
    tok_embed [talker_hidden] float32 -> 15 token ids."""
    pred.stack.reset()
    x = torch.stack([past_hidden, tok_embed]) @ pred.w + pred.b  # [2, pred_hidden]
    hs = pred.stack.forward(x)
    tok = _draw(hs[-1] @ pred.heads[0], sampling, generator)
    toks = [tok]
    for step in range(1, pred.cfg.num_codebooks):
        emb = pred.embeds[step - 1, tok] @ pred.w + pred.b  # [pred_hidden]
        hd = pred.stack.forward(emb[None])
        tok = _draw(hd[-1] @ pred.heads[step], sampling, generator)
        toks.append(tok)
    return toks


def parity_generate_streaming(
    params,
    cfg: Qwen3TTSConfig,
    tie,
    attention_mask,
    trailing_text,
    tts_pad_embed,
    max_seq_len: int = 2048,
    max_new_tokens: int = 2048,
    min_new_tokens: int = 2,
    temperature: float = 0.9,
    top_k: int = 50,
    top_p: float = 1.0,
    do_sample: bool = True,
    repetition_penalty: float = 1.05,
    chunk_size: int = 12,
    first_chunk_size: Optional[int] = None,
    seed: Optional[int] = None,
    subtalker_dosample: Optional[bool] = None,
    subtalker_top_k: Optional[int] = None,
    subtalker_top_p: Optional[float] = None,
    subtalker_temperature: Optional[float] = None,
) -> Generator[Tuple[np.ndarray, Dict[str, Any]], None, None]:
    """Streaming parity decode, the protocol of the engine's streams: yields
    (frames [n, 16] int32, timing) per chunk. Batch 1 only; the prompt is
    taken unpadded."""
    from .generate import predictor_sampling  # the predictor's default sampling

    tcfg: TalkerConfig = cfg.talker
    sampling = SamplingParams(temperature, top_k, top_p, do_sample, repetition_penalty)
    pred_sampling = predictor_sampling(subtalker_dosample, subtalker_top_k, subtalker_top_p,
                                       subtalker_temperature)
    device = params["talker"]["codec_embed"].device

    def f32(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    # the unpadded prompt (no buckets on this path)
    mask = torch.as_tensor(np.asarray(attention_mask)[0].astype(bool), device=device)
    x = f32(tie)[0][mask]  # [P, H]
    P = x.shape[0]
    if P > max_seq_len:
        raise ValueError(f"prefill length {P} exceeds max_seq_len {max_seq_len}")
    tth = f32(trailing_text)[0]
    tpe = f32(tts_pad_embed).reshape(-1)

    talker = _Stack(
        params["talker"]["layers"], params["talker"]["final_norm"], tcfg.num_attention_heads,
        tcfg.num_key_value_heads, tcfg.head_dim, tcfg.rms_norm_eps, tcfg.rope_theta,
        sliding_window=tcfg.sliding_window, layer_types=tcfg.layer_types,
    )
    codec_embed = dequantize(params["talker"]["codec_embed"])
    codec_head = dequantize(params["talker"]["codec_head"])
    pred = _Predictor(params["predictor"], cfg.predictor)

    V, eos = tcfg.vocab_size, tcfg.codec_eos_token_id
    suppress = make_suppress_mask(V, eos, device)
    eos_onehot = torch.arange(V, device=device) == eos

    if seed is None:
        seed = int(np.random.default_rng().integers(0, 2**31 - 1))
    generator = torch.Generator(device=device).manual_seed(seed)

    t0 = time.perf_counter()
    past_hidden = talker.forward(x)[-1]
    token = _draw(past_hidden @ codec_head, sampling, generator, suppress,
                  eos_onehot if min_new_tokens > 0 else None)
    prefill_ms = (time.perf_counter() - t0) * 1000.0

    seen = torch.zeros(V, dtype=torch.bool, device=device)
    buffer: List[np.ndarray] = []
    total = chunk_index = gen_step = 0
    t_chunk = time.perf_counter()

    def flush(is_final: bool):
        nonlocal chunk_index, buffer, t_chunk
        if not buffer:
            return None
        out = np.stack(buffer)
        timing = {
            "chunk_index": chunk_index,
            "chunk_steps": int(out.shape[0]),
            "prefill_ms": prefill_ms if chunk_index == 0 else 0.0,
            "decode_ms": (time.perf_counter() - t_chunk) * 1000.0,
            "total_steps_so_far": total,
            "is_final": bool(is_final),
        }
        buffer = []
        chunk_index += 1
        t_chunk = time.perf_counter()
        return out, timing

    while total < max_new_tokens:
        if token == eos:
            break
        tok_embed = codec_embed[token]
        cbs = _predict_codebooks_parity(pred, past_hidden, tok_embed, generator, pred_sampling)
        buffer.append(np.asarray([token] + cbs, np.int32))
        total += 1

        if talker.pos >= max_seq_len - 1 or total >= max_new_tokens:
            res = flush(True)
            if res:
                yield res
            return

        # next talker input: the 16 codec embeddings and the step's text hidden
        emb = tok_embed
        for i, t in enumerate(cbs):
            emb = emb + pred.embeds[i, t]
        text_h = tth[gen_step] if gen_step < tth.shape[0] else tpe
        gen_step += 1
        past_hidden = talker.forward((emb + text_h)[None])[-1]
        logits = past_hidden @ codec_head

        seen[token] = True
        logits = torch.where(
            seen,
            torch.where(logits > 0, logits / repetition_penalty, logits * repetition_penalty),
            logits,
        )
        token = _draw(logits, sampling, generator, suppress,
                      eos_onehot if total < min_new_tokens else None)

        # a smaller first chunk, as the engine's TTFA path
        target = (first_chunk_size or chunk_size) if chunk_index == 0 else chunk_size
        if len(buffer) >= target:
            yield flush(False)

    res = flush(True)
    if res:
        yield res


def parity_generate(
    params, cfg: Qwen3TTSConfig, tie, attention_mask, trailing_text, tts_pad_embed, **kwargs,
) -> Tuple[Optional[np.ndarray], Dict[str, Any]]:
    """Non-streaming parity decode -> ([T, 16] codes or None, timing)."""
    t0 = time.perf_counter()
    chunks = []
    prefill_ms = 0.0
    for frames, timing in parity_generate_streaming(
        params, cfg, tie, attention_mask, trailing_text, tts_pad_embed, **kwargs
    ):
        chunks.append(frames)
        if timing["chunk_index"] == 0:
            prefill_ms = timing["prefill_ms"]
    decode_s = time.perf_counter() - t0
    steps = int(sum(c.shape[0] for c in chunks))
    timing = {
        "prefill_ms": prefill_ms,
        "decode_s": decode_s,
        "steps": steps,
        "ms_per_step": (decode_s / steps * 1000.0) if steps else 0.0,
        "steps_per_s": (steps / decode_s) if decode_s > 0 else 0.0,
    }
    if not chunks:
        return None, timing
    return np.concatenate(chunks, axis=0), timing
