"""The plain reference: Qwen3-TTS prompt, talker, code predictor and codec in
float32, with no kernels, no cache, no graphs and no batching of streams.

It reads the parameter tree the benchmark made (`portbench.maker`) and the
configuration file, and works out everything else itself: the Q8_0 weights
(per output channel absmax / 127, round half to even, clipped to +-127), the
prompt rows of a request (x-vector, preset speaker or ICL voice), the
logits at every served position (teacher forced: the served tokens are fed
back), and the audio of every streamed chunk (the window rule of a streaming
vocoder, and for an ICL voice the host vocoder's regime before it). It
imports nothing of the program. Its math is a frozen copy of the port's
plain float32 paths (`engine/parity.py`, `prompt.py`'s host layout,
`model._StreamVocoder`, `models/codec.py`), written over whole sequences
instead of step by step.

`act` rounds the input of every projection; the identity gives the
reference, `fp8_rows` the control (activations in float8 e4m3 with a scale a
row, the precision below the configuration's bfloat16). `stream_audio(...,
tf32=True)` runs the codec with TF32 on, the precision below its float32
with TF32 off.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

_NEG = -1e30
_RES_DILATIONS = (1, 3, 9)

# The byte tokenizer's chat framing (ids 0-255 bytes, then specials).
IM_START, IM_END, NL, ROLE_ASSISTANT = 256, 257, 258, 259


def assistant_ids(text: str) -> List[int]:
    """3 header ids + the text's bytes + 5 trailer ids."""
    return [IM_START, ROLE_ASSISTANT, NL] + list(text.encode("utf-8")) + [IM_END, NL, IM_START, ROLE_ASSISTANT, NL]


def q8_0(w: torch.Tensor) -> torch.Tensor:
    """Q8_0 of a [..., in, out] weight, dequantized to float32."""
    wf = w.float()
    scale = torch.clamp_min(wf.abs().amax(dim=-2, keepdim=True) / torch.tensor(127.0, device=w.device), 1e-12)
    return (wf / scale).round().clamp(-127, 127) * scale


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale a row (absmax to 448)."""
    s = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True) / 448.0, 1e-30)
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _rms(w, x, eps):
    return w * (x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps))


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, h, D] rotated at positions 0..S-1 (the 'cat' layout)."""
    S, D = x.shape[1], x.shape[-1]
    half = D // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv[None, :]
    cos = torch.cos(torch.cat([ang, ang], -1))[None, :, None, :]
    sin = torch.sin(torch.cat([ang, ang], -1))[None, :, None, :]
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], -1) * sin


class _Decoder:
    """A Qwen3 decoder stack (talker or code predictor) over whole causal
    sequences, Q8_0 weights dequantized once."""

    def __init__(self, layers: Dict[str, torch.Tensor], final_norm, sub: Dict[str, Any]):
        self.w = {k: q8_0(layers[k]) for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")}
        self.n = {k: layers[k].float() for k in ("q_norm", "k_norm", "ln1", "ln2")}
        self.final = final_norm.float()
        self.nh, self.nkv, self.hd = sub["num_attention_heads"], sub["num_key_value_heads"], sub["head_dim"]
        self.eps, self.theta = sub["rms_norm_eps"], sub["rope_theta"]

    def __call__(self, x: torch.Tensor, act) -> torch.Tensor:
        """x [B, S, hidden] f32 at positions 0..S-1 -> final-normed hiddens."""
        B, S, _ = x.shape
        causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        rep = self.nh // self.nkv
        for i in range(self.w["wq"].shape[0]):
            w = {k: v[i] for k, v in self.w.items()}
            h = act(_rms(self.n["ln1"][i], x, self.eps))
            q = _rope(_rms(self.n["q_norm"][i], (h @ w["wq"]).view(B, S, self.nh, self.hd), self.eps), self.theta)
            k = _rope(_rms(self.n["k_norm"][i], (h @ w["wk"]).view(B, S, self.nkv, self.hd), self.eps), self.theta)
            v = (h @ w["wv"]).view(B, S, self.nkv, self.hd)
            k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
            scores = torch.einsum("bshd,bthd->bhst", q, k) * self.hd ** -0.5
            probs = torch.softmax(torch.where(causal, scores, _NEG), dim=-1)
            attn = torch.einsum("bhst,bthd->bshd", probs, v).reshape(B, S, -1)
            x = x + act(attn) @ w["wo"]
            h = act(_rms(self.n["ln2"][i], x, self.eps))
            x = x + act(F.silu(h @ w["w_gate"]) * (h @ w["w_up"])) @ w["w_down"]
        return _rms(self.final, x, self.eps)


class Reference:
    """The reference model of one configuration file over one tree."""

    def __init__(self, tree: Dict[str, Any], cfg: Dict[str, Any]):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        t, p = tree["talker"], tree["predictor"]
        self.t_cfg, self.p_cfg, self.c_cfg = cfg["talker"], cfg["predictor"], cfg["codec"]
        self.text_embed = t["text_embed"]  # looked up, then widened
        self.text_w, self.text_b = q8_0(t["text_proj"]["w"]), t["text_proj"]["b"].float()
        self.codec_embed = t["codec_embed"].float()
        self.codec_head = q8_0(t["codec_head"])
        self.spk_w, self.spk_b = t["spk_proj"]["w"].float(), t["spk_proj"]["b"].float()
        self.talker = _Decoder(t["layers"], t["final_norm"], self.t_cfg)
        self.mtp_w, self.mtp_b = q8_0(p["mtp_proj"]["w"]), p["mtp_proj"]["b"].float()
        self.pred_embeds = p["codec_embeds"].float()  # [15, Vp, H]
        self.lm_heads = q8_0(p["lm_heads"])  # [15, Hp, Vp]
        self.predictor = _Decoder(p["layers"], p["final_norm"], self.p_cfg)
        self.codec = tree["codec"]
        self.device = self.codec_embed.device

    # -- the prompt ------------------------------------------------------------------------------------

    def text_hidden(self, ids: Sequence[int], act) -> torch.Tensor:
        x = self.text_embed[torch.as_tensor(list(ids), device=self.device)].float()
        return act(x) @ self.text_w + self.text_b

    def frame_embeds(self, codes: torch.Tensor) -> torch.Tensor:
        """Frames [T, 16] -> the talker's input for each [T, H]: the codebook-0
        embedding plus the code predictor's embeddings of codebooks 1-15."""
        idx = torch.arange(15, device=self.device)
        return self.codec_embed[codes[:, 0]] + self.pred_embeds[idx[None, :], codes[:, 1:]].sum(dim=1)

    def icl_block(self, req: Dict[str, Any], pad: torch.Tensor, act) -> torch.Tensor:
        """An ICL voice's reference block [Tc + 1, H]: over codec_bos and the
        Tc reference frames' embeddings, the reference text's rows (as many
        as fit) and then tts_pad."""
        codes = torch.as_tensor(req["ref_code"], device=self.device).long()
        tc = codes.shape[0]
        ref_text = self.text_hidden(list(req["ref_text"].encode("utf-8")), act)[: tc + 1]
        lane = torch.cat([ref_text, pad.expand(tc + 1 - ref_text.shape[0], -1)])
        bos = self.codec_embed[self.t_cfg["codec_bos_id"]][None]
        return lane + torch.cat([bos, self.frame_embeds(codes)])

    def prompt(self, req: Dict[str, Any], act):
        """One request's prompt rows [P, H] and trailing text rows [T, H] (the
        text fed a frame at a time; after them the pad row) and the pad row.
        An x-vector request has the streaming layout (the first text token in
        the prompt), an ICL request (`ref_code`, `ref_text` and its x-vector)
        the streaming one with the reference block in place of the first
        text token (the whole text fed), a preset speaker's the whole-text
        one (the program's defaults for voice clone and CustomVoice)."""
        tc = self.t_cfg
        ids = assistant_ids(req["text"])
        full = self.text_hidden(ids, act)
        pad, bos, eos = self.text_hidden([self.cfg["tts_pad_token_id"], self.cfg["tts_bos_token_id"],
                                          self.cfg["tts_eos_token_id"]], act)
        ce = lambda i: self.codec_embed[i]  # noqa: E731
        lang = req["language"].lower()
        speaker = req.get("speaker")
        lang_id = None if lang == "auto" else tc["codec_language_id"][lang]
        dialect = tc["spk_is_dialect"].get(speaker.lower()) if speaker else None
        if lang in ("chinese", "auto") and dialect:
            lang_id = tc["codec_language_id"][dialect]
        if lang_id is None:
            prefix = [tc["codec_nothink_id"], tc["codec_think_bos_id"], tc["codec_think_eos_id"]]
        else:
            prefix = [tc["codec_think_id"], tc["codec_think_bos_id"], lang_id, tc["codec_think_eos_id"]]
        rows = [ce(i) for i in prefix]
        if req.get("xvector") is not None:
            rows.append(torch.as_tensor(req["xvector"], device=self.device).float() @ self.spk_w + self.spk_b)
        elif speaker:
            rows.append(ce(tc["spk_id"][speaker.lower()]))
        rows += [ce(tc["codec_pad_id"]), ce(tc["codec_bos_id"])]
        codec_block = torch.stack(rows)
        k = codec_block.shape[0]
        lane = torch.cat([pad.expand(k - 2, -1), bos[None]])
        parts = [full[:3], lane + codec_block[:-1]]
        if req.get("ref_code") is not None:  # ICL streaming: the reference block, the whole text fed
            parts.append(self.icl_block(req, pad, act))
            trailing = torch.cat([full[3:-5], eos[None]])
        elif req.get("xvector") is not None:  # streaming: the first text token sits in the prompt
            parts.append(full[3:4] + codec_block[-1:])
            trailing = torch.cat([full[4:-5], eos[None]])
        else:  # the whole text in the prompt
            parts.append(torch.cat([full[3:-5], eos[None]]) + ce(tc["codec_pad_id"]))
            parts.append((pad + ce(tc["codec_bos_id"]))[None])
            trailing = pad[None]
        return torch.cat(parts), trailing, pad

    # -- logits at the served positions --------------------------------------------------------------

    def logits(self, req: Dict[str, Any], frames: torch.Tensor, act=identity):
        """Teacher-forced logits of one request served as `frames` [T, 16]:
        -> (talker logits [T + 1, V] before any masking: row t predicts frame
        t's codebook-0 token, row T the token after the last frame; predictor
        logits [T, 15, Vp]: codebooks 1-15 of each frame)."""
        frames = frames.to(self.device).long()
        T = frames.shape[0]
        prompt, trailing, pad = self.prompt(req, act)
        n = min(T, trailing.shape[0])
        text = torch.cat([trailing[:n], pad.expand(T - n, -1)])
        idx = torch.arange(15, device=self.device)
        fed = self.frame_embeds(frames) + text
        h = self.talker(torch.cat([prompt, fed])[None], act)[0, prompt.shape[0] - 1:]  # [T + 1, H]
        talker_logits = act(h) @ self.codec_head
        # the code predictor, one sequence a frame: [h_t, e(cb0)] then e(cb1..cb14)
        seq = torch.cat([h[:T, None], self.codec_embed[frames[:, 0]][:, None],
                         self.pred_embeds[idx[:14][None, :], frames[:, 1:15]]], dim=1)  # [T, 16, H]
        ph = self.predictor(act(seq) @ self.mtp_w + self.mtp_b, act)[:, 1:]  # [T, 15, Hp]
        pred_logits = torch.einsum("tch,chv->tcv", act(ph), self.lm_heads)
        return talker_logits, pred_logits

    # -- audio -----------------------------------------------------------------------------------------

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [T, 16] -> waveform [T * up - D] f32 in [-1, 1]."""
        return _codec_decode(self.codec, self.c_cfg, codes.to(self.device).long()[None])[0, :]

    def stream_audio(self, frames: torch.Tensor, chunk_frames: Sequence[int], context: int = 24,
                     tf32: bool = False, inputs: Optional[Dict[str, Any]] = None) -> List[torch.Tensor]:
        """The audio of each streamed chunk of `frames` by the window rule: a
        chunk of v frames after n earlier ones decodes the window of its
        last min(n, context) earlier frames and its own and emits the window's
        samples [ctx * up - D, ctx * up - D + v * up) (the first chunk: its
        first v * up - D). For an ICL request (`inputs` with `ref_code`), a
        chunk after fewer than `context` frames decodes the Tc reference
        frames and every frame so far, cuts off the first int(Tc / (Tc + n
        + v) * samples) samples, and emits what follows the samples emitted
        before (the host vocoder's regime)."""
        up, D = codec_upsample(self.c_cfg), codec_deficit(self.c_cfg)
        rc = None if inputs is None or inputs.get("ref_code") is None else torch.as_tensor(inputs["ref_code"])
        out, n, emitted = [], 0, 0
        with _tf32(tf32):
            for v in chunk_frames:
                if rc is not None and n < context:
                    codes = torch.cat([rc.to(self.device).long(), frames[:n + v].to(self.device).long()])
                    wav = self.decode(codes)
                    wav = wav[int(rc.shape[0] / codes.shape[0] * wav.shape[0]):]
                    out.append(wav[emitted:])
                    emitted = wav.shape[0]
                    n += v
                    continue
                ctx = min(n, context)
                wav = self.decode(frames[n - ctx:n + v])
                start = ctx * up - D if n else 0
                out.append(wav[start:start + (v * up if n else v * up - D)])
                n += v
        return out


@contextlib.contextmanager
def _tf32(on: bool):
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


# -- the codec decoder -------------------------------------------------------------------------------


def codec_upsample(c: Dict[str, Any]) -> int:
    return math.prod(c["upsampling_ratios"]) * math.prod(c["upsample_rates"])


def codec_deficit(c: Dict[str, Any]) -> int:
    """T frames decode to T * up - D samples."""
    D = 0
    for r in c["upsample_rates"]:
        D = (D + 1) * r
    return D


def _causal_conv(x, w, b, stride=1, dilation=1, groups=1):
    k = w.shape[-1]
    k_eff = (k - 1) * dilation + 1
    pad = k_eff - stride
    n = (x.shape[-1] - k_eff + pad) / stride + 1
    extra = int((math.ceil(n) - 1) * stride + (k_eff - pad) - x.shape[-1])
    return F.conv1d(F.pad(x, (pad, max(extra, 0))), w, b, stride=stride, dilation=dilation, groups=groups)


def _causal_tconv(x, w, b, stride):
    y = F.conv_transpose1d(x, w, b, stride=stride)
    trim = w.shape[-1] - stride
    return y[..., trim:y.shape[-1] - trim] if trim > 0 else y


def _snake(x, a, b):
    return x + torch.sin(x * torch.exp(a)[:, None]).square() / (torch.exp(b)[:, None] + 1e-9)


def _codec_decode(p, c, codes):
    B, T, Q = codes.shape
    offsets = torch.arange(Q, device=codes.device) * c["codebook_size"]
    x = p["code_embed"][codes + offsets].mean(dim=2)  # [B, T, C]
    # sliding-window causal transformer over frames
    L, H, D = p["pre_transformer"]["layers"]["wq"].shape[0], c["num_attention_heads"], c["head_dim"]
    i = torch.arange(T, device=codes.device)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - c["sliding_window"])
    eps = c["rms_norm_eps"]
    for li in range(L):
        lw = {k: v[li] for k, v in p["pre_transformer"]["layers"].items()}
        h = _rms(lw["ln1"], x, eps)
        q = _rope((h @ lw["wq"]).view(B, T, H, D), c["rope_theta"])
        k = _rope((h @ lw["wk"]).view(B, T, H, D), c["rope_theta"])
        v = (h @ lw["wv"]).view(B, T, H, D)
        probs = torch.softmax(torch.where(mask, torch.einsum("bqhd,bkhd->bhqk", q, k) * D ** -0.5, _NEG), -1)
        x = x + lw["scale_attn"] * (torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, T, H * D) @ lw["wo"])
        h = _rms(lw["ln2"], x, eps)
        x = x + lw["scale_mlp"] * ((F.silu(h @ lw["w_gate"]) * (h @ lw["w_up"])) @ lw["w_down"])
    x = _rms(p["pre_transformer"]["final_norm"], x, eps)
    for st, f in zip(p["upsample"], c["upsampling_ratios"]):
        x = _causal_tconv(x.transpose(1, 2), st["up_w"], st["up_b"], f).transpose(1, 2)
        cn = st["convnext"]
        h = _causal_conv(x.transpose(1, 2), cn["dw_w"], cn["dw_b"], groups=x.shape[-1]).transpose(1, 2)
        h = F.layer_norm(h, (h.shape[-1],), cn["ln_w"], cn["ln_b"], eps=1e-6)
        h = F.gelu(h @ cn["pw1_w"] + cn["pw1_b"]) @ cn["pw2_w"] + cn["pw2_b"]
        x = x + cn["gamma"] * h
    x = _causal_conv(x.transpose(1, 2), p["dec_in_w"], p["dec_in_b"])
    for blk, rate in zip(p["blocks"], c["upsample_rates"]):
        x = _causal_tconv(_snake(x, blk["a"], blk["b"]), blk["up_w"], blk["up_b"], rate)
        for u, dil in zip(blk["units"], _RES_DILATIONS):
            h = _causal_conv(_snake(x, u["a1"], u["b1"]), u["c1_w"], u["c1_b"], dilation=dil)
            x = x + _causal_conv(_snake(h, u["a2"], u["b2"]), u["c2_w"], u["c2_b"])
    x = _causal_conv(_snake(x, p["out_a"], p["out_b"]), p["dec_out_w"], p["dec_out_b"])
    return x[:, 0].clamp(-1.0, 1.0)
