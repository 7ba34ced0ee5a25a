"""Reference-audio analysis: ECAPA-TDNN speaker encoder + codec encoder.

Port of faster_qwen3_tts_tpu/models/voice_extract.py: raw audio ->
(a) a 2048-d speaker embedding (x-vector) and (b) [T, 16] RVQ codec tokens,
the acoustic prompt of ICL voice clone.

- Mel front end: host numpy, the same arithmetic as the JAX package (the
  JAX module imports jax at its top, so it is restated here).
- Speaker encoder: ECAPA-TDNN (reflect-"same" TDNN convs, SE-Res2Net blocks
  at dilations 2, 3, 4, multi-layer feature aggregation, masked attentive
  statistics pooling). Activations stay channels-last [B, T, C] as in JAX;
  each convolution runs channels-first through `F.conv1d`.
- Codec encoder: the mirror of the Code2Wav decoder (strided causal conv
  blocks, ConvNeXt downsample stages, the sliding-window pre-transformer),
  built from models/codec.py's primitives, then residual vector
  quantization against the decoder's own 16 codebooks.

Both encoders run in float32 on the model's device. Their convolutions and
products go through cuDNN / cuBLAS, as the JAX package leaves them to XLA.
Frame counts are bucketed to powers of two exactly as in the JAX package,
so both pad the same way and give the same codes.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from faster_qwen3_tts_tpu.config import CodecConfig, Qwen3TTSConfig, SpeakerEncoderConfig
from faster_qwen3_tts_tpu.utils import audio as audio_lib

from .. import weights as weights_lib
from .codec import _RES_DILATIONS, causal_conv1d, convnext_block, pre_transformer, residual_unit, snake_beta

_STAT_EPS = 1e-12  # std clamp of the public ECAPA AttentiveStatisticsPooling


def mel_spectrogram(audio: np.ndarray, sr: int, n_mels: int = 80, n_fft: int = 400, hop: int = 160,
                    target_sr: int = 16000) -> np.ndarray:
    """audio [n] float32 -> log-mel [frames, n_mels] float32."""
    audio = audio_lib.resample(audio, sr, target_sr)
    if len(audio) < n_fft:
        audio = np.pad(audio, (0, n_fft - len(audio)))
    window = np.hanning(n_fft).astype(np.float32)
    n_frames = 1 + (len(audio) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = audio[idx] * window[None, :]
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2  # [frames, n_fft // 2 + 1]

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    mels = np.linspace(hz_to_mel(0.0), hz_to_mel(target_sr / 2), n_mels + 2)
    bins = np.floor((n_fft + 1) * mel_to_hz(mels) / target_sr).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1), np.float32)
    for m in range(1, n_mels + 1):
        lo, c, hi = bins[m - 1], bins[m], bins[m + 1]
        if c > lo:
            fb[m - 1, lo:c] = (np.arange(lo, c) - lo) / max(c - lo, 1)
        if hi > c:
            fb[m - 1, c:hi] = (hi - np.arange(c, hi)) / max(hi - c, 1)
    mel = spec @ fb.T
    return np.log(np.maximum(mel, 1e-10)).astype(np.float32)


# -- speaker encoder: ECAPA-TDNN ------------------------------------------------


def _reflect_pad(x: torch.Tensor, length: torch.Tensor, pad: int) -> torch.Tensor:
    """Length-aware reflect padding [B, T, C] -> [B, T + 2 pad, C]: position
    t reads x[-t] before the signal and x[2 L - 2 - t] past its valid length
    L, so bucket padding leaves every valid output exact."""
    T = x.shape[1]
    t = torch.arange(-pad, T + pad, device=x.device)[None, :]
    L = length[:, None]
    src = torch.where(t < 0, -t, torch.where(t < L, t, torch.clamp(2 * L - 2 - t, 0, T - 1)))
    return torch.gather(x, 1, src[:, :, None].expand(-1, -1, x.shape[2]))


def _tdnn(p, x: torch.Tensor, length: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """Reflect-"same" dilated conv -> ReLU. x [B, T, Cin] -> [B, T, Cout];
    p["w"] is [Cout, Cin, K]."""
    w = p["w"]
    pad = (w.shape[-1] - 1) * dilation // 2
    if pad:
        x = _reflect_pad(x, length, pad)
    y = F.conv1d(x.transpose(1, 2), w, dilation=dilation).transpose(1, 2)
    return torch.relu(y + p["b"])


def _se_res2_block(p, x, length, dilation: int, scale: int, mask):
    """tdnn1 -> Res2Net (y_0 = x_0, y_1 = conv(x_1), y_i = conv(x_i + y_{i-1}))
    -> tdnn2 -> squeeze-excitation over the valid frames -> + x."""
    h = _tdnn(p["tdnn1"], x, length)
    parts = torch.split(h, h.shape[-1] // scale, dim=-1)
    outs, y = [parts[0]], None
    for i in range(1, scale):
        y = _tdnn(p["res2"][i - 1], parts[i] if y is None else parts[i] + y, length, dilation)
        outs.append(y)
    h = _tdnn(p["tdnn2"], torch.cat(outs, dim=-1), length)
    denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
    s = (h * mask[..., None]).sum(dim=1) / denom
    (w1, b1), (w2, b2) = p["se1"], p["se2"]
    s = torch.relu(s @ w1 + b1)
    s = torch.sigmoid(s @ w2 + b2)
    return x + h * s[:, None, :]


def speaker_forward(params, cfg: SpeakerEncoderConfig, mel: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """mel [B, T, n_mels] f32, mask [B, T] f32 (1 = valid) -> x-vector
    [B, embedding_dim]. Padded frames stay out of every statistic."""
    length = mask.sum(dim=1).to(torch.long)
    h = _tdnn(params["in"], mel, length)
    feats = []
    for i in range(cfg.num_blocks):
        h = _se_res2_block(params[f"block{i}"], h, length, i + 2, cfg.res2net_scale, mask)
        feats.append(h)
    h = _tdnn(params["mfa"], torch.cat(feats, dim=-1), length)  # [B, T, mfa]

    # channel-wise attentive statistics pooling with global context
    denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
    m = mask[..., None]
    mean_g = (h * m).sum(dim=1) / denom
    var_g = ((h - mean_g[:, None, :]).square() * m).sum(dim=1) / denom
    std_g = torch.sqrt(torch.clamp(var_g, min=_STAT_EPS))
    ctx = torch.cat([h, mean_g[:, None, :].expand_as(h), std_g[:, None, :].expand_as(h)], dim=-1)
    a = torch.tanh(_tdnn(params["att_tdnn"], ctx, length))
    aw, ab = params["att_proj"]
    e = torch.where(m > 0, a @ aw + ab, -1e30)
    alpha = torch.softmax(e, dim=1)  # over valid time, per channel
    mean = (alpha * h).sum(dim=1)
    var = (alpha * (h - mean[:, None, :]).square()).sum(dim=1)
    stats = torch.cat([mean, torch.sqrt(torch.clamp(var, min=_STAT_EPS))], dim=-1)
    ow, ob = params["out"]
    return stats @ ow + ob


# -- codec encoder: mirror of the Code2Wav decoder -------------------------------


def encode_latents(params, cfg: CodecConfig, audio: torch.Tensor) -> torch.Tensor:
    """audio [B, n] f32 -> latents [B, n / total_upsample, hidden]: conv stem,
    strided blocks (reversed upsample_rates), mid conv, ConvNeXt downsample
    stages (reversed upsampling_ratios), sliding-window transformer."""
    h = causal_conv1d(audio[:, None, :], params["enc_in_w"], params["enc_in_b"])
    for blk, rate in zip(params["blocks"], reversed(cfg.upsample_rates)):
        for unit, dilation in zip(blk["units"], _RES_DILATIONS):
            h = residual_unit(unit, h, dilation)
        h = snake_beta(h, blk["a"], blk["b"])
        h = causal_conv1d(h, blk["down_w"], blk["down_b"], stride=rate)
    h = causal_conv1d(h, params["enc_mid_w"], params["enc_mid_b"])
    for stage, factor in zip(params["downsample"], reversed(cfg.upsampling_ratios)):
        h = convnext_block(stage["convnext"], h.transpose(1, 2)).transpose(1, 2)
        h = causal_conv1d(h, stage["down_w"], stage["down_b"], stride=factor)
    return pre_transformer(params["pre_transformer"], h.transpose(1, 2), cfg)


def rvq_encode(code_embed: torch.Tensor, latents: torch.Tensor, num_quantizers: int,
               codebook_size: int) -> torch.Tensor:
    """Residual VQ against the decoder's codebooks: code_embed
    [num_quantizers * codebook_size, hidden], latents [B, T, hidden] ->
    codes [B, T, num_quantizers] int32. The decoder embeds a frame as the
    MEAN of its quantizers' codewords, so the residual starts at
    num_quantizers * latents."""
    table_all = code_embed.float()
    residual = latents.float() * num_quantizers
    codes = []
    for q in range(num_quantizers):
        table = table_all[q * codebook_size:(q + 1) * codebook_size]
        d = (residual.square().sum(dim=-1, keepdim=True)
             - 2.0 * torch.einsum("bth,ch->btc", residual, table)
             + table.square().sum(dim=-1)[None, None, :])
        idx = torch.argmin(d, dim=-1)
        residual = residual - table[idx]
        codes.append(idx)
    return torch.stack(codes, dim=-1).to(torch.int32)


def _bucket(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class VoiceExtractor:
    """The speaker encoder and the codec encoder behind one object. Their
    random weights (seeds `seed` and `seed + 1`, as in the JAX package) are
    added to `params` in float32 on the codec's device, once."""

    def __init__(self, params: Dict, cfg: Qwen3TTSConfig, seed: int = 7):
        self.cfg = cfg
        self.device = params["codec"]["code_embed"].device
        if "speaker_encoder" not in params:
            tree = {"speaker_encoder": weights_lib.init_speaker_encoder(seed, cfg.speaker_encoder)}
            params["speaker_encoder"] = weights_lib.params_from_numpy(tree, self.device)["speaker_encoder"]
        if "codec_encoder" not in params:
            tree = {"codec_encoder": weights_lib.init_codec_encoder(seed + 1, cfg.codec)}
            params["codec_encoder"] = weights_lib.params_from_numpy(tree, self.device)["codec_encoder"]
        self.params = params

    def extract_xvector(self, audio: np.ndarray, sr: int) -> np.ndarray:
        """audio -> 2048-d float32 x-vector."""
        mel = mel_spectrogram(audio, sr, n_mels=self.cfg.speaker_encoder.mel_bins)
        T = mel.shape[0]
        bucket = _bucket(T, 64)
        padded = np.zeros((1, bucket, mel.shape[1]), np.float32)
        padded[0, :T] = mel
        mask = np.zeros((1, bucket), np.float32)
        mask[0, :T] = 1.0
        emb = speaker_forward(self.params["speaker_encoder"], self.cfg.speaker_encoder,
                              torch.from_numpy(padded).to(self.device),
                              torch.from_numpy(mask).to(self.device))
        return emb[0].cpu().numpy()

    def encode(self, audio: np.ndarray, sr: int):
        """audio -> (latents [1, bucket, hidden] on the device, valid frame
        count): resampled to the codec rate, cut or padded to whole frames,
        then padded to a power-of-two bucket (>= 32) of frames."""
        ccfg = self.cfg.codec
        wav = audio_lib.resample(audio, sr, ccfg.sample_rate)
        up = ccfg.total_upsample
        n_frames = max(1, int(round(len(wav) / up)))
        need = n_frames * up
        wav = np.pad(wav, (0, max(0, need - len(wav))))[:need]
        wav = np.pad(wav, (0, _bucket(n_frames, 32) * up - need))
        wav = torch.from_numpy(np.ascontiguousarray(wav, np.float32)[None]).to(self.device)
        return encode_latents(self.params["codec_encoder"], ccfg, wav), n_frames

    def extract_codes(self, audio: np.ndarray, sr: int) -> np.ndarray:
        """audio -> [T, 16] int32 RVQ codec tokens (the ICL acoustic prompt)."""
        ccfg = self.cfg.codec
        latents, n_frames = self.encode(audio, sr)
        codes = rvq_encode(self.params["codec"]["code_embed"], latents, ccfg.num_quantizers,
                           ccfg.codebook_size)
        return codes[0, :n_frames].cpu().numpy()
