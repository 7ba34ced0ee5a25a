"""Window vocode of a streaming chunk, chained on the device after its decode.

Port of faster_qwen3_tts_tpu/engine/fused_stream.py. A window of
(ctx + chunk) frames decodes to (ctx + chunk) * up - D samples, D being the
decoder's fixed transposed-conv trim deficit. Emitting the window-local
samples [ctx * up - D, (ctx + chunk) * up - D) makes consecutive chunks
exactly contiguous in absolute sample positions. Tokens stay int tensors:
the JAX package's float-value transport works around a TPU-only problem.
Under a (dp, tp) mesh each dp group vocodes its own lanes on its replicated
codec (one window graph a group's set), where GSPMD partitions the JAX
package's B-lane window over dp.
"""
from __future__ import annotations

import torch

from faster_qwen3_tts_tpu_torch.config import CodecConfig, TalkerConfig

from ..models import codec as codec_lib
from . import core


def codec_deficit(cfg: CodecConfig) -> int:
    """Fixed sample deficit of the decoder geometry: T frames -> T * up - D."""
    D = 0
    for r in cfg.upsample_rates:
        D = (D + 1) * r
    return D


def _vocode_window(
    codec_params,
    talker_cfg: TalkerConfig,
    codec_cfg: CodecConfig,
    hist,  # [B, ctx, 16] int tensor, or None when ctx == 0
    packed: torch.Tensor,  # [chunk, B, 18] from core.decode_chunk
    chunk_size: int,
    ctx: int,
) -> torch.Tensor:
    """Decode the window -> audio [B, chunk * up] f32. The first window
    (ctx == 0) has D samples fewer, zero-padded at the end."""
    frames = packed[:, :, : talker_cfg.num_code_groups].transpose(0, 1)
    window = torch.cat([hist, frames], dim=1) if ctx > 0 else frames
    wav = codec_lib.decode_frames(codec_params, codec_cfg, window)
    up = codec_cfg.total_upsample
    D = codec_deficit(codec_cfg)
    start = ctx * up - D
    if start < 0:
        return torch.nn.functional.pad(wav[:, : chunk_size * up - D], (0, D))
    return wav[:, start : start + chunk_size * up]


def split_fused_output(audio: torch.Tensor, packed: torch.Tensor):
    """One host read of a chunk -> (audio [B, chunk * up] f32, valid frames
    [n, 16] int32 of stream 0, done)."""
    frames, done = core.read_packed(packed)
    return audio.float().cpu().numpy(), frames, done


def split_fused_output_batch(audio: torch.Tensor, packed: torch.Tensor):
    """One host read of a chunk, every lane -> (audio [B, chunk * up] f32,
    frames [chunk, B, 16] int32, valid [chunk, B] bool, done [B] bool)."""
    frames, valid, done = core.read_packed_batch(packed)
    return audio.float().cpu().numpy(), frames, valid, done
