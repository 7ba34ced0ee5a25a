"""Stacked-layer int8 weight streaming, with K3.

Counterpart of the Pallas probe `kern` of benchmarks/pallas_bw_probe.py (git
4565532): one bf16 row x [1, I] against L stacked int8 layers w [L, I, O],
each upcast to bf16 (exact) and multiplied with f32 accumulation, summed over
the layers into y [1, O] f32. It is on no serving path: it measures the rate
at which the card streams the decode step's stacked layer weights, the bound
K2 is judged against.
"""
from __future__ import annotations

import torch

from . import kernels

_TARGET_BLOCKS = 2048  # ~16 blocks per SM of an H100, so the last wave is short


def weight_stream_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3: a per-layer product of f32 upcasts,
    summed over the layers in f32 -> [1, O] f32."""
    xf = x.reshape(1, -1).float()
    y = torch.zeros((1, w.shape[-1]), dtype=torch.float32, device=x.device)
    for layer in w:
        y += torch.matmul(xf, layer.float())
    return y


def weight_stream(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y [1, O] f32 = sum_l x @ w[l] for x bf16 [1, I], w int8 [L, I, O].
    A CUDA tensor launches K3 (csrc/weight_stream.cu) and counts it in
    `weight_stream.launches`; a CPU tensor takes the plain version."""
    if x.device.type == "cpu":
        return weight_stream_plain(x, w)
    if w.dim() != 3 or x.numel() != w.shape[1]:
        raise ValueError(f"weight_stream shapes: x {tuple(x.shape)}, w {tuple(w.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.int8:
        raise TypeError("weight_stream takes bf16 x and int8 w")
    kernels.require_cuda(x, w)
    L, I, O = w.shape
    if O % 16 or w.data_ptr() % 16:
        raise ValueError("weight_stream needs O % 16 == 0 and a 16-byte aligned w")
    lib = kernels.library()
    R = L * I
    n_tiles = -(-O // lib.stream_block_cols)
    ksplit = max(1, min(-(-R // lib.stream_row_step), -(-_TARGET_BLOCKS // n_tiles)))
    rows_per_split = -(-R // (ksplit * lib.stream_row_step)) * lib.stream_row_step
    ksplit = -(-R // rows_per_split)
    y = torch.empty((1, O), dtype=torch.float32, device=x.device)
    partial = torch.empty((ksplit * O,) if ksplit > 1 else (1,), dtype=torch.float32,
                          device=x.device)
    lib.call("fq3t_weight_stream", x.data_ptr(), w.data_ptr(), partial.data_ptr(), y.data_ptr(),
             R, I, O, rows_per_split, ksplit, kernels.stream_handle(x.device))
    weight_stream.launches += 1
    return y


weight_stream.launches = 0
