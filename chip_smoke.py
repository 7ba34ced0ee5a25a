#!/usr/bin/env python3
"""Smoke run of the PyTorch port (faster_qwen3_tts_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                       # from the repository root, on a machine with a card
    python3 chip_smoke.py --report out.json     # also write every measurement to out.json
    python3 chip_smoke.py --kernels-only        # phases 1-4 only (no ok line)

Phases, each of which fails the run:
1. device: a CUDA card must be visible; prints its name and power limit;
2. build: compiles the port's CUDA kernels (K1 decode attention, K2 int8
   GEMV, K4 int4 GEMV, K3 weight streaming) from faster_qwen3_tts_tpu_torch/csrc
   with one nvcc per source for sm_90a, and prints what ptxas says of each
   kernel;
3. kernels: K1 and K2 against their plain PyTorch versions on the same
   inputs at the shapes of the 0.6B and 1.7B slices and of an 8-lane pool
   (K1 over 8 lanes of different ages, K2 at 8 and 16 rows), with the
   error, the median device time per call (CUDA-graph replay over operands
   larger than L2) of the kernel, of its plain version and of one PyTorch
   call that computes the same function (the yardstick the port never
   calls: SDPA for K1, `torch._weight_int8pack_mm` for K2, and for scale
   the bf16 matmul), the bound (bytes over the HBM rate or operations over
   the peak rate, whichever is larger) and the median eager call time; K4
   the same way at every 0.6B and 1.7B shape with 1, 2, 8 and 16 rows, each
   with the path its plan took (CUDA or tensor cores, tile, cluster, CTAs)
   (yardsticks `torch._weight_int4pack_mm` on the same nibbles with bf16
   scales and zeros, its error stated, and the bf16 matmul), one float32
   case and one replay in a CUDA graph;
4. probe: K3 streams the stacked int8 weights of the Pallas probe it
   replaces (L=28, I=2048, O=12288, the 1.7B gate+up stack, and L=28,
   I=1024, O=6144), timed with CUDA events, then held against its plain
   version: error, device ms and GB/s of each, its bound and the library
   call's time;
5. reference: the port on the card against the port on the CPU (plain
   versions) at a tiny geometry in float32, greedy, each model loaded from
   an own-format checkpoint under build/ (`save_pretrained` of the seeded
   tree) on both devices: x-vector streams (equal
   tokens); ICL voice clone from a seeded synthetic recording written under
   build/: x-vector (relative 1e-3), reference codes (equal, up to argmin
   ties), streamed tokens (equal) and audio (1e-3); a CustomVoice stream
   (dialect speaker, Chinese, an instruction) and a VoiceDesign stream:
   equal tokens, audio within 1e-3; then many streams in Q8_0 (a narrow
   vocoder): a lockstep batch of an x-vector, a long-reference and a
   short-reference ICL request, and a ContinuousBatcher with a late joiner
   and a reused slot: every lane's tokens equal its solo stream's on each
   device, and the card's equal the CPU's, audio within 1e-4; the x-vector
   stream also in Q4_K_M and Q8_4 (equal tokens, audio within 1e-3); then
   `parity_mode=True` against the engine on the card for float32, Q8_0,
   Q4_K_M and Q8_4 weights, greedy and sampled with one seed: equal tokens;
6. cli: `python -m faster_qwen3_tts_tpu_torch.cli clone` on the tiny
   checkpoint as a subprocess on the card (rc 0, a 24 kHz wav);
7. checkpoint + slice 0.6B Q8_0: the 0.6B Base tree of `init_numpy(seed=0)`
   (0.96 B parameters) written by `export_hf_layout` (float32, 3.86 GB)
   under build/ and loaded by `from_pretrained(dir, quant="Q8_0",
   strict=True)`: full coverage, every leaf bitwise equal to `materialize`
   of the same tree; export, load phases and times; the directory is
   deleted. On that model `warmup()`,
   then two streaming x-vector voice-clone requests (chunk 8, first chunk
   4, 32 frames); checks the audio, that K1 and K2 carried the run, and
   greedy determinism; prints TTFA and stream RTF per request; then one
   24-frame stream under torch.profiler: K1 and K2 device ms and launches
   per frame;
8. slice ICL on the same Q8_0 model: `create_voice_clone_prompt` timed on a
   4.0 s recording; ICL streams from `ref_audio` with a long reference
   (~56 frames: every chunk vocoded on the card) and a short one (~19
   frames: host decode with the reference prepended until 24 frames), one
   `xvec_only` stream, one non-streaming ICL request; checks sample counts,
   that K1 and K2 carried these requests, and greedy determinism;
9. batches on the same Q8_0 model: eight solo greedy x-vector streams,
   then `generate_voice_clone_streaming_batch` of the same requests at B =
   1, 2, 4, 8 (64 frames a lane): aggregate RTF, TTFA per lane, K1 and K2
   launches per decode step (which must not grow with B), the lanes' row
   and lane counts at K2 and K1 (B = 8 must launch K1 at 8 lanes and K2 at
   8 and 16 rows), each lane's agreement with its solo stream, the B = 8
   batch in reverse lane order (each request's tokens must not change), and
   a B = 8 run under torch.profiler (K1 and K2 device ms and launches per
   step, busy share); then a ContinuousBatcher (8 slots) answering 12
   requests (8 x-vector, 4 ICL) submitted from a thread every 150 ms, one
   cancelled at its first audio and one with text over the pool's bucket:
   every stream must end once, those two with `cancelled` and `error`;
   TTFA from submit p50 / max, aggregate RTF, peak memory;
10. serve on the same Q8_0 model: `server.make_server(model, continuous=8)`
   on a thread, an x-vector and an ICL voice from the 4.0 s recording; 4
   concurrent POSTs (2 wav, 1 pcm, 1 ICL), a bad chunk_size and an unknown
   response_format (400), a client that closes after its first audio bytes
   (its lane must be released), GET /health; every 200 body a 24 kHz wav or
   PCM16 stream, K1 and K2 launched; POST to first audio byte per request;
11. int4 slice: the same seeded 0.6B tree (one `init_numpy`) materialized
    in float32, BF16, Q8_0, Q4_K_M and Q8_4: the quant_delta row (prefill
    logit cosine and top-10 overlap against float32, projection bytes);
    Q8_0, Q4_K_M and Q8_4 each serve a 32-frame x-vector stream, back to
    back (TTFA, RTF, peak memory, K2 and K4 launches per decode step; K4
    must launch), Q4_K_M and Q8_4 a profiled 24-frame stream (K4's device us
    a launch printed beside K2's from the Q8_0 and Q8_4 profiles of the same
    run); on Q8_4 a 16-frame greedy `parity_mode` stream against the
    engine's (frames that agree, reported);
12. slice BF16: one x-vector request in BF16 (K1 only) and a B = 8 batch;
13. slice 1.7B Q8_0: `from_pretrained("Qwen/Qwen3-TTS-12Hz-1.7B-CustomVoice",
   quant="Q8_0")`, `warmup()`, two CustomVoice streams (a plain speaker in
   English, a dialect speaker in Chinese) and one non-streaming request;
   on the same weights VoiceDesign (a stream with an instruction, one
   non-streaming request) and a Base x-vector stream; checks sample counts,
   that K1 and K2 carried these requests, and greedy determinism; prints
   load and warmup time, TTFA and stream RTF per request, peak memory; then
   a 24-frame CustomVoice stream under torch.profiler, as in 7.

The run fails if jax or any module of the JAX package (faster_qwen3_tts_tpu)
was loaded.
The second-to-last line is the kernels' JSON record, the last line
`{"ok": true, "device": {...}}`. Any failure exits non-zero before them.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import resource
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
MODEL = "Qwen/Qwen3-TTS-12Hz-0.6B-Base"
MODEL_17B = "Qwen/Qwen3-TTS-12Hz-1.7B-CustomVoice"
TEXT = "The quick brown fox jumps over the lazy dog today."
CHUNK, FIRST_CHUNK, FRAMES = 8, 4, 32  # 32 frames: 2.6 s of audio a stream
BATCH_FRAMES, AGREE_FRAMES = 64, 8  # a lockstep lane's frames; frames held against a solo stream
REF_TEXT = "This is a seeded reference recording for the smoke run."
INSTRUCT = "Speak slowly, in a calm and warm low voice."
DESIGN = ("A warm middle-aged female narrator with a low, slightly husky voice, speaking slowly "
          "and clearly, calm and reassuring.")
HBM_PEAK_GB_S = 3350.0  # H100 SXM5 80GB HBM3, the card's data sheet
# dense peak operations per second by input type (H100 SXM data sheet): bf16
# on the tensor cores, float32 outside them
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
# bf16 kernel output against the f32 plain result from the same bf16 inputs:
# the final rounding to bf16 alone is up to 2^-9 relative (|out| <= ~4 here),
# plus f32 sums in another order.
ATOL = RTOL = 2e-2


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


_START = time.perf_counter()
CARD = "no card"  # the card's name and power limit as nvidia-smi prints them (set in main)


def phase(name: str) -> None:
    """Mark the start of a phase with the seconds since the script began."""
    log(f"[{time.perf_counter() - _START:.1f} s] phase: {name}")


def eager_ms(fn, reps: int = 50, warm: int = 5) -> float:
    """Median wall time of one eager call, host work included (CUDA events)."""
    import torch

    for _ in range(warm):
        fn(0)
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn(0)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, copies: int, reps: int = 11) -> float:
    """Median device time of one call: `copies` calls on distinct operand sets
    (together larger than the 50 MB L2, so weights and caches arrive cold, as
    in a decode step) are captured in a CUDA graph and replayed; host work is
    out of the measurement."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(copies):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(copies):
            fn(i)
    graph.replay()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / copies)
    return statistics.median(times)


def _copies(nbytes: int) -> int:
    return max(2, min(64, -(-96_000_000 // nbytes)))


@contextlib.contextmanager
def tapped_frames(model, frames):
    """For the block, keep in `frames` the token frames of the model's
    streams (its (frames, audio, timing) items pass through unchanged)."""
    relay = model._stream_decode

    def recording(stream):
        for item in stream:
            frames.append(item[0])
            yield item

    model._stream_decode = lambda stream, *a: relay(recording(stream), *a)
    try:
        yield frames
    finally:
        del model._stream_decode  # the class's method again: no cycle keeps the model alive


@contextlib.contextmanager
def tapped_codes(model, codes):
    """For the block, keep in `codes` the codec ids of each whole-sequence
    decode of the model."""
    relay = model._decode_audio
    model._decode_audio = lambda ids, rc: (codes.append(ids), relay(ids, rc))[1]
    try:
        yield codes
    finally:
        del model._decode_audio


def check_close(name, out, ref, details, atol=ATOL, rtol=RTOL):
    import torch

    err = (out.float() - ref.float()).abs()
    bad = (err > atol + rtol * ref.float().abs()).sum().item()
    max_err = err.max().item()
    details.append({"case": name, "max_abs_err": max_err, "atol": atol, "rtol": rtol})
    if bad or not torch.isfinite(out).all():
        fail(f"{name}: {bad} elements outside atol {atol} / rtol {rtol} (max abs err {max_err})")
    return max_err


def bound(nbytes: float, nops: float, dtype) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the peak rate of the inputs' type."""
    by_bytes = nbytes / (HBM_PEAK_GB_S * 1e9) * 1e3
    by_ops = nops / PEAK_OPS[str(dtype).replace("torch.", "")] * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "ops": nops}


def library_time(name, fn, n):
    """Device ms of one PyTorch call computing the kernel's function (the
    yardstick; the port never calls it), or None where the card's PyTorch
    has no such call."""
    try:
        return device_ms(fn, n)
    except (RuntimeError, NotImplementedError) as e:
        log(f"{name}: no single library call ({type(e).__name__}: {str(e).splitlines()[0][:160]})")
        return None


def _fmt(ms):
    return "none" if ms is None else f"{ms:.5f}"


# K1: the talker (S_max 2048) and predictor (S_max 17) caches, the same at
# 0.6B and 1.7B (16 / 8 heads of 128); live [56, 300) is a VoiceDesign prefill
# of ~200 rows, left-padded to its bucket of 256, plus 44 frames
K1_CASES = [(2048, 0, 33), (2048, 5, 133), (2048, 56, 300), (2048, 0, 2048), (17, 0, 3), (17, 0, 17)]
# K1 at the shapes of an 8-lane pool: the talker with eight lanes of different
# ages (live ranges of 40-300 slots, some left-padded), and the predictor with
# every lane at its last pass (17 live)
K1_BATCH_CASES = [(2048, [(0, 40), (5, 85), (56, 300), (0, 120), (20, 180), (0, 220), (31, 291), (0, 300)]),
                  (17, [(0, 17)] * 8)]
# K2: every Q8_0 projection shape of the 0.6B and 1.7B talkers and the
# predictor they share
K2_SHAPES = {(1024, 2048): "wq/lm_heads", (1024, 1024): "wk/wv/mtp_proj/text_proj",
             (2048, 1024): "wo; 1.7B wk/wv/mtp_proj", (1024, 3072): "gate/up/codec_head",
             (3072, 1024): "down", (2048, 2048): "1.7B wq/wo/text_proj", (2048, 6144): "1.7B gate/up",
             (6144, 2048): "1.7B down", (2048, 3072): "1.7B codec_head"}
# the 0.6B shapes also at the rows of an 8-lane pool: 8 (talker, predictor
# passes 2-15) and 16 (the predictor's first pass, two rows a lane)
K2_SHAPES_06B = ((1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072), (3072, 1024))


def kernel_phase(report):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from faster_qwen3_tts_tpu_torch.ops import attention, quant

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    k1_cases, k2_cases = [], []
    for S, lo, hi in K1_CASES:
        q = torch.randn(1, 1, 16, 128, generator=g).to(dev, torch.bfloat16)
        k = torch.randn(1, S, 8, 128, generator=g).to(dev, torch.bfloat16)
        v = torch.randn(1, S, 8, 128, generator=g).to(dev, torch.bfloat16)
        s = torch.arange(S)
        mask = ((s >= lo) & (s < hi)).to(torch.int32)[None].to(dev)
        out = attention.decode_attention(q, k, v, mask)
        torch.cuda.synchronize()
        ref = attention.decode_attention_plain(q.float(), k.float(), v.float(), mask)
        name = f"K1 S_max={S} live=[{lo},{hi})"
        err = check_close(name, out, ref, k1_cases)
        n = _copies(2 * k.numel() * k.element_size())
        ks, vs = [k] + [k.clone() for _ in range(n - 1)], [v] + [v.clone() for _ in range(n - 1)]
        bmask = (mask > 0)[:, None, None, :]  # SDPA's boolean mask, True = attend
        qt = q.transpose(1, 2)
        timed = {
            "ms": device_ms(lambda i: attention.decode_attention(q, ks[i], vs[i], mask), n),
            "plain_ms": device_ms(lambda i: attention.decode_attention_plain(q, ks[i], vs[i], mask), n),
            "library_ms": library_time(name, lambda i: F.scaled_dot_product_attention(
                qt, ks[i].transpose(1, 2), vs[i].transpose(1, 2), attn_mask=bmask, enable_gqa=True), n),
            "eager_ms": eager_ms(lambda i: attention.decode_attention(q, k, v, mask)),
            "plain_eager_ms": eager_ms(lambda i: attention.decode_attention_plain(q, k, v, mask)),
        }
        live = hi - lo
        # q, the live K/V rows, the mask, out; 4 flops per live (query head, slot, d)
        timed.update(bound(2 * q.numel() * 2 + 2 * live * 8 * 128 * 2 + S * 4, 4 * live * 16 * 128,
                           q.dtype))
        k1_cases[-1].update(timed)
        del ks, vs
        log(f"{name}: max_abs_err {err:.3e} (atol {ATOL}, rtol {RTOL}); device ms per call: kernel "
            f"{timed['ms']:.5f}, plain {timed['plain_ms']:.5f}, SDPA {_fmt(timed['library_ms'])}, bound "
            f"{timed['bound_ms']:.5f} ({timed['bound_by']}); eager call ms: kernel "
            f"{timed['eager_ms']:.4f}, plain {timed['plain_eager_ms']:.4f}")
    for S, ranges in K1_BATCH_CASES:
        B = len(ranges)
        q = torch.randn(B, 1, 16, 128, generator=g).to(dev, torch.bfloat16)
        k = torch.randn(B, S, 8, 128, generator=g).to(dev, torch.bfloat16)
        v = torch.randn(B, S, 8, 128, generator=g).to(dev, torch.bfloat16)
        s = torch.arange(S)
        mask = torch.stack([((s >= lo) & (s < hi)).to(torch.int32) for lo, hi in ranges]).to(dev)
        out = attention.decode_attention(q, k, v, mask)
        torch.cuda.synchronize()
        ref = attention.decode_attention_plain(q.float(), k.float(), v.float(), mask)
        live = sum(hi - lo for lo, hi in ranges)
        name = f"K1 B={B} S_max={S} live {min(hi - lo for lo, hi in ranges)}-{max(hi - lo for lo, hi in ranges)}"
        err = check_close(name, out, ref, k1_cases)
        n = _copies(2 * k.numel() * k.element_size())
        ks, vs = [k] + [k.clone() for _ in range(n - 1)], [v] + [v.clone() for _ in range(n - 1)]
        bmask = (mask > 0)[:, None, None, :]
        qt = q.transpose(1, 2)
        timed = {
            "ms": device_ms(lambda i: attention.decode_attention(q, ks[i], vs[i], mask), n),
            "plain_ms": device_ms(lambda i: attention.decode_attention_plain(q, ks[i], vs[i], mask), n),
            "library_ms": library_time(name, lambda i: F.scaled_dot_product_attention(
                qt, ks[i].transpose(1, 2), vs[i].transpose(1, 2), attn_mask=bmask, enable_gqa=True), n),
            "eager_ms": eager_ms(lambda i: attention.decode_attention(q, k, v, mask)),
            "plain_eager_ms": eager_ms(lambda i: attention.decode_attention_plain(q, k, v, mask)),
        }
        # q, every lane's live K/V rows, the masks, out; 4 flops per live (query head, slot, d)
        timed.update(bound(2 * q.numel() * 2 + 2 * live * 8 * 128 * 2 + B * S * 4, 4 * live * 16 * 128, q.dtype))
        k1_cases[-1].update(timed, batch=B)
        del ks, vs
        log(f"{name}: max_abs_err {err:.3e} (atol {ATOL}, rtol {RTOL}); device ms per call: kernel "
            f"{timed['ms']:.5f}, plain {timed['plain_ms']:.5f}, SDPA {_fmt(timed['library_ms'])}, bound "
            f"{timed['bound_ms']:.5f} ({timed['bound_by']}); eager call ms: kernel "
            f"{timed['eager_ms']:.4f}, plain {timed['plain_eager_ms']:.4f}")
    rng = np.random.default_rng(0)
    for (I, O), what in K2_SHAPES.items():
        ql = quant.quantize_linear(rng.standard_normal((I, O)).astype("float32") * I**-0.5)
        qw, sc = torch.from_numpy(ql.q).to(dev), torch.from_numpy(ql.scale).to(dev)
        n = _copies(qw.numel())
        qs = [qw] + [qw.clone() for _ in range(n - 1)]
        packed = [w.t().contiguous() for w in qs]  # [O, I], the layout torch's int8 call takes
        sc_bf16 = sc.reshape(O).to(torch.bfloat16)
        wbf = [qw.to(torch.bfloat16)] + [qw.to(torch.bfloat16) for _ in range(max(2, n // 2) - 1)]
        for M in (1, 2, 8, 16) if (I, O) in K2_SHAPES_06B else (1, 2):
            x = torch.randn(M, I, generator=g).to(dev, torch.bfloat16)
            out = quant.int8_gemv(x, qw, sc)
            torch.cuda.synchronize()
            ref = quant.int8_gemv_plain(x.float(), qw, sc)
            name = f"K2 M={M} I={I} O={O} ({what})"
            err = check_close(name, out, ref, k2_cases)
            timed = {
                "ms": device_ms(lambda i: quant.int8_gemv(x, qs[i], sc), n),
                "plain_ms": device_ms(lambda i: quant.int8_gemv_plain(x, qs[i], sc), n),
                "library_ms": library_time(
                    name, lambda i: torch._weight_int8pack_mm(x, packed[i], sc_bf16), n),
                # the BF16 slice's own product: twice the weight bytes
                "bf16_matmul_ms": device_ms(lambda i: torch.matmul(x, wbf[i]), len(wbf)),
                "eager_ms": eager_ms(lambda i: quant.int8_gemv(x, qw, sc)),
                "plain_eager_ms": eager_ms(lambda i: quant.int8_gemv_plain(x, qw, sc)),
            }
            timed["gb_s"] = qw.numel() / timed["ms"] / 1e6
            # x, q, scale, y; 2 flops per (row, weight)
            timed.update(bound(M * I * 2 + I * O + O * 4 + M * O * 2, 2 * M * I * O, x.dtype))
            k2_cases[-1].update(timed, shape=(M, I, O))
            log(f"{name}: max_abs_err {err:.3e} (atol {ATOL}, rtol {RTOL}); device ms per call: "
                f"kernel {timed['ms']:.5f} ({timed['gb_s']:.0f} GB/s of weights), plain "
                f"{timed['plain_ms']:.5f}, int8 library call {_fmt(timed['library_ms'])}, bf16 matmul "
                f"{timed['bf16_matmul_ms']:.5f}, bound {timed['bound_ms']:.5f} ({timed['bound_by']}); "
                f"eager call ms: kernel {timed['eager_ms']:.4f}, plain {timed['plain_eager_ms']:.4f}")
        del qs, packed, wbf
    k4_cases = k4_phase(g)
    report["kernel_cases"] = {"K1": k1_cases, "K2": k2_cases, "K4": k4_cases}
    return k1_cases, k2_cases, k4_cases


# f32 activations: K4's f32 sums of up to 6144 products in another order than
# the plain version's (about 1e-6 relative each)
ATOL_F32, RTOL_F32 = 1e-4, 1e-5


def _int4pack(packed, I, O):
    """The same nibbles in the layout `torch._weight_int4pack_mm` takes, or
    None where the card's PyTorch has no such conversion. Its uint8 input is
    [O, I/2] with the even row in the high nibble, as here."""
    import torch

    tiles = next(t for t in (8, 4, 2) if I % (16 * t) == 0)
    try:
        return torch._convert_weight_to_int4pack(packed.t().contiguous(), tiles)
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        log(f"K4 {I}x{O}: no int4pack conversion ({type(e).__name__}: {str(e).splitlines()[0][:160]})")
        return None


def k4_phase(g):
    """K4 against its plain version at every 0.6B and 1.7B projection shape,
    M = 1, 2, 8, 16 in bf16, one f32 case and one CUDA-graph replay. Device
    us per call (graph replay over operand copies larger than L2) of K4, of
    the plain version, of `torch._weight_int4pack_mm` on the same nibbles
    (its scales and zeros are bf16: w = (q - 8) * scale + zero, so zero =
    wmin + 8 scale rounded to bf16; its error against the plain version is
    reported) and of the bf16 matmul; the bound in bytes: 0.5 B a weight plus
    f32 scale and min per group of 32."""
    import numpy as np
    import torch

    from faster_qwen3_tts_tpu_torch.ops import quant

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    cases = []
    for (I, O), what in K2_SHAPES.items():
        ql = quant.quantize_linear4(rng.standard_normal((I, O)).astype("float32") * I**-0.5)
        packed, scale, wmin = (torch.from_numpy(a).to(dev) for a in ql)
        wbytes = packed.numel() + 2 * scale.numel() * 4
        n = _copies(wbytes)
        ops_ = [(packed, scale, wmin)] + [(packed.clone(), scale.clone(), wmin.clone()) for _ in range(n - 1)]
        lib_w = _int4pack(packed, I, O)
        lib_ws = None if lib_w is None else [lib_w] + [lib_w.clone() for _ in range(n - 1)]
        # tinygemm's affine form, w = (q - 8) * scale + zero, in bf16
        sz = torch.stack([scale, wmin + 8 * scale], dim=-1).to(torch.bfloat16).contiguous()
        wbf = quant.dequantize(quant.QuantizedLinear4(packed, scale, wmin)).to(torch.bfloat16)
        wbfs = [wbf] + [wbf.clone() for _ in range(max(2, n // 2) - 1)]
        for M in (1, 2, 8, 16):
            x = torch.randn(M, I, generator=g).to(dev, torch.bfloat16)
            out = quant.int4_gemv(x, packed, scale, wmin)
            torch.cuda.synchronize()
            ref = quant.int4_gemv_plain(x.float(), packed, scale, wmin)
            plan = quant._int4_plan(M, I, O, 32)  # an older tree's plan (timed in turns) lacks mma and cols
            path = (f"{'tensor cores' if getattr(plan, 'mma', False) else 'CUDA cores'}, "
                    f"{getattr(plan, 'cols', 128)}-column tiles, cluster {plan.cluster}, "
                    f"{math.prod(plan.grid)} CTAs")
            name = f"K4 M={M} I={I} O={O} ({what})"
            err = check_close(name, out, ref, cases)
            cases[-1]["path"] = path
            lib_err = None
            if lib_ws is not None:
                try:
                    lib_err = (torch._weight_int4pack_mm(x, lib_w, 32, sz).float() - ref).abs().max().item()
                except (RuntimeError, NotImplementedError) as e:
                    log(f"{name}: no int4 library call ({type(e).__name__}: {str(e).splitlines()[0][:160]})")
                    lib_ws = None
            timed = {
                "ms": device_ms(lambda i: quant.int4_gemv(x, *ops_[i]), n),
                "plain_ms": device_ms(lambda i: quant.int4_gemv_plain(x, *ops_[i]), n),
                "library_ms": None if lib_ws is None else library_time(
                    name, lambda i: torch._weight_int4pack_mm(x, lib_ws[i], 32, sz), n),
                "library_max_abs_err": lib_err,
                "bf16_matmul_ms": device_ms(lambda i: torch.matmul(x, wbfs[i]), len(wbfs)),
            }
            timed["gb_s"] = wbytes / timed["ms"] / 1e6
            # x, nibbles, scale and min, y; 2 flops per (row, weight) and the group terms
            timed.update(bound(M * I * 2 + wbytes + M * O * 2, 2 * M * I * O, x.dtype))
            cases[-1].update(timed, shape=(M, I, O))
            log(f"{name} [{path}]: max_abs_err {err:.3e} (atol {ATOL}, rtol {RTOL}); device ms per call: kernel "
                f"{timed['ms']:.5f} ({timed['gb_s']:.0f} GB/s of weights, scales and mins), plain "
                f"{timed['plain_ms']:.5f}, int4 library call {_fmt(timed['library_ms'])} (bf16 scale/zero, "
                f"max abs err {lib_err if lib_err is None else f'{lib_err:.3e}'}), bf16 matmul "
                f"{timed['bf16_matmul_ms']:.5f}, bound {timed['bound_ms']:.5f} ({timed['bound_by']})")
        del ops_, lib_ws, wbfs
    # float32 activations, as the tiny reference phases run them
    ql = quant.quantize_linear4(rng.standard_normal((1024, 3072)).astype("float32") * 1024**-0.5)
    packed, scale, wmin = (torch.from_numpy(a).to(dev) for a in ql)
    x = torch.randn(3, 1024, generator=g).to(dev)
    err = check_close("K4 f32 M=3 I=1024 O=3072", quant.int4_gemv(x, packed, scale, wmin),
                      quant.int4_gemv_plain(x, packed, scale, wmin), cases, ATOL_F32, RTOL_F32)
    log(f"K4 f32 M=3 I=1024 O=3072: max_abs_err {err:.3e} (atol {ATOL_F32}, rtol {RTOL_F32})")
    # one launch captured in a CUDA graph, replayed on new inputs: the eager call's bits
    x = torch.randn(1, 1024, generator=g).to(dev, torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        quant.int4_gemv(x, packed, scale, wmin)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = quant.int4_gemv(x, packed, scale, wmin)
    x.copy_(torch.randn(1, 1024, generator=g).to(dev, torch.bfloat16))
    graph.replay()
    torch.cuda.synchronize()
    same = bool(torch.equal(y, quant.int4_gemv(x, packed, scale, wmin)))
    cases.append({"case": "K4 graph replay M=1 I=1024 O=3072", "max_abs_err": 0.0 if same else float("inf"),
                  "bitwise_equal_to_eager": same})
    log(f"K4 in a CUDA graph, replayed on new inputs: bitwise equal to the eager call: {same}")
    if not same:
        fail("K4 replayed in a CUDA graph differs from its eager call")
    return cases


def _events_ms(fn, reps: int, warm: int = 2) -> float:
    """Median device time of one call, each call between its own CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def probe_phase(report, k2_cases):
    """K3 streams stacked int8 layer weights (operands far larger than L2, so
    no copies are needed) -> (cases, launches of the timed probe runs)."""
    import torch

    from faster_qwen3_tts_tpu_torch.ops import weight_stream as ws

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    cases, launches = [], 0
    for L, I, O in [(28, 2048, 12288), (28, 1024, 6144)]:
        w = torch.randint(-127, 127, (L, I, O), dtype=torch.int8, device=dev, generator=g)
        x = (torch.randn(1, I, device=dev, generator=g) * 0.1).to(torch.bfloat16)
        ws.weight_stream.launches = 0  # the probe itself: the timed runs
        ms = _events_ms(lambda: ws.weight_stream(x, w), reps=20)
        launches += ws.weight_stream.launches
        plain_ms = _events_ms(lambda: ws.weight_stream_plain(x, w), reps=5, warm=1)
        out, ref = ws.weight_stream(x, w), ws.weight_stream_plain(x, w)
        tol = 1e-5 * ref.abs().max().item()  # f32 sums of exact products in another order
        # one library call for the same sum: x repeated L times against the
        # [L*I, O] stack, in the [O, L*I] layout torch's int8 call takes
        packed, xs, ones = w.reshape(L * I, O).t().contiguous(), x.repeat(1, L), torch.ones(
            O, dtype=torch.bfloat16, device=dev)
        try:
            library_ms = _events_ms(lambda: torch._weight_int8pack_mm(xs, packed, ones), reps=20)
        except (RuntimeError, NotImplementedError) as e:
            log(f"K3: no single library call ({type(e).__name__}: {str(e).splitlines()[0][:160]})")
            library_ms = None
        del packed
        gb = w.numel() / 1e9
        c = {"case": f"K3 L={L} I={I} O={O}", "gb": gb, "ms": ms, "plain_ms": plain_ms,
             "library_ms": library_ms, "gb_s": gb / ms * 1e3, "plain_gb_s": gb / plain_ms * 1e3,
             "max_abs_err": (out - ref).abs().max().item(), "atol": tol,
             **bound(w.numel() + I * 2 + O * 4, 2 * w.numel(), x.dtype)}
        cases.append(c)
        log(f"{c['case']} ({gb * 1e3:.0f} MB int8): max_abs_err {c['max_abs_err']:.3e} (atol "
            f"{tol:.3e}); device ms: kernel {ms:.4f} ({c['gb_s']:.0f} GB/s, "
            f"{c['gb_s'] / HBM_PEAK_GB_S:.1%} of HBM peak), plain {plain_ms:.4f} "
            f"({c['plain_gb_s']:.0f} GB/s, {c['plain_gb_s'] / HBM_PEAK_GB_S:.1%}), int8 library call "
            f"{_fmt(library_ms)}, bound {c['bound_ms']:.4f} ({c['bound_by']})")
        if not c["max_abs_err"] <= tol or not torch.isfinite(out).all():
            fail(f"{c['case']}: the kernel disagrees with its plain version")
        del w, out, ref
    gate_up = next(c for c in k2_cases if c["shape"] == (1, 2048, 6144))
    log(f"K2 1.7B gate/up (M=1, 2048x6144, 12.6 MB) {gate_up['gb_s']:.0f} GB/s beside K3's "
        f"{cases[0]['gb_s']:.0f} GB/s over the 1.7B gate+up stack")
    if launches == 0:
        fail("the probe did not launch K3")
    report["probe"] = {"cases": cases, "launches": launches}
    return cases, launches


# A tiny geometry of the Base model (the widths of the JAX package's
# `config.tiny_test_config`), as a config.json that `from_pretrained` reads;
# the text vocabulary is cut to 512, so the tts control ids move below it,
# and the vocoder is 64 wide (the CPU side vocodes every chunk).
TINY_CONFIG = {
    "model_type": "base", "tts_bos_token_id": 300, "tts_eos_token_id": 301, "tts_pad_token_id": 302,
    "talker_config": {"num_hidden_layers": 2, "hidden_size": 128, "num_attention_heads": 4,
                      "num_key_value_heads": 2, "head_dim": 32, "intermediate_size": 256,
                      "text_hidden_size": 64, "text_vocab_size": 512},
    "predictor_config": {"num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 2,
                         "num_key_value_heads": 1, "head_dim": 32, "intermediate_size": 128},
    "codec_config": {"hidden_size": 64, "num_hidden_layers": 1, "intermediate_size": 128,
                     "num_attention_heads": 2, "num_key_value_heads": 2, "head_dim": 32, "decoder_dim": 64},
}


def reference_phase(report, devices=("cpu", "cuda")):
    """Port on the card vs port on the CPU (the kernels' plain versions) at a
    tiny geometry in float32, greedy, through `from_pretrained`."""
    import numpy as np

    from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS

    tiny_dir = _tiny_config_dir("chip_smoke_tiny")
    prompt = {"ref_spk_embedding": [np.random.default_rng(0).standard_normal(2048).astype(np.float32)]}
    for quant in ("none", "Q8_0", "Q4_K_M", "Q8_4"):  # float32 weights, or their quantizations
        runs = []
        for device in devices:
            model = FasterQwen3TTS.from_pretrained(str(tiny_dir), device=device, dtype="float32",
                                                   quant=quant, max_seq_len=256, seed=0)
            with tapped_frames(model, []) as frames:
                audio = [a for a, _, _ in model.generate_voice_clone_streaming(
                    "Hello from the reference phase.", "English", voice_clone_prompt=prompt,
                    max_new_tokens=30, chunk_size=CHUNK, first_chunk_size=FIRST_CHUNK,
                    do_sample=False, subtalker_dosample=False, seed=0)]
            runs.append((np.concatenate(frames), np.concatenate(audio)))
        (f_cpu, a_cpu), (f_gpu, a_gpu) = runs
        same = f_cpu.shape == f_gpu.shape and (f_cpu == f_gpu).all()
        # float32 throughout (TF32 off); only the order of the sums differs
        err = float(np.abs(a_cpu - a_gpu).max()) if a_cpu.shape == a_gpu.shape else float("inf")
        log(f"reference ({quant}, tiny f32, greedy): {f_gpu.shape[0]} frames equal to CPU: {bool(same)}; "
            f"audio max abs diff {err:.3e} (tolerance 1e-3)")
        report.setdefault("reference", []).append({"quant": quant, "frames": int(f_gpu.shape[0]),
                                                   "tokens_equal": bool(same), "audio_max_abs_diff": err})
        if not same or not err <= 1e-3:
            fail(f"reference phase ({quant}): the card disagrees with the CPU plain path")
    return tiny_dir


def reference_parity_phase(report, tiny_dir):
    """`parity_mode=True` (the independent eager decode) against the engine
    on the card at the tiny geometry in float32, for unquantized, Q8_0,
    Q4_K_M and Q8_4 weights: greedy, and sampled with one seed (one
    generator on the card, drawn in the engine's order). Token frames must
    be equal. -> the engine's launches."""
    import numpy as np

    from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS

    prompt = {"ref_spk_embedding": [np.random.default_rng(1).standard_normal(2048).astype(np.float32)]}
    # no EOS before 24 frames (a tiny random model may end at once), so every frame is compared
    kw = dict(voice_clone_prompt=prompt, max_new_tokens=24, min_new_tokens=24, chunk_size=CHUNK,
              first_chunk_size=FIRST_CHUNK, seed=5)
    rows, launches = [], {"K1": 0, "K2": 0, "K4": 0}
    for quant in ("none", "Q8_0", "Q4_K_M", "Q8_4"):
        model = FasterQwen3TTS.from_pretrained(str(tiny_dir), device="cuda", dtype="float32", quant=quant,
                                               max_seq_len=256, seed=0)
        for mode, extra in (("greedy", dict(do_sample=False, subtalker_dosample=False)), ("sampled", {})):
            toks = {}
            for parity in (False, True):
                _reset_launches()
                with tapped_frames(model, []) as frames:
                    for _ in model.generate_voice_clone_streaming(
                            "Hello from the parity phase.", "English", parity_mode=parity, **kw, **extra):
                        pass
                counted = _read_launches()
                if parity and any(counted.values()):
                    fail(f"reference parity ({quant}): the parity decode launched kernels {counted}")
                if not parity:
                    launches = {k: launches[k] + counted[k] for k in launches}
                toks[parity] = np.concatenate(frames)
            same = toks[False].shape == toks[True].shape and bool((toks[False] == toks[True]).all())
            rows.append({"quant": quant, "mode": mode, "frames": int(toks[True].shape[0]), "tokens_equal": same})
            log(f"reference parity ({quant}, tiny f32, {mode}): {toks[True].shape[0]} parity frames equal to "
                f"the engine's on the card: {same}")
            if not same:
                fail(f"reference parity ({quant}, {mode}): parity_mode disagrees with the engine on the card")
        del model
    report["reference_parity"] = rows
    return launches


def write_recording(path: Path, secs: float, seed: int) -> Path:
    """A seeded synthetic voice-like recording at 24 kHz (a gliding harmonic
    tone under a syllable-rate envelope, plus noise), written as 16-bit PCM."""
    import numpy as np

    from faster_qwen3_tts_tpu_torch.model import audio_lib

    rng = np.random.default_rng(seed)
    sr = 24000
    t = np.arange(int(secs * sr)) / sr
    f0 = 120.0 + 30.0 * np.sin(2 * np.pi * 0.7 * t + rng.uniform(0, 2 * np.pi))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voice = sum(np.sin(k * phase) / k for k in range(1, 6))
    envelope = 0.5 + 0.5 * np.sin(2 * np.pi * 4.0 * t)
    audio = 0.2 * envelope * voice + 0.01 * rng.standard_normal(t.size)
    path.parent.mkdir(parents=True, exist_ok=True)
    audio_lib.write_wav(path, audio.astype(np.float32), sr)
    return path


def code_ties(model, audio, sr, codes_ref, codes):
    """Entries where `codes` (card) differ from `codes_ref` (CPU): each must
    be an argmin tie, the two codewords' distances to the CPU residual
    agreeing within 1e-4 relative. Later levels of such a frame start from
    another residual and are not compared. -> [(frame, level, rel), ...]."""
    import numpy as np

    ccfg = model.config.codec
    latents, n = model._get_voice_extractor().encode(audio, sr)
    table = model.params["codec"]["code_embed"].float()
    residual = latents[0, :n].float() * ccfg.num_quantizers
    ties = []
    for f in np.nonzero((codes_ref != codes).any(axis=1))[0]:
        q = int(np.nonzero(codes_ref[f] != codes[f])[0][0])
        r = residual[f] - sum(table[lv * ccfg.codebook_size + int(codes_ref[f, lv])] for lv in range(q))
        d = [float((r - table[q * ccfg.codebook_size + int(c[f, q])]).square().sum()) for c in (codes_ref, codes)]
        rel = abs(d[0] - d[1]) / max(abs(d[0]), abs(d[1]), 1e-30)
        if rel > 1e-4:
            fail(f"reference codes differ at frame {f}, level {q} beyond an argmin tie (distances {d})")
        ties.append((int(f), q, rel))
    return ties


def reference_icl_phase(report, tiny_dir, devices=("cpu", "cuda")):
    """ICL voice clone from a reference recording: the card against the CPU
    at the tiny geometry, float32, greedy. The 1.0 s recording (+ 0.5 s of
    silence) gives 19 reference frames, so the stream takes the host
    prepend path and switches to the card's window vocode at 24 frames."""
    import numpy as np

    from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS, audio_lib

    ref = write_recording(REPO / "build" / "chip_smoke_ref_tiny.wav", 1.0, seed=3)
    audio, sr = audio_lib.load_ref_audio(ref, silence_secs=0.5)
    kw = dict(max_new_tokens=36, chunk_size=CHUNK, first_chunk_size=FIRST_CHUNK, do_sample=False,
              subtalker_dosample=False, seed=0)

    def stream(model, **prompt):
        with tapped_frames(model, []) as frames:
            audio_out = [a for a, _, _ in model.generate_voice_clone_streaming(
                "Hello from the ICL reference phase.", "English", **prompt, **kw)]
        return np.concatenate(frames), np.concatenate(audio_out)

    runs = []
    for device in devices:
        model = FasterQwen3TTS.from_pretrained(str(tiny_dir), device=device, dtype="float32",
                                               max_seq_len=256, seed=0)
        (item,) = model.create_voice_clone_prompt((audio, sr), ref_text=REF_TEXT)
        runs.append((model, item, stream(model, ref_audio=str(ref), ref_text=REF_TEXT)))
    (cpu, cpu_item, (f_cpu, a_cpu)), (gpu, gpu_item, (f_gpu, a_gpu)) = runs
    x_cpu, x_gpu = cpu_item.ref_spk_embedding, gpu_item.ref_spk_embedding
    x_rel = float(np.abs(x_gpu - x_cpu).max() / np.abs(x_cpu).max())
    c_cpu, c_gpu = cpu_item.ref_code, gpu_item.ref_code
    if c_cpu.shape != c_gpu.shape:
        fail(f"reference codes of shape {c_gpu.shape} on the card, {c_cpu.shape} on the CPU")
    ties = code_ties(cpu, audio, sr, c_cpu, c_gpu)
    for f, q, rel in ties:
        log(f"reference ICL: argmin tie at frame {f}, level {q} (distances agree to {rel:.2e})")
    if ties:  # hold the stream to the CPU's prompt so the tokens stay comparable
        f_gpu, a_gpu = stream(gpu, voice_clone_prompt=[cpu_item])
    same = f_cpu.shape == f_gpu.shape and bool((f_cpu == f_gpu).all())
    err = float(np.abs(a_cpu - a_gpu).max()) if a_cpu.shape == a_gpu.shape else float("inf")
    log(f"reference ICL (tiny f32, greedy, {c_cpu.shape[0]} reference frames): x-vector max rel diff "
        f"{x_rel:.3e} (tolerance 1e-3); codes equal but {len(ties)} argmin ties; {f_gpu.shape[0]} frames "
        f"equal to CPU: {same}; audio max abs diff {err:.3e} (tolerance 1e-3)")
    report["reference_icl"] = {"ref_frames": int(c_cpu.shape[0]), "xvec_max_rel_diff": x_rel,
                               "code_ties": ties, "frames": int(f_gpu.shape[0]), "tokens_equal": same,
                               "audio_max_abs_diff": err}
    if not x_rel <= 1e-3 or not same or not err <= 1e-3:
        fail("reference ICL phase: the card disagrees with the CPU plain path")


@contextlib.contextmanager
def greedy_predictor():
    """The CustomVoice and VoiceDesign methods take no `subtalker_*`
    arguments and leave the code predictor sampling: make it greedy."""
    from faster_qwen3_tts_tpu_torch.engine import generate as gen_lib

    sampling = gen_lib.predictor_sampling
    gen_lib.predictor_sampling = lambda *a: sampling(False)
    try:
        yield
    finally:
        gen_lib.predictor_sampling = sampling


def _tiny_config_dir(name, **over):
    """TINY_CONFIG with top-level overrides and talker keys (`talker_config`),
    as an own-format checkpoint under build/ (`save_pretrained` of
    `init_numpy(cfg, seed=0)`: the weights the seeded init draws) -> its
    directory."""
    from faster_qwen3_tts_tpu_torch import weights
    from faster_qwen3_tts_tpu_torch.config import config_from_dict

    d = dict(TINY_CONFIG, **over)
    d["talker_config"] = dict(TINY_CONFIG["talker_config"], **over.get("talker_config", {}))
    cfg = config_from_dict(d)
    path = REPO / "build" / name
    weights.save_pretrained(str(path), weights.init_numpy(cfg, seed=0), cfg)
    return path


def reference_custom_phase(report, devices=("cpu", "cuda")):
    """CustomVoice (a dialect speaker asked for Chinese, with an instruction a
    1.7B model keeps) and VoiceDesign streams: the card against the CPU at
    the tiny geometry, float32, greedy talker and predictor."""
    import numpy as np

    from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS

    custom = _tiny_config_dir("chip_smoke_tiny_custom", model_type="custom_voice", model_size="1b7",
                              talker_config={"spk_id": {"aiden": 2180, "dylan": 2182},
                                             "spk_is_dialect": {"aiden": False, "dylan": "beijing_dialect"}})
    design = _tiny_config_dir("chip_smoke_tiny_design", model_type="voice_design", model_size="1b7")
    # no EOS before 30 frames (a tiny random model may end at once), so every chunk is compared
    kw = dict(max_new_tokens=30, min_new_tokens=30, chunk_size=CHUNK, first_chunk_size=FIRST_CHUNK,
              do_sample=False, seed=0)
    cases = [("CustomVoice dylan/Chinese", custom, "generate_custom_voice_streaming",
              ("Hello from the custom voice phase.", "dylan", "Chinese"), {"instruct": INSTRUCT}),
             ("VoiceDesign", design, "generate_voice_design_streaming",
              ("Hello from the voice design phase.", DESIGN, "English"), {})]
    for name, tiny_dir, method, args, extra in cases:
        runs = []
        for device in devices:
            # the instruction and the whole text sit in the prefill (bucket 256)
            model = FasterQwen3TTS.from_pretrained(str(tiny_dir), device=device, dtype="float32",
                                                   max_seq_len=512, seed=0)
            with tapped_frames(model, []) as frames, greedy_predictor():
                audio = [a for a, _, _ in getattr(model, method)(*args, **extra, **kw)]
            runs.append((np.concatenate(frames), np.concatenate(audio)))
        (f_cpu, a_cpu), (f_gpu, a_gpu) = runs
        same = f_cpu.shape == f_gpu.shape and bool((f_cpu == f_gpu).all())
        err = float(np.abs(a_cpu - a_gpu).max()) if a_cpu.shape == a_gpu.shape else float("inf")
        log(f"reference {name} (tiny f32, greedy): {f_gpu.shape[0]} frames equal to CPU: {same}; "
            f"audio max abs diff {err:.3e} (tolerance 1e-3)")
        report.setdefault("reference_custom", []).append(
            {"case": name, "frames": int(f_gpu.shape[0]), "tokens_equal": same, "audio_max_abs_diff": err})
        if not same or not err <= 1e-3:
            fail(f"reference {name}: the card disagrees with the CPU plain path")


def run_request(model, seed, greedy=False, frames=FRAMES, method="generate_voice_clone_streaming",
                args=(TEXT, "English"), **prompt):
    """One streaming request through `method` -> (record, token frames).
    `prompt` holds the voice kwargs (voice clone default: a seeded
    x-vector). An ICL reference's length decides the expected sample count:
    exact for chunks vocoded on the card (x-vector, CustomVoice, VoiceDesign,
    or >= 24 reference frames), within 2 frames after the proportional cut of
    a shorter reference. greedy: the talker, and the predictor through
    `subtalker_dosample` (voice clone) or `greedy_predictor` (the caller's)."""
    import numpy as np
    import torch

    from faster_qwen3_tts_tpu_torch.engine.fused_stream import codec_deficit

    clone = method == "generate_voice_clone_streaming"
    if clone and not prompt:
        prompt = {"voice_clone_prompt": {
            "ref_spk_embedding": [np.random.default_rng(0).standard_normal(2048).astype(np.float32)]}}
    extra = {}
    if greedy:
        extra = dict(do_sample=False, subtalker_dosample=False) if clone else dict(do_sample=False)
    t0 = time.perf_counter()
    ttfa, chunks, sr, n_frames = None, [], None, 0
    with tapped_frames(model, []) as tokens:
        for audio, sr, timing in getattr(model, method)(
            *args, max_new_tokens=frames, chunk_size=CHUNK, first_chunk_size=FIRST_CHUNK,
            seed=seed, **prompt, **extra,
        ):
            if ttfa is None:
                ttfa = (time.perf_counter() - t0) * 1000.0
            chunks.append(audio)
            n_frames = timing["total_steps_so_far"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    audio = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    up = model.config.codec.total_upsample
    ref_frames = None
    if "ref_audio" in prompt and not prompt.get("xvec_only"):
        vcp, _ = model._voice_prompt_cache[(prompt["ref_audio"], prompt["ref_text"], False, True)]
        ref_frames = int(vcp["ref_code"][0].shape[0])
    if ref_frames is None:  # x-vector: the first window lacks the decoder's deficit
        expect, slack = n_frames * up - codec_deficit(model.config.codec), 0
    else:  # ICL: the reference tail is the first window's context, or it is cut off
        expect, slack = n_frames * up, (0 if ref_frames >= 24 else 2 * up)
    if sr != 24000 or audio.dtype != np.float32 or audio.size == 0:
        fail(f"request seed {seed}: bad audio (sr {sr}, dtype {audio.dtype}, {audio.size} samples)")
    if not np.isfinite(audio).all() or abs(audio.size - expect) > slack:
        fail(f"request seed {seed}: {audio.size} samples for {n_frames} frames, expected {expect} "
             f"(+- {slack}), finite {bool(np.isfinite(audio).all())}")
    rtf = (audio.size / sr) / wall
    return {"seed": seed, "frames": int(n_frames), "ref_frames": ref_frames, "samples": int(audio.size),
            "ttfa_ms": ttfa, "stream_rtf": rtf, "wall_s": wall}, np.concatenate(tokens)


def _reset_launches():
    from faster_qwen3_tts_tpu_torch.ops import attention
    from faster_qwen3_tts_tpu_torch.ops import quant as quant_ops

    attention.decode_attention.launches = 0
    quant_ops.int8_gemv.launches = 0
    quant_ops.int4_gemv.launches = 0


def _read_launches():
    from faster_qwen3_tts_tpu_torch.ops import attention
    from faster_qwen3_tts_tpu_torch.ops import quant as quant_ops

    return {"K1": attention.decode_attention.launches, "K2": quant_ops.int8_gemv.launches,
            "K4": quant_ops.int4_gemv.launches}


def _profile_row(prof, frames, wall_s):
    """Device time per frame of all kernels, of K1 and of K2, from a trace
    of `frames` frames over `wall_s` seconds."""

    def device_us(e):  # the kernel's own device time, across torch versions
        us = getattr(e, "self_device_time_total", None)
        return us if us is not None else e.self_cuda_time_total

    events = prof.key_averages()
    total_us = sum(device_us(e) for e in events)
    row = {"frames": frames, "wall_ms_per_frame": wall_s * 1e3 / frames,
           "device_ms_per_frame": total_us / 1e3 / frames, "busy_share": total_us / 1e6 / wall_s}
    for kname, needle in (("K1", "decode_attn_kernel"), ("K2", "int8_gemv_kernel"), ("K4", "int4_gemv_kernel")):
        hits = [e for e in events if needle in e.key]
        row[kname] = {"ms_per_frame": sum(device_us(e) for e in hits) / 1e3 / frames,
                      "launches_per_frame": sum(e.count for e in hits) / frames,
                      "us_per_launch": sum(device_us(e) for e in hits) / max(1, sum(e.count for e in hits))}
    return row


def frame_profile(model, name, report, method="generate_voice_clone_streaming", args=(TEXT, "English"),
                  need=("K1", "K2")):
    """The kernels inside the frame: one 24-frame stream under torch.profiler
    -> device ms and launches per frame of K1, K2, K4 and of all kernels;
    fails if a kernel of `need` is not in the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    _reset_launches()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:  # device activity only: less to parse
        req, _ = run_request(model, seed=41, frames=24, method=method, args=args)
    counted = _read_launches()
    parse_s = time.perf_counter() - t0 - req["wall_s"]
    frames = req["frames"]

    row = _profile_row(prof, frames, req["wall_s"])
    row.update(parse_s=parse_s, counted_launches=counted)
    log(f"frame profile, {name}: {frames} frames, profiled wall {row['wall_ms_per_frame']:.1f} ms/frame, "
        f"device {row['device_ms_per_frame']:.3f} ms/frame; K1 {row['K1']['ms_per_frame']:.3f} ms/frame "
        f"({row['K1']['launches_per_frame']:.1f} launches, {row['K1']['us_per_launch']:.2f} us each); K2 "
        f"{row['K2']['ms_per_frame']:.3f} ms/frame ({row['K2']['launches_per_frame']:.1f} launches, "
        f"{row['K2']['us_per_launch']:.2f} us each); K4 {row['K4']['ms_per_frame']:.3f} ms/frame "
        f"({row['K4']['launches_per_frame']:.1f} launches, {row['K4']['us_per_launch']:.2f} us each); counted "
        f"launches {counted}; trace parsed in {parse_s:.1f} s")
    if any(row[k]["launches_per_frame"] == 0 for k in need):
        fail(f"frame profile {name}: the trace lacks one of {need}")
    report.setdefault("frame_profile", {})[name] = row


def slice_icl_phase(model, report):
    """ICL voice clone from reference recordings on the full-width model."""
    import numpy as np
    import torch

    from faster_qwen3_tts_tpu_torch.model import audio_lib

    build = REPO / "build"
    long_ref = write_recording(build / "chip_smoke_ref_4s.wav", 4.0, seed=11)
    short_ref = write_recording(build / "chip_smoke_ref_1s.wav", 1.0, seed=12)
    torch.cuda.reset_peak_memory_stats()
    audio, sr = audio_lib.read_wav(long_ref)
    extract_ms = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (item,) = model.create_voice_clone_prompt((audio, sr), ref_text=REF_TEXT)
        torch.cuda.synchronize()
        extract_ms.append((time.perf_counter() - t0) * 1000.0)
    log(f"slice ICL: create_voice_clone_prompt on a 4.0 s recording: first call {extract_ms[0]:.1f} ms "
        f"(the encoders came with the checkpoint), then {', '.join(f'{t:.1f}' for t in extract_ms[1:])} ms; "
        f"{item.ref_code.shape[0]} frames of codes")

    cases = [("long ICL", long_ref, False, FRAMES, 21), ("short ICL", short_ref, False, FRAMES, 22),
             ("xvec_only", short_ref, True, FRAMES, 23)]
    _reset_launches()
    requests = []
    for name, ref, xvec_only, frames, seed in cases:
        prompt = dict(ref_audio=str(ref), ref_text=REF_TEXT, xvec_only=xvec_only)
        # first request for the voice: extraction, then the voice-prompt cache is warm
        cold, _ = run_request(model, seed, frames=FIRST_CHUNK, **prompt)
        req, _ = run_request(model, seed, frames=frames, **prompt)
        req.update(name=name, cold_voice_ttfa_ms=cold["ttfa_ms"])
        requests.append(req)
        log(f"slice ICL {name}: {req['ref_frames']} reference frames, {req['frames']} frames, TTFA "
            f"{req['ttfa_ms']:.1f} ms (first request for the voice {cold['ttfa_ms']:.1f} ms), "
            f"stream RTF {req['stream_rtf']:.3f}")

    with tapped_codes(model, []) as codec_ids:
        t0 = time.perf_counter()
        (wav,), sr = model.generate_voice_clone(TEXT, "English", ref_audio=str(long_ref),
                                                ref_text=REF_TEXT, max_new_tokens=24, seed=24)
        wall = time.perf_counter() - t0
    up = model.config.codec.total_upsample
    n = codec_ids[0].shape[0]
    if sr != 24000 or not np.isfinite(wav).all() or abs(wav.size - n * up) > 2 * up:
        fail(f"non-streaming ICL: {wav.size} samples for {n} frames at {sr} Hz")
    nonstream = {"frames": int(n), "samples": int(wav.size), "wall_s": wall, "rtf": wav.size / sr / wall}
    log(f"slice ICL non-streaming: {n} frames in {wall:.2f} s, RTF {nonstream['rtf']:.3f}")
    launches = _read_launches()
    log(f"slice ICL: launches during the ICL requests {launches}")
    if launches["K1"] == 0 or launches["K2"] == 0:
        fail(f"the ICL requests did not go through both kernels: {launches}")

    prompt = dict(ref_audio=str(long_ref), ref_text=REF_TEXT)
    _, tok_a = run_request(model, seed=7, greedy=True, frames=24, **prompt)
    _, tok_b = run_request(model, seed=8, greedy=True, frames=24, **prompt)
    if tok_a.shape != tok_b.shape or not (tok_a == tok_b).all():
        fail("slice ICL: two greedy runs gave different tokens")
    log(f"slice ICL: two greedy runs gave equal tokens ({tok_a.shape[0]} frames)")
    report["slice_icl_Q8_0"] = {"extract_ms": extract_ms, "requests": requests, "non_streaming": nonstream,
                                "launches": launches,
                                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    return launches


def slice_phase(quant, n_requests, report, icl=False, tree=None, init_s=None):
    """The full-width model (Q8_0: loaded from the checkpoint phase's
    export; BF16: seeded init): x-vector requests, then (icl) the ICL
    requests, then the lockstep batches (and for Q8_0 the continuous
    batcher and the server) on the same model. -> launches of the solo, ICL
    and batch paths (the server's counted with the batches)."""
    import torch

    from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if quant == "Q8_0":  # the checkpoint this slice serves: an HF-layout export of the seeded tree
        model = checkpoint_phase(report, tree, init_s)
    else:
        model = FasterQwen3TTS.from_pretrained(MODEL, device="cuda", quant=quant, seed=0)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model.warmup(chunk_size=CHUNK, first_chunk_size=FIRST_CHUNK)
    warmup_s = time.perf_counter() - t0
    log(f"slice {quant}: loaded in {load_s:.1f} s, warmup {warmup_s:.1f} s")
    _reset_launches()
    requests = []
    for i in range(n_requests):
        req, _ = run_request(model, seed=i + 1)
        requests.append(req)
        log(f"slice {quant} request {i}: {req['frames']} frames, TTFA {req['ttfa_ms']:.1f} ms, "
            f"stream RTF {req['stream_rtf']:.3f}")
    launches = _read_launches()
    log(f"slice {quant}: launches during the requests {launches}")
    _, tok_a = run_request(model, seed=7, greedy=True, frames=24)
    _, tok_b = run_request(model, seed=8, greedy=True, frames=24)
    if tok_a.shape != tok_b.shape or not (tok_a == tok_b).all():
        fail(f"slice {quant}: two greedy runs gave different tokens")
    log(f"slice {quant}: two greedy runs gave equal tokens ({tok_a.shape[0]} frames)")
    if quant == "Q8_0":
        frame_profile(model, "0.6B Q8_0 x-vector", report)
    report[f"slice_{quant}"] = {"load_s": load_s, "warmup_s": warmup_s, "requests": requests,
                                "launches": launches,
                                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    icl_launches = slice_icl_phase(model, report) if icl else None
    phase(f"batch {quant}")
    batch = slice_batch_phase(model, quant, report)
    if quant == "Q8_0":
        phase(f"continuous {quant}")
        cont = continuous_phase(model, report, REPO / "build" / "chip_smoke_ref_4s.wav")
        phase("serve 0.6B Q8_0")
        served = serve_phase(model, report, REPO / "build" / "chip_smoke_ref_4s.wav")
        batch = {k: batch[k] + cont[k] + served[k] for k in batch}
    del model
    gc.collect()  # each slice's peak memory is its own
    torch.cuda.empty_cache()
    return launches, icl_launches, batch


def checkpoint_phase(report, tree, init_s):
    """The 0.6B Base tree of `init_numpy(seed=0)` (float32, 0.96 B parameters;
    drawn once by `main` in `init_s` seconds and kept for the int4 slice)
    written by the port's `export_hf_layout` under build/, loaded strictly
    by `from_pretrained(dir, quant="Q8_0", strict=True)`; every loaded leaf
    must equal, bit for bit, `materialize` of the same tree. The directory
    is deleted. -> the model."""
    import shutil

    import torch

    from faster_qwen3_tts_tpu_torch import weights
    from faster_qwen3_tts_tpu_torch.config import get_config
    from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS
    from faster_qwen3_tts_tpu_torch.utils import safetensors as st

    cfg = get_config(MODEL)
    path = REPO / "build" / "chip_smoke_hf_0.6b"
    shutil.rmtree(path, ignore_errors=True)
    leaves = weights._leaves(tree)
    n_params, n_leaves = sum(a.size for a in leaves), len(leaves)
    del leaves
    t0 = time.perf_counter()
    weights.export_hf_layout(tree, cfg, str(path))
    (path / "config.json").write_text(json.dumps(weights._config_to_dict(cfg)))
    export_s = time.perf_counter() - t0
    file_gb = (path / "model.safetensors").stat().st_size / 1e9
    n_tensors = len(st.read_header(path / "model.safetensors")[0])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = FasterQwen3TTS.from_pretrained(str(path), device="cuda", quant="Q8_0", strict=True)
    load_s = time.perf_counter() - t0
    card_gb, card_peak_gb = torch.cuda.memory_allocated() / 1e9, torch.cuda.max_memory_allocated() / 1e9
    host_peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6  # kB: the process's peak so far
    cov = model.load_coverage
    full = all(int(v.split("/")[0]) == int(v.split("/")[1]) for k, v in cov.items()
               if k in ("talker", "predictor", "codec"))
    if not full or not all(cov[k].startswith("absent") for k in ("speaker_encoder", "codec_encoder")):
        fail(f"checkpoint: coverage {cov}")
    t0 = time.perf_counter()
    ref = weights.materialize(tree, torch.bfloat16, "int8", "cuda")
    ref_s = time.perf_counter() - t0
    compared = 0
    for sub in ("talker", "predictor", "codec"):
        got, want = weights._leaves(model.params[sub]), weights._leaves(ref[sub])
        if len(got) != len(want):
            fail(f"checkpoint: {sub} has {len(got)} leaves, materialize gives {len(want)}")
        for i, (a, b) in enumerate(zip(got, want)):
            if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
                fail(f"checkpoint: {sub} leaf {i} ({tuple(a.shape)} {a.dtype}) differs from materialize")
        compared += len(got)
    del ref
    shutil.rmtree(path)
    gc.collect()
    torch.cuda.empty_cache()
    row = {"params": n_params, "leaves": n_leaves, "tensors": n_tensors, "file_gb": file_gb, "init_s": init_s,
           "export_s": export_s, "load_s": load_s, "card_gb": card_gb, "card_peak_gb": card_peak_gb,
           "host_peak_rss_gb": host_peak_gb, "load_phases": model.load_phases, "coverage": cov, "materialize_s": ref_s,
           "leaves_bitwise_equal": compared, "card": CARD}
    log(f"checkpoint 0.6B Base ({CARD}): init_numpy {init_s:.1f} s, export_hf_layout {export_s:.1f} s "
        f"({n_params / 1e9:.3f} B parameters, {n_leaves} leaves, {n_tensors} tensors, {file_gb:.2f} GB float32); "
        f"from_pretrained(strict, Q8_0) {load_s:.1f} s, phases {model.load_phases}, {card_gb:.2f} GB on the card "
        f"(peak {card_peak_gb:.2f} GB), process peak RSS {host_peak_gb:.1f} GB; coverage {cov}; "
        f"{compared} leaves bitwise equal to materialize of the same tree ({ref_s:.1f} s)")
    report["checkpoint_0.6B"] = row
    return model


@contextlib.contextmanager
def tapped_steps(rec):
    """For the block, count in rec["steps"] the engine's decode steps and in
    rec["K1"] / ["K2"] / ["K4"] the kernel launches made inside them (not
    those of prompt building or the prefill)."""
    from faster_qwen3_tts_tpu_torch.engine import core

    real = core.decode_chunk
    rec.update(steps=0, K1=0, K2=0, K4=0)

    def counting(*a, **k):
        before = _read_launches()
        state, packed = real(*a, **k)
        for key, n in _read_launches().items():
            rec[key] += n - before[key]
        rec["steps"] += packed.shape[0]
        return state, packed

    core.decode_chunk = counting
    try:
        yield rec
    finally:
        core.decode_chunk = real


def _tree_gb(node) -> float:
    """Bytes of every tensor of a parameter tree, in GB."""
    import torch

    if isinstance(node, dict):
        return sum(_tree_gb(v) for v in node.values())
    if isinstance(node, (list, tuple)):
        return sum(_tree_gb(v) for v in node)
    return node.numel() * node.element_size() / 1e9 if isinstance(node, torch.Tensor) else 0.0


# launches a 0.6B decode step should make, counted from the shapes: 28 talker and
# 75 predictor layer passes of 7 projections, 15 lm_heads, 15 mtp_proj, codec_head
K4_EXPECTED = {"Q8_0": {"K2": 752, "K4": 0}, "Q4_K_M": {"K2": 0, "K4": 752}, "Q8_4": {"K2": 197, "K4": 555}}


def slice_int4_phase(report, tree):
    """The 0.6B Base tree that the checkpoint phase exported (one
    `init_numpy(seed=0)`), materialized on the card in float32, BF16, Q8_0,
    Q4_K_M and Q8_4 in turn: the quant_delta row (each mode's talker prefill
    logits against float32: cosine and top-10 overlap, on each model's own
    prompt) and the projection bytes; then, for Q8_0, Q4_K_M and Q8_4,
    `warmup()` and one x-vector stream of 32 frames, back to back so that
    their RTFs share the host's state (TTFA, RTF, peak memory, K2 and K4
    launches per decode step; the run fails if an int4 stream never
    launched K4), for Q4_K_M and Q8_4 a 24-frame stream under
    torch.profiler, and for Q8_4 a 16-frame greedy
    `parity_mode` stream held against the engine's (reported, not asserted:
    a bf16 engine and the f32 parity decode part early on random weights).
    -> launches of the Q4_K_M and Q8_4 streams."""
    import torch

    from faster_qwen3_tts_tpu_torch import weights
    from faster_qwen3_tts_tpu_torch.config import get_config
    from faster_qwen3_tts_tpu_torch.engine import core
    from faster_qwen3_tts_tpu_torch.engine import generate as gen_lib
    from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS
    from faster_qwen3_tts_tpu_torch.ops.sampling import SamplingParams
    from faster_qwen3_tts_tpu_torch.utils.tokenizer import PromptTokenizer, load_tokenizer

    cfg = get_config(MODEL)
    tokenizer = PromptTokenizer(load_tokenizer(None))
    voice = _xvec_prompt(0)
    launches = {"K1": 0, "K2": 0, "K4": 0}
    delta, rows, ref_logits = {}, {}, None
    for quant, mode, dtype in (("F32", "none", torch.float32), ("BF16", "none", torch.bfloat16),
                               ("Q8_0", "int8", torch.bfloat16), ("Q4_K_M", "int4", torch.bfloat16),
                               ("Q8_4", "mixed", torch.bfloat16)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        params = weights.materialize(tree, dtype, mode, "cuda")
        torch.cuda.synchronize()
        materialize_s = time.perf_counter() - t0
        model = FasterQwen3TTS(params, cfg, tokenizer)
        card_gb = (torch.cuda.memory_allocated() - base) / 1e9
        proj_gb = _tree_gb(params["talker"]["layers"]) + _tree_gb(params["predictor"]["layers"]) + sum(
            _tree_gb(params[a][b]) for a, b in (("talker", "codec_head"), ("talker", "text_proj"),
                                                ("predictor", "lm_heads"), ("predictor", "mtp_proj")))
        # the talker prefill of one x-vector prompt, built by this model's own prompt builder
        tie, tam, tth, tpe, _ = model._prepare_generation(TEXT, language="English", voice_clone_prompt=voice)
        sess = gen_lib.GenerationSession(params, cfg, tie, tam, tth, tpe, model.max_seq_len,
                                         SamplingParams(do_sample=False), gen_lib.predictor_sampling(False), 2,
                                         seed=0)
        _, logits = core.start_state(params["talker"], cfg.talker, sess.tie, sess.mask, sess.generator,
                                     model.max_seq_len, sess.sampling, 2)
        logits = logits[0].float().cpu()
        if ref_logits is None:
            ref_logits = logits
        cos = float(torch.nn.functional.cosine_similarity(logits, ref_logits, dim=0))
        top = len(set(torch.topk(logits, 10).indices.tolist()) & set(torch.topk(ref_logits, 10).indices.tolist()))
        delta[quant] = {"prefill_logit_cosine": cos, "top10_overlap": top / 10, "card_gb": card_gb,
                        "projection_gb": proj_gb, "materialize_s": materialize_s}
        log(f"quant_delta 0.6B {quant} ({CARD}): prefill logits against float32: cosine {cos:.6f}, top-10 "
            f"overlap {top}/10; projections {proj_gb:.3f} GB, {card_gb:.2f} GB on the card, materialize "
            f"{materialize_s:.1f} s")
        if mode != "none":
            t0 = time.perf_counter()
            model.warmup(chunk_size=CHUNK, first_chunk_size=FIRST_CHUNK)
            warmup_s = time.perf_counter() - t0
            _reset_launches()
            with tapped_steps({}) as steps:
                req, _ = run_request(model, seed=1)
            counted = _read_launches()
            per_step = {k: steps[k] / max(1, steps["steps"]) for k in ("K1", "K2", "K4")}
            if mode != "int8":
                launches = {k: launches[k] + counted[k] for k in launches}
            log(f"slice 0.6B {quant}: warmup {warmup_s:.1f} s; {req['frames']} frames, TTFA {req['ttfa_ms']:.1f} ms, "
                f"stream RTF {req['stream_rtf']:.3f}; launches {counted}, per decode step (of {steps['steps']}) "
                f"K1 {per_step['K1']:.1f}, K2 {per_step['K2']:.1f}, K4 {per_step['K4']:.1f} (expected "
                f"{K4_EXPECTED[quant]}); peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
            need = {"int8": ("K1", "K2"), "int4": ("K1", "K4"), "mixed": ("K1", "K2", "K4")}[mode]
            if any(counted[k] == 0 for k in need):
                fail(f"the 0.6B {quant} stream did not go through its kernels {need}: {counted}")
            if mode != "int8":  # the Q8_0 slice's own profile is phase 7's
                frame_profile(model, f"0.6B {quant} x-vector", report, need=need)
            row = {"materialize_s": materialize_s, "warmup_s": warmup_s, "request": req, "launches": counted,
                   "decode_steps": steps["steps"], "launches_per_step": per_step, "card_gb": card_gb,
                   "projection_gb": proj_gb, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
            if mode == "mixed":
                _, tok_eng = run_request(model, seed=3, greedy=True, frames=16)
                par, tok_par = run_request(model, seed=3, greedy=True, frames=16, voice_clone_prompt=voice,
                                           parity_mode=True)
                row["parity"] = dict(_agreement(tok_eng, tok_par), wall_s=par["wall_s"])
                log(f"slice 0.6B {quant} parity_mode (f32 eager) against the engine (bf16), greedy: "
                    f"{row['parity']['equal_frames']}/{row['parity']['frames']} frames equal, "
                    f"{row['parity']['equal_codebook0']} codebook-0 tokens equal, first difference (frame, "
                    f"codebook) {row['parity']['first_difference']}; 16 frames in {par['wall_s']:.1f} s")
            rows[quant] = row
        del model, params, sess
        gc.collect()
        torch.cuda.empty_cache()
    profiles = report.get("frame_profile", {})
    q8, q4, q84 = (profiles.get(f"0.6B {q} x-vector") for q in ("Q8_0", "Q4_K_M", "Q8_4"))
    if q8 and q4 and q84:
        log(f"slice 0.6B, us per launch inside the frame ({CARD}): K4 {q4['K4']['us_per_launch']:.2f} (Q4_K_M), "
            f"{q84['K4']['us_per_launch']:.2f} (Q8_4) beside K2 {q8['K2']['us_per_launch']:.2f} (Q8_0), "
            f"{q84['K2']['us_per_launch']:.2f} (Q8_4); kernel ms a frame Q8_0 {q8['device_ms_per_frame']:.2f}, "
            f"Q4_K_M {q4['device_ms_per_frame']:.2f}, Q8_4 {q84['device_ms_per_frame']:.2f}")
    report["quant_delta_0.6B"] = delta
    report["slice_int4_0.6B"] = rows
    return launches


def run_non_streaming(model, method, args, seed, frames=24):
    """One non-streaming CustomVoice / VoiceDesign request; the decode of the
    whole sequence gives exactly frames * upsample - deficit samples."""
    import numpy as np

    from faster_qwen3_tts_tpu_torch.engine.fused_stream import codec_deficit

    with tapped_codes(model, []) as codec_ids:
        t0 = time.perf_counter()
        (wav,), sr = getattr(model, method)(*args, max_new_tokens=frames, seed=seed)
        wall = time.perf_counter() - t0
    n = codec_ids[0].shape[0]
    expect = n * model.config.codec.total_upsample - codec_deficit(model.config.codec)
    if sr != 24000 or not np.isfinite(wav).all() or wav.size != expect:
        fail(f"{method}: {wav.size} samples for {n} frames at {sr} Hz, expected {expect}")
    return {"frames": int(n), "samples": int(wav.size), "wall_s": wall, "rtf": wav.size / sr / wall}


def slice_17b_phase(report):
    """The 1.7B geometry in Q8_0: CustomVoice through `from_pretrained`, then
    VoiceDesign and a Base x-vector stream on the same parameter tree (the
    seeded init reads only the geometry, so these are the weights
    `from_pretrained` would draw for them). -> launches of these requests."""
    import torch

    from faster_qwen3_tts_tpu_torch.config import get_config
    from faster_qwen3_tts_tpu_torch.engine import generate as gen_lib
    from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS
    from faster_qwen3_tts_tpu_torch.ops.sampling import SamplingParams

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = FasterQwen3TTS.from_pretrained(MODEL_17B, device="cuda", quant="Q8_0", seed=0)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model.warmup(chunk_size=CHUNK, first_chunk_size=FIRST_CHUNK)
    warmup_s = time.perf_counter() - t0
    weights_gb = torch.cuda.memory_allocated() / 1e9
    log(f"slice 1.7B Q8_0: loaded in {load_s:.1f} s ({weights_gb:.2f} GB on the card), warmup "
        f"{warmup_s:.1f} s")
    design = FasterQwen3TTS(model.params, get_config("1.7b-design"), model.tokenizer)
    base = FasterQwen3TTS(model.params, get_config("1.7b"), model.tokenizer)
    prefills = {}
    for name, m, speaker, instruct, nsm in [
            ("CustomVoice, whole text", model, "aiden", None, True),
            ("CustomVoice, step-fed text", model, "aiden", None, False),
            ("VoiceDesign, whole text", design, None, DESIGN, True)]:
        prompt = m._prepare_generation_custom(TEXT, "English", speaker, instruct=instruct,
                                              non_streaming_mode=nsm)
        times = []
        for _ in range(3):
            sess = gen_lib.GenerationSession(m.params, m.config, *prompt, m.max_seq_len,
                                             SamplingParams(0.9, 50, 1.0, True, 1.05),
                                             gen_lib.predictor_sampling(), 2, seed=0)
            sess.prefill()
            times.append(sess.prefill_ms)
        prefills[name] = {"rows": int(prompt[0].shape[1]), "ms": statistics.median(times)}
        log(f"slice 1.7B prefill, {name}: {prompt[0].shape[1]} rows, {prefills[name]['ms']:.1f} ms")
    cv, vd = "generate_custom_voice", "generate_voice_design"
    streams = [("CustomVoice aiden/English", model, cv, (TEXT, "aiden", "English"), 31),
               ("CustomVoice dylan/Chinese", model, cv, (TEXT, "dylan", "Chinese"), 32),
               ("VoiceDesign", design, vd, (TEXT, DESIGN, "English"), 33),
               ("Base x-vector", base, "generate_voice_clone", (TEXT, "English"), 35)]
    non_streaming = [("CustomVoice aiden/English", model, cv, (TEXT, "aiden", "English"), 36),
                     ("VoiceDesign", design, vd, (TEXT, DESIGN, "English"), 37)]
    _reset_launches()
    requests = []
    for name, m, method, args, seed in streams:
        req, _ = run_request(m, seed, method=f"{method}_streaming", args=args)
        req["name"] = name
        requests.append(req)
        log(f"slice 1.7B {name}: {req['frames']} frames, TTFA {req['ttfa_ms']:.1f} ms, "
            f"stream RTF {req['stream_rtf']:.3f}")
    for name, m, method, args, seed in non_streaming:
        req = run_non_streaming(m, method, args, seed)
        req["name"] = f"{name} non-streaming"
        requests.append(req)
        log(f"slice 1.7B {req['name']}: {req['frames']} frames in {req['wall_s']:.2f} s, "
            f"RTF {req['rtf']:.3f}")
    launches = _read_launches()
    log(f"slice 1.7B: launches during the requests {launches}")
    if launches["K1"] == 0 or launches["K2"] == 0:
        fail(f"the 1.7B requests did not go through both kernels: {launches}")
    with greedy_predictor():
        toks = [run_request(model, seed, greedy=True, frames=24, method=f"{cv}_streaming",
                            args=(TEXT, "dylan", "Chinese"))[1] for seed in (7, 8)]
    if toks[0].shape != toks[1].shape or not (toks[0] == toks[1]).all():
        fail("slice 1.7B: two greedy CustomVoice runs gave different tokens")
    log(f"slice 1.7B: two greedy CustomVoice runs gave equal tokens ({toks[0].shape[0]} frames)")
    frame_profile(model, "1.7B Q8_0 CustomVoice", report, method=f"{cv}_streaming",
                  args=(TEXT, "aiden", "English"))
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"slice 1.7B: peak device memory {peak:.2f} GB")
    report["slice_1.7B_Q8_0"] = {"load_s": load_s, "warmup_s": warmup_s, "weights_gb": weights_gb,
                                 "prefill": prefills, "requests": requests, "launches": launches,
                                 "peak_mem_gb": peak}
    del model, design, base
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# -- many streams on one engine batch ---------------------------------------------------------------

BATCH_TEXTS = ["The quick brown fox jumps over the lazy dog today.", "Please leave the parcel by the door.",
               "Our next train leaves at half past nine.", "She sells sea shells by the sea shore.",
               "Turn left at the second light, then keep right.", "The meeting moved to Thursday morning.",
               "A warm cup of tea settles the mind.", "Rain is expected later this evening."]


def _xvec_prompt(seed):
    import numpy as np

    return {"ref_spk_embedding": [np.random.default_rng(seed).standard_normal(2048).astype(np.float32)]}


@contextlib.contextmanager
def tapped_lanes(rec):
    """For the block, keep in rec["lanes"][s] the valid token frames of lane s
    of each lockstep batch, in rec["steps"] the frames decoded, in
    rec["start"] the kernel launches counted when the engine began (after
    the prompts were built), and in rec["logits0"] lane 0's prefill logits."""
    from faster_qwen3_tts_tpu_torch.engine import core
    from faster_qwen3_tts_tpu_torch.engine import generate as gen_lib

    real, start_state = gen_lib.fast_generate_streaming_batch, core.start_state
    rec.update(lanes={}, steps=0)

    def prefill(*a, **k):
        state, logits = start_state(*a, **k)
        rec["logits0"] = logits[0].float().clone()  # read after the run
        return state, logits

    def recording(*a, **k):
        rec["start"] = _read_launches()
        for item in real(*a, **k):
            frames, valid = item[0], item[1]
            for s in range(frames.shape[1]):
                rec["lanes"].setdefault(s, []).append(frames[valid[:, s], s])
            rec["steps"] += frames.shape[0]
            yield item

    gen_lib.fast_generate_streaming_batch, core.start_state = recording, prefill
    try:
        yield rec
    finally:
        gen_lib.fast_generate_streaming_batch, core.start_state = real, start_state


@contextlib.contextmanager
def tapped_reads():
    """For the block, keep the engine's host reads in order: rec["solo"] the
    B=1 reads (admission chunks), rec["batch"] the last pool read."""
    from faster_qwen3_tts_tpu_torch.engine import core

    rec = {"solo": [], "batch": None}
    solo, batch = core.read_packed, core.read_packed_batch

    def read_solo(packed):
        out = solo(packed)
        rec["solo"].append(out[0])
        return out

    def read_batch(packed):
        rec["batch"] = batch(packed)
        return rec["batch"]

    core.read_packed, core.read_packed_batch = read_solo, read_batch
    try:
        yield rec
    finally:
        core.read_packed, core.read_packed_batch = solo, batch


def batcher_tokens(rec, sid_tokens, sid, timing):
    """File the token frames behind one yield of a ContinuousBatcher."""
    v = timing["chunk_steps"]
    if timing.get("solo_first_chunk"):
        frames = rec["solo"].pop(0)[:v]
    elif v:
        f, valid, _ = rec["batch"]
        frames = f[:, timing["slot"]][valid[:, timing["slot"]]][:v]
    else:
        return
    sid_tokens.setdefault(sid, []).append(frames)


@contextlib.contextmanager
def shape_tally(tally):
    """For the block, count K1 launches by lane count and K2 launches by row
    count (the engine's calls of the two wrappers)."""
    from faster_qwen3_tts_tpu_torch.models import layers
    from faster_qwen3_tts_tpu_torch.ops import quant as quant_ops

    attn, gemv = layers.decode_attention, quant_ops.int8_gemv

    def attn_counted(q, *a):
        tally.setdefault("K1", {}).setdefault(q.shape[0], 0)
        tally["K1"][q.shape[0]] += 1
        return attn(q, *a)

    def gemv_counted(x, q, scale):
        m = x.numel() // x.shape[-1]
        tally.setdefault("K2", {}).setdefault(m, 0)
        tally["K2"][m] += 1
        return gemv(x, q, scale)

    # int8_gemv counts its launches on the module's name for it: keep the count
    gemv_counted.launches = gemv.launches
    layers.decode_attention, quant_ops.int8_gemv = attn_counted, gemv_counted
    try:
        yield tally
    finally:
        layers.decode_attention, quant_ops.int8_gemv = attn, gemv
        gemv.launches = gemv_counted.launches


def reference_batch_phase(report, tiny_dir, devices=("cpu", "cuda")):
    """Many streams at the tiny geometry, float32 activations, Q8_0
    weights, greedy: a lockstep batch of an x-vector, a long-reference (30 frames)
    and a short-reference (6 frames) ICL request, and a ContinuousBatcher
    (2 slots) with a late joiner and a reused slot. On each device every
    lane's tokens equal its own solo stream's; the card's tokens equal the
    CPU's and its audio is within 1e-4."""
    import numpy as np

    from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS

    def icl(seed, n):
        rng = np.random.default_rng(seed)
        return {"ref_spk_embedding": [rng.standard_normal(2048).astype(np.float32)],
                "x_vector_only_mode": [False], "icl_mode": [True],
                "ref_code": [rng.integers(0, 2048, size=(n, 16)).astype(np.int32)]}

    lock_reqs = [{"text": "Hello from lane zero.", "voice_clone_prompt": _xvec_prompt(0), "xvec_only": True},
                 {"text": "A long reference in lane one.", "voice_clone_prompt": icl(1, 30), "ref_text": REF_TEXT},
                 {"text": "Short reference, lane two.", "voice_clone_prompt": icl(2, 6), "ref_text": REF_TEXT}]
    # (request, budget): the first runs past 24 frames (the device vocode), the
    # second joins late and ends first, the third waits and reuses its slot
    cont_reqs = [({"text": "The first stream runs longest.", "voice_clone_prompt": _xvec_prompt(3),
                   "xvec_only": True}, 40),
                 ({"text": "A late joiner.", "voice_clone_prompt": _xvec_prompt(4), "xvec_only": True}, 16),
                 ({"text": "It waits for a free lane.", "voice_clone_prompt": icl(5, 6), "ref_text": REF_TEXT}, 24)]
    greedy = dict(do_sample=False, subtalker_dosample=False, seed=0)
    frames_n = 36

    def solo(model, req, budget, min_new):
        with tapped_frames(model, []) as toks:
            audio = [a for a, _, _ in model.generate_voice_clone_streaming(
                req["text"], "English", voice_clone_prompt=req["voice_clone_prompt"],
                ref_text=req.get("ref_text", ""), xvec_only=req.get("xvec_only", False),
                max_new_tokens=budget, min_new_tokens=min_new, chunk_size=CHUNK,
                first_chunk_size=FIRST_CHUNK, **greedy)]
        return np.concatenate(toks), np.concatenate(audio)

    runs = []
    for device in devices:
        model = FasterQwen3TTS.from_pretrained(str(tiny_dir), device=device, dtype="float32", quant="Q8_0",
                                               max_seq_len=256, seed=0)
        with tapped_lanes({}) as rec:
            out = list(model.generate_voice_clone_streaming_batch(
                lock_reqs, chunk_size=CHUNK, first_chunk_size=FIRST_CHUNK, max_new_tokens=frames_n,
                min_new_tokens=frames_n, **greedy))
        lock = {s: (np.concatenate(rec["lanes"][s]), np.concatenate([a for sl, a, _, _ in out if sl == s]))
                for s in range(len(lock_reqs))}
        for s, req in enumerate(lock_reqs):
            toks, _ = solo(model, req, frames_n, frames_n)
            if toks.shape != lock[s][0].shape or not (toks == lock[s][0]).all():
                fail(f"reference batch ({device}): lockstep lane {s} differs from its solo stream")
        cb = model.continuous_batcher(max_slots=2, chunk_size=CHUNK, first_chunk_size=FIRST_CHUNK,
                                      min_new_tokens=40, **greedy)
        cb.submit(cont_reqs[0][0], max_new_tokens=cont_reqs[0][1])
        sid_tokens, sid_audio, slots, finals = {}, {}, {}, {}
        with tapped_reads() as reads:
            for sid, audio, _sr, t in cb.run():
                batcher_tokens(reads, sid_tokens, sid, t)
                sid_audio.setdefault(sid, []).append(audio)
                slots.setdefault(sid, t["slot"])
                if t["is_final"]:
                    finals[sid] = t
                if sid == 0 and t["chunk_index"] == 1 and len(slots) == 1:
                    for req, budget in cont_reqs[1:]:
                        cb.submit(req, max_new_tokens=budget)
        if sorted(finals) != [0, 1, 2] or slots[2] != slots[1]:
            fail(f"reference batch ({device}): continuous run ended {sorted(finals)}, slots {slots}")
        cont = {sid: (np.concatenate(sid_tokens[sid]), np.concatenate(sid_audio[sid])) for sid in finals}
        for sid, (req, budget) in enumerate(cont_reqs):
            toks, _ = solo(model, req, budget, 40)
            if toks.shape != cont[sid][0].shape or not (toks == cont[sid][0]).all():
                fail(f"reference batch ({device}): continuous stream {sid} differs from its solo stream")
        runs.append((lock, cont))
        del model, cb
    (cpu_lock, cpu_cont), (gpu_lock, gpu_cont) = runs
    rows = []
    for name, cpu, gpu in (("lockstep lane", cpu_lock, gpu_lock), ("continuous stream", cpu_cont, gpu_cont)):
        for key in cpu:
            (tc, ac), (tg, ag) = cpu[key], gpu[key]
            same = tc.shape == tg.shape and bool((tc == tg).all())
            err = float(np.abs(ac - ag).max()) if ac.shape == ag.shape and ac.size else float("inf")
            rows.append({"case": f"{name} {key}", "frames": int(tg.shape[0]), "tokens_equal": same,
                         "audio_max_abs_diff": err})
            log(f"reference batch {name} {key} (tiny f32 Q8_0, greedy): {tg.shape[0]} frames equal to CPU: "
                f"{same}, to its solo stream: True; audio max abs diff {err:.3e} (tolerance 1e-4)")
            if not same or not err <= 1e-4:
                fail(f"reference batch {name} {key}: the card disagrees with the CPU plain path")
    report["reference_batch"] = rows


def lockstep_run(model, requests, frames, greedy=True):
    """One lockstep batch of `frames` frames a lane through
    `generate_voice_clone_streaming_batch` -> (record, lane tokens)."""
    import numpy as np
    import torch

    from faster_qwen3_tts_tpu_torch.engine.fused_stream import codec_deficit

    kw = dict(do_sample=False, subtalker_dosample=False) if greedy else {}
    B = len(requests)
    first, chunks = {}, {s: [] for s in range(B)}
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tapped_lanes({}) as rec:
        for s, audio, sr, t in model.generate_voice_clone_streaming_batch(
                requests, chunk_size=CHUNK, first_chunk_size=FIRST_CHUNK, max_new_tokens=frames,
                min_new_tokens=frames, seed=1, **kw):
            first.setdefault(s, (time.perf_counter() - t0) * 1000.0)
            chunks[s].append(audio)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the engine's launches: prompt building also runs K2 on short text pieces
    launches = {k: n - rec["start"][k] for k, n in _read_launches().items()}
    up, D = model.config.codec.total_upsample, codec_deficit(model.config.codec)
    samples = []
    for s in range(B):
        audio = np.concatenate(chunks[s])
        n = sum(f.shape[0] for f in rec["lanes"][s])
        if audio.dtype != np.float32 or not np.isfinite(audio).all() or audio.size != n * up - D:
            fail(f"lockstep B={B} lane {s}: {audio.size} samples for {n} frames, expected {n * up - D}")
        samples.append(audio.size)
    steps = rec["steps"]
    tokens = [np.concatenate(rec["lanes"][s]) for s in range(B)]
    return {"logits0": rec["logits0"].cpu(), "B": B, "frames_per_lane": [int(t.shape[0]) for t in tokens],
            "steps": steps, "wall_s": wall,
            "ttfa_ms": [first[s] for s in range(B)], "aggregate_rtf": sum(samples) / 24000 / wall,
            "launches": launches, "launches_per_step": {k: v / steps for k, v in launches.items()}}, tokens


def batch_profile(model, requests, report, name):
    """One B-lane lockstep run of a first chunk and one chunk under
    torch.profiler (device activity only) -> K1 and K2 device ms and
    launches per decode step, and the card's busy share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rec, _ = lockstep_run(model, requests, FIRST_CHUNK + CHUNK)
    row = _profile_row(prof, rec["steps"], rec["wall_s"])
    row.update(B=len(requests), counted_launches=rec["launches"])
    log(f"batch profile, {name}: B={len(requests)}, {rec['steps']} steps, profiled wall "
        f"{row['wall_ms_per_frame']:.1f} ms/step, device {row['device_ms_per_frame']:.3f} ms/step (busy "
        f"{row['busy_share']:.1%}); K1 {row['K1']['ms_per_frame']:.3f} ms/step ({row['K1']['launches_per_frame']:.1f} "
        f"launches, {row['K1']['us_per_launch']:.2f} us each); K2 {row['K2']['ms_per_frame']:.3f} ms/step "
        f"({row['K2']['launches_per_frame']:.1f} launches, {row['K2']['us_per_launch']:.2f} us each)")
    if row["K1"]["launches_per_frame"] == 0 or row["K2"]["launches_per_frame"] == 0:
        fail(f"batch profile {name}: the trace shows no K1 or K2 kernel")
    report.setdefault("batch_profile", {})[name] = row


def continuous_phase(model, report, long_ref):
    """A ContinuousBatcher(max_slots=8, chunk 8, first chunk 4) answering 12
    requests (8 x-vector, 4 ICL from a 4.0 s recording) submitted from a
    thread every 150 ms; one is cancelled at its first audio, one has text
    over the pool's trailing-text bucket."""
    import threading

    import numpy as np
    import torch

    reqs = [{"text": BATCH_TEXTS[i], "voice_clone_prompt": _xvec_prompt(100 + i), "xvec_only": True}
            for i in range(8)]
    reqs[5] = dict(reqs[5], text="word " * 400)  # 2000 trailing rows, the pool's bucket is 256
    reqs += [{"text": BATCH_TEXTS[i], "ref_audio": str(long_ref), "ref_text": REF_TEXT} for i in range(4)]
    cancel_sid, bad_sid = 2, 5
    cb = model.continuous_batcher(max_slots=8, chunk_size=CHUNK, first_chunk_size=FIRST_CHUNK,
                                  max_new_tokens=40, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()

    def feeder():
        for r in reqs:
            cb.submit(r)
            time.sleep(0.15)
        cb.close()

    _reset_launches()
    t0 = time.perf_counter()
    th = threading.Thread(target=feeder, daemon=True)
    th.start()
    finals, samples, first = {}, {}, {}
    with shape_tally({}) as tally:
        for sid, audio, sr, t in cb.run(wait=True):
            samples[sid] = samples.get(sid, 0) + audio.size
            if audio.size and sid not in first:
                first[sid] = t["ttfa_from_submit_ms"]
                if sid == cancel_sid:
                    cb.cancel(sid)
            if t["is_final"]:
                if sid in finals:
                    fail(f"continuous: stream {sid} ended twice")
                finals[sid] = t
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    th.join(timeout=60)
    launches = _read_launches()
    after_mem = torch.cuda.memory_allocated()  # the pool stays with the batcher
    if th.is_alive() or sorted(finals) != list(range(len(reqs))):
        fail(f"continuous: streams that ended {sorted(finals)} of {len(reqs)}")
    if not finals[cancel_sid].get("cancelled") or "error" not in finals[bad_sid]:
        fail(f"continuous: cancelled terminal {finals[cancel_sid]}, oversized terminal {finals[bad_sid]}")
    bad = [sid for sid, t in finals.items() if sid not in (cancel_sid, bad_sid)
           and ("error" in t or "cancelled" in t or not samples[sid])]
    if bad:
        fail(f"continuous: streams {bad} ended without audio or with an error")
    ttfa = sorted(first.values())
    row = {"requests": len(reqs), "wall_s": wall, "audio_s": sum(samples.values()) / 24000,
           "aggregate_rtf": sum(samples.values()) / 24000 / wall, "ttfa_from_submit_ms": first,
           "ttfa_p50_ms": statistics.median(ttfa), "ttfa_max_ms": max(ttfa), "launches": launches,
           "shapes": tally, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "base_mem_gb": base_mem / 1e9, "after_mem_gb": after_mem / 1e9,
           "final_keys": {sid: sorted(t) for sid, t in finals.items() if sid in (0, cancel_sid, bad_sid)}}
    log(f"continuous 0.6B Q8_0: {len(reqs)} requests every 150 ms, 8 slots: {row['audio_s']:.2f} s of audio "
        f"in {wall:.2f} s, aggregate RTF {row['aggregate_rtf']:.3f}; TTFA from submit p50 "
        f"{row['ttfa_p50_ms']:.1f} ms, max {row['ttfa_max_ms']:.1f} ms; stream {cancel_sid} cancelled, "
        f"stream {bad_sid} error; launches {launches}, by shape {tally}; peak memory {row['peak_mem_gb']:.2f} GB "
        f"(before the run {row['base_mem_gb']:.2f} GB, after it {row['after_mem_gb']:.2f} GB with the pool)")
    report["continuous_Q8_0"] = row
    return launches


SERVE_FRAMES = 48  # frames a served request may take at most (the server's max_new_tokens)


def _read_upto(resp, n):
    """Read n bytes of a response body (fewer at its end)."""
    buf = b""
    while len(buf) < n:
        part = resp.read(n - len(buf))
        if not part:
            break
        buf += part
    return buf


def serve_phase(model, report, long_ref):
    """The port's server on the loaded checkpoint: `make_server(model,
    continuous=8)` on a thread, an x-vector voice and an ICL voice from the
    4.0 s recording; 4 concurrent POSTs (2 wav, 1 pcm, 1 ICL wav), a bad
    chunk_size and an unknown response_format (400 each), a client that
    closes after its first audio bytes (its lane must be released), GET
    /health. -> launches during the requests."""
    import http.client
    import socket
    import threading
    import urllib.request

    import torch

    from faster_qwen3_tts_tpu_torch import server

    voices = {"xvec": {"ref_audio": str(long_ref), "xvec_only": True},
              "icl": {"ref_audio": str(long_ref), "ref_text": REF_TEXT}}
    srv = server.make_server(model, "127.0.0.1", 0, voices=voices, continuous=8, max_new_tokens=SERVE_FRAMES)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    port = srv.server_address[1]

    def request(body, abort=False):
        fmt = body.get("response_format", "wav")
        rec = {"voice": body.get("voice"), "format": fmt}
        t0 = time.perf_counter()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        conn.request("POST", "/v1/audio/speech", body=json.dumps(body), headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        rec["status"] = resp.status
        if resp.status != 200:
            rec["error"] = json.loads(resp.read())["error"]
            conn.close()
            return rec
        head = 44 if fmt == "wav" else 0
        first = _read_upto(resp, head + 2)  # the header, then the first sample
        rec["first_audio_ms"] = (time.perf_counter() - t0) * 1000.0
        if abort:
            conn.sock.shutdown(socket.SHUT_RDWR)
            conn.close()
            return rec
        data = first + resp.read()
        conn.close()
        rec.update(ms=(time.perf_counter() - t0) * 1000.0, bytes=len(data), audio_s=(len(data) - head) / 2 / 24000)
        if fmt == "wav":
            ok = (data[:4] == b"RIFF" and data[8:12] == b"WAVE" and int.from_bytes(data[24:28], "little") == 24000
                  and int.from_bytes(data[34:36], "little") == 16)
        else:
            ok = True
        pcm = data[head:]
        if not ok or not pcm or len(pcm) % 2:
            fail(f"serve: a {fmt} body of {len(data)} bytes is not a 24 kHz wav / PCM16 stream ({data[:44]!r})")
        return rec

    _reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    bodies = [{"input": BATCH_TEXTS[0], "voice": "xvec"},
              {"input": BATCH_TEXTS[1], "voice": "xvec"},
              {"input": BATCH_TEXTS[2], "voice": "xvec", "response_format": "pcm"},
              {"input": BATCH_TEXTS[3], "voice": "icl"}]
    out = [None] * len(bodies)
    threads = [threading.Thread(target=lambda i: out.__setitem__(i, request(bodies[i])), args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(r is None or r["status"] != 200 for r in out):
        fail(f"serve: concurrent requests answered {out}")
    launches = _read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    bad = [request({"input": "x", "voice": "xvec", "chunk_size": 5}),
           request({"input": "x", "voice": "xvec", "response_format": "ogg"})]
    if [r["status"] for r in bad] != [400, 400]:
        fail(f"serve: bad requests answered {bad}")
    aborted = request({"input": BATCH_TEXTS[4], "voice": "xvec"}, abort=True)
    deadline = time.monotonic() + 120
    while (srv.continuous.cancelled_streams < 1 or srv.continuous.live_lanes()) and time.monotonic() < deadline:
        time.sleep(0.01)
    lanes, cancelled = srv.continuous.live_lanes(), srv.continuous.cancelled_streams
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=60) as r:
        health = json.loads(r.read())
    srv.shutdown()
    srv.server_close()
    th.join(timeout=60)
    if cancelled < 1 or lanes:
        fail(f"serve: after the client went away {cancelled} streams were cancelled, {lanes} lanes live")
    if not health.get("continuous") or health.get("max_slots") != 8 or sorted(health["voices"]) != ["icl", "xvec"]:
        fail(f"serve: health {health}")
    if launches["K1"] == 0 or launches["K2"] == 0:
        fail(f"serve: the requests did not go through both kernels: {launches}")
    row = {"card": CARD, "requests": out, "wall_s": wall, "base_mem_gb": base_gb, "peak_mem_gb": peak_gb,
           "bad_requests": bad, "aborted": aborted,
           "cancelled_streams": cancelled, "live_lanes_after": lanes, "health": health, "launches": launches}
    for r in out:
        log(f"serve ({CARD}): {r['voice']} {r['format']}: POST to first audio byte {r['first_audio_ms']:.1f} ms, "
            f"{r['audio_s']:.2f} s of audio in {r['ms'] / 1000:.2f} s")
    log(f"serve: 4 concurrent requests in {wall:.2f} s, peak device memory {peak_gb:.2f} GB (before "
        f"{base_gb:.2f} GB); launches {launches}; 400 for "
        f"{[r['error'] for r in bad]}; aborted client after {aborted['first_audio_ms']:.1f} ms -> "
        f"{cancelled} stream cancelled, {lanes} lanes live; health {health}")
    report["serve_0.6B_Q8_0"] = row
    return launches


def cli_phase(report, tiny_dir):
    """`python -m faster_qwen3_tts_tpu_torch.cli clone` on the tiny own-format
    checkpoint, on the card, as a subprocess: rc 0 and a 24 kHz wav."""
    from faster_qwen3_tts_tpu_torch.utils import audio as audio_lib

    ref = write_recording(REPO / "build" / "chip_smoke_ref_4s.wav", 4.0, seed=11)
    out = REPO / "build" / "cli.wav"
    out.unlink(missing_ok=True)
    cmd = [sys.executable, "-m", "faster_qwen3_tts_tpu_torch.cli", "clone", "Hello from the command line.",
           "--model", str(tiny_dir), "--xvec-only", "--ref-audio", str(ref), "--streaming", "--max-new-tokens", "8",
           "--seed", "0", "-o", str(out)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"cli: rc {proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    wav, sr = audio_lib.read_wav(out)
    if sr != 24000 or not wav.size or not (abs(wav) <= 1.0).all():
        fail(f"cli: {out} holds {wav.size} samples at {sr} Hz")
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    log(f"cli: {' '.join(cmd[1:4])} ... rc 0 in {wall:.1f} s: {' | '.join(lines)}; {wav.size} samples at {sr} Hz")
    report["cli"] = {"wall_s": wall, "stdout": lines, "samples": int(wav.size)}


def _agreement(ref, toks):
    """Leading frames of `toks` [n, 16] against a solo stream's `ref`."""
    import numpy as np

    n = min(len(ref), len(toks))
    diff = np.argwhere(ref[:n] != toks[:n])
    return {"frames": int(n), "equal_frames": int(n - len(np.unique(diff[:, 0]))),
            "equal_codebook0": int((ref[:n, 0] == toks[:n, 0]).sum()),
            "first_difference": [int(v) for v in diff[0]] if len(diff) else None}  # [frame, codebook]


def slice_batch_phase(model, quant, report):
    """Lockstep x-vector batches on the full-width model: greedy, 64 frames a
    lane; Q8_0 at B = 1, 2, 4, 8 (the first 8 frames of each lane against
    its solo greedy stream; the B = 8 batch again in reverse lane order must
    give each request the same tokens), BF16 at B = 8. -> launches of these
    runs."""
    reqs = [{"text": BATCH_TEXTS[i], "voice_clone_prompt": _xvec_prompt(100 + i), "xvec_only": True}
            for i in range(8)]
    sizes = (1, 2, 4, 8) if quant == "Q8_0" else (8,)
    total = {"K1": 0, "K2": 0}
    rows, solo = [], {}
    if quant == "Q8_0":
        for i, r in enumerate(reqs):
            rec, toks = run_request(model, seed=1, greedy=True, frames=AGREE_FRAMES, args=(r["text"], "English"),
                                    voice_clone_prompt=r["voice_clone_prompt"], min_new_tokens=BATCH_FRAMES)
            solo[i] = (rec, toks)
        log(f"slice {quant} solo greedy streams: RTF " + ", ".join(f"{solo[i][0]['stream_rtf']:.3f}" for i in solo))
    for B in sizes:
        with shape_tally({}) as tally:
            rec, toks = lockstep_run(model, reqs[:B], BATCH_FRAMES)
        for k in total:
            total[k] += rec["launches"][k]
        rec["shapes"] = tally
        logits0 = rec.pop("logits0")
        if solo:  # B = 1 ran first; lane 0 is request 0 at every B
            ref0 = logits0 if B == 1 else ref0
            agree = [_agreement(solo[i][1], t) for i, t in enumerate(toks)]
            rec.update(lane0_prefill_logits_max_abs_diff=float((logits0 - ref0).abs().max()),
                       lane0_prefill_argmax_equal=bool(logits0.argmax() == ref0.argmax()),
                       agreement_with_solo=agree)
        rows.append(rec)
        log(f"lockstep {quant} B={B}: {rec['steps']} steps, wall {rec['wall_s']:.2f} s, aggregate RTF "
            f"{rec['aggregate_rtf']:.3f}; TTFA per lane " + ", ".join(f"{x:.0f}" for x in rec["ttfa_ms"]) +
            f" ms; launches per step K1 {rec['launches_per_step']['K1']:.1f}, K2 "
            f"{rec['launches_per_step']['K2']:.1f}; by shape {tally}" +
            (f"; lane 0's prefill logits vs B=1: max abs diff {rec['lane0_prefill_logits_max_abs_diff']:.3e} "
             f"(of {float(ref0.abs().max()):.3f}), argmax equal {rec['lane0_prefill_argmax_equal']}"
             "; with solo: equal frames " + ", ".join(f"{a['equal_frames']}/{a['frames']}" for a in agree) +
             ", equal codebook-0 tokens " + ", ".join(str(a["equal_codebook0"]) for a in agree) +
             ", first difference (frame, codebook) " + ", ".join(str(a["first_difference"]) for a in agree)
             if solo else ""))
    if quant == "Q8_0":
        per_step = [r["launches_per_step"] for r in rows]
        if any(p["K1"] > per_step[0]["K1"] or p["K2"] > per_step[0]["K2"] for p in per_step):
            fail(f"launches per step grew with B: {per_step}")
        b8 = rows[-1]["shapes"]
        if set(b8.get("K1", {})) != {8} or not {8, 16} <= set(b8.get("K2", {})):
            fail(f"B=8: K1 not launched at 8 lanes or K2 not at 8 and 16 rows: {b8}")
        # lanes are independent: the same requests in reverse lane order get the same tokens
        _, rtoks = lockstep_run(model, reqs[::-1], AGREE_FRAMES)
        for i, t in enumerate(rtoks[::-1]):
            n = min(len(t), len(toks[i]))
            if n < AGREE_FRAMES or not (t[:n] == toks[i][:n]).all():
                fail(f"lockstep B=8 in reverse lane order: request {i} got other tokens ({_agreement(toks[i], t)})")
        log(f"lockstep {quant} B=8 in reverse lane order: every request's {AGREE_FRAMES} frames equal")
        batch_profile(model, reqs, report, f"0.6B B=8 {quant}")
    report[f"lockstep_{quant}"] = {"runs": rows, "solo": {i: solo[i][0] for i in solo}}
    return total


def write_report(path, report) -> None:
    if path:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(report, indent=1))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--report", type=Path, help="write every measurement to this JSON file")
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after the build, kernel and probe phases (prints no ok line)")
    args = parser.parse_args()
    if not (REPO / "faster_qwen3_tts_tpu_torch" / "csrc").is_dir():
        fail("faster_qwen3_tts_tpu_torch/ is not beside chip_smoke.py: run it from the repository")
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    if not smi:
        fail("nvidia-smi printed no name and power limit")
    global CARD
    card = CARD = smi[0]
    log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(card)  # name, power limit: as nvidia-smi prints them
    report = {"device": kind, "nvidia_smi": card, "torch": torch.__version__}

    from faster_qwen3_tts_tpu_torch.ops import kernels

    phase("build")
    lib = kernels.library()
    ptxas = [ln.strip() for ln in lib.build_log.splitlines() if "registers" in ln or "spill" in ln]
    log(f"build: nvcc sm_90a {lib.build_seconds:.1f} s -> {lib.path.name}")
    for ln in ptxas:
        log(f"  ptxas {ln}")
    report["build_s"] = lib.build_seconds

    phase("kernels")
    k1_cases, k2_cases, k4_cases = kernel_phase(report)
    phase("probe")
    k3_cases, k3_launches = probe_phase(report, k2_cases)
    if args.kernels_only:
        write_report(args.report, report)
        log("chip_smoke: --kernels-only, stopped before the reference and slice phases")
        return
    phase("reference")
    tiny_dir = reference_phase(report)
    reference_icl_phase(report, tiny_dir)
    reference_custom_phase(report)
    reference_batch_phase(report, tiny_dir)
    parity_launches = reference_parity_phase(report, tiny_dir)
    phase("cli")
    cli_phase(report, tiny_dir)
    phase("checkpoint + slice 0.6B Q8_0 + ICL")
    from faster_qwen3_tts_tpu_torch import weights
    from faster_qwen3_tts_tpu_torch.config import get_config

    t0 = time.perf_counter()
    tree = weights.init_numpy(get_config(MODEL), seed=0)  # the one 0.6B tree: Q8_0 export, then int4
    init_s = time.perf_counter() - t0
    q8, icl, q8_batch = slice_phase("Q8_0", 2, report, icl=True, tree=tree, init_s=init_s)
    phase("slice 0.6B Q4_K_M + Q8_4 + quant_delta")
    q4 = slice_int4_phase(report, tree)
    del tree
    gc.collect()
    phase("slice BF16")
    bf16, _, bf16_batch = slice_phase("BF16", 1, report)
    if q4["K4"] == 0 or parity_launches["K4"] == 0:
        fail(f"the int4 paths did not launch K4: 0.6B {q4}, tiny {parity_launches}")
    if q8["K1"] == 0 or q8["K2"] == 0 or q8_batch["K1"] == 0 or q8_batch["K2"] == 0:
        fail(f"the Q8_0 slice did not go through both kernels: {q8}, batches {q8_batch}")
    if bf16["K1"] == 0 or bf16_batch["K1"] == 0:
        fail(f"the BF16 slice did not go through K1: {bf16}, batch {bf16_batch}")
    phase("slice 1.7B Q8_0")
    q8_17b = slice_17b_phase(report)
    phase("record")
    jaxish = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.") or
                    m == "faster_qwen3_tts_tpu" or m.startswith("faster_qwen3_tts_tpu."))
    if jaxish:
        fail(f"the port loaded jax or the JAX package: {jaxish[:8]}")
    # launches of every slice path: 0.6B Q8_0 x-vector, Q8_0 ICL, Q8_0 lockstep
    # and continuous batches and the server's requests, 0.6B Q4_K_M and Q8_4
    # x-vector, BF16 x-vector and lockstep batch, 1.7B Q8_0 CustomVoice /
    # VoiceDesign / Base, the tiny engine streams held against parity_mode;
    # K3's probe
    paths = (q8, icl, q8_batch, q4, bf16, bf16_batch, q8_17b, parity_launches)
    total = {k: sum(p.get(k, 0) for p in paths) for k in ("K1", "K2", "K4")}
    total["K3"] = k3_launches

    def entry(name, source, replaces, cases, launches, pick):
        c = cases[pick]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": max(c["max_abs_err"] for c in cases),
                "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                "bound_by": c["bound_by"], "library_ms": c["library_ms"]}

    # ms: K1 at 133 live talker slots, K2 and K4 at the 1.7B gate/up (M = 1), K3 at 704 MB
    gate_up = next(i for i, c in enumerate(k2_cases) if c["shape"] == (1, 2048, 6144))
    gate_up4 = next(i for i, c in enumerate(k4_cases) if c.get("shape") == (1, 2048, 6144))
    record = {"kernels": [
        entry("decode_attention", "faster_qwen3_tts_tpu_torch/csrc/decode_attention.cu",
              "faster_qwen3_tts_tpu/ops/decode_attn_pallas.py:84 (git ce388ee^)", k1_cases,
              total["K1"], 1),
        entry("int8_gemv", "faster_qwen3_tts_tpu_torch/csrc/int8_gemv.cu",
              "faster_qwen3_tts_tpu/ops/matvec_pallas.py:86 (git f94c020^)", k2_cases, total["K2"],
              gate_up),
        entry("weight_stream", "faster_qwen3_tts_tpu_torch/csrc/weight_stream.cu",
              "benchmarks/pallas_bw_probe.py:73 (git 4565532)", k3_cases, total["K3"], 0),
        # K4 replaces no Pallas kernel: its spec is the XLA-computed `_dot4`
        entry("int4_gemv", "faster_qwen3_tts_tpu_torch/csrc/int4_gemv.cu",
              "faster_qwen3_tts_tpu/ops/quant.py:87", k4_cases, total["K4"], gate_up4),
    ]}
    report["record"] = record
    write_report(args.report, report)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
