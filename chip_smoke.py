#!/usr/bin/env python3
"""Smoke run of the PyTorch port (faster_qwen3_tts_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                       # from the repository root, on a machine with a card
    python3 chip_smoke.py --report out.json     # also write every measurement to out.json
    python3 chip_smoke.py --kernels-only        # phases 1-4 only (no ok line)

Phases, each of which fails the run:
1. device: a CUDA card must be visible; prints its name and power limit;
2. build: compiles the port's CUDA kernels (K1 decode attention, K2 int8
   GEMV, K3 weight streaming) from faster_qwen3_tts_tpu_torch/csrc with one
   nvcc per source for sm_90a, and prints what ptxas says of each kernel;
3. kernels: K1 and K2 against their plain PyTorch versions on the same
   inputs at the shapes of the 0.6B and 1.7B slices, with the error, the
   median device time per call (CUDA-graph replay over operands larger than
   L2) of the kernel, of its plain version and of one PyTorch call that
   computes the same function (the yardstick the port never calls: SDPA
   for K1, `torch._weight_int8pack_mm` for K2, and for scale the bf16
   matmul), the bound (bytes over the HBM rate or operations over the peak
   rate, whichever is larger) and the median eager call time;
4. probe: K3 streams the stacked int8 weights of the Pallas probe it
   replaces (L=28, I=2048, O=12288, the 1.7B gate+up stack, and L=28,
   I=1024, O=6144), timed with CUDA events, then held against its plain
   version: error, device ms and GB/s of each, its bound and the library
   call's time;
5. reference: the port on the card against the port on the CPU (plain
   versions) at a tiny geometry in float32, greedy: x-vector streams (equal
   tokens); ICL voice clone from a seeded synthetic recording written under
   build/: x-vector (relative 1e-3), reference codes (equal, up to argmin
   ties), streamed tokens (equal) and audio (1e-3); a CustomVoice stream
   (dialect speaker, Chinese, an instruction) and a VoiceDesign stream:
   equal tokens, audio within 1e-3;
6. slice 0.6B Q8_0: `from_pretrained("Qwen/Qwen3-TTS-12Hz-0.6B-Base",
   quant="Q8_0")` at full width (random weights from a seed), `warmup()`,
   then three streaming x-vector voice-clone requests (chunk 8, first chunk
   4); checks the audio, that K1 and K2 carried the run, and greedy
   determinism; prints TTFA and stream RTF per request; then one 24-frame
   stream under torch.profiler: K1 and K2 device ms and launches per frame;
7. slice ICL on the same Q8_0 model: `create_voice_clone_prompt` timed on a
   4.0 s recording; ICL streams from `ref_audio` with a long reference
   (~56 frames: every chunk vocoded on the card) and a short one (~19
   frames: host decode with the reference prepended until 24 frames), one
   `xvec_only` stream, one non-streaming ICL request; checks sample counts,
   that K1 and K2 carried these requests, and greedy determinism;
8. slice BF16: one x-vector request in BF16 (K1 only);
9. slice 1.7B Q8_0: `from_pretrained("Qwen/Qwen3-TTS-12Hz-1.7B-CustomVoice",
   quant="Q8_0")`, `warmup()`, two CustomVoice streams (a plain speaker in
   English, a dialect speaker in Chinese) and one non-streaming request;
   on the same weights VoiceDesign (two streams with an instruction, one
   non-streaming request) and a Base x-vector stream; checks sample counts,
   that K1 and K2 carried these requests, and greedy determinism; prints
   load and warmup time, TTFA and stream RTF per request, peak memory; then
   a 24-frame CustomVoice stream under torch.profiler, as in 6.

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
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
MODEL = "Qwen/Qwen3-TTS-12Hz-0.6B-Base"
MODEL_17B = "Qwen/Qwen3-TTS-12Hz-1.7B-CustomVoice"
TEXT = "The quick brown fox jumps over the lazy dog today."
CHUNK, FIRST_CHUNK, FRAMES = 8, 4, 64  # 64 frames: 5.1 s of audio a stream
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


def check_close(name, out, ref, details):
    import torch

    err = (out.float() - ref.float()).abs()
    bad = (err > ATOL + RTOL * ref.float().abs()).sum().item()
    max_err = err.max().item()
    details.append({"case": name, "max_abs_err": max_err, "atol": ATOL, "rtol": RTOL})
    if bad or not torch.isfinite(out).all():
        fail(f"{name}: {bad} elements outside atol {ATOL} / rtol {RTOL} (max abs err {max_err})")
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
# K2: every Q8_0 projection shape of the 0.6B and 1.7B talkers and the
# predictor they share
K2_SHAPES = {(1024, 2048): "wq/lm_heads", (1024, 1024): "wk/wv/mtp_proj/text_proj",
             (2048, 1024): "wo; 1.7B wk/wv/mtp_proj", (1024, 3072): "gate/up/codec_head",
             (3072, 1024): "down", (2048, 2048): "1.7B wq/wo/text_proj", (2048, 6144): "1.7B gate/up",
             (6144, 2048): "1.7B down", (2048, 3072): "1.7B codec_head"}


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
    rng = np.random.default_rng(0)
    for (I, O), what in K2_SHAPES.items():
        ql = quant.quantize_linear(rng.standard_normal((I, O)).astype("float32") * I**-0.5)
        qw, sc = torch.from_numpy(ql.q).to(dev), torch.from_numpy(ql.scale).to(dev)
        n = _copies(qw.numel())
        qs = [qw] + [qw.clone() for _ in range(n - 1)]
        packed = [w.t().contiguous() for w in qs]  # [O, I], the layout torch's int8 call takes
        sc_bf16 = sc.reshape(O).to(torch.bfloat16)
        wbf = [qw.to(torch.bfloat16)] + [qw.to(torch.bfloat16) for _ in range(max(2, n // 2) - 1)]
        for M in (1, 2):
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
    report["kernel_cases"] = {"K1": k1_cases, "K2": k2_cases}
    return k1_cases, k2_cases


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
# the text vocabulary is cut to 512, so the tts control ids move below it.
TINY_CONFIG = {
    "model_type": "base", "tts_bos_token_id": 300, "tts_eos_token_id": 301, "tts_pad_token_id": 302,
    "talker_config": {"num_hidden_layers": 2, "hidden_size": 128, "num_attention_heads": 4,
                      "num_key_value_heads": 2, "head_dim": 32, "intermediate_size": 256,
                      "text_hidden_size": 64, "text_vocab_size": 512},
    "predictor_config": {"num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 2,
                         "num_key_value_heads": 1, "head_dim": 32, "intermediate_size": 128},
    "codec_config": {"hidden_size": 64, "num_hidden_layers": 1, "intermediate_size": 128,
                     "num_attention_heads": 2, "num_key_value_heads": 2, "head_dim": 32},
}


def reference_phase(report, devices=("cpu", "cuda")):
    """Port on the card vs port on the CPU (the kernels' plain versions) at a
    tiny geometry in float32, greedy, through `from_pretrained`."""
    import numpy as np

    from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS

    tiny_dir = _tiny_config_dir("chip_smoke_tiny")
    prompt = {"ref_spk_embedding": [np.random.default_rng(0).standard_normal(2048).astype(np.float32)]}
    for quant in ("none", "Q8_0"):  # float32 weights, or their int8 quantization
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
    as a config.json under build/ -> its directory."""
    cfg = dict(TINY_CONFIG, **over)
    cfg["talker_config"] = dict(TINY_CONFIG["talker_config"], **over.get("talker_config", {}))
    path = REPO / "build" / name
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(cfg))
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


def _read_launches():
    from faster_qwen3_tts_tpu_torch.ops import attention
    from faster_qwen3_tts_tpu_torch.ops import quant as quant_ops

    return {"K1": attention.decode_attention.launches, "K2": quant_ops.int8_gemv.launches}


def frame_profile(model, name, report, method="generate_voice_clone_streaming", args=(TEXT, "English")):
    """K1 and K2 inside the frame: one 24-frame stream under torch.profiler ->
    device ms and launches per frame of each kernel and of all kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    _reset_launches()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:  # device activity only: less to parse
        req, _ = run_request(model, seed=41, frames=24, method=method, args=args)
    counted = _read_launches()
    parse_s = time.perf_counter() - t0 - req["wall_s"]
    frames = req["frames"]

    def device_us(e):  # the kernel's own device time, across torch versions
        us = getattr(e, "self_device_time_total", None)
        return us if us is not None else e.self_cuda_time_total

    events = prof.key_averages()
    total_us = sum(device_us(e) for e in events)
    row = {"frames": frames, "wall_ms_per_frame": req["wall_s"] * 1e3 / frames, "parse_s": parse_s,
           "device_ms_per_frame": total_us / 1e3 / frames, "counted_launches": counted}
    for kname, needle in (("K1", "decode_attn_kernel"), ("K2", "int8_gemv_kernel")):
        hits = [e for e in events if needle in e.key]
        row[kname] = {"ms_per_frame": sum(device_us(e) for e in hits) / 1e3 / frames,
                      "launches_per_frame": sum(e.count for e in hits) / frames,
                      "us_per_launch": sum(device_us(e) for e in hits) / max(1, sum(e.count for e in hits))}
    log(f"frame profile, {name}: {frames} frames, profiled wall {row['wall_ms_per_frame']:.1f} ms/frame, "
        f"device {row['device_ms_per_frame']:.3f} ms/frame; K1 {row['K1']['ms_per_frame']:.3f} ms/frame "
        f"({row['K1']['launches_per_frame']:.1f} launches, {row['K1']['us_per_launch']:.2f} us each); K2 "
        f"{row['K2']['ms_per_frame']:.3f} ms/frame ({row['K2']['launches_per_frame']:.1f} launches, "
        f"{row['K2']['us_per_launch']:.2f} us each); counted launches {counted}; trace parsed in "
        f"{parse_s:.1f} s")
    if row["K1"]["launches_per_frame"] == 0 or row["K2"]["launches_per_frame"] == 0:
        fail(f"frame profile {name}: the trace shows no K1 or K2 kernel")
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
    for _ in range(4):  # the first call also draws the encoders' weights and moves them to the card
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (item,) = model.create_voice_clone_prompt((audio, sr), ref_text=REF_TEXT)
        torch.cuda.synchronize()
        extract_ms.append((time.perf_counter() - t0) * 1000.0)
    log(f"slice ICL: create_voice_clone_prompt on a 4.0 s recording: first call {extract_ms[0]:.1f} ms "
        f"(encoder init included), then {', '.join(f'{t:.1f}' for t in extract_ms[1:])} ms; "
        f"{item.ref_code.shape[0]} frames of codes")

    cases = [("long ICL", long_ref, False, FRAMES, 21), ("short ICL", short_ref, False, 48, 22),
             ("xvec_only", short_ref, True, 48, 23)]
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
                                                ref_text=REF_TEXT, max_new_tokens=48, seed=24)
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


def slice_phase(quant, n_requests, report, icl=False):
    """x-vector requests on the full-width model, then (icl) the ICL
    requests on the same model. -> launches of each path."""
    import torch

    from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
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
    del model
    gc.collect()  # each slice's peak memory is its own
    torch.cuda.empty_cache()
    return launches, icl_launches


def run_non_streaming(model, method, args, seed, frames=48):
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
               ("VoiceDesign 1", design, vd, (TEXT, DESIGN, "English"), 33),
               ("VoiceDesign 2", design, vd, (TEXT, DESIGN, "English"), 34),
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
    card = smi[0]
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
    k1_cases, k2_cases = kernel_phase(report)
    phase("probe")
    k3_cases, k3_launches = probe_phase(report, k2_cases)
    if args.kernels_only:
        write_report(args.report, report)
        log("chip_smoke: --kernels-only, stopped before the reference and slice phases")
        return
    phase("reference")
    reference_icl_phase(report, reference_phase(report))
    reference_custom_phase(report)
    phase("slice 0.6B Q8_0 + ICL")
    q8, icl = slice_phase("Q8_0", 3, report, icl=True)
    phase("slice BF16")
    bf16, _ = slice_phase("BF16", 1, report)
    if q8["K1"] == 0 or q8["K2"] == 0:
        fail(f"the Q8_0 slice did not go through both kernels: {q8}")
    if bf16["K1"] == 0:
        fail(f"the BF16 slice did not go through K1: {bf16}")
    phase("slice 1.7B Q8_0")
    q8_17b = slice_17b_phase(report)
    phase("record")
    jaxish = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.") or
                    m == "faster_qwen3_tts_tpu" or m.startswith("faster_qwen3_tts_tpu."))
    if jaxish:
        fail(f"the port loaded jax or the JAX package: {jaxish[:8]}")
    # launches of every slice path: 0.6B Q8_0 x-vector, Q8_0 ICL, BF16
    # x-vector, 1.7B Q8_0 CustomVoice / VoiceDesign / Base; K3's probe
    total = {k: q8[k] + icl[k] + bf16[k] + q8_17b[k] for k in q8}
    total["K3"] = k3_launches

    def entry(name, source, replaces, cases, launches, pick):
        c = cases[pick]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": max(c["max_abs_err"] for c in cases),
                "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                "bound_by": c["bound_by"], "library_ms": c["library_ms"]}

    # ms: K1 at 133 live talker slots, K2 at the 1.7B gate/up (M = 1), K3 at 704 MB
    gate_up = next(i for i, c in enumerate(k2_cases) if c["shape"] == (1, 2048, 6144))
    record = {"kernels": [
        entry("decode_attention", "faster_qwen3_tts_tpu_torch/csrc/decode_attention.cu",
              "faster_qwen3_tts_tpu/ops/decode_attn_pallas.py:84 (git ce388ee^)", k1_cases,
              total["K1"], 1),
        entry("int8_gemv", "faster_qwen3_tts_tpu_torch/csrc/int8_gemv.cu",
              "faster_qwen3_tts_tpu/ops/matvec_pallas.py:86 (git f94c020^)", k2_cases, total["K2"],
              gate_up),
        entry("weight_stream", "faster_qwen3_tts_tpu_torch/csrc/weight_stream.cu",
              "benchmarks/pallas_bw_probe.py:73 (git 4565532)", k3_cases, total["K3"], 0),
    ]}
    report["record"] = record
    write_report(args.report, report)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
