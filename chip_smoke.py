#!/usr/bin/env python3
"""Smoke run of the PyTorch port (faster_qwen3_tts_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                       # from the repository root, on a machine with a card
    python3 chip_smoke.py --report out.json     # also write every measurement to out.json
    python3 chip_smoke.py --kernels-only        # phases 1-4 only (no ok line)
    python3 chip_smoke.py --restart-from DIR    # phase 10c's fresh process: restart from the bundle DIR

Phases, each of which fails the run:
1. device: a CUDA card must be visible; prints its name and power limit;
2. build: compiles the port's CUDA kernels (K1 decode attention, K2 int8
   GEMV, K4 int4 GEMV, K3 weight streaming, K5-K7 the decoder layer's glue)
   from faster_qwen3_tts_tpu_torch/csrc
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
   case and one replay in a CUDA graph; K2 and K4 also at the shapes of
   the fused projection layout (wqkv I 1024 / 2048, O 4096; w_gateup
   1024 x 6144 and 2048 x 12288) with 1, 8 and 16 rows; K1 at one tp = 2
   rank's heads (8 query / 4 kv), one lane and a dp group's two lanes (bf16
   and float32), and K2 at every 0.6B and 1.7B tp = 2 shard shape (column
   shards O / 2, row shards I / 2) with 1 and 2 bf16 rows, the row shards
   also with 1, 2 and 4 float32 rows as the mesh feeds them (float32 cases
   at atol 1e-4 / rtol 1e-5); then K5 (add + RMSNorm), K6 (q / k norm,
   RoPE, K/V write) and K7 (SiLU * up) the same way at the main path's bf16
   shapes (K5: 1 x 1024 and 1 x 2048 with a residual, 8 x 1024, a predictor
   prefill's per-head q norm on a fused-layout view, `F.rms_norm` its
   yardstick; K6: B = 1 and 8, 16 / 8 heads, S_max 2048, split and fused
   views, a lane clamped to the last slot, every other cache slot held
   unchanged; K7: 1 x 3072, 1 x 6144 and 8 x 3072, split and fused), normed
   rows within one bf16 ulp, K5's sums, K6's V rows and K7 bit for bit;
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
6. mesh refusals: `from_pretrained(<tiny dir>, dp=2, tp=2)` on one card
   raises the device-count ValueError, a process mesh whose tp group sits
   on cuda:0 twice ValueError (NCCL's one rank a card) before spawning, a
   tp group or dp groups over cuda:0 and cuda:1 the device-count
   ValueError;
   cli: `python -m faster_qwen3_tts_tpu_torch.cli clone` on the tiny
   checkpoint as a subprocess on the card (rc 0, a 24 kHz wav); examples:
   each script of examples_torch/ as a subprocess on the card at the tiny
   geometry (extract_speaker to .npy and .spk, generate_with_embedding from
   each, streaming_playback twice: the second run must read the voice from
   the native backend's cache);
6b. tokenizer: for both committed fixture layouts (tests/fixtures/
   qwen_tokenizer, a tokenizer.json; tests/torch_fixtures/qwen2_tokenizer,
   vocab.json + merges.txt + a Qwen2Tokenizer config), `load_tokenizer`
   must pick the port's BPE reader (`utils/bpe.py`) with no WARNING logged,
   and its ids and decodes of every fixed text must equal the ones
   `AutoTokenizer` wrote into tests/torch_fixtures/tokenizer_expected.json;
   prints the reader's load ms (the first in the process builds the
   Unicode class tables), encode us per text (word cache cleared, and
   warm) and the phase's seconds;
7. checkpoint + slice 0.6B Q8_0: the 0.6B Base tree of `init_numpy(seed=0)`
   (0.96 B parameters) written by `export_hf_layout` (float32, 3.86 GB)
   under build/ beside the Qwen2-layout tokenizer fixture, and loaded by
   `from_pretrained(dir, quant="Q8_0", strict=True)`: full coverage, every
   leaf bitwise equal to `materialize` of the same tree, the tokenizer the
   port's BPE reader and no byte-tokenizer warning (so every stream, batch
   and server request of this model below runs on BPE ids); export, load
   phases and times; the weights file is deleted (the tokenizer assets stay
   for the restart's bundles). On that model `warmup()` (the graphs of
   the JAX warmup's set, the prefill graphs of prompt buckets 32-256 among them: its
   phases, captures, seconds and graph memory are printed), then two
   streaming x-vector voice-clone requests (chunk 8, first chunk 4, 32
   frames; their prompts assembled on the card) that must run no frame and
   no prefill eagerly; checks the audio, that K1 and K2 carried the run,
   and greedy determinism; prints TTFA and stream RTF per request beside
   the eager-prefill runs'; then one 24-frame stream under torch.profiler:
   K1 and K2 device ms and launches per frame (over graph replays);
7b. graphs on the same Q8_0 model: from one start state, 32 replays of the
   captured frame against eager `core.decode_chunk` (packed rows, pos, done
   and KV cache exact), greedy and sampled with one seed; a (8, 24) window
   replay against eager `_vocode_window` (1e-5); the captured frame's ms
   (CUDA events) against the eager frame's and the kernels' ms a frame and
   busy share (torch.profiler over the replays); then the prefill graphs:
   at prompt buckets 32, 64, 128 and 256, greedy and sampled with one seed,
   a replay of the bucket's graph must equal eager `core.start_state` of
   the same prompt bit for bit (KV cache over the bucket, token, past
   hidden, pos, num_pads) and run no eager prefill; eager ms against replay
   ms (CUDA events);
8. slice ICL on the same Q8_0 model: `create_voice_clone_prompt` timed on a
   4.0 s recording; the device prompt against the host prompt at full width
   in bf16 for an x-vector and an ICL request from that recording (masks
   equal, tie and trailing text within the kernels' tolerance, the largest
   difference printed) and each builder's ms a request; ICL streams from `ref_audio` with a long reference
   (~56 frames: every chunk vocoded on the card) and a short one (~19
   frames: host decode with the reference prepended until 24 frames), one
   `xvec_only` stream, one non-streaming ICL request; checks sample counts,
   that K1 and K2 carried these requests, and greedy determinism;
9. batches on the same Q8_0 model: the lockstep graphs captured first
   (B = 8 under a tally of K1's lanes and K2's rows), eight solo greedy
   x-vector streams, then `generate_voice_clone_streaming_batch` of the
   same requests at B = 1, 2, 4, 8 (64 frames a lane, no eager frame): aggregate RTF, TTFA per lane, K1 and K2
   launches per decode step (which must not grow with B), the lanes' row
   and lane counts at K2 and K1 (B = 8 must launch K1 at 8 lanes and K2 at
   8 and 16 rows), each lane's agreement with its solo stream, the B = 8
   batch in reverse lane order (each request's tokens must not change), and
   a B = 8 run under torch.profiler (K1 and K2 device ms and launches per
   step, busy share); then the pool's graphs captured (`warmup(pool_slots=8)`)
   and a ContinuousBatcher (8 slots, no eager frame or prefill) answering 12
   requests (8 x-vector, 4 ICL) submitted from a thread every 150 ms, one
   cancelled at its first audio and one with text over the pool's bucket:
   every stream must end once, those two with `cancelled` and `error`;
   TTFA from submit p50 / max (beside the eager-prefill runs'), aggregate RTF,
   peak memory;
10. serve on the same Q8_0 model: `server.warm(model, continuous=8)` (what
   `--warmup` runs), `server.make_server(model, continuous=8)` on a thread, an x-vector and an ICL voice from the 4.0 s recording; 4
   concurrent POSTs (2 wav, 1 pcm, 1 ICL), a bad chunk_size and an unknown
   response_format (400), a client that closes after its first audio bytes
   (its lane must be released), GET /health; every 200 body a 24 kHz wav or
   PCM16 stream, K1 and K2 launched, no eager frame or prefill; POST to
   first audio byte per request, beside the eager-prefill runs';
10b. demo on the same Q8_0 model: `demo_server.make_demo_server` with the
   model injected as ("0.6b", "Q8_0") and its usage store under build/;
   POST /load with warmup (a cache hit that must capture nothing), the 4.0 s
   recording uploaded raw and as multipart (one ref_id), two concurrent SSE
   streams at chunk 8 (x-vector and ICL from the upload, 48 frames; events
   queued -> chunk... -> done, chunk_index 0..n-1, every wav_b64 a mono
   24 kHz PCM16 WAV, audio_s their sum, one queued at position 1, no eager
   frame or prefill, K1 and K2 launched), one POST /generate (24 kHz), 400s
   for chunk_size 5 and 1001 characters, a client that leaves after its
   first chunk (the next request completes, no graph set stays leased), a
   login with a daily limit of 1 (200, then 429) and the web-only gate (403
   without the page token, 200 with it);
10c. restart on the same Q8_0 model: `save_deploy_bundle` full float32 and
   compact under build/ (sizes, seconds, the size the JAX writer gives the
   manifest, which must be the file's); a fresh process (`--restart-from`)
   runs `from_pretrained(<full bundle>)`, `warmup(first_chunk_size=4)` and
   one greedy x-vector stream: its tokenizer must be the BPE reader (the
   bundle carries the checkpoint's tokenizer assets) with no byte-tokenizer
   warning, its codes must equal this model's greedy stream exactly and its
   card memory after the load be within 1 % of the strict load's; printed: process start to first audio, the load phases
   (pin, weights_read, device_transfer, transfer_mb) beside the strict
   load's seconds, K1 / K2 launches (which must move); then the compact
   bundle loaded in this process: every leaf the bf16 rounding of the
   strict leaf, its greedy codes counted against this model's (not held:
   compact rounds the quantization scales too);
10d. mesh procs, from the full bundle: dp = 2 x tp = 1 as two processes on
   cuda:0 (this one, rank 0, and a spawned worker; `make_mesh(2, dp=2,
   tp=1, devices=[cuda:0] * 2, processes=True)` passed to
   `from_pretrained`): the worker's start (spawn, join, load) and its
   module check, `warmup`, a 4-lane greedy lockstep batch of 32 frames
   whose every dp group's 2 lanes must equal, code for code, this model's
   B = 2 batch of the same two requests; no eager frame or prefill in
   either process (the worker's counters read over the control plane), K1
   and K2 launched in both (the worker's launches go into the record);
   captured B = 2 frame ms of each process and of this model, aggregate
   RTF, lane TTFA; then the NCCL capture check on rank 0's one-rank NCCL tp
   group: the port's `mesh.all_reduce` (float32 [4, 1, H]) and
   `mesh.all_gather` (logits along dim -1) captured in one CUDA graph, 100
   replays each equal to eager; the host ms of a control-plane round trip
   (one command out, one reply back, median of 20); `close()` leaves no
   worker;
11. int4 slice: the same seeded 0.6B tree (one `init_numpy`) materialized
    in float32, BF16, Q8_0, Q4_K_M and Q8_4: the quant_delta row (prefill
    logit cosine and top-10 overlap against float32, projection bytes);
    Q8_0, Q4_K_M and Q8_4 each serve a 32-frame x-vector stream, back to
    back (TTFA, RTF, peak memory, K2 and K4 launches per decode step; K4
    must launch; no eager frame or prefill), Q4_K_M the graphs check of 7b
    (greedy) and its prefill graphs check (greedy and sampled),
    Q4_K_M and Q8_4 a profiled 24-frame stream (K4's device us
    a launch printed beside K2's from the Q8_0 and Q8_4 profiles of the same
    run); on Q8_4 a 16-frame greedy `parity_mode` stream against the
    engine's (frames that agree, reported); native, on the Q8_0 params:
    the host library must load (built with g++ from the port's
    csrc/fq3t.cpp; no fallback hides its absence), native against numpy
    resampling and PCM16, a ring-buffer round trip, `NativeQwen3TTS` over
    the same params extracting a reference once (miss) and again (hit), a
    greedy stream from the `.spk` file bitwise equal to one from a
    `voice_clone_prompt` of the same x-vector (after a warmup of the greedy
    key: no eager frame or prefill),
    `from_pretrained(<tiny dir>, backend="native")` once; fused, on the
    Q8_0 and Q4_K_M params: `quant.fuse_layer_weights` at full width as a
    second model with graph sets of its own, 32 fused replays bitwise equal
    to fused eager (greedy and sampled), fused against unfused on one
    greedy prompt (layer 0's fused products within 2e-2, prefill logits and
    hidden by cosine, the first frame where greedy tokens part), K2 / K4 launches, us a
    launch, kernel ms a frame and frame ms beside the unfused figures of the
    run, `warmup` and three solo streams (TTFA, RTF, launches a decode
    step; no eager frame or prefill), both models' graph memory; the BF16
    model written as a bundle and loaded with quant="Q8_0" (quantized on the
    card): every int8 leaf and every leaf but the scales bitwise equal to
    materialize's Q8_0, the scales' largest ulp distance printed; the Q8_4
    model bundled (full float32) and loaded back: every leaf bitwise, greedy
    codes equal, K1 / K2 / K4 launched; the (dp, tp) mesh, after each of
    F32, Q8_0 and Q8_4: the tree sharded on a 2 x 2 mesh of one card
    (`make_mesh(4, dp=2, tp=2, devices=[cuda:0] * 4)`, `FasterQwen3TTS(
    shard_params(...), mesh=mesh)`); F32: a 4-lane greedy lockstep batch
    against the unsharded model (prefill logits within
    MESH_F32_LOGIT_REL, every lane's first frame equal); F32 and Q8_0: the
    same prompts' prefill logits again with a planted fault (the last tp
    rank's partials dropped), which must fall outside the limit
    (MESH_F32_LOGIT_REL, MESH_Q8_LOGIT_REL for Q8_0's bf16); Q8_0 and Q8_4:
    `warmup`, a 4-lane lockstep batch of 32 frames (two lanes a dp group,
    no eager frame or prefill; K4 must launch under Q8_4), Q8_0 also a solo
    tp stream and the unsharded model's batch and stream: captured frame ms
    against unsharded, launches a group's frame against the count the
    sharded layers make, K1 / K2 shapes at capture (K1 at 4 kv heads, K2 at
    the shard widths), graph memory, lane TTFA and aggregate RTF;
12. slice BF16: one x-vector request in BF16 (K1 only) and a B = 8 batch;
13. slice 1.7B Q8_0: `from_pretrained("Qwen/Qwen3-TTS-12Hz-1.7B-CustomVoice",
   quant="Q8_0")`, `warmup()`, the prefill graphs check of 7b, the device
   prompt against the host prompt of 8 for a CustomVoice and a VoiceDesign
   request, two CustomVoice streams (a plain speaker in
   English, a dialect speaker in Chinese) and one non-streaming request;
   on the same weights VoiceDesign (a stream with an instruction, one
   non-streaming request) and a Base x-vector stream; checks sample counts,
   that K1 and K2 carried these requests, and greedy determinism; prints
   load and warmup time, TTFA and stream RTF per request (no eager frame or
   prefill), peak memory; a `mode: "custom"` and a `mode: "design"` SSE
   stream through the demo server over these weights (no eager frame or
   prefill, K1 and K2 launched); then
   a 24-frame CustomVoice stream under torch.profiler, as in 7. After the
   warmup, device init: `FQ3T_DEVICE_INIT=1 from_pretrained(...,
   quant="Q8_0")` beside the host init's seconds: the same tree, shapes
   and dtypes, constant leaves exact, every other leaf of >= 256 elements
   with a std within 0.6-1.6x the host leaf's, one CustomVoice stream
   (finite audio, K1 and K2 launched).

Kernel launches are counted replay-aware: each wrapper counts its eager
launches and those it records into a graph at capture; `engine.graphs`
counts what replays launched (a graph's launches at capture times its
replays); a path fails if one of its kernels launched no time, and the
run fails if the slice paths together never launched K5, K6 or K7. The run
fails if jax or any module of the JAX package (faster_qwen3_tts_tpu)
was loaded.
Before them, one `demo` line: per demo stream the POST to its first chunk
event beside the event's ttfa_ms, the done RTF and the queued position;
/generate ms, the demo phases' seconds and K1 / K2 launches.
The second-to-last line is the kernels' JSON record (K1-K7: source, the
TPU kernel each replaces, launches over the slice paths, the largest error,
and one main-path case's ms, plain ms, bound and library ms), the last line
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
import threading
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
# K1 at one tp = 2 rank's heads (8 query / 4 kv): the talker at 128 live
# slots and the predictor's last pass
K1_TP2_CASES = [(2048, 5, 133), (17, 0, 17)]
# K1 at a tp = 2 rank's heads over the two lanes of a dp group (the mesh's
# own launch shape), in bf16 (the Q8_0 / Q8_4 mesh) and float32 (the F32 mesh)
K1_TP2_BATCH_CASES = [(2048, [(5, 133), (0, 40)]), (17, [(0, 17)] * 2)]
# K2: every Q8_0 projection shape of the 0.6B and 1.7B talkers and the
# predictor they share
K2_SHAPES = {(1024, 2048): "wq/lm_heads", (1024, 1024): "wk/wv/mtp_proj/text_proj",
             (2048, 1024): "wo; 1.7B wk/wv/mtp_proj", (1024, 3072): "gate/up/codec_head",
             (3072, 1024): "down", (2048, 2048): "1.7B wq/wo/text_proj", (2048, 6144): "1.7B gate/up",
             (6144, 2048): "1.7B down", (2048, 3072): "1.7B codec_head"}
# the 0.6B shapes also at the rows of an 8-lane pool: 8 (talker, predictor
# passes 2-15) and 16 (the predictor's first pass, two rows a lane)
K2_SHAPES_06B = ((1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072), (3072, 1024))
# K2 at the tp = 2 shard widths (`parallel.mesh.shard_params`): column shards
# O / 2, row shards I / 2; the 0.6B predictor shares the 0.6B talker's widths
K2_TP2_SHAPES = {(1024, 1024): "0.6B wq, wo rows, lm_heads", (1024, 512): "0.6B wk/wv",
                 (1024, 1536): "0.6B gate/up, codec_head", (1536, 1024): "0.6B down rows",
                 (2048, 1024): "1.7B wq", (2048, 512): "1.7B wk/wv", (1024, 2048): "1.7B wo rows",
                 (2048, 3072): "1.7B gate/up", (3072, 2048): "1.7B down rows", (2048, 1536): "1.7B codec_head"}
# the row shards again with float32 rows, as the mesh feeds them
# (`models.layers._row`: float32 partials into the reduction), at a group's
# 1 and 2 lanes and the predictor's first pass of 2 lanes (4 rows)
K2_TP2_ROW_SHAPES = ((1024, 1024), (1536, 1024), (1024, 2048), (3072, 2048))
# the fused projection layout (`quant.fuse_layer_weights`): K2 and K4 at 1, 8
# and 16 rows at the widths no unfused projection has
FUSED_SHAPES = {(1024, 4096): "fused wqkv: 0.6B talker, predictor", (1024, 6144): "fused w_gateup: 0.6B, predictor",
                (2048, 4096): "fused wqkv: 1.7B talker", (2048, 12288): "fused w_gateup: 1.7B"}


def _gemv_cases(main_rows):
    """(I, O, what, rows, fused) of every K2 / K4 case: the main-path shapes
    at `main_rows(I, O)` rows, the fused shapes at 1, 8 and 16."""
    return ([(I, O, what, main_rows(I, O), False) for (I, O), what in K2_SHAPES.items()]
            + [(I, O, what, (1, 8, 16), True) for (I, O), what in FUSED_SHAPES.items()])


def kernel_phase(report):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from faster_qwen3_tts_tpu_torch.ops import attention, quant

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    k1_cases, k2_cases = [], []
    # the whole heads (16 query / 8 kv), then one tp = 2 rank's (8 / 4; GQA ratio 2 in both)
    for S, lo, hi, hq, hkv in [c + (16, 8) for c in K1_CASES] + [c + (8, 4) for c in K1_TP2_CASES]:
        q = torch.randn(1, 1, hq, 128, generator=g).to(dev, torch.bfloat16)
        k = torch.randn(1, S, hkv, 128, generator=g).to(dev, torch.bfloat16)
        v = torch.randn(1, S, hkv, 128, generator=g).to(dev, torch.bfloat16)
        s = torch.arange(S)
        mask = ((s >= lo) & (s < hi)).to(torch.int32)[None].to(dev)
        out = attention.decode_attention(q, k, v, mask)
        torch.cuda.synchronize()
        ref = attention.decode_attention_plain(q.float(), k.float(), v.float(), mask)
        name = f"K1 S_max={S} live=[{lo},{hi})" + ("" if hkv == 8 else f" heads {hq}/{hkv} (a tp=2 rank; {CARD})")
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
        timed.update(bound(2 * q.numel() * 2 + 2 * live * hkv * 128 * 2 + S * 4, 4 * live * hq * 128,
                           q.dtype))
        k1_cases[-1].update(timed, heads=(hq, hkv))
        del ks, vs
        log(f"{name}: max_abs_err {err:.3e} (atol {ATOL}, rtol {RTOL}); device ms per call: kernel "
            f"{timed['ms']:.5f}, plain {timed['plain_ms']:.5f}, SDPA {_fmt(timed['library_ms'])}, bound "
            f"{timed['bound_ms']:.5f} ({timed['bound_by']}); eager call ms: kernel "
            f"{timed['eager_ms']:.4f}, plain {timed['plain_eager_ms']:.4f}")
    # an 8-lane pool at the whole heads, then a dp group's 2 lanes at a tp = 2 rank's heads in bf16 and float32
    batch_cases = ([(S, ranges, 16, 8, torch.bfloat16) for S, ranges in K1_BATCH_CASES]
                   + [(S, ranges, 8, 4, dt) for dt in (torch.bfloat16, torch.float32)
                      for S, ranges in K1_TP2_BATCH_CASES])
    for S, ranges, hq, hkv, dt in batch_cases:
        B = len(ranges)
        q = torch.randn(B, 1, hq, 128, generator=g).to(dev, dt)
        k = torch.randn(B, S, hkv, 128, generator=g).to(dev, dt)
        v = torch.randn(B, S, hkv, 128, generator=g).to(dev, dt)
        s = torch.arange(S)
        mask = torch.stack([((s >= lo) & (s < hi)).to(torch.int32) for lo, hi in ranges]).to(dev)
        out = attention.decode_attention(q, k, v, mask)
        torch.cuda.synchronize()
        ref = attention.decode_attention_plain(q.float(), k.float(), v.float(), mask)
        live = sum(hi - lo for lo, hi in ranges)
        name = f"K1 B={B} S_max={S} live {min(hi - lo for lo, hi in ranges)}-{max(hi - lo for lo, hi in ranges)}"
        if hkv != 8:
            name += f" heads {hq}/{hkv} {str(dt).replace('torch.', '')} (a dp group's lanes on a tp=2 rank; {CARD})"
        tol = (ATOL, RTOL) if dt == torch.bfloat16 else (ATOL_F32, RTOL_F32)
        err = check_close(name, out, ref, k1_cases, *tol)
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
        es = q.element_size()
        timed.update(bound(2 * q.numel() * es + 2 * live * hkv * 128 * es + B * S * 4, 4 * live * hq * 128, q.dtype))
        k1_cases[-1].update(timed, batch=B, heads=(hq, hkv))
        del ks, vs
        log(f"{name}: max_abs_err {err:.3e} (atol {tol[0]}, rtol {tol[1]}); device ms per call: kernel "
            f"{timed['ms']:.5f}, plain {timed['plain_ms']:.5f}, SDPA {_fmt(timed['library_ms'])}, bound "
            f"{timed['bound_ms']:.5f} ({timed['bound_by']}); eager call ms: kernel "
            f"{timed['eager_ms']:.4f}, plain {timed['plain_eager_ms']:.4f}")
    rng = np.random.default_rng(0)
    cases = _gemv_cases(lambda I, O: (1, 2, 8, 16) if (I, O) in K2_SHAPES_06B else (1, 2))
    # the column (O / 2) and row (I / 2) shards of a tp = 2 mesh, at a group's 1 and 2 lanes
    cases += [(I, O, f"tp=2 shard: {what}", (1, 2), "tp2") for (I, O), what in K2_TP2_SHAPES.items()]
    cases += [(I, O, f"tp=2 row shard, float32 rows: {K2_TP2_SHAPES[I, O]}", (1, 2, 4), "tp2_f32")
              for I, O in K2_TP2_ROW_SHAPES]
    for I, O, what, rows, fused in cases:
        ql = quant.quantize_linear(rng.standard_normal((I, O)).astype("float32") * I**-0.5)
        qw, sc = torch.from_numpy(ql.q).to(dev), torch.from_numpy(ql.scale).to(dev)
        n = _copies(qw.numel())
        qs = [qw] + [qw.clone() for _ in range(n - 1)]
        packed = [w.t().contiguous() for w in qs]  # [O, I], the layout torch's int8 call takes
        f32 = fused == "tp2_f32"
        dt = torch.float32 if f32 else torch.bfloat16
        sc_lib = sc.reshape(O).to(dt)
        wbf = [qw.to(torch.bfloat16)] + [qw.to(torch.bfloat16) for _ in range(max(2, n // 2) - 1)]
        tol = (ATOL_F32, RTOL_F32) if f32 else (ATOL, RTOL)
        for M in rows:
            x = torch.randn(M, I, generator=g).to(dev, dt)
            out = quant.int8_gemv(x, qw, sc)
            torch.cuda.synchronize()
            ref = quant.int8_gemv_plain(x.float(), qw, sc)
            name = f"K2 M={M} I={I} O={O} ({what}{f'; {CARD}' if fused else ''})"
            err = check_close(name, out, ref, k2_cases, *tol)
            timed = {
                "ms": device_ms(lambda i: quant.int8_gemv(x, qs[i], sc), n),
                "plain_ms": device_ms(lambda i: quant.int8_gemv_plain(x, qs[i], sc), n),
                "library_ms": library_time(
                    name, lambda i: torch._weight_int8pack_mm(x, packed[i], sc_lib), n),
                # the BF16 slice's own product: twice the weight bytes (bf16 rows only)
                "bf16_matmul_ms": None if f32 else device_ms(lambda i: torch.matmul(x, wbf[i]), len(wbf)),
                "eager_ms": eager_ms(lambda i: quant.int8_gemv(x, qw, sc)),
                "plain_eager_ms": eager_ms(lambda i: quant.int8_gemv_plain(x, qw, sc)),
            }
            timed["gb_s"] = qw.numel() / timed["ms"] / 1e6
            # x, q, scale, y; 2 flops per (row, weight)
            es = x.element_size()
            timed.update(bound(M * I * es + I * O + O * 4 + M * O * es, 2 * M * I * O, x.dtype))
            k2_cases[-1].update(timed, shape=(M, I, O), fused=fused is True, tp2=fused in ("tp2", "tp2_f32"),
                                rows_dtype=str(dt).replace("torch.", ""))
            log(f"{name}: max_abs_err {err:.3e} (atol {tol[0]}, rtol {tol[1]}); device ms per call: "
                f"kernel {timed['ms']:.5f} ({timed['gb_s']:.0f} GB/s of weights), plain "
                f"{timed['plain_ms']:.5f}, int8 library call {_fmt(timed['library_ms'])}, bf16 matmul "
                f"{_fmt(timed['bf16_matmul_ms'])}, bound {timed['bound_ms']:.5f} ({timed['bound_by']}); "
                f"eager call ms: kernel {timed['eager_ms']:.4f}, plain {timed['plain_eager_ms']:.4f}")
        del qs, packed, wbf
    k4_cases = k4_phase(g)
    k5_cases, k6_cases, k7_cases = glue_phase(g)
    report["kernel_cases"] = {"K1": k1_cases, "K2": k2_cases, "K4": k4_cases, "K5": k5_cases, "K6": k6_cases,
                              "K7": k7_cases}
    return k1_cases, k2_cases, k4_cases, k5_cases, k6_cases, k7_cases


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
    for I, O, what, rows, fused in _gemv_cases(lambda I, O: (1, 2, 8, 16)):
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
        for M in rows:
            x = torch.randn(M, I, generator=g).to(dev, torch.bfloat16)
            out = quant.int4_gemv(x, packed, scale, wmin)
            torch.cuda.synchronize()
            ref = quant.int4_gemv_plain(x.float(), packed, scale, wmin)
            plan = quant._int4_plan(M, I, O, 32)  # an older tree's plan (timed in turns) lacks mma and cols
            path = (f"{'tensor cores' if getattr(plan, 'mma', False) else 'CUDA cores'}, "
                    f"{getattr(plan, 'cols', 128)}-column tiles, cluster {plan.cluster}, "
                    f"{math.prod(plan.grid)} CTAs")
            name = f"K4 M={M} I={I} O={O} ({what}{f'; {CARD}' if fused else ''})"
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
            cases[-1].update(timed, shape=(M, I, O), fused=fused)
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


def _ulps(a, b) -> int:
    """The largest distance between a and b in steps of their dtype."""
    import torch

    def key(t):
        bits, sign = (torch.int16, 0x7FFF) if t.dtype == torch.bfloat16 else (torch.int32, 0x7FFFFFFF)
        i = t.contiguous().view(bits).to(torch.int64)
        return torch.where(i < 0, -(i & sign), i)

    return int((key(a) - key(b)).abs().max().item()) if a.numel() else 0


GLUE_COPIES = 64  # operand sets a timed graph cycles through (a call moves kilobytes)
GLUE_EPS = 1e-6


def _glue_case(cases, name, outs, kernel, plain, nbytes, nops, library=None):
    """Check one K5 / K6 / K7 case and time it. `outs` is a list of (what,
    kernel output, plain output, ulps allowed): 1 for normed rows (the f32
    sum of squares is taken in another order than PyTorch's), 0 for what
    must be bit for bit. Then the device ms per call (`device_ms` over
    GLUE_COPIES operand sets) of `kernel(i)`, `plain(i)` and, where one
    PyTorch call computes the function, `library(i)`; the bound; the eager
    ms."""
    import torch

    ulps = {what: _ulps(a, b) for what, a, b, _ in outs}
    err = max(float((a.float() - b.float()).abs().max()) for _, a, b, _ in outs)
    bad = [f"{what} {ulps[what]} ulps (at most {most})" for what, _, _, most in outs if ulps[what] > most]
    if bad or not all(torch.isfinite(a).all() for _, a, _, _ in outs):
        fail(f"{name}: {', '.join(bad) or 'not finite'}")
    row = {"case": name, "max_abs_err": err, "ulps": ulps,
           "ms": device_ms(kernel, GLUE_COPIES), "plain_ms": device_ms(plain, GLUE_COPIES),
           "library_ms": None if library is None else library_time(name, library, GLUE_COPIES),
           "eager_ms": eager_ms(kernel), "plain_eager_ms": eager_ms(plain)}
    row.update(bound(nbytes, nops, torch.bfloat16))
    cases.append(row)
    log(f"{name}: bf16 ulps {ulps}, max_abs_err {err:.3e}; device ms per call: kernel {row['ms']:.5f}, plain "
        f"{row['plain_ms']:.5f}, library {_fmt(row['library_ms'])}, bound {row['bound_ms']:.6f} "
        f"({row['bound_by']}); eager call ms: kernel {row['eager_ms']:.4f}, plain {row['plain_eager_ms']:.4f}")


def glue_phase(g):
    """K5, K6 and K7 (csrc/glue.cu) against their plain versions on the same
    bf16 CUDA tensors at the main path's shapes. K5: one row of 1024 and of
    2048 with a residual, 8 rows of 1024, and the per-head norm of a
    predictor prefill's q (2 rows of 16 heads of 128, a column view of the
    fused wqkv output; `F.rms_norm` as the yardstick). K6: B = 1 and 8, 16 /
    8 heads, S_max 2048, split and fused-layout column views, finished lanes
    clamped to the last slot; every cache slot but the write positions must
    stay as it was. K7: 1 x 3072, 1 x 6144 and 8 x 3072, split and the fused
    gate / up halves. Normed rows within one bf16 ulp; K5's sums, K6's V
    rows and K7 bit for bit. -> the K5, K6 and K7 cases."""
    import torch
    import torch.nn.functional as F

    from faster_qwen3_tts_tpu_torch.models.layers import rope_cos_sin
    from faster_qwen3_tts_tpu_torch.ops import glue

    n = GLUE_COPIES

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to("cuda", torch.bfloat16)

    def norm_weight(W):
        return (1 + 0.1 * torch.randn(W, generator=g)).to("cuda", torch.bfloat16)

    k5 = []
    for rows, W in [(1, 1024), (1, 2048), (8, 1024)]:
        xs, rs = [rand(rows, 1, W, scale=3.0) for _ in range(n)], [rand(rows, 1, W) for _ in range(n)]
        w = norm_weight(W)
        s, y = glue.add_rms_norm(xs[0], rs[0], w, GLUE_EPS)
        ps, py = glue.add_rms_norm_plain(xs[0], rs[0], w, GLUE_EPS)
        _glue_case(k5, f"K5 {rows} x {W} + residual", [("sum", s, ps, 0), ("normed", y, py, 1)],
                   lambda i: glue.add_rms_norm(xs[i], rs[i], w, GLUE_EPS),
                   lambda i: glue.add_rms_norm_plain(xs[i], rs[i], w, GLUE_EPS),
                   rows * W * 2 * 4 + W * 2, 4 * rows * W)  # x, residual, sum, out; w
    # the predictor prefill's q: [1, 2, 16, 128] cut from a [1, 2, 4096] wqkv output
    qs, w = [rand(1, 2, 4096, scale=2.0)[..., :2048].view(1, 2, 16, 128) for _ in range(n)], norm_weight(128)
    _glue_case(k5, "K5 per-head 1 x 2 x 16 x 128 (fused view)",
               [("normed", glue.add_rms_norm(qs[0], None, w, GLUE_EPS)[1],
                 glue.add_rms_norm_plain(qs[0], None, w, GLUE_EPS)[1], 1)],
               lambda i: glue.add_rms_norm(qs[i], None, w, GLUE_EPS),
               lambda i: glue.add_rms_norm_plain(qs[i], None, w, GLUE_EPS),
               2 * 2 * 16 * 128 * 2 + 128 * 2, 4 * 2 * 16 * 128, lambda i: F.rms_norm(qs[i], (128,), w, GLUE_EPS))

    k6 = []
    Hq, Hkv, D, S = 16, 8, 128, 2048
    for B, fused in [(1, False), (1, True), (8, False), (8, True)]:
        def qkv():
            if fused:  # column views of one [B, 1, (Hq + 2 Hkv) D] product
                y = rand(B, 1, (Hq + 2 * Hkv) * D, scale=2.0)
                return (y[..., :Hq * D].view(B, 1, Hq, D), y[..., Hq * D:(Hq + Hkv) * D].view(B, 1, Hkv, D),
                        y[..., (Hq + Hkv) * D:].view(B, 1, Hkv, D))
            return rand(B, 1, Hq, D, scale=2.0), rand(B, 1, Hkv, D, scale=2.0), rand(B, 1, Hkv, D)

        ins = [qkv() for _ in range(n)]
        qw, kw = norm_weight(D), norm_weight(D)
        cos, sin = rope_cos_sin(torch.randint(0, 3000, (B, 1), generator=g).to("cuda", torch.int32), D, 1e6)
        # lane 0 finished (clamped to the last slot), the others mid-cache
        wp = torch.tensor([S - 1] + [(S // 2 + 37 * b) % S for b in range(1, B)], dtype=torch.int32, device="cuda")
        kc0, vc0 = rand(B, S, Hkv, D), rand(B, S, Hkv, D)
        kc, vc, pk, pv = kc0.clone(), vc0.clone(), kc0.clone(), vc0.clone()
        out = glue.qk_norm_rope_kv(*ins[0], qw, kw, cos, sin, kc, vc, wp, GLUE_EPS)
        ref = glue.qk_norm_rope_kv_plain(*ins[0], qw, kw, cos, sin, pk, pv, wp, GLUE_EPS)
        rest = torch.ones(B, S, dtype=torch.bool, device="cuda")
        rest[torch.arange(B, device="cuda"), wp.long()] = False
        untouched = bool(torch.equal(kc[rest], kc0[rest]) and torch.equal(vc[rest], vc0[rest]))
        name = f"K6 B={B} S_max={S} heads {Hq}/{Hkv} ({'fused' if fused else 'split'}, lane 0 clamped)"
        if not untouched:
            fail(f"{name}: a cache slot other than a write position changed")
        # q, k, v and the two weights read, cos / sin read, q out and the k / v cache rows written
        _glue_case(k6, name, [("q", out, ref, 1), ("k cache", kc, pk, 1), ("v cache", vc, pv, 0)],
                   lambda i: glue.qk_norm_rope_kv(*ins[i], qw, kw, cos, sin, kc, vc, wp, GLUE_EPS),
                   lambda i: glue.qk_norm_rope_kv_plain(*ins[i], qw, kw, cos, sin, kc, vc, wp, GLUE_EPS),
                   2 * B * (Hq + 2 * Hkv) * D * 2 + 2 * D * 2 + 2 * B * D * 4, B * (Hq + Hkv) * D * 10)
        k6[-1]["untouched_slots_equal"] = untouched
        del ins, kc, vc, pk, pv, kc0, vc0

    k7 = []
    for rows, inter in [(1, 3072), (1, 6144), (8, 3072)]:
        for fused in (False, True):
            def gate_up():
                if fused:  # the halves of one [rows, 1, 2 I] gate / up product
                    y = rand(rows, 1, 2 * inter, scale=4.0)
                    return y[..., :inter], y[..., inter:]
                return rand(rows, 1, inter, scale=4.0), rand(rows, 1, inter, scale=4.0)

            gu = [gate_up() for _ in range(n)]
            _glue_case(k7, f"K7 {rows} x {inter} ({'fused' if fused else 'split'})",
                       [("out", glue.silu_mul(*gu[0]), glue.silu_mul_plain(*gu[0]), 0)],
                       lambda i: glue.silu_mul(*gu[i]), lambda i: glue.silu_mul_plain(*gu[i]),
                       3 * rows * inter * 2, 6 * rows * inter)
    return k5, k6, k7


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
    rows, launches = [], dict.fromkeys(KERNELS, 0)
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


# the kernels whose wrappers count their launches: K1 attention, K2 / K4
# the int8 / int4 products, K5-K7 the decoder layer's glue
KERNELS = ("K1", "K2", "K4", "K5", "K6", "K7")


def _launchers():
    from faster_qwen3_tts_tpu_torch.ops import attention, glue
    from faster_qwen3_tts_tpu_torch.ops import quant as quant_ops

    return {"K1": attention.decode_attention, "K2": quant_ops.int8_gemv, "K4": quant_ops.int4_gemv,
            "K5": glue.add_rms_norm, "K6": glue.qk_norm_rope_kv, "K7": glue.silu_mul}


def _reset_launches():
    from faster_qwen3_tts_tpu_torch.engine import graphs

    for fn in _launchers().values():
        fn.launches = 0
    graphs.reset_replayed()


def _read_launches():
    """Kernel launches since `_reset_launches`: the wrappers' counts (eager
    launches, and launches recorded into a graph at its capture) plus the
    launches that graph replays made (each graph's count at capture times its
    replays)."""
    from faster_qwen3_tts_tpu_torch.engine import graphs

    return {k: fn.launches + graphs.replayed[k] for k, fn in _launchers().items()}


def _eager_frames():
    """Frames run eagerly on the card so far (capture warm-ups included)."""
    from faster_qwen3_tts_tpu_torch.engine import core

    return core._decode_frame.eager_cuda


@contextlib.contextmanager
def no_eager_frames(what):
    """Fail if a frame ran eagerly on the card inside the block (after a
    warmup that captured its keys, every frame must be a replay)."""
    before = _eager_frames()
    yield
    ran = _eager_frames() - before
    if ran:
        fail(f"{what}: {ran} frames ran eagerly on the card after warmup")


def _eager_prefills():
    """Prefills run eagerly on the card so far (capture warm-ups included)."""
    from faster_qwen3_tts_tpu_torch.engine import core

    return core.start_state.eager_cuda


@contextlib.contextmanager
def no_eager_prefills(what):
    """Fail if a prefill ran eagerly on the card inside the block (after a
    warmup that captured its prompt buckets, every prefill must be a
    replay)."""
    before = _eager_prefills()
    yield
    ran = _eager_prefills() - before
    if ran:
        fail(f"{what}: {ran} prefills ran eagerly on the card after warmup")


def _profile_row(prof, frames, wall_s):
    """Device time per frame of all kernels and of each hand-written kernel
    (K1, K2, K4, K5-K7), from a trace of `frames` frames over `wall_s`
    seconds."""

    def device_us(e):  # the kernel's own device time, across torch versions
        us = getattr(e, "self_device_time_total", None)
        return us if us is not None else e.self_cuda_time_total

    events = prof.key_averages()
    total_us = sum(device_us(e) for e in events)
    row = {"frames": frames, "wall_ms_per_frame": wall_s * 1e3 / frames,
           "device_ms_per_frame": total_us / 1e3 / frames, "busy_share": total_us / 1e6 / wall_s,
           "device_ops_per_frame": sum(e.count for e in events if device_us(e) > 0) / frames}
    for kname, needle in (("K1", "decode_attn_kernel"), ("K2", "int8_gemv_kernel"), ("K4", "int4_gemv_kernel"),
                          ("K5", "add_rms_norm_kernel"), ("K6", "qk_norm_rope_kv_kernel"), ("K7", "silu_mul_kernel")):
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


GRAPH_FRAMES = 32  # frames of the replayed chunk held against the eager engine


def graphs_phase(model, name, report, modes=("greedy", "sampled")):
    """The captured decode at full width against the eager engine. From one
    start state (the session's prefill into its leased set, and the eager
    `core.start_state` with the same seed: their tokens and caches must be
    equal), one chunk of 32 replays of the frame graph against eager
    `core.decode_chunk`: packed rows (tokens, valid and done flags) exact,
    greedy and (modes) sampled with one seed; one (8, 24) window replay
    against eager `_vocode_window` (max abs diff 1e-5). Then, on the same set,
    the ms a frame of 32 replays (CUDA events) beside the eager frame's (host
    clock, synchronized), the kernels' device ms a frame and the device's
    busy share from torch.profiler over 32 replays, and the window's replay
    against its eager run."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from faster_qwen3_tts_tpu_torch.engine import core, fused_stream, graphs
    from faster_qwen3_tts_tpu_torch.engine import generate as gen_lib
    from faster_qwen3_tts_tpu_torch.ops.sampling import SamplingParams

    params, cfg, n = model.params, model.config, GRAPH_FRAMES
    tie, tam, tth, tpe, _ = model._prepare_generation(TEXT, language="English", voice_clone_prompt=_xvec_prompt(0))
    samplings = {"greedy": (SamplingParams(do_sample=False), gen_lib.predictor_sampling(False)),
                 "sampled": (SamplingParams(), gen_lib.predictor_sampling())}
    row = {"card": CARD, "frames": n}
    for mode in modes:
        ts, ps = samplings[mode]
        sess = gen_lib.GenerationSession(params, cfg, tie, tam, tth, tpe, model.max_seq_len, ts, ps, 2, seed=13)
        try:
            sess.prefill()
            gset = sess.graphs
            gen = torch.Generator(device="cuda").manual_seed(13)
            state, _ = core.start_state(params["talker"], cfg.talker, sess.tie, sess.mask, gen, model.max_seq_len,
                                        ts, 2)
            if not (torch.equal(state.token, gset.state.token) and torch.equal(state.cache.k, gset.state.cache.k)
                    and torch.equal(state.pos, gset.state.pos)):
                fail(f"graphs {name} ({mode}): the session's start state differs from the eager one")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, eager = core.decode_chunk(params["talker"], params["predictor"], cfg.talker, cfg.predictor,
                                             state, sess.tth, sess.tpe, n, ts, ps, 2)
            torch.cuda.synchronize()
            eager_ms = (time.perf_counter() - t0) * 1e3 / n
            replayed = sess.decode_chunk_async(n)
            equal = bool(torch.equal(eager, replayed))
            same_state = bool(torch.equal(state.pos, gset.state.pos) and torch.equal(state.done, gset.state.done)
                              and torch.equal(state.cache.k, gset.state.cache.k))
            valid = int(eager[:, 0, -2].sum())
            log(f"graphs {name} ({mode}, seed 13): {n} replayed frames against eager core.decode_chunk: rows "
                f"equal {equal}, state (pos, done, KV cache) equal {same_state}; {valid} valid frames")
            if not equal or not same_state:
                diff = (eager != replayed).nonzero()
                fail(f"graphs {name} ({mode}): the replayed chunk differs from eager (first rows {diff[:4].tolist()})")
            row[mode] = {"rows_equal": equal, "state_equal": same_state, "valid_frames": valid,
                         "eager_ms_per_frame": eager_ms}
            if mode != modes[0]:
                continue
            # the window: its replay against its eager run on the same static buffers
            frames_b = eager[:, :, :cfg.talker.num_code_groups].transpose(0, 1).cpu().numpy()
            gset.set_history(frames_b, gen_lib.CONTEXT_FRAMES)
            audio = gset.vocode(params, CHUNK, gen_lib.CONTEXT_FRAMES).clone()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = fused_stream._vocode_window(params["codec"], cfg.talker, cfg.codec,
                                               gset.hist(gen_lib.CONTEXT_FRAMES), gset.packed[:CHUNK], CHUNK,
                                               gen_lib.CONTEXT_FRAMES)
            torch.cuda.synchronize()
            window_eager_ms = (time.perf_counter() - t0) * 1e3
            w_err = float((audio.float() - want.float()).abs().max())
            if audio.shape != want.shape or not w_err <= 1e-5 or not torch.isfinite(audio).all():
                fail(f"graphs {name}: the window replay differs from eager _vocode_window by {w_err}")
            # times of the captured frame and window on this set
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev[0].record()
            sess.decode_chunk_async(n)
            ev[1].record()
            host_ms = (time.perf_counter() - t0) * 1e3 / n  # the host's cost to queue a frame
            ev[1].synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
            ev[2].record()
            gset.vocode(params, CHUNK, gen_lib.CONTEXT_FRAMES)
            ev[3].record()
            ev[3].synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sess.decode_chunk_async(n)
                torch.cuda.synchronize()
                prof_wall = time.perf_counter() - t0
            prof_row = _profile_row(prof, n, prof_wall)
            row.update(window_max_abs_err=w_err, window_tolerance=1e-5, frame_ms=ev[0].elapsed_time(ev[1]) / n,
                       frame_wall_ms=wall_ms, frame_host_ms=host_ms, window_ms=ev[2].elapsed_time(ev[3]),
                       window_eager_ms=window_eager_ms, profile=prof_row,
                       frame_launches=dict(gset.frame_launches))
            log(f"graphs {name} ({CARD}): captured frame {row['frame_ms']:.3f} ms (CUDA events over {n} replays; "
                f"host queues one in {host_ms:.3f} ms) against the eager frame's {eager_ms:.1f} ms; kernels "
                f"{prof_row['device_ms_per_frame']:.3f} ms a frame in {prof_row['device_ops_per_frame']:.0f} device ops (profiler "
                f"over {n} replays, wall "
                f"{prof_row['wall_ms_per_frame']:.3f} ms a frame, device busy {prof_row['busy_share']:.1%}); K1 "
                f"{prof_row['K1']['launches_per_frame']:.0f}, K2 {prof_row['K2']['launches_per_frame']:.0f}, K4 "
                f"{prof_row['K4']['launches_per_frame']:.0f} launches a frame (at capture "
                f"{gset.frame_launches}); window (8, 24) replay {row['window_ms']:.3f} ms against eager "
                f"{window_eager_ms:.1f} ms, max abs diff {w_err:.2e} (tolerance 1e-5)")
            need = [k for k, v in gset.frame_launches.items() if v]
            if not need or any(prof_row[k]["launches_per_frame"] == 0 for k in need):
                fail(f"graphs {name}: the profile of the replays lacks one of {need}")
        finally:
            sess.close()
    mem = graphs.registry_for(params).memory()
    row.update(graph_static_gb=mem["static_bytes"] / 1e9,
               graph_pool_gb=None if mem["pool_bytes"] is None else mem["pool_bytes"] / 1e9,
               sets=len(graphs.registry_for(params).sets), peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"graphs {name} ({CARD}): {row['sets']} graph sets of this model so far, static buffers "
        f"{row['graph_static_gb']:.3f} GB, graph pool {_fmt(row['graph_pool_gb'])} GB, peak device memory "
        f"{row['peak_mem_gb']:.2f} GB")
    report.setdefault("graphs", {})[name] = row
    return row


PREFILL_REPS = 5  # timed eager prefills and replays a bucket
# kernel families of a prefill replay, by a substring of the kernel's name: the
# many-row products (cuBLAS / CUTLASS), the casts and copies around them (the
# int8 or int4 weights widened to f32 among them), K2 (the codec head's row)
PREFILL_FAMILIES = (("products", ("gemm", "xmma", "cutlass")), ("casts_copies", ("copy",)),
                    ("K2", ("int8_gemv_kernel",)))


def _prefill_profile(replay, n=3):
    """torch.profiler over `n` replays of one prefill graph -> device ms a
    prefill, its device ops, the ms of each kernel family and the five
    kernels that take most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            replay()
        torch.cuda.synchronize()

    def device_us(e):
        us = getattr(e, "self_device_time_total", None)
        return us if us is not None else e.self_cuda_time_total

    events = [e for e in prof.key_averages() if device_us(e) > 0]
    total = sum(device_us(e) for e in events) / 1e3 / n
    fam = {name: sum(device_us(e) for e in events if any(k in e.key.lower() for k in keys)) / 1e3 / n
           for name, keys in PREFILL_FAMILIES}
    top = sorted(events, key=device_us, reverse=True)[:5]
    return {"device_ms": total, "device_ops": sum(e.count for e in events) / n, "families_ms": fam,
            "top": [{"kernel": e.key[:100], "ms": device_us(e) / 1e3 / n, "calls": e.count / n} for e in top]}


def prefill_graphs_phase(model, name, report):
    """The captured prefill at full width against eager `core.start_state`.
    For each prompt bucket warmup captures (32-256), greedy and sampled with
    one seed, a B = 1 set replays the bucket's graph on a seeded prompt
    (left-padded to 3/4 of the bucket): it must run no eager prefill and
    equal eager `core.start_state` of the same prompt and seed bit for bit
    (the KV cache over the bucket, token, past hidden, pos, num_pads). Then
    the eager ms against the replay ms (CUDA events, median of 5), and the
    graph pool's bytes."""
    import torch

    from faster_qwen3_tts_tpu_torch.engine import core, graphs
    from faster_qwen3_tts_tpu_torch.engine import generate as gen_lib
    from faster_qwen3_tts_tpu_torch.ops.sampling import SamplingParams

    params, cfg, max_seq = model.params, model.config, model.max_seq_len
    reg = graphs.registry_for(params)
    H, dtype, dev = cfg.talker.hidden_size, params["talker"]["codec_embed"].dtype, params["talker"]["codec_embed"].device
    samplings = {"greedy": (SamplingParams(do_sample=False), gen_lib.predictor_sampling(False)),
                 "sampled": (SamplingParams(), gen_lib.predictor_sampling())}

    def timed(fn):
        times = []
        for _ in range(PREFILL_REPS):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    row = {"card": CARD}
    captures0 = reg.stats["prefill_captures"]
    for mode, (ts, ps) in samplings.items():
        gset = reg.lease(params, cfg, graphs.make_key(params, 1, max_seq, gen_lib.tth_bucket(1), ts, ps, 2))
        try:
            for bucket in gen_lib.SERVED_PREFILL_BUCKETS:
                real = bucket * 3 // 4
                g = torch.Generator(device=dev).manual_seed(bucket)
                tie = torch.zeros(1, bucket, H, device=dev, dtype=dtype)
                tie[:, bucket - real:] = (torch.randn(1, real, H, device=dev, generator=g) * 0.05).to(dtype)
                mask = (torch.arange(bucket, device=dev) >= bucket - real).to(torch.int32)[None]
                gset.prepare_prefill(params, bucket)
                before = _eager_prefills()
                gset.prefill(params, tie, mask, 17)
                if _eager_prefills() != before:
                    fail(f"prefill graphs {name} ({mode}, bucket {bucket}): the prefill ran eagerly")
                gen = torch.Generator(device=dev).manual_seed(17)
                state, _ = core.start_state(params["talker"], cfg.talker, tie, mask, gen, max_seq, ts, 2)
                st = gset.state
                equal = {f: bool(torch.equal(getattr(st, f), getattr(state, f)))
                         for f in ("token", "past_hidden", "pos", "num_pads")}
                equal["kv_cache"] = bool(torch.equal(st.cache.k[:, :, :bucket], state.cache.k[:, :, :bucket])
                                         and torch.equal(st.cache.v[:, :, :bucket], state.cache.v[:, :, :bucket]))
                if not all(equal.values()):
                    fail(f"prefill graphs {name} ({mode}, bucket {bucket}): the replay differs from eager "
                         f"core.start_state: {equal}")
                del state
                eager = timed(lambda: core.start_state(params["talker"], cfg.talker, tie, mask, gen, max_seq, ts, 2))
                replay = timed(lambda: gset.prefill(params, tie, mask, 17))
                row.setdefault(mode, {})[bucket] = {"rows": real, "equal": equal, "eager_ms": eager,
                                                    "replay_ms": replay,
                                                    "launches": dict(gset.prefill_launches.get(bucket, {}))}
                if mode == "greedy" and bucket in (32, 256):  # where the replay's device time goes
                    prof = row[mode][bucket]["profile"] = _prefill_profile(lambda: gset.prefill(params, tie, mask, 17))
                    log(f"prefill graphs {name} bucket {bucket} ({CARD}): {prof['device_ms']:.3f} ms of kernels a "
                        f"prefill in {prof['device_ops']:.0f} device ops (torch.profiler over 3 replays); "
                        + ", ".join(f"{k} {v:.3f} ms" for k, v in prof["families_ms"].items()) + "; most: "
                        + "; ".join(f"{t['ms']:.3f} ms x{t['calls']:.0f} {t['kernel'][:70]}" for t in prof["top"]))
        finally:
            reg.release(gset)
    mem = reg.memory()
    row.update(captured_here=reg.stats["prefill_captures"] - captures0,
               graph_pool_gb=None if mem["pool_bytes"] is None else mem["pool_bytes"] / 1e9)
    for mode in samplings:
        log(f"prefill graphs {name} ({mode}, seed 17, {CARD}): replay equal to eager core.start_state bit for bit "
            "(KV cache, token, past hidden, pos, num_pads) at buckets "
            + ", ".join(f"{b} ({r['rows']} rows: eager {r['eager_ms']:.2f} ms, replay {r['replay_ms']:.3f} ms)"
                        for b, r in row[mode].items()))
    log(f"prefill graphs {name}: {row['captured_here']} prefill graphs captured in this phase (the rest by "
        f"warmup); graph pool {_fmt(row['graph_pool_gb'])} GB")
    report.setdefault("prefill_graphs", {})[name] = row
    return row


def prompt_builders_phase(name, report, cases):
    """The device prompt (`build_device`, the default of a streaming request)
    against the host prompt (`build`, padded to the same buckets and cast to
    the parameter dtype as a session does) at full width, for each case
    (label, model, prepare method, args, kwargs): masks equal, tie and tth
    within check_close's tolerance (the device path projects the request's
    text at 256 rows or more, the host path at its own bucket), the largest
    difference reported; then each builder's ms per request, median of 5
    after a first call: the call on the host, and until the card has the
    prompt (synchronized)."""
    import torch

    from faster_qwen3_tts_tpu_torch.engine import generate as gen_lib

    rows = {}
    for label, model, method, args, kw in cases:
        build = getattr(model, method)
        dev = build(*args, **kw)[:4]
        host = build(*args, **kw, prefer_device=False)[:4]
        embed = model.params["talker"]["codec_embed"]
        pb, tb = dev[0].shape[1], dev[2].shape[1]
        tie_h, mask_h = gen_lib._pad_left(host[0], host[1], pb)
        tth_h = gen_lib._pad_trailing(host[2], host[3], tb)
        tie_h, tth_h = (torch.as_tensor(a).to(embed.device, embed.dtype) for a in (tie_h, tth_h))
        if not torch.equal(dev[1], torch.as_tensor(mask_h, device=embed.device)):
            fail(f"prompt builders {name} {label}: the device mask differs from the host one")
        details = []
        err = {"tie": check_close(f"prompt {name} {label} tie", dev[0], tie_h, details),
               "tth": check_close(f"prompt {name} {label} tth", dev[2], tth_h, details)}
        bitwise = bool(torch.equal(dev[0], tie_h) and torch.equal(dev[2], tth_h))
        times = {}
        for where, prefer in (("device", True), ("host", False)):
            call, ready = [], []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                build(*args, **kw, prefer_device=prefer)
                call.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
                ready.append((time.perf_counter() - t0) * 1e3)
            times[where] = {"call_ms": statistics.median(call), "ready_ms": statistics.median(ready)}
        rows[label] = {"rows": pb, "trailing_rows": tb, "max_abs_diff": err, "bitwise": bitwise, "ms": times}
        log(f"prompt builders {name} {label} ({CARD}): device against host prompt at buckets ({pb}, {tb}): "
            f"max abs diff tie {err['tie']:.3e}, tth {err['tth']:.3e} (tolerance {ATOL}), bitwise {bitwise}; "
            f"ms a request: device {times['device']['call_ms']:.2f} on the host, {times['device']['ready_ms']:.2f} "
            f"ready; host {times['host']['call_ms']:.2f}, {times['host']['ready_ms']:.2f} ready")
    report.setdefault("prompt_builders", {})[name] = rows
    return rows


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
    prompt_builders_phase("0.6B Q8_0", report, [
        ("x-vector", model, "_prepare_generation", (TEXT,), dict(voice_clone_prompt=_xvec_prompt(0))),
        ("ICL 4.0 s", model, "_prepare_generation", (TEXT,), dict(ref_audio=str(long_ref), ref_text=REF_TEXT))])

    cases = [("long ICL", long_ref, False, FRAMES, 21), ("short ICL", short_ref, False, FRAMES, 22),
             ("xvec_only", short_ref, True, FRAMES, 23)]
    _reset_launches()
    requests = []
    with no_eager_frames("slice ICL requests"), no_eager_prefills("slice ICL requests"):
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
    model.warmup(chunk_sizes=(8, 12), first_chunk_size=FIRST_CHUNK)
    warmup_s = time.perf_counter() - t0
    log(f"slice {quant} ({CARD}): loaded in {load_s:.1f} s, warmup {warmup_s:.1f} s (the JAX warmup's set: "
        f"{model.warmup_phases})")
    _reset_launches()
    requests = []
    with no_eager_frames(f"slice {quant} requests"), no_eager_prefills(f"slice {quant} requests"):
        for i in range(n_requests):
            req, _ = run_request(model, seed=i + 1)
            requests.append(req)
            log(f"slice {quant} request {i} ({CARD}): {req['frames']} frames, TTFA {req['ttfa_ms']:.1f} ms "
                f"(eager prefill, Q8_0: 124.5-139.5 ms), stream RTF {req['stream_rtf']:.3f}")
    launches = _read_launches()
    log(f"slice {quant}: launches during the requests {launches}")
    _, tok_a = run_request(model, seed=7, greedy=True, frames=24)
    _, tok_b = run_request(model, seed=8, greedy=True, frames=24)
    if tok_a.shape != tok_b.shape or not (tok_a == tok_b).all():
        fail(f"slice {quant}: two greedy runs gave different tokens")
    log(f"slice {quant}: two greedy runs gave equal tokens ({tok_a.shape[0]} frames)")
    if quant == "Q8_0":
        frame_profile(model, "0.6B Q8_0 x-vector", report)
        phase("graphs 0.6B Q8_0")
        graphs_phase(model, "0.6B Q8_0", report)
        prefill_graphs_phase(model, "0.6B Q8_0", report)
    report[f"slice_{quant}"] = {"load_s": load_s, "warmup_s": warmup_s, "warmup_phases": model.warmup_phases,
                                "requests": requests, "launches": launches,
                                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    icl_launches = slice_icl_phase(model, report) if icl else None
    phase(f"batch {quant}")
    batch = slice_batch_phase(model, quant, report)
    if quant == "Q8_0":
        phase(f"continuous {quant}")
        cont = continuous_phase(model, report, REPO / "build" / "chip_smoke_ref_4s.wav")
        phase("serve 0.6B Q8_0")
        served = serve_phase(model, report, REPO / "build" / "chip_smoke_ref_4s.wav")
        phase("demo 0.6B Q8_0")
        demo = demo_phase(model, report, REPO / "build" / "chip_smoke_ref_4s.wav")
        phase("restart 0.6B Q8_0 from a deploy bundle")
        restart = restart_phase(model, report)
        batch = {k: batch[k] + cont[k] + served[k] + demo[k] + restart.get(k, 0) for k in batch}
    del model
    gc.collect()  # each slice's peak memory is its own
    torch.cuda.empty_cache()
    return launches, icl_launches, batch


def checkpoint_phase(report, tree, init_s):
    """The 0.6B Base tree of `init_numpy(seed=0)` (float32, 0.96 B parameters;
    drawn once by `main` in `init_s` seconds and kept for the int4 slice)
    written by the port's `export_hf_layout` under build/ beside the
    Qwen2-layout tokenizer fixture, loaded strictly by
    `from_pretrained(dir, quant="Q8_0", strict=True)`; every loaded leaf
    must equal, bit for bit, `materialize` of the same tree, and the
    tokenizer must be the BPE reader, with no byte-tokenizer warning. The
    weights file is deleted (the restart phase deletes the directory).
    -> the model."""
    import shutil

    import torch

    from faster_qwen3_tts_tpu_torch import weights
    from faster_qwen3_tts_tpu_torch.config import get_config
    from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS
    from faster_qwen3_tts_tpu_torch.utils import safetensors as st

    cfg = get_config(MODEL)
    path = HF_DIR
    shutil.rmtree(path, ignore_errors=True)
    leaves = weights._leaves(tree)
    n_params, n_leaves = sum(a.size for a in leaves), len(leaves)
    del leaves
    t0 = time.perf_counter()
    weights.export_hf_layout(tree, cfg, str(path))
    (path / "config.json").write_text(json.dumps(weights._config_to_dict(cfg)))
    for f in QWEN2_TOKENIZER.iterdir():  # a Qwen checkpoint's tokenizer layout
        shutil.copy2(f, path / f.name)
    export_s = time.perf_counter() - t0
    file_gb = (path / "model.safetensors").stat().st_size / 1e9
    n_tensors = len(st.read_header(path / "model.safetensors")[0])
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with logged_warnings() as warned:
        model = FasterQwen3TTS.from_pretrained(str(path), device="cuda", quant="Q8_0", strict=True)
    load_s = time.perf_counter() - t0
    reader = bpe_reader(model.tokenizer.base)
    if reader is None or any("BYTE tokenizer" in w for w in warned):
        fail(f"checkpoint: the tokenizer is {model.tokenizer.base!r}, not the BPE reader over the Qwen2 assets "
             f"(warnings {warned})")
    card_gb = (torch.cuda.memory_allocated() - base) / 1e9  # what the load holds (the restart is held to it)
    card_peak_gb = torch.cuda.max_memory_allocated() / 1e9
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
    for f in path.rglob("*.safetensors"):  # the tokenizer assets stay, for the restart's bundles
        f.unlink()
    gc.collect()
    torch.cuda.empty_cache()
    row = {"params": n_params, "leaves": n_leaves, "tensors": n_tensors, "file_gb": file_gb, "init_s": init_s,
           "export_s": export_s, "load_s": load_s, "card_gb": card_gb, "card_peak_gb": card_peak_gb,
           "host_peak_rss_gb": host_peak_gb, "load_phases": model.load_phases, "coverage": cov, "materialize_s": ref_s,
           "leaves_bitwise_equal": compared, "tokenizer": repr(reader), "card": CARD}
    log(f"checkpoint 0.6B Base ({CARD}): init_numpy {init_s:.1f} s, export_hf_layout {export_s:.1f} s "
        f"({n_params / 1e9:.3f} B parameters, {n_leaves} leaves, {n_tensors} tensors, {file_gb:.2f} GB float32); "
        f"from_pretrained(strict, Q8_0) {load_s:.1f} s, phases {model.load_phases}, {card_gb:.2f} GB on the card "
        f"(peak {card_peak_gb:.2f} GB), process peak RSS {host_peak_gb:.1f} GB; coverage {cov}; "
        f"{compared} leaves bitwise equal to materialize of the same tree ({ref_s:.1f} s); tokenizer: the BPE "
        f"reader ({reader!r}), no byte-tokenizer warning")
    report["checkpoint_0.6B"] = row
    return model


# -- the serving restart: deploy bundles, device quantization, device init --------------------------

HF_DIR = REPO / "build" / "chip_smoke_hf_0.6b"  # the checkpoint phase's export, with its tokenizer assets
RESTART_SEED = 41  # the greedy x-vector stream held between the strict load and the restarted process
_ITEMSIZE = {"bfloat16": 2, "float32": 4, "int8": 1, "uint8": 1}  # the dtypes a bundle's sections hold


def _jax_writer_bytes(path) -> int:
    """The bytes the JAX package's writer gives the bundle of this manifest
    (sections in sorted dtype order, each 128-byte aligned); fails if a
    section sits elsewhere in the file."""
    meta = json.loads((Path(path) / "bundle.json").read_text())
    offset = 0
    for dt in sorted(meta["sections"]):
        offset += (-offset) % 128
        if meta["sections"][dt][0] != offset:
            fail(f"bundle {path}: section {dt} at byte {meta['sections'][dt][0]}, the JAX writer puts it at {offset}")
        offset += meta["sections"][dt][1] * _ITEMSIZE[dt]
    return offset


def write_bundle(model, path, compact):
    """`model.save_deploy_bundle(path, compact_f32=compact)`, timed -> its record."""
    import shutil

    shutil.rmtree(path, ignore_errors=True)
    t0 = time.perf_counter()
    model.save_deploy_bundle(str(path), compact_f32=compact)
    write_s = time.perf_counter() - t0
    size, want = (Path(path) / "bundle.bin").stat().st_size, _jax_writer_bytes(path)
    if size != want:
        fail(f"bundle {path}: {size} bytes, the JAX writer would write {want}")
    return {"gb": size / 1e9, "jax_writer_gb": want / 1e9, "write_s": write_s}


def _max_ulps(a, b) -> int:
    """The largest distance in float32 units of the last place between two tensors."""
    import torch

    def ordered(t):
        i = t.float().contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


def _paths(node, prefix=""):
    """(path, tensor) of every leaf of a tree, where it lies (dict keys sorted)."""
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _paths(node[k], f"{prefix}{k}/")
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], node


def _leaf_pairs(a, b, what):
    """The leaves of two port trees in one order; fails on another structure."""
    fa, fb = dict(_paths(a)), dict(_paths(b))
    if list(fa) != list(fb):
        fail(f"{what}: the trees differ: {sorted(set(fa) ^ set(fb))[:6]}")
    return [(k, fa[k], fb[k]) for k in fa]


def restart_child(path):
    """The restart phase's fresh process: `from_pretrained(<bundle>)`,
    `warmup(first_chunk_size=4)`, one greedy x-vector stream; prints one
    `RESTART {...}` line (load phases, card memory, its tokenizer, codes,
    launches, the epoch time of the first audio chunk)."""
    import torch

    from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS

    if not torch.cuda.is_available():
        fail("the restart needs the card")
    t0 = time.perf_counter()
    with logged_warnings() as warned:
        model = FasterQwen3TTS.from_pretrained(str(path), device="cuda")
    load_s = time.perf_counter() - t0
    card_gb = torch.cuda.memory_allocated() / 1e9
    reader = bpe_reader(model.tokenizer.base)
    tokenizer = {"reader": repr(reader) if reader is not None else None,
                 "fallback_reason": getattr(model.tokenizer.base, "fallback_reason", None),
                 "byte_warning": any("BYTE tokenizer" in w for w in warned)}
    t0 = time.perf_counter()
    model.warmup(first_chunk_size=FIRST_CHUNK)
    warmup_s = time.perf_counter() - t0
    _reset_launches()
    start = time.time()
    req, codes = run_request(model, seed=RESTART_SEED, greedy=True)
    launches = _read_launches()
    jaxish = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "faster_qwen3_tts_tpu"))
    if jaxish:
        fail(f"the restarted process loaded jax or the JAX package: {jaxish[:8]}")
    print("RESTART " + json.dumps({"load_s": load_s, "load_phases": model.load_phases, "card_gb": card_gb,
                                   "warmup_s": warmup_s, "first_audio_epoch": start + req["ttfa_ms"] / 1000.0,
                                   "request": req, "launches": launches, "tokenizer": tokenizer,
                                   "codes": codes.tolist()}), flush=True)


def restart_phase(model, report):
    """The serving restart on the strictly loaded 0.6B Q8_0 model: its
    bundles (full float32 and compact) written under build/, sizes and
    seconds beside the JAX writer's size; a fresh process restarts from the
    full bundle (`restart_child`) and must stream this model's greedy codes
    exactly, with card memory within 1 % of the strict load's; the compact
    bundle loaded here must hold every leaf's bf16 rounding (its greedy
    codes are counted against this model's, not held). -> launches of the
    restarted process's and the compact model's streams."""
    import shutil

    import numpy as np
    import torch

    from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS

    t_phase = time.perf_counter()
    build = REPO / "build"
    full, compact = build / "chip_smoke_bundle_0.6b", build / "chip_smoke_bundle_0.6b_compact"
    files = {"full_f32": write_bundle(model, full, False), "compact": write_bundle(model, compact, True)}
    for name, f in files.items():
        log(f"restart 0.6B Q8_0 ({CARD}): {name} bundle {f['gb']:.3f} GB written in {f['write_s']:.1f} s "
            f"(the JAX writer: {f['jax_writer_gb']:.3f} GB; predicted ~1.81 GB full, ~1.37 GB compact)")
    _, want = run_request(model, seed=RESTART_SEED, greedy=True)
    spawn = time.time()
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), "--restart-from", str(full)],
                          capture_output=True, text=True, timeout=600, cwd=REPO)
    if proc.returncode != 0:
        fail(f"the restart process exited {proc.returncode}: {proc.stderr[-3000:]}")
    line = next((ln for ln in reversed(proc.stdout.splitlines()) if ln.startswith("RESTART ")), None)
    if line is None:
        fail(f"the restart process printed no RESTART line: {proc.stdout[-2000:]}")
    child = json.loads(line[len("RESTART "):])
    got = np.asarray(child["codes"])
    to_audio_s = child["first_audio_epoch"] - spawn
    strict = report["checkpoint_0.6B"]
    log(f"restart 0.6B Q8_0 ({CARD}): fresh process to first audio {to_audio_s:.1f} s; from_pretrained(bundle) "
        f"{child['load_s']:.2f} s (strict HF load of the same tree: {strict['load_s']:.1f} s; predicted <= 3 s), "
        f"phases {child['load_phases']}; {child['card_gb']:.3f} GB on the card (strict load: "
        f"{strict['card_gb']:.3f} GB); warmup {child['warmup_s']:.1f} s; stream TTFA "
        f"{child['request']['ttfa_ms']:.1f} ms, {got.shape[0]} frames; launches {child['launches']}")
    phases = child["load_phases"]
    read_s = phases.get("weights_read", 0.0)
    mb = phases["transfer_mb"]
    log(f"restart 0.6B Q8_0 ({CARD}): read {mb / 1e3 / max(read_s, 1e-9):.2f} GB/s from the page cache "
        f"(predicted >= 2), pinned copy and unpack {mb / 1e3 / max(phases['device_transfer'], 1e-9):.2f} GB/s "
        f"(predicted >= 20 for the copy)")
    if got.shape != want.shape or not (got == want).all():
        fail(f"restart: the restarted process's greedy codes differ from the strict load's "
             f"({got.shape} vs {want.shape})")
    if abs(child["card_gb"] - strict["card_gb"]) > 0.01 * strict["card_gb"]:
        fail(f"restart: {child['card_gb']:.3f} GB on the card after the bundle load, the strict load held "
             f"{strict['card_gb']:.3f} GB")
    if child["launches"]["K1"] == 0 or child["launches"]["K2"] == 0:
        fail(f"restart: the restarted stream did not go through K1 and K2: {child['launches']}")
    if child["tokenizer"]["reader"] is None or child["tokenizer"]["byte_warning"]:
        fail(f"restart: the restarted process did not read the bundle's tokenizer with the BPE reader: "
             f"{child['tokenizer']}")
    log(f"restart 0.6B Q8_0: the restarted process's tokenizer {child['tokenizer']['reader']} (from the bundle's "
        f"copy of the checkpoint's assets), no byte-tokenizer warning")

    t0 = time.perf_counter()
    cm = FasterQwen3TTS.from_pretrained(str(compact), device="cuda")
    compact_load_s = time.perf_counter() - t0
    if bpe_reader(cm.tokenizer.base) is None:
        fail(f"compact bundle: its tokenizer is {cm.tokenizer.base!r}, not the BPE reader")
    n = 0
    for key, a, b in _leaf_pairs(model.params, cm.params, "compact bundle"):
        expect = a.to(torch.bfloat16).float() if a.dtype == torch.float32 else a
        if b.dtype != a.dtype or not torch.equal(b, expect):
            fail(f"compact bundle: {key} is not the bf16 rounding of the strict leaf")
        n += 1
    _reset_launches()
    _, toks = run_request(cm, seed=RESTART_SEED, greedy=True)
    launches = _read_launches()
    if launches["K1"] == 0 or launches["K2"] == 0:
        fail(f"compact: the stream did not go through K1 and K2: {launches}")
    m = min(len(toks), len(want))
    equal = int((toks[:m] == want[:m]).sum())
    log(f"restart 0.6B Q8_0 compact ({CARD}): loaded in {compact_load_s:.2f} s ({cm.load_phases}); {n} leaves "
        f"equal to the bf16 rounding of the strict leaves (scales too: not the model bit for bit); greedy codes "
        f"equal to the strict model's: {equal}/{want.size} (reported, not held)")
    compact_phases = cm.load_phases
    del cm
    gc.collect()
    torch.cuda.empty_cache()
    phase("mesh procs: dp = 2 over two processes on cuda:0, from the full bundle")
    procs_launches = mesh_procs_phase(model, full, report)
    shutil.rmtree(full)
    shutil.rmtree(compact)
    shutil.rmtree(HF_DIR, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    log(f"restart 0.6B Q8_0: phase {phase_s:.1f} s")
    report["restart_0.6B_Q8_0"] = {"bundles": files, "child": {k: v for k, v in child.items() if k != "codes"},
                                   "to_first_audio_s": to_audio_s, "codes_equal": True,
                                   "compact": {"load_s": compact_load_s, "leaves": n, "codes_equal": equal,
                                               "codes": int(want.size), "load_phases": compact_phases},
                                   "phase_s": phase_s, "card": CARD}
    return {k: child["launches"][k] + launches[k] + procs_launches[k] for k in launches}


def mixed_bundle_phase(model, report):
    """The 0.6B Q8_4 model bundled (full float32) under build/ and loaded
    back: every leaf bitwise, greedy codes equal the in-memory model's, K1,
    K2 and K4 launched. -> launches of the bundle-loaded model's stream."""
    import shutil

    import torch

    from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS

    path = REPO / "build" / "chip_smoke_bundle_0.6b_q84"
    f = write_bundle(model, path, False)
    t0 = time.perf_counter()
    bm = FasterQwen3TTS.from_pretrained(str(path), device="cuda")
    load_s = time.perf_counter() - t0
    pairs = _leaf_pairs(model.params, bm.params, "Q8_4 bundle")
    for key, a, b in pairs:
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            fail(f"Q8_4 bundle: {key} differs from the in-memory model's")
    _, want = run_request(model, seed=RESTART_SEED, greedy=True)
    _reset_launches()
    _, got = run_request(bm, seed=RESTART_SEED, greedy=True)
    launches = _read_launches()
    if any(launches[k] == 0 for k in ("K1", "K2", "K4")):
        fail(f"Q8_4 bundle: the stream did not go through K1, K2 and K4: {launches}")
    if got.shape != want.shape or not (got == want).all():
        fail("Q8_4 bundle: greedy codes differ from the in-memory model's")
    log(f"restart 0.6B Q8_4 ({CARD}): bundle {f['gb']:.3f} GB (JAX writer {f['jax_writer_gb']:.3f} GB) written in "
        f"{f['write_s']:.1f} s, loaded in {load_s:.2f} s ({bm.load_phases}); {len(pairs)} leaves bitwise; "
        f"greedy codes equal ({got.shape[0]} frames); launches {launches}")
    report["restart_0.6B_Q8_4"] = {"bundle": f, "load_s": load_s, "load_phases": bm.load_phases,
                                   "leaves_bitwise": len(pairs), "launches": launches, "card": CARD}
    del bm
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(path)
    return launches


def quantize_on_card_phase(host_quantized, bundle, report):
    """The unquantized (BF16) bundle loaded with quant="Q8_0": quantized on
    the card after the copy; every int8 leaf and every leaf that is not a
    scale must equal the host quantization's (`host_quantized`, materialize
    in Q8_0) bit for bit; the scales' largest distance in ulps is printed."""
    import shutil

    import torch

    from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS

    t0 = time.perf_counter()
    qm = FasterQwen3TTS.from_pretrained(str(bundle), device="cuda", quant="Q8_0")
    load_s = time.perf_counter() - t0
    ulps, n_q = 0, 0
    for key, a, b in _leaf_pairs(host_quantized, qm.params, "BF16 bundle quantized on the card"):
        if a.dtype != b.dtype or a.shape != b.shape:
            fail(f"quantize on the card: {key} is {b.dtype} {tuple(b.shape)}, the host's {a.dtype} {tuple(a.shape)}")
        if key.endswith("/1") and a.dtype == torch.float32 and a.dim() >= 2:  # QuantizedLinear.scale
            ulps = max(ulps, _max_ulps(a, b))
        elif not torch.equal(a, b):
            fail(f"quantize on the card: {key} differs from the host quantization")
        n_q += a.dtype == torch.int8
    log(f"quantize on the card 0.6B BF16 bundle -> Q8_0 ({CARD}): loaded and quantized in {load_s:.2f} s "
        f"({qm.load_phases}); {n_q} int8 leaves bitwise equal to the host quantization; scales' largest "
        f"difference {ulps} ulp")
    report["quantize_on_card_0.6B"] = {"load_s": load_s, "load_phases": qm.load_phases, "int8_leaves": n_q,
                                       "scale_max_ulps": ulps, "card": CARD}
    del qm
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(bundle)


def device_init_phase(host_model, host_load_s, report):
    """`FQ3T_DEVICE_INIT=1 from_pretrained(1.7B CustomVoice, quant="Q8_0")`:
    the tree, shapes and dtypes of the host init's model, constant leaves
    exact, each other leaf of >= 256 elements with a std within 0.6-1.6x
    the host leaf's; then one CustomVoice stream (finite audio, K1 and K2
    launched). -> launches of that stream."""
    import os

    import torch

    from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS

    os.environ["FQ3T_DEVICE_INIT"] = "1"
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dm = FasterQwen3TTS.from_pretrained(MODEL_17B, device="cuda", quant="Q8_0", seed=0)
        load_s = time.perf_counter() - t0
    finally:
        del os.environ["FQ3T_DEVICE_INIT"]
    n_const = n_random = 0
    worst = (0.0, "")
    for key, a, b in _leaf_pairs(host_model.params, dm.params, "device init"):
        if a.dtype != b.dtype or a.shape != b.shape:
            fail(f"device init: {key} is {b.dtype} {tuple(b.shape)}, the host init's {a.dtype} {tuple(a.shape)}")
        flat = a.reshape(-1)
        if flat.numel() and bool((flat == flat[0]).all()):
            if not torch.equal(a, b):
                fail(f"device init: the constant leaf {key} differs from the host init's")
            n_const += 1
        elif a.numel() >= 256:
            ratio = float(b.float().std()) / max(float(a.float().std()), 1e-30)
            if not 0.6 < ratio < 1.6:
                fail(f"device init: {key} std {ratio:.3f}x the host init's")
            worst = max(worst, (abs(math.log(ratio)), key))
            n_random += 1
    bundle_gb = sum(t.numel() * t.element_size() for _, t in _paths(host_model.params)) / 1e9
    _reset_launches()
    with greedy_predictor():
        req, _ = run_request(dm, 38, method="generate_custom_voice_streaming", args=(TEXT, "aiden", "English"))
    launches = _read_launches()
    if launches["K1"] == 0 or launches["K2"] == 0:
        fail(f"device init: the stream did not go through K1 and K2: {launches}")
    log(f"device init 1.7B Q8_0 ({CARD}): FQ3T_DEVICE_INIT=1 from_pretrained {load_s:.2f} s ({dm.load_phases}) "
        f"against the host init's {host_load_s:.1f} s; {n_const} constant leaves exact, {n_random} random leaves "
        f"within 0.6-1.6x the host std (farthest {math.exp(worst[0]):.3f}x, {worst[1]}); a full-f32 bundle of "
        f"this tree would hold {bundle_gb:.3f} GB (predicted ~3.17); stream {req['frames']} frames, TTFA "
        f"{req['ttfa_ms']:.1f} ms; launches {launches}")
    report["device_init_1.7B_Q8_0"] = {"load_s": load_s, "host_init_load_s": host_load_s,
                                       "load_phases": dm.load_phases, "constant_leaves": n_const,
                                       "random_leaves": n_random, "bundle_gb": bundle_gb, "request": req,
                                       "launches": launches, "card": CARD}
    del dm
    gc.collect()
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def tapped_steps(rec):
    """For the block, count in rec["steps"] the engine's decode steps (the
    graph sets' chunks) and in rec["K1"] / ["K2"] / ["K4"] the kernel
    launches made inside them (their replays; not those of prompt building or
    the prefill)."""
    from faster_qwen3_tts_tpu_torch.engine import graphs

    real = graphs.GraphSet.run_chunk
    rec.update(steps=0, **dict.fromkeys(KERNELS, 0))

    def counting(gset, *a, **k):
        before = _read_launches()
        packed = real(gset, *a, **k)
        for key, n in _read_launches().items():
            rec[key] += n - before[key]
        rec["steps"] += packed.shape[0]
        return packed

    graphs.GraphSet.run_chunk = counting
    try:
        yield rec
    finally:
        graphs.GraphSet.run_chunk = real


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


# the (dp, tp) mesh phase: F32 talker prefill logits of the 2 x 2 mesh against
# the unsharded model, max |diff| over the largest |logit| (PERF.md states the
# limit: the tp partials summed in another order, and cuBLAS at the shard widths)
MESH_F32_LOGIT_REL = 1e-3
# the same gap of the Q8_0 mesh (bf16 activations): its limit lies between two
# readings that PERF.md states, the floor of bf16 itself (the unsharded
# model's prefill logits at 1 and 2 rows of a batch differ by 0.0625, 1.6e-2 of
# the largest logit) and a planted fault (`_fault_gap`), which must exceed it
MESH_Q8_LOGIT_REL = 8e-2
MESH_F32_FRAMES = 8  # frames a lane of the F32 batches (captured at first use)


@contextlib.contextmanager
def kept_prompts(prompts):
    """For the block, keep (group params, tie, mask) of every graph set's
    prefill in `prompts`, in call order (the order of the tapped logits)."""
    from faster_qwen3_tts_tpu_torch.engine import graphs

    set_prefill = graphs.GraphSet.prefill

    def keep(gset, params, tie, mask, *a, **k):
        prompts.append((params, tie.clone(), mask.clone()))
        return set_prefill(gset, params, tie, mask, *a, **k)

    graphs.GraphSet.prefill = keep
    try:
        yield prompts
    finally:
        graphs.GraphSet.prefill = set_prefill


def _fault_gap(prompts, cfg, ref_logits):
    """The kept prompts' talker prefill logits, eager, over every dp group
    -> (gap of the mesh as it is, gap with a planted fault: the last tp
    rank's partial dropped from every row-parallel reduction), each max
    |diff| from `ref_logits` over its largest |logit|."""
    import torch

    from faster_qwen3_tts_tpu_torch.models import layers
    from faster_qwen3_tts_tpu_torch.models import talker as talker_lib

    def gap():
        got = torch.cat([talker_lib.prefill(params["talker"], cfg.talker, tie, mask)[1].float().cpu()
                         for params, tie, mask in prompts])
        return float((got - ref_logits).abs().max() / ref_logits.abs().max())

    clean, reduce = gap(), layers.all_reduce
    layers.all_reduce = lambda parts, group=None: reduce(parts[:-1], group)
    try:
        return clean, gap()
    finally:
        layers.all_reduce = reduce


def _mesh_frame_launches(cfg, quant, tp):
    """Kernel launches of one dp group's frame on a tp mesh: K1, K6 (q / k
    norm, RoPE, cache write) once a rank a talker layer and a predictor
    decode pass (14); K7 (SiLU * up) once a rank a layer pass, the
    predictor's prefill included; K5 (add + RMSNorm) once a layer pass at
    ln1 and ln2 and once a stack call (the hidden state is replicated), and
    once a rank for each per-head q / k norm of the predictor's prefill;
    int8 projections once a rank (mtp_proj is replicated: once), int4 ones
    whole, once."""
    t, p = cfg.talker.num_hidden_layers, cfg.predictor.num_hidden_layers
    k1 = tp * (t + 14 * p)
    glue = {"K5": (2 * t + 1) + 15 * (2 * p + 1) + tp * 2 * p, "K6": k1, "K7": tp * (t + 15 * p)}
    talker = tp * (7 * t + 1)  # 7 projections a layer, the codec head
    if quant == "Q8_0":
        return {"K1": k1, "K2": talker + tp * (15 * 7 * p + 15) + 15, "K4": 0, **glue}
    return {"K1": k1, "K2": talker, "K4": 15 * 7 * p + 15 + 15, **glue}  # Q8_4: the predictor in int4, whole


@contextlib.contextmanager
def sharded_shapes(tally):
    """For the block, count K1 launches by (lanes, query heads, kv heads) and
    K2 launches by (rows, I, O): the engine's calls of the two wrappers (on
    the card at eager runs and captures)."""
    from faster_qwen3_tts_tpu_torch.models import layers
    from faster_qwen3_tts_tpu_torch.ops import quant as quant_ops

    attn, gemv = layers.decode_attention, quant_ops.int8_gemv

    def attn_counted(q, k, *a):
        key = (q.shape[0], q.shape[2], k.shape[2])
        tally.setdefault("K1", {})[key] = tally.setdefault("K1", {}).get(key, 0) + 1
        return attn(q, k, *a)

    def gemv_counted(x, q, scale):
        key = (x.numel() // x.shape[-1],) + tuple(q.shape)
        tally.setdefault("K2", {})[key] = tally.setdefault("K2", {}).get(key, 0) + 1
        return gemv(x, q, scale)

    gemv_counted.launches = gemv.launches  # int8_gemv counts on the module's name for it
    layers.decode_attention, quant_ops.int8_gemv = attn_counted, gemv_counted
    try:
        yield tally
    finally:
        layers.decode_attention, quant_ops.int8_gemv = attn, gemv
        gemv.launches = gemv_counted.launches


def _replay_ms(gset, n=20):
    """A frame graph's device ms a replay (CUDA events over n replays of a
    free set: masked lanes, the timing only)."""
    import torch

    for _ in range(3):
        gset.frame_graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        gset.frame_graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _set_of(reg, batch, greedy):
    return next(g for g in reg.sets if g.key.batch == batch and g.key.sampling.do_sample != greedy)


def mesh_refusals(tiny_dir):
    """On a machine with one card `from_pretrained(dp=2, tp=2)` raises the JAX
    package's device-count ValueError; a process mesh whose tp group sits on
    cuda:0 twice raises ValueError (NCCL takes one rank a card) before
    spawning anything; and a mesh over cuda:0 and cuda:1 (a tp group or dp
    groups) raises the device-count ValueError."""
    import multiprocessing

    import torch

    from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS
    from faster_qwen3_tts_tpu_torch.parallel import mesh as mesh_lib

    n, said = torch.cuda.device_count(), None
    try:
        FasterQwen3TTS.from_pretrained(str(tiny_dir), dp=2, tp=2)
        if n < 4:
            fail(f"from_pretrained(dp=2, tp=2) on {n} card(s) did not raise")
    except ValueError as e:
        if n >= 4 or f"needs 4 devices; only {n} visible" not in str(e):
            fail(f"from_pretrained(dp=2, tp=2) on {n} card(s): {e}")
        said = str(e)
    card = torch.device("cuda", 0)
    children = len(multiprocessing.active_children())
    try:
        mesh_lib.make_mesh(2, dp=1, tp=2, devices=[card, card], processes=True)
        fail("a process mesh with tp = 2 over cuda:0 twice did not raise")
    except ValueError as e:
        if "NCCL" not in str(e) or "one-process mesh" not in str(e):
            fail(f"a process mesh with tp = 2 over cuda:0 twice: {e}")
    if len(multiprocessing.active_children()) != children:
        fail("the refused process mesh spawned a process")
    for dp, tp in ((1, 2), (2, 1)):
        try:
            mesh_lib.make_mesh(2, dp=dp, tp=tp, devices=[card, torch.device("cuda", 1)])
            if n < 2:
                fail(f"a dp={dp} x tp={tp} mesh over cuda:0 and cuda:1 on {n} card did not raise")
        except ValueError as e:
            if n >= 2 or f"needs 2 devices; only {n} visible" not in str(e):
                fail(f"a dp={dp} x tp={tp} mesh over cuda:0 and cuda:1: {e}")
    log(f"mesh refusals: from_pretrained(dp=2, tp=2) on {n} card: ValueError '{said}'; a process mesh with tp "
        "over cuda:0 twice: ValueError (NCCL, nothing spawned); a tp group and dp groups over cuda:0, cuda:1: "
        "the device-count ValueError")


MESH_PROCS_FRAMES = 32  # frames a lane of the process mesh's lockstep batch
NCCL_REPLAYS = 100  # replays of the captured one-rank NCCL all-reduce and all-gather
CONTROL_ROUND_TRIPS = 20  # timed control-plane commands (a broadcast to the worker and a gather back)


def worker_frame_ms(params, batch):
    """Run in a process mesh's worker (`Workers.call`): the device ms a
    replay of this process's greedy frame graph of `batch` lanes."""
    from faster_qwen3_tts_tpu_torch.engine import graphs

    return _replay_ms(_set_of(graphs.registries(params)[0], batch, True))


def nccl_capture_check(pg, cfg):
    """The port's own `mesh.all_reduce` (float32 [4, 1, H]) and
    `mesh.all_gather` (logits [4, V] along dim -1) over the one-rank NCCL
    tp group `pg`, captured in one CUDA graph and replayed NCCL_REPLAYS
    times on fresh inputs: each replay must equal the eager calls on the
    same inputs. -> its row (replay us)."""
    import torch
    import torch.distributed as dist

    from faster_qwen3_tts_tpu_torch.parallel import mesh as mesh_lib

    if dist.get_backend(pg) != "nccl" or dist.get_world_size(pg) != 1:
        fail(f"the tp group is {dist.get_backend(pg)} of {dist.get_world_size(pg)} ranks, not one-rank NCCL")
    dev = torch.device("cuda", 0)
    x = torch.empty((4, 1, cfg.talker.hidden_size), device=dev)
    lg = torch.empty((4, cfg.talker.vocab_size), device=dev)

    def body():
        return mesh_lib.all_reduce([x * 1.0], pg), mesh_lib.all_gather([lg * 1.0], -1, pg)

    x.normal_(), lg.normal_()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out_r, out_g = body()
    bad = 0
    for _ in range(NCCL_REPLAYS):
        x.normal_(), lg.normal_()
        graph.replay()
        want_r, want_g = body()
        bad += not (torch.equal(out_r, want_r) and torch.equal(out_g, want_g) and torch.equal(out_r, x))
    torch.cuda.synchronize()
    if bad:
        fail(f"NCCL capture: {bad} of {NCCL_REPLAYS} replays differ from the eager all_reduce / all_gather")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(NCCL_REPLAYS):
        graph.replay()
    end.record()
    end.synchronize()
    return {"replays": NCCL_REPLAYS, "equal": True, "replay_us": start.elapsed_time(end) * 1000.0 / NCCL_REPLAYS}


def mesh_procs_phase(plain, bundle, report):
    """The process form of the mesh on one card: dp = 2 x tp = 1 as two
    processes on cuda:0 (this process, rank 0, and one spawned worker),
    `from_pretrained(<full bundle>, mesh=make_mesh(2, dp=2, tp=1,
    devices=[cuda:0] * 2, processes=True))`; `warmup`, then a 4-lane greedy
    lockstep batch of MESH_PROCS_FRAMES frames: each dp group's 2 lanes must
    equal, code for code, the unsharded model `plain`'s B = 2 batch of the
    same two requests (the same graph key: the same shapes and kernels), no
    frame or prefill may run eagerly in either process, and the worker's K1
    and K2 must launch. Then the NCCL capture check on rank 0's one-rank tp
    group, and the mesh's close (no worker left). -> the launches of both
    processes."""
    import numpy as np
    import torch

    from faster_qwen3_tts_tpu_torch.engine import graphs
    from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS
    from faster_qwen3_tts_tpu_torch.parallel import mesh as mesh_lib

    t_phase = time.perf_counter()
    counters = "faster_qwen3_tts_tpu_torch.parallel.procs:counters"
    reqs = [{"text": BATCH_TEXTS[i], "voice_clone_prompt": _xvec_prompt(300 + i), "xvec_only": True}
            for i in range(4)]
    warm = dict(chunk_sizes=(CHUNK,), first_chunk_size=FIRST_CHUNK, do_sample=False, subtalker_dosample=False,
                min_new_tokens=BATCH_FRAMES)
    plain.warmup(batch_sizes=(2,), **warm)
    ref, want = [], []
    for pair in (reqs[:2], reqs[2:]):
        rec, tok = lockstep_run(plain, pair, MESH_PROCS_FRAMES)
        ref.append(rec)
        want += tok
    mesh = mesh_lib.make_mesh(2, dp=2, tp=1, devices=[torch.device("cuda", 0)] * 2, processes=True)
    t0 = time.perf_counter()
    model = FasterQwen3TTS.from_pretrained(str(bundle), device="cuda", mesh=mesh)
    row = {"from_pretrained_s": time.perf_counter() - t0, "workers_start_s": mesh.workers.start_s,
           "workers": mesh.workers.reports, "card": CARD}
    try:
        if not all(r["modules_checked"] and not r["forbidden"] for r in row["workers"]):
            fail(f"mesh procs: a worker did not check its modules or loaded jax: {row['workers']}")
        t0 = time.perf_counter()
        model.warmup(batch_sizes=(4,), **warm)
        row.update(warmup_s=time.perf_counter() - t0, warmup_phases=model.warmup_phases)
        before = mesh.workers.call(counters, True)  # read, then zeroed
        with no_eager_frames("mesh procs lockstep"), no_eager_prefills("mesh procs lockstep"):
            got, tok = lockstep_run(model, reqs, MESH_PROCS_FRAMES)
        after = mesh.workers.call(counters)
        worker = {k: sum(a[k] for a in after) for k in KERNELS}
        eager = [(a["eager_frames"] - b["eager_frames"], a["eager_prefills"] - b["eager_prefills"])
                 for a, b in zip(after, before)]
        if any(e != (0, 0) for e in eager):
            fail(f"mesh procs: the worker ran (frames, prefills) {eager} eagerly on the card after warmup")
        if worker["K1"] == 0 or worker["K2"] == 0 or got["launches"]["K1"] == 0 or got["launches"]["K2"] == 0:
            fail(f"mesh procs: K1 / K2 did not launch in both processes: rank 0 {got['launches']}, worker {worker}")
        equal = [bool(t.shape == w.shape and (t == w).all()) for t, w in zip(tok, want)]
        if not all(equal):
            fail(f"mesh procs: lanes whose codes differ from the unsharded B = 2 batch: "
                 f"{[s for s, e in enumerate(equal) if not e]} (frames {[t.shape[0] for t in tok]})")
        row.update(lockstep={k: got[k] for k in ("steps", "wall_s", "ttfa_ms", "aggregate_rtf", "launches")},
                   worker_launches=worker, codes_equal=equal,
                   plain_lockstep=[{k: r[k] for k in ("steps", "wall_s", "ttfa_ms", "aggregate_rtf")} for r in ref],
                   frame_ms={"rank0": _replay_ms(_set_of(graphs.registries(model.params)[0], 2, True)),
                             "worker": mesh.workers.call("chip_smoke:worker_frame_ms", 2)[0],
                             "unsharded": _replay_ms(_set_of(graphs.registry_for(plain.params), 2, True))},
                   nccl=nccl_capture_check(mesh.tp_group, plain.config))
        rtt = []
        for _ in range(CONTROL_ROUND_TRIPS):  # one command out, one reply back: the cost a chunk's collect adds
            t0 = time.perf_counter()
            mesh.workers.call(counters)
            rtt.append((time.perf_counter() - t0) * 1000.0)
        row["control_round_trip_ms"] = statistics.median(rtt)
    finally:
        mesh.close()
    if any(mesh.workers.alive()):
        fail("mesh procs: a worker is alive after close()")
    row["phase_s"] = time.perf_counter() - t_phase
    fm, ws = row["frame_ms"], row["workers"][0]
    log(f"mesh procs dp=2 x tp=1, two processes on cuda:0 ({CARD}): from_pretrained {row['from_pretrained_s']:.1f} s "
        f"(the worker's spawn to ready {row['workers_start_s']:.1f} s: join {ws['join_s']:.1f} s, load "
        f"{ws['load_s']:.2f} s), warmup {row['warmup_s']:.1f} s (the worker's captures "
        f"{row['warmup_phases'].get('workers')}); lockstep B=4 x {MESH_PROCS_FRAMES} frames: aggregate RTF "
        f"{got['aggregate_rtf']:.3f} (unsharded B=2 {ref[0]['aggregate_rtf']:.3f} / {ref[1]['aggregate_rtf']:.3f}), "
        f"lane TTFA " + ", ".join(f"{x:.0f}" for x in got["ttfa_ms"]) + " ms; every lane's codes equal the "
        f"unsharded B=2 batch's; captured B=2 frame rank 0 {fm['rank0']:.3f} ms, worker {fm['worker']:.3f} ms, "
        f"unsharded {fm['unsharded']:.3f} ms (each replayed alone); launches rank 0 {got['launches']}, worker "
        f"{worker}; NCCL one-rank all_reduce + all_gather captured, {row['nccl']['replays']} replays equal to "
        f"eager, {row['nccl']['replay_us']:.1f} us a replay; a control-plane round trip (host, median of "
        f"{CONTROL_ROUND_TRIPS}) {row['control_round_trip_ms']:.3f} ms; phase {row['phase_s']:.1f} s")
    report["mesh_procs"] = row
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {k: got["launches"][k] + worker[k] for k in KERNELS}


def mesh_phase(params, plain, quant, report):
    """The 0.6B tree of this quant mode on a 2 x 2 mesh of one card,
    `make_mesh(4, dp=2, tp=2, devices=[cuda:0] * 4)`, through
    `FasterQwen3TTS(shard_params(params, mesh), ..., mesh=mesh)`: F32, a
    4-lane greedy lockstep batch of 8 frames a lane against the unsharded
    model `plain` (talker prefill logits within MESH_F32_LOGIT_REL, the first
    frame's 16 codes of every lane equal; Q8_0's within MESH_Q8_LOGIT_REL;
    both limits held against a planted fault, `_fault_gap`); Q8_0 and Q8_4,
    `warmup` then a
    4-lane lockstep batch of 32 frames (two lanes a dp group; no eager frame
    or prefill), Q8_0 also a solo tp stream (dp group 0) of 32 frames and
    the unsharded model's batch and stream: captured frame ms (CUDA events)
    against unsharded, launches a frame (each group's frame graph) against
    the count the sharded layers make, K1 / K2 by shape at the captures,
    graph memory, lane TTFA and aggregate RTF. -> the phase's launches."""
    import numpy as np
    import torch

    from faster_qwen3_tts_tpu_torch.engine import graphs
    from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS
    from faster_qwen3_tts_tpu_torch.parallel import mesh as mesh_lib

    t_phase = time.perf_counter()
    mesh = mesh_lib.make_mesh(4, dp=2, tp=2, devices=[torch.device("cuda", 0)] * 4)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sharded = mesh_lib.shard_params(params, mesh)
    torch.cuda.synchronize()
    row = {"shard_s": time.perf_counter() - t0, "sharded_gb": (torch.cuda.memory_allocated() - base) / 1e9}
    model = FasterQwen3TTS(sharded, plain.config, plain.tokenizer, mesh=mesh)
    reqs = [{"text": BATCH_TEXTS[i], "voice_clone_prompt": _xvec_prompt(200 + i), "xvec_only": True}
            for i in range(4)]
    total = dict.fromkeys(KERNELS, 0)
    prompts = []
    if quant == "F32":
        ref, ref_tok = lockstep_run(plain, reqs, MESH_F32_FRAMES)
        with sharded_shapes({}) as shapes, kept_prompts(prompts):
            got, tok = lockstep_run(model, reqs, MESH_F32_FRAMES)
        total = dict(got["launches"])
        gap = float((got["logits"] - ref["logits"]).abs().max())
        scale = float(ref["logits"].abs().max())
        agree = [_agreement(r, t) for r, t in zip(ref_tok, tok)]
        eager_rel, fault_rel = _fault_gap(prompts, plain.config, ref["logits"])
        row.update(logits_max_abs_diff=gap, logits_max_abs=scale, logits_rel=gap / scale,
                   eager_logits_rel=eager_rel, fault_logits_rel=fault_rel,
                   argmax_equal=bool((got["logits"].argmax(-1) == ref["logits"].argmax(-1)).all()),
                   agreement=agree, shapes=shapes)
        log(f"mesh 2x2 F32 ({CARD}): 4-lane prefill logits against unsharded: max abs diff {gap:.3e} of "
            f"{scale:.3f} (relative {gap / scale:.2e}, limit {MESH_F32_LOGIT_REL:.0e}; eager {eager_rel:.2e}, "
            f"with the last rank's partials dropped {fault_rel:.2e}), argmax equal "
            f"{row['argmax_equal']}; greedy lanes: equal frames " +
            ", ".join(f"{a['equal_frames']}/{a['frames']}" for a in agree) + ", first difference " +
            ", ".join(str(a["first_difference"]) for a in agree) + f"; K1 by (lanes, heads) {shapes.get('K1')}")
        if not gap / scale <= MESH_F32_LOGIT_REL:
            fail(f"mesh F32: prefill logits {gap / scale:.2e} relative from unsharded (limit {MESH_F32_LOGIT_REL})")
        if not fault_rel > MESH_F32_LOGIT_REL:
            fail(f"mesh F32: a dropped partial moves the logits only {fault_rel:.2e} (limit {MESH_F32_LOGIT_REL})")
        if any(not (r[0] == t[0]).all() for r, t in zip(ref_tok, tok)):
            fail(f"mesh F32: the first frame's greedy codes differ from unsharded: {agree}")
    else:
        warm = dict(chunk_sizes=(CHUNK,), first_chunk_size=FIRST_CHUNK, do_sample=False, subtalker_dosample=False,
                    min_new_tokens=BATCH_FRAMES)
        t0 = time.perf_counter()
        sizes = (1, 4) if quant == "Q8_0" else (4,)  # B = 4: two sets of 2 lanes, one a dp group; B = 1: group 0
        with sharded_shapes({}) as shapes:
            model.warmup(batch_sizes=sizes, **warm)
        row.update(warmup_s=time.perf_counter() - t0, warmup_phases=model.warmup_phases, shapes=shapes)
        with no_eager_frames(f"mesh {quant} lockstep"), no_eager_prefills(f"mesh {quant} lockstep"), \
                kept_prompts(prompts):
            got, tok = lockstep_run(model, reqs, FRAMES)
        total = {k: total[k] + got["launches"][k] for k in total}
        regs = graphs.registries(model.params)
        expect = _mesh_frame_launches(plain.config, quant, 2)
        frame = [_set_of(r, 2, True).frame_launches for r in regs]
        if any(f != expect for f in frame):
            fail(f"mesh {quant}: a dp group's frame launches {frame}, expected {expect}")
        row.update(lockstep={k: got[k] for k in ("steps", "wall_s", "ttfa_ms", "aggregate_rtf", "launches",
                                                   "launches_per_step")},
                   frame_launches_per_group=frame[0], lockstep_step_ms=sum(_replay_ms(_set_of(r, 2, True))
                                                                           for r in regs))
        need = ("K1", "K2") if quant == "Q8_0" else ("K1", "K2", "K4")
        if any(got["launches"][k] == 0 for k in need):
            fail(f"mesh {quant}: the lockstep batch did not launch {need}: {got['launches']}")
        if quant == "Q8_0":
            plain.warmup(batch_sizes=sizes, **warm)
            ref, ref_tok = lockstep_run(plain, reqs, FRAMES)
            solo_kw = dict(seed=1, greedy=True, voice_clone_prompt=reqs[0]["voice_clone_prompt"],
                           min_new_tokens=BATCH_FRAMES)
            _reset_launches()
            with no_eager_frames("mesh Q8_0 solo tp stream"), no_eager_prefills("mesh Q8_0 solo tp stream"):
                solo, solo_tok = run_request(model, **solo_kw)
            counted = _read_launches()
            total = {k: total[k] + counted[k] for k in total}
            plain_solo, plain_tok = run_request(plain, **solo_kw)
            preg = graphs.registry_for(plain.params)
            row.update(solo=solo, solo_launches=counted, plain_solo=plain_solo,
                       plain_lockstep={k: ref[k] for k in ("steps", "wall_s", "ttfa_ms", "aggregate_rtf")},
                       solo_frame_ms=_replay_ms(_set_of(regs[0], 1, True)),
                       plain_frame_ms=_replay_ms(_set_of(preg, 1, True)),
                       plain_step_ms=_replay_ms(_set_of(preg, 4, True)),
                       plain_frame_launches=_set_of(preg, 1, True).frame_launches,
                       agreement=[_agreement(r, t) for r, t in zip(ref_tok, tok)],
                       solo_agreement=_agreement(plain_tok, solo_tok),
                       logits_rel=float((got["logits"] - ref["logits"]).abs().max() / ref["logits"].abs().max()))
            row["eager_logits_rel"], row["fault_logits_rel"] = _fault_gap(prompts, plain.config, ref["logits"])
            if solo["frames"] == 0 or counted["K1"] == 0 or counted["K2"] == 0:
                fail(f"mesh Q8_0 solo tp stream: {solo['frames']} frames, launches {counted}")
            if not row["logits_rel"] <= MESH_Q8_LOGIT_REL:
                fail(f"mesh Q8_0: prefill logits {row['logits_rel']:.2e} relative from unsharded (limit "
                     f"{MESH_Q8_LOGIT_REL})")
            if not row["fault_logits_rel"] > MESH_Q8_LOGIT_REL:
                fail(f"mesh Q8_0: a dropped partial moves the logits only {row['fault_logits_rel']:.2e} (limit "
                     f"{MESH_Q8_LOGIT_REL})")
            log(f"mesh 2x2 Q8_0 solo tp stream ({CARD}): TTFA {solo['ttfa_ms']:.1f} ms, stream RTF "
                f"{solo['stream_rtf']:.3f} (unsharded {plain_solo['ttfa_ms']:.1f} ms, {plain_solo['stream_rtf']:.3f}); "
                f"captured frame {row['solo_frame_ms']:.3f} ms against unsharded {row['plain_frame_ms']:.3f} ms; "
                f"launches a frame {frame[0]} against unsharded {row['plain_frame_launches']}; greedy codes against "
                f"unsharded: {row['solo_agreement']['equal_frames']}/{row['solo_agreement']['frames']} frames equal, "
                "lockstep lanes " + ", ".join(f"{a['equal_frames']}/{a['frames']}" for a in row["agreement"]) +
                f" (bf16; prefill logits {row['logits_rel']:.2e} relative from unsharded, limit "
                f"{MESH_Q8_LOGIT_REL:.0e}; eager {row['eager_logits_rel']:.2e}, with the last rank's partials "
                f"dropped {row['fault_logits_rel']:.2e})")
        mem = model.warmup_phases
        log(f"mesh 2x2 {quant} lockstep B=4 ({CARD}): {got['steps']} steps, aggregate RTF {got['aggregate_rtf']:.3f}"
            + (f" (unsharded {row['plain_lockstep']['aggregate_rtf']:.3f})" if quant == "Q8_0" else "")
            + "; lane TTFA " + ", ".join(f"{x:.0f}" for x in got["ttfa_ms"]) + " ms; a step's two group frames "
            f"{row['lockstep_step_ms']:.3f} ms" + (f" against one unsharded B=4 frame {row['plain_step_ms']:.3f} ms"
                                                  if quant == "Q8_0" else "")
            + f"; launches a group frame {frame[0]}; graph memory static {mem['graph_static_gb']:.3f} GB, pool "
            f"{mem['graph_pool_gb']} GB; capture shapes K1 {shapes.get('K1')}, K2 rows x I x O "
            f"{sorted(shapes.get('K2', {}))}; warmup {row['warmup_s']:.1f} s")
        kv = plain.config.talker.num_key_value_heads // 2
        if not any(h == kv for _, _, h in shapes.get("K1", {})):
            fail(f"mesh {quant}: K1 never ran at {kv} kv heads: {shapes.get('K1')}")
        if quant == "Q8_0" and not {(2, 1024, 512), (2, 1536, 1024)} <= set(shapes.get("K2", {})):
            fail(f"mesh Q8_0: K2 not at the shard shapes: {sorted(shapes.get('K2', {}))}")
    row["shapes"] = {k: {str(key): n for key, n in d.items()} for k, d in row.get("shapes", {}).items()}
    row["phase_s"] = time.perf_counter() - t_phase
    log(f"mesh 2x2 {quant}: sharded in {row['shard_s']:.2f} s ({row['sharded_gb']:.2f} GB on the card), phase "
        f"{row['phase_s']:.1f} s, launches {total}")
    report.setdefault("mesh_2x2", {})[quant] = row
    del model, sharded
    gc.collect()
    torch.cuda.empty_cache()
    return total


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
    a bf16 engine and the f32 parity decode part early on random weights);
    on the Q8_0 params the native phase, and on the Q8_0 and Q4_K_M params
    the fused phase (`native_phase`, `fused_phase`). Its models keep the
    byte tokenizer (`load_tokenizer(None)`): each comparison here is among
    them and the Q8_4 bundle, which has no tokenizer assets to carry; none
    is with the checkpoint's model, which reads BPE ids. -> launches of the
    Q4_K_M and Q8_4 streams and of the native and fused phases."""
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
    launches = dict.fromkeys(KERNELS, 0)
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
        _, logits = core.start_state(params["talker"], cfg.talker, sess.tie, sess.mask, None,
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
        if quant == "BF16":  # its bundle is quantized on the card at Q8_0, against Q8_0's host quantization
            bf16_bundle = REPO / "build" / "chip_smoke_bundle_0.6b_bf16"
            rec = write_bundle(model, bf16_bundle, False)
            log(f"restart 0.6B BF16 ({CARD}): bundle {rec['gb']:.3f} GB written in {rec['write_s']:.1f} s")
        elif quant == "Q8_0":
            phase("quantize a BF16 bundle on the card")
            quantize_on_card_phase(params, bf16_bundle, report)
        if mode != "none":
            t0 = time.perf_counter()
            model.warmup(chunk_sizes=(8, 12), first_chunk_size=FIRST_CHUNK)
            warmup_s = time.perf_counter() - t0
            _reset_launches()
            with tapped_steps({}) as steps, no_eager_frames(f"slice 0.6B {quant}"), \
                    no_eager_prefills(f"slice 0.6B {quant}"):
                req, _ = run_request(model, seed=1)
            counted = _read_launches()
            per_step = {k: steps[k] / max(1, steps["steps"]) for k in ("K1", "K2", "K4")}
            if mode != "int8":
                launches = {k: launches[k] + counted[k] for k in launches}
            log(f"slice 0.6B {quant}: warmup {warmup_s:.1f} s; {req['frames']} frames, TTFA {req['ttfa_ms']:.1f} ms "
                f"(eager prefill: Q8_0 134-172, Q4_K_M 232-298 ms), "
                f"stream RTF {req['stream_rtf']:.3f}; launches {counted}, per decode step (of {steps['steps']}) "
                f"K1 {per_step['K1']:.1f}, K2 {per_step['K2']:.1f}, K4 {per_step['K4']:.1f} (expected "
                f"{K4_EXPECTED[quant]}); peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
            need = {"int8": ("K1", "K2"), "int4": ("K1", "K4"), "mixed": ("K1", "K2", "K4")}[mode]
            if any(counted[k] == 0 for k in need):
                fail(f"the 0.6B {quant} stream did not go through its kernels {need}: {counted}")
            if mode != "int8":  # the Q8_0 slice's own profile is phase 7's
                frame_profile(model, f"0.6B {quant} x-vector", report, need=need)
            if mode == "int4":
                graphs_phase(model, f"0.6B {quant}", report, modes=("greedy",))
                prefill_graphs_phase(model, f"0.6B {quant}", report)
            row = {"materialize_s": materialize_s, "warmup_s": warmup_s, "warmup_phases": model.warmup_phases,
                   "request": req, "launches": counted,
                   "decode_steps": steps["steps"], "launches_per_step": per_step, "card_gb": card_gb,
                   "projection_gb": proj_gb, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
            if mode == "mixed":
                phase("restart 0.6B Q8_4 from a deploy bundle")
                launches = {k: launches[k] + n for k, n in mixed_bundle_phase(model, report).items()}
                _, tok_eng = run_request(model, seed=3, greedy=True, frames=16)
                par, tok_par = run_request(model, seed=3, greedy=True, frames=16, voice_clone_prompt=voice,
                                           parity_mode=True)
                row["parity"] = dict(_agreement(tok_eng, tok_par), wall_s=par["wall_s"])
                log(f"slice 0.6B {quant} parity_mode (f32 eager) against the engine (bf16), greedy: "
                    f"{row['parity']['equal_frames']}/{row['parity']['frames']} frames equal, "
                    f"{row['parity']['equal_codebook0']} codebook-0 tokens equal, first difference (frame, "
                    f"codebook) {row['parity']['first_difference']}; 16 frames in {par['wall_s']:.1f} s")
            rows[quant] = row
            if mode == "int8":
                phase("native on the 0.6B Q8_0 params")
                launches = {k: launches[k] + n for k, n in native_phase(model, report).items()}
            if quant in FUSED_EXPECTED:
                phase(f"fused 0.6B {quant}")
                launches = {k: launches[k] + n for k, n in fused_phase(model, quant, report).items()}
        if quant in ("F32", "Q8_0", "Q8_4"):
            phase(f"mesh 2x2 0.6B {quant}")
            launches = {k: launches[k] + n for k, n in mesh_phase(params, model, quant, report).items()}
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


# K2 / K4 launches a fused 0.6B decode step should make: 28 talker and 75
# predictor layer passes of 4 projections, 15 lm_heads, 15 mtp_proj, codec_head
FUSED_EXPECTED = {"Q8_0": {"K2": 443, "K4": 0}, "Q4_K_M": {"K2": 0, "K4": 443}}
FUSED_ATOL = FUSED_RTOL = 2e-2  # bf16: K2 / K4 split the longer fused rows differently, so sums run in another order
FUSED_MIN_COSINE = 0.999  # full depth: a wrong fusion (columns swapped or misplaced) decorrelates the logits


def _greedy_session(model, params):
    """A greedy session of the x-vector prompt of seed 0 on `params`, prefilled."""
    from faster_qwen3_tts_tpu_torch.engine import generate as gen_lib
    from faster_qwen3_tts_tpu_torch.ops.sampling import SamplingParams

    tie, tam, tth, tpe, _ = model._prepare_generation(TEXT, language="English", voice_clone_prompt=_xvec_prompt(0))
    sess = gen_lib.GenerationSession(params, model.config, tie, tam, tth, tpe, model.max_seq_len,
                                     SamplingParams(do_sample=False), gen_lib.predictor_sampling(False), 2, seed=0)
    sess.prefill()
    return sess


def fused_phase(model, quant, report):
    """The fused projection layout at full width: `quant.fuse_layer_weights`
    of the model's tree (loaded from no disk; the fused tree shares every
    other leaf) as a second model in the same process, with graph sets of its
    own. Fused replays against fused eager (graphs_phase: bitwise, greedy and
    sampled, and its 32-replay profile); fused against unfused: layer 0's
    fused products on a prompt's rows and on one row (within 2e-2), the
    prefill's logits and hidden state (cosine >= 0.999; the max abs diff
    printed beside the floor of two unfused prefills at 1 and 2 rows), the
    first frame's, and the frame where one prompt's greedy tokens part; K2 / K4
    launches a frame, us a launch, kernel ms a frame and frame ms beside the
    unfused model's figures of this run; then `warmup` and three solo streams
    (TTFA, RTF, launches a decode step), with no eager frame or prefill.
    -> launches of the streams."""
    import torch

    from faster_qwen3_tts_tpu_torch.engine import core, graphs
    from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS
    from faster_qwen3_tts_tpu_torch.models import talker as talker_lib
    from faster_qwen3_tts_tpu_torch.models.layers import rms_norm, unstack_layers
    from faster_qwen3_tts_tpu_torch.ops import quant as quant_ops
    from faster_qwen3_tts_tpu_torch.ops.sampling import SamplingParams

    name = f"0.6B {quant} fused"
    cfg = model.config
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    fparams = quant_ops.fuse_layer_weights(model.params)
    torch.cuda.synchronize()
    fuse_s = time.perf_counter() - t0
    fused_gb = (torch.cuda.memory_allocated() - before) / 1e9
    fmodel = FasterQwen3TTS(fparams, model.config, model.tokenizer)
    if graphs.registry_for(fparams) is graphs.registry_for(model.params):
        fail(f"{name}: the fused tree shares the unfused tree's graph registry")
    row = {"card": CARD, "fuse_s": fuse_s, "fused_leaves_gb": fused_gb}
    # fused against unfused on one greedy prompt: the prefill, the first frame, then 31 more (replays)
    sess = {k: _greedy_session(model, p) for k, p in (("plain", model.params), ("fused", fparams))}
    try:
        got = {k: {"prefill logits": s.graphs.logits.float().clone(),
                   "prefill hidden": s.state.past_hidden.float().clone()} for k, s in sess.items()}
        first = {}
        for k, s in sess.items():
            first[k] = s.decode_chunk_async(1).clone()
            got[k]["frame 1 hidden"] = s.state.past_hidden.float().clone()
            got[k]["frame 1 logits"] = talker_lib.codec_logits(s.params["talker"], s.state.past_hidden[:, 0, :])
        toks = {k: torch.cat([first[k], s.decode_chunk_async(GRAPH_FRAMES - 1)])[:, 0, :16] for k, s in sess.items()}
        tie, mask = sess["plain"].tie, sess["plain"].mask
    finally:
        for s in sess.values():
            s.close()
    parted = (toks["plain"] != toks["fused"]).any(dim=-1).nonzero()
    first_part = int(parted[0]) if parted.numel() else None
    # The fused products themselves, held at the kernels' tolerance: layer 0's wqkv and w_gateup
    # against the unfused projections on the prompt's normed rows (the many-row product) and on its
    # last row (K2 / K4). Through 28 bf16 layers, sums in another order part further; the full-depth
    # difference is held by cosine and printed beside the same-run floor of two unfused prefills that
    # differ only in row count (the prompt alone, and twice in one batch).
    lf, lu = (unstack_layers(p["talker"]["layers"])[0] for p in (fparams, model.params))
    h = rms_norm(lu["ln1"], tie, cfg.talker.rms_norm_eps)
    products = {}
    for rows, x in (("prompt rows", h), ("one row", h[:, -1:])):
        for fk, parts in (("wqkv", ("wq", "wk", "wv")), ("w_gateup", ("w_gate", "w_up"))):
            products[f"{fk}, {rows}"] = (quant_ops.dot(x, lf[fk]).float(),
                                         torch.cat([quant_ops.dot(x, lu[k]) for k in parts], dim=-1).float())
    for w, (a, b) in products.items():
        bad = ((a - b).abs() > FUSED_ATOL + FUSED_RTOL * b.abs()).sum().item()
        if bad or not torch.isfinite(a).all():
            fail(f"fused {name}: layer 0's {w} product differs from unfused beyond the tolerance ({bad} elements)")
    greedy = SamplingParams(do_sample=False)
    _, l1 = core.start_state(model.params["talker"], cfg.talker, tie, mask, None, model.max_seq_len, greedy, 2)
    _, l2 = core.start_state(model.params["talker"], cfg.talker, tie.expand(2, -1, -1).contiguous(),
                             mask.expand(2, -1).contiguous(), None, model.max_seq_len, greedy, 2)
    floor = float((l2[0].float() - l1[0].float()).abs().max())
    row["max_abs_diff"] = {w: float((a - b).abs().max()) for w, (a, b) in products.items()}
    row["max_abs_diff"].update({w: float((got["fused"][w] - got["plain"][w]).abs().max()) for w in got["plain"]})
    cos = {w: float(torch.nn.functional.cosine_similarity(got["fused"][w].flatten(), got["plain"][w].flatten(),
                                                          dim=0)) for w in ("prefill logits", "prefill hidden")}
    row.update(tolerance={"atol": FUSED_ATOL, "rtol": FUSED_RTOL}, cosine=cos, unfused_row_count_floor=floor,
               first_parting_frame=first_part, frames_compared=GRAPH_FRAMES)
    log(f"fused {name} ({CARD}): fuse_layer_weights {fuse_s * 1e3:.1f} ms, {fused_gb:.3f} GB of fused leaves beside "
        f"the unfused tree; against unfused, max abs diff "
        + ", ".join(f"{w} {v:.3e}" for w, v in row["max_abs_diff"].items())
        + f" (layer 0's products held at atol {FUSED_ATOL} + rtol {FUSED_RTOL} x |unfused|); prefill cosine "
        + ", ".join(f"{w} {v:.6f}" for w, v in cos.items())
        + f" (held at {FUSED_MIN_COSINE}); unfused prefill logits at 1 against 2 rows of a batch differ by "
        f"{floor:.3e}; greedy tokens (one prompt) part at frame {first_part} of {GRAPH_FRAMES} (None: never)")
    if min(cos.values()) < FUSED_MIN_COSINE:
        fail(f"fused {name}: the prefill differs from unfused (cosine {cos})")
    # replays against eager, and the profile of 32 replays, beside the unfused set's of this run
    g = graphs_phase(fmodel, name, report)
    base = report.get("graphs", {}).get(f"0.6B {quant}")
    kern = "K2" if quant == "Q8_0" else "K4"
    prof, bprof = g["profile"], base["profile"] if base else None
    row["profile"] = {"frame_ms": g["frame_ms"], "kernel_ms_per_frame": prof["device_ms_per_frame"],
                      f"{kern}_launches_per_frame": prof[kern]["launches_per_frame"],
                      f"{kern}_us_per_launch": prof[kern]["us_per_launch"],
                      f"{kern}_ms_per_frame": prof[kern]["ms_per_frame"]}
    if bprof:
        row["unfused_profile"] = {"frame_ms": base["frame_ms"], "kernel_ms_per_frame": bprof["device_ms_per_frame"],
                                  f"{kern}_launches_per_frame": bprof[kern]["launches_per_frame"],
                                  f"{kern}_us_per_launch": bprof[kern]["us_per_launch"],
                                  f"{kern}_ms_per_frame": bprof[kern]["ms_per_frame"]}
        log(f"fused {name} against unfused, 32 frame replays ({CARD}): {kern} "
            f"{prof[kern]['launches_per_frame']:.0f} launches a frame (unfused {bprof[kern]['launches_per_frame']:.0f}), "
            f"{prof[kern]['us_per_launch']:.2f} us a launch (unfused {bprof[kern]['us_per_launch']:.2f}), "
            f"{prof[kern]['ms_per_frame']:.3f} ms a frame (unfused {bprof[kern]['ms_per_frame']:.3f}); kernels "
            f"{prof['device_ms_per_frame']:.3f} ms a frame (unfused {bprof['device_ms_per_frame']:.3f}); captured "
            f"frame {g['frame_ms']:.3f} ms (unfused {base['frame_ms']:.3f})")
    # served: warmup, then three solo streams
    t0 = time.perf_counter()
    fmodel.warmup(chunk_sizes=(8, 12), first_chunk_size=FIRST_CHUNK)
    row["warmup_s"] = time.perf_counter() - t0
    _reset_launches()
    reqs = []
    with tapped_steps({}) as steps, no_eager_frames(name), no_eager_prefills(name):
        for i in range(3):
            req, _ = run_request(fmodel, seed=i + 1)
            reqs.append(req)
    counted = _read_launches()
    per_step = {k: steps[k] / max(1, steps["steps"]) for k in ("K1", "K2", "K4")}
    if counted[kern] == 0 or counted["K1"] == 0:
        fail(f"{name}: the streams did not launch K1 and {kern}: {counted}")
    regs = {k: graphs.registry_for(p).memory() for k, p in (("unfused", model.params), ("fused", fparams))}
    mem = {k: {"static_gb": v["static_bytes"] / 1e9,
               "pool_gb": None if v["pool_bytes"] is None else v["pool_bytes"] / 1e9} for k, v in regs.items()}
    row.update(requests=reqs, launches=counted, launches_per_step=per_step, expected_per_step=FUSED_EXPECTED[quant],
               graph_memory=mem, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"fused {name} ({CARD}): warmup {row['warmup_s']:.1f} s; 3 streams: TTFA "
        + ", ".join(f"{r['ttfa_ms']:.1f}" for r in reqs) + " ms, RTF "
        + ", ".join(f"{r['stream_rtf']:.3f}" for r in reqs)
        + f"; launches a decode step (of {steps['steps']}) K1 {per_step['K1']:.1f}, K2 {per_step['K2']:.1f}, K4 "
        f"{per_step['K4']:.1f} (expected {FUSED_EXPECTED[quant]}); no eager frame or prefill; graph memory "
        f"unfused {mem['unfused']}, fused {mem['fused']} (GB); peak device memory {row['peak_mem_gb']:.2f} GB")
    report.setdefault("fused", {})[name] = row
    del fmodel, fparams
    return counted


def native_phase(model, report):
    """The native backend's host side on the card's machine: the host
    library must load (a missing library fails the run; no fallback hides
    it); native against numpy resampling and PCM, a ring-buffer round trip;
    `NativeQwen3TTS` over the model's params (its graph sets): a reference
    extracted once (miss) and again (hit), a greedy stream from the `.spk`
    file equal bit for bit to one from a `voice_clone_prompt` of the same
    x-vector, no eager frame or prefill; `from_pretrained(<tiny dir>,
    backend="native")` once. -> launches of the streams."""
    import shutil

    import numpy as np

    from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS
    from faster_qwen3_tts_tpu_torch.native_backend import NativeQwen3TTS
    from faster_qwen3_tts_tpu_torch.utils import audio as audio_lib
    from faster_qwen3_tts_tpu_torch.utils import native

    t0 = time.perf_counter()
    if not native.available():
        fail(f"native: the host library did not load on the card's machine: {native.build_error}")
    row = {"card": CARD, "library": native.library_path().name, "load_s": time.perf_counter() - t0}
    rng = np.random.default_rng(5)
    x = np.convolve(rng.standard_normal(48000).astype(np.float32) * 0.3, np.ones(8) / 8, mode="same")
    x = x.astype(np.float32)
    y, y_np = native.resample(x, 16000, 24000), audio_lib.resample(x, 16000, 24000)
    n = min(len(y), len(y_np)) - 100
    row["resample_mean_abs_diff"] = float(np.abs(y[50:n] - y_np[50:n]).mean())
    pcm = np.frombuffer(native.float_to_pcm16(x), "<i2").astype(np.int32)
    row["pcm16_max_lsb_diff"] = int(np.abs(pcm - np.frombuffer(audio_lib.float_to_pcm16(x), "<i2")).max())
    ring = native.RingBuffer(4096)
    wrote = ring.write(x[:3000])
    back = ring.read(3000)
    row["ring_round_trip_equal"] = bool(wrote == 3000 and np.array_equal(back, x[:3000]) and ring.available() == 0)
    if row["resample_mean_abs_diff"] >= 0.01 or row["pcm16_max_lsb_diff"] > 1 or not row["ring_round_trip_equal"]:
        fail(f"native: the host library disagrees with numpy: {row}")
    cache = REPO / "build" / "chip_smoke_refs"
    shutil.rmtree(cache, ignore_errors=True)
    nm = NativeQwen3TTS(model.params, model.config, model.tokenizer, voice_ref_cache_dir=cache)
    ref = REPO / "build" / "chip_smoke_ref_4s.wav"
    xv, codes, miss = nm.extract_voice_ref(ref)
    _, _, hit = nm.extract_voice_ref(ref)
    if (miss["cache"], hit["cache"]) != ("miss", "hit") or codes is None:
        fail(f"native: extraction {miss}, then {hit}")
    spk = cache / "voice.spk"
    xv.tofile(spk)
    nm.warmup(chunk_sizes=(CHUNK,), first_chunk_size=FIRST_CHUNK, do_sample=False, subtalker_dosample=False)
    _reset_launches()
    with no_eager_frames("native"), no_eager_prefills("native"):
        by_file, tok_file = run_request(nm, seed=3, greedy=True, frames=24, ref_spk=spk, xvec_only=True)
        by_prompt, tok_prompt = run_request(nm, seed=3, greedy=True, frames=24,
                                            voice_clone_prompt={"ref_spk_embedding": [xv]})
    launches = _read_launches()
    same = tok_file.shape == tok_prompt.shape and bool((tok_file == tok_prompt).all())
    if not same:
        fail("native: a stream from ref_spk differs from one from voice_clone_prompt with the same x-vector")
    t0 = time.perf_counter()
    tiny = FasterQwen3TTS.from_pretrained(str(REPO / "build" / "chip_smoke_tiny"), device="cuda", backend="native",
                                          voice_ref_cache_dir=cache / "tiny")
    (wav,), sr = tiny.generate_voice_clone("Hello from the native backend.", "English", ref_spk_emb=xv,
                                           xvec_only=True, max_new_tokens=8, seed=0)
    tiny_s = time.perf_counter() - t0
    if not isinstance(tiny, NativeQwen3TTS) or sr != 24000 or not wav.size or not np.isfinite(wav).all():
        fail(f"native: from_pretrained(backend='native') gave {type(tiny).__name__}, {wav.size} samples at {sr}")
    row.update(extract_miss_ms=miss["prepare_ms"], extract_hit_ms=hit["prepare_ms"], ref_spk_equals_prompt=same,
               frames=int(tok_file.shape[0]), ttfa_ms=[by_file["ttfa_ms"], by_prompt["ttfa_ms"]],
               stream_rtf=[by_file["stream_rtf"], by_prompt["stream_rtf"]], launches=launches,
               tiny_from_pretrained_s=tiny_s)
    log(f"native ({CARD}): host library {row['library']} loaded in {row['load_s']:.2f} s (built from the port's "
        f"csrc/fq3t.cpp); resample against numpy mean abs diff {row['resample_mean_abs_diff']:.2e}, PCM16 within "
        f"{row['pcm16_max_lsb_diff']} LSB, ring buffer round trip {row['ring_round_trip_equal']}; reference "
        f"extracted in {miss['prepare_ms']:.1f} ms (miss), {hit['prepare_ms']:.2f} ms (hit); a ref_spk stream equals "
        f"the voice_clone_prompt stream bit for bit ({row['frames']} greedy frames; TTFA {by_file['ttfa_ms']:.1f} / "
        f"{by_prompt['ttfa_ms']:.1f} ms, no eager frame or prefill); launches {launches}; "
        f"from_pretrained(tiny, backend='native') and one request in {tiny_s:.1f} s")
    report["native"] = row
    del tiny, nm
    return launches


def examples_phase(report):
    """Each script of examples_torch/ on the card, as a subprocess, at the
    tiny geometry, in three chains run side by side (each chain in order):
    extract_speaker to .npy then generate_with_embedding from it; the same
    with the .spk file; streaming_playback through the native backend's
    cache twice (extracted, then read from the cache)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from faster_qwen3_tts_tpu_torch.utils import audio as audio_lib

    ex, build, tiny = REPO / "examples_torch", REPO / "build" / "chip_smoke_examples", REPO / "build" / "chip_smoke_tiny"
    build.mkdir(parents=True, exist_ok=True)
    ref = REPO / "build" / "chip_smoke_ref_4s.wav"
    model = ["--model", str(tiny), "--device", "cuda"]
    chains = [
        [("extract_speaker.py", [str(ref), str(build / f"spk.{ext}"), *flag, *model]),
         ("generate_with_embedding.py", [str(build / f"spk.{ext}"), "Hello from a saved voice.", "-o",
                                         str(build / f"{ext}.wav"), "--max-new-tokens", "8", *model])]
        for ext, flag in (("npy", []), ("spk", ["--spk"]))
    ] + [[("streaming_playback.py", ["Hello there.", "--ref-audio", str(ref), "--ref-text", REF_TEXT,
                                     "--ref-cache-dir", str(build / "refs"), "--max-new-tokens", "8",
                                     "--out", str(build / "streamed.wav"), *model])] * 2]

    def run(chain):
        rows = []
        for script, argv in chain:
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, str(ex / script), *argv], cwd=REPO, capture_output=True,
                                  text=True, timeout=300)
            rows.append({"script": script, "rc": proc.returncode, "wall_s": time.perf_counter() - t0,
                         "stdout": [ln for ln in proc.stdout.splitlines() if ln.strip()],
                         "stderr": proc.stderr[-3000:]})
            if proc.returncode != 0:
                break
        return rows

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(chains)) as pool:
        rows = [r for chain_rows in pool.map(run, chains) for r in chain_rows]
    wall = time.perf_counter() - t0
    for r in rows:
        if r["rc"] != 0:
            fail(f"examples: {r['script']} rc {r['rc']}\n{' | '.join(r['stdout'])[-2000:]}\n{r['stderr']}")
        log(f"examples ({CARD}): {r['script']} rc 0 in {r['wall_s']:.1f} s: {' | '.join(r['stdout'])}")
    for wav in ("npy.wav", "spk.wav", "streamed.wav"):
        audio, sr = audio_lib.read_wav(build / wav)
        if sr != 24000 or not audio.size or not np.isfinite(audio).all():
            fail(f"examples: {wav} holds {audio.size} samples at {sr} Hz")
    if "cache hit" not in " ".join(rows[-1]["stdout"]):
        fail(f"examples: the second streaming_playback run did not read the cache: {rows[-1]['stdout']}")
    log(f"examples: {len(rows)} runs in three chains side by side in {wall:.1f} s")
    report["examples"] = {"runs": [{k: r[k] for k in ("script", "wall_s", "stdout")} for r in rows], "wall_s": wall}


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
    weights_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    model.warmup(chunk_sizes=(8, 12), first_chunk_size=FIRST_CHUNK)
    warmup_s = time.perf_counter() - t0
    log(f"slice 1.7B Q8_0 ({CARD}): loaded in {load_s:.1f} s ({weights_gb:.2f} GB on the card), warmup "
        f"{warmup_s:.1f} s ({model.warmup_phases})")
    phase("device init 1.7B Q8_0")
    device_init = device_init_phase(model, load_s, report)
    design = FasterQwen3TTS(model.params, get_config("1.7b-design"), model.tokenizer)
    base = FasterQwen3TTS(model.params, get_config("1.7b"), model.tokenizer)
    prefill_graphs_phase(model, "1.7B Q8_0", report)
    prompt_builders_phase("1.7B Q8_0", report, [
        ("CustomVoice", model, "_prepare_generation_custom", (TEXT, "English", "aiden"),
         dict(non_streaming_mode=False)),
        ("VoiceDesign", design, "_prepare_generation_custom", (TEXT, "English", None),
         dict(instruct=DESIGN, non_streaming_mode=False))])
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
            sess.close()  # its graph set goes back for the requests below
            times.append(sess.prefill_ms)
        prefills[name] = {"rows": int(prompt[0].shape[1]), "ms": statistics.median(times)}
        log(f"slice 1.7B prefill, {name}: {prompt[0].shape[1]} rows, {prefills[name]['ms']:.1f} ms (a replay of "
            f"the bucket's graph; eager: 47-86 ms)")
    cv, vd = "generate_custom_voice", "generate_voice_design"
    streams = [("CustomVoice aiden/English", model, cv, (TEXT, "aiden", "English"), 31),
               ("CustomVoice dylan/Chinese", model, cv, (TEXT, "dylan", "Chinese"), 32),
               ("VoiceDesign", design, vd, (TEXT, DESIGN, "English"), 33),
               ("Base x-vector", base, "generate_voice_clone", (TEXT, "English"), 35)]
    non_streaming = [("CustomVoice aiden/English", model, cv, (TEXT, "aiden", "English"), 36),
                     ("VoiceDesign", design, vd, (TEXT, DESIGN, "English"), 37)]
    _reset_launches()
    requests = []
    with no_eager_frames("slice 1.7B requests"), no_eager_prefills("slice 1.7B requests"):
        for name, m, method, args, seed in streams:
            req, _ = run_request(m, seed, method=f"{method}_streaming", args=args)
            req["name"] = name
            requests.append(req)
            log(f"slice 1.7B {name} ({CARD}): {req['frames']} frames, TTFA {req['ttfa_ms']:.1f} ms (eager prefill: "
                f"123-175 ms), "
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
    demo = demo_17b_phase(model, design, report)
    launches = {k: launches[k] + demo[k] + device_init[k] for k in launches}
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
    report["slice_1.7B_Q8_0"] = {"load_s": load_s, "warmup_s": warmup_s, "warmup_phases": model.warmup_phases,
                                 "weights_gb": weights_gb,
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
    the prompts were built), in rec["logits0"] lane 0's prefill logits and
    in rec["logits"] each graph set's (one a dp group under a mesh)."""
    from faster_qwen3_tts_tpu_torch.engine import generate as gen_lib
    from faster_qwen3_tts_tpu_torch.engine import graphs

    real, set_prefill = gen_lib.fast_generate_streaming_batch, graphs.GraphSet.prefill
    rec.update(lanes={}, steps=0)

    def prefill(gset, *a, **k):  # on the card a replay: the set keeps the logits
        set_prefill(gset, *a, **k)
        rec.setdefault("logits0", gset.logits[0].float().clone())  # read after the run
        rec.setdefault("logits", []).append(gset.logits.float().clone())

    def recording(*a, **k):
        rec["start"] = _read_launches()
        for item in real(*a, **k):
            frames, valid = item[0], item[1]
            for s in range(frames.shape[1]):
                rec["lanes"].setdefault(s, []).append(frames[valid[:, s], s])
            rec["steps"] += frames.shape[0]
            yield item

    gen_lib.fast_generate_streaming_batch, graphs.GraphSet.prefill = recording, prefill
    try:
        yield rec
    finally:
        gen_lib.fast_generate_streaming_batch, graphs.GraphSet.prefill = real, set_prefill


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
    `generate_voice_clone_streaming_batch` -> (record, lane tokens). No EOS
    before BATCH_FRAMES frames (one min_new_tokens, so one graph key a batch
    size, warmed by `slice_batch_phase`)."""
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
                min_new_tokens=BATCH_FRAMES, seed=1, **kw):
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
    return {"logits0": rec["logits0"].cpu(), "logits": torch.cat(rec["logits"]).cpu(), "B": B,
            "frames_per_lane": [int(t.shape[0]) for t in tokens],
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
    reqs[5] = dict(reqs[5], text="word " * 400)  # 801 BPE ids (2000 bytes): over the pool's bucket of 256
    reqs += [{"text": BATCH_TEXTS[i], "ref_audio": str(long_ref), "ref_text": REF_TEXT} for i in range(4)]
    cancel_sid, bad_sid = 2, 5
    t0 = time.perf_counter()
    model.warmup(chunk_sizes=(CHUNK,), first_chunk_size=FIRST_CHUNK, pool_slots=8)  # the pool's graphs, as `server.py --warmup` captures them
    pool_warm_s = time.perf_counter() - t0
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
    with shape_tally({}) as tally, no_eager_frames("continuous"), no_eager_prefills("continuous"):
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
    row = {"card": CARD, "pool_warmup_s": pool_warm_s, "requests": len(reqs), "wall_s": wall,
           "audio_s": sum(samples.values()) / 24000,
           "aggregate_rtf": sum(samples.values()) / 24000 / wall, "ttfa_from_submit_ms": first,
           "ttfa_p50_ms": statistics.median(ttfa), "ttfa_max_ms": max(ttfa), "launches": launches,
           "shapes": tally, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "base_mem_gb": base_mem / 1e9, "after_mem_gb": after_mem / 1e9,
           "final_keys": {sid: sorted(t) for sid, t in finals.items() if sid in (0, cancel_sid, bad_sid)}}
    log(f"continuous 0.6B Q8_0 ({CARD}): pool graphs captured in {pool_warm_s:.1f} s; {len(reqs)} requests "
        f"every 150 ms, 8 slots: {row['audio_s']:.2f} s of audio "
        f"in {wall:.2f} s, aggregate RTF {row['aggregate_rtf']:.3f}; TTFA from submit p50 "
        f"{row['ttfa_p50_ms']:.1f} ms, max {row['ttfa_max_ms']:.1f} ms (eager prefill: p50 324-431 ms, max 1.76-1.89 s); "
        f"stream {cancel_sid} cancelled, "
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
    t0 = time.perf_counter()
    server.warm(model, continuous=8)  # what `--warmup` runs
    warm_s = time.perf_counter() - t0
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
    with no_eager_frames("serve"), no_eager_prefills("serve"):
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
    row = {"card": CARD, "warm_s": warm_s, "requests": out, "wall_s": wall, "base_mem_gb": base_gb,
           "peak_mem_gb": peak_gb,
           "bad_requests": bad, "aborted": aborted,
           "cancelled_streams": cancelled, "live_lanes_after": lanes, "health": health, "launches": launches}
    for r in out:
        log(f"serve ({CARD}): {r['voice']} {r['format']}: POST to first audio byte {r['first_audio_ms']:.1f} ms "
            f"(eager prefill: 1.04-1.16 s), "
            f"{r['audio_s']:.2f} s of audio in {r['ms'] / 1000:.2f} s")
    log(f"serve: server.warm {warm_s:.1f} s; 4 concurrent requests in {wall:.2f} s (no eager frame or prefill), "
        f"peak device "
        f"memory {peak_gb:.2f} GB (before "
        f"{base_gb:.2f} GB); launches {launches}; 400 for "
        f"{[r['error'] for r in bad]}; aborted client after {aborted['first_audio_ms']:.1f} ms -> "
        f"{cancelled} stream cancelled, {lanes} lanes live; health {health}")
    report["serve_0.6B_Q8_0"] = row
    return launches


# -- the browser demo server ---------------------------------------------------------------------


def _demo_server(models):
    """`demo_server.make_demo_server` over loaded models on a thread, its
    usage store under build/ -> (server, thread, port)."""
    import os

    from faster_qwen3_tts_tpu_torch import demo_server

    db = REPO / "build" / "demo_usage.sqlite3"
    for path in (db, Path(str(db) + ".hmac-key")):
        path.unlink(missing_ok=True)
    old = os.environ.get("USAGE_DB_PATH")
    os.environ["USAGE_DB_PATH"] = str(db)
    try:
        srv = demo_server.make_demo_server("127.0.0.1", 0, models=models, device="cuda")
    finally:
        if old is None:
            os.environ.pop("USAGE_DB_PATH")
        else:
            os.environ["USAGE_DB_PATH"] = old
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    return srv, th, srv.server_address[1]


def _demo_call(port, method, path, body=None, headers=None):
    """-> (status, headers, body bytes); a dict body goes as JSON."""
    import http.client

    hdrs = dict(headers or {})
    if isinstance(body, dict):
        body = json.dumps(body).encode()
        hdrs.setdefault("Content-Type", "application/json")
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request(method, path, body=body, headers=hdrs)
        resp = conn.getresponse()
        return resp.status, resp.headers, resp.read()
    finally:
        conn.close()


def _wav_pcm16(data: bytes, what: str):
    """A WAV's bytes -> its PCM16 samples; it must be mono 24 kHz 16-bit."""
    import io
    import wave

    import numpy as np

    with wave.open(io.BytesIO(data)) as w:
        if (w.getnchannels(), w.getsampwidth(), w.getframerate()) != (1, 2, 24000):
            fail(f"demo: {what} is not a mono 24 kHz PCM16 WAV ({w.getnchannels()} channels, "
                 f"{w.getsampwidth()} bytes, {w.getframerate()} Hz)")
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def demo_stream(port, body, headers=None, abort=False):
    """POST /generate/stream and read its SSE events -> a record: status,
    events, POST to first `chunk` event ms, total ms. abort: close the
    socket after the first chunk event."""
    import base64
    import http.client
    import socket

    rec = {"mode": body.get("mode", "clone"), "ttfa_ms": None, "first_chunk_ms": None}
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", "/generate/stream", body=json.dumps(body),
                 headers={"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    rec["status"] = resp.status
    if resp.status != 200:
        rec["error"] = json.loads(resp.read())["error"]
        conn.close()
        return rec
    events = []
    while True:
        line = resp.readline()
        if not line:
            break
        if not line.startswith(b"data: "):
            continue
        ev = json.loads(line[6:])
        events.append(ev)
        if ev["type"] == "chunk" and rec["first_chunk_ms"] is None:
            rec["first_chunk_ms"] = (time.perf_counter() - t0) * 1000.0
            rec["ttfa_ms"] = ev["ttfa_ms"]
            if abort:
                conn.sock.shutdown(socket.SHUT_RDWR)
                break
    conn.close()
    rec["ms"] = (time.perf_counter() - t0) * 1000.0
    rec["types"] = [ev["type"] for ev in events]
    rec["position"] = events[0].get("position") if events else None
    if abort:
        return rec
    chunks = [ev for ev in events if ev["type"] == "chunk"]
    samples = [_wav_pcm16(base64.b64decode(ev["wav_b64"]), f"chunk {ev['chunk_index']}").size for ev in chunks]
    done = events[-1] if events else {}
    if (not events or events[0]["type"] != "queued" or done.get("type") != "done" or not chunks
            or rec["types"] != ["queued"] + ["chunk"] * len(chunks) + ["done"]):
        fail(f"demo: {rec['mode']} stream events {rec['types']} ({done})")
    if [ev["chunk_index"] for ev in chunks] != list(range(len(chunks))):
        fail(f"demo: chunk_index runs {[ev['chunk_index'] for ev in chunks]}")
    if abs(sum(samples) / 24000 - done["audio_s"]) > 1e-9 or min(samples) == 0:
        fail(f"demo: audio_s {done['audio_s']} for chunks of {samples} samples")
    rec.update(chunks=len(chunks), samples=sum(samples), audio_s=done["audio_s"], rtf=done["rtf"],
               done_ttfa_ms=done["ttfa_ms"], usage=done["usage"])
    return rec


def demo_phase(model, report, long_ref):
    """The browser demo server (`demo_server.make_demo_server`) over the
    loaded 0.6B Q8_0 model, injected into its cache as ("0.6b", "Q8_0"):
    POST /load with warmup (a cache hit that captures nothing), the 4.0 s
    recording uploaded raw and as multipart (one ref_id), two concurrent
    SSE streams at chunk 8 (x-vector and ICL from the upload; no eager frame
    or prefill; one queued at position 1), one POST /generate, 400s for
    chunk_size 5 and 1001 characters, a client that leaves after its first
    chunk (the next request completes; no graph set stays leased), a login
    with a daily limit of 1 (200, then 429) and the web-only gate (403
    without the page token, 200 with it). -> launches during the requests."""
    import base64

    from faster_qwen3_tts_tpu_torch.engine import graphs
    from faster_qwen3_tts_tpu_torch.usage_db import UsageDB

    t_phase = time.perf_counter()
    srv, th, port = _demo_server({("0.6b", "Q8_0"): model})
    which = {"model": "0.6b", "quant": "Q8_0"}
    reg = graphs.registry_for(model.params)
    stats0 = dict(reg.stats)
    t0 = time.perf_counter()
    status, _, raw = _demo_call(port, "POST", "/load", dict(which, warmup=True))
    load_ms = (time.perf_counter() - t0) * 1000.0
    if status != 200 or json.loads(raw) != {"loaded": ["0.6b (Q8_0)"]}:
        fail(f"demo: /load answered {status} {raw[:200]!r}")
    recaptured = {k: reg.stats[k] - stats0[k] for k in ("captures", "prefill_captures")}
    if any(recaptured.values()):
        fail(f"demo: /load's warmup captured again what the slice had warmed: {recaptured}")

    data = long_ref.read_bytes()
    boundary = "fq3tChipSmokeBoundary"
    multipart = (f'--{boundary}\r\nContent-Disposition: form-data; name="file"; filename="ref.wav"\r\n'
                 f"Content-Type: audio/wav\r\n\r\n").encode() + data + f"\r\n--{boundary}--\r\n".encode()
    ids = [json.loads(_demo_call(port, "POST", "/upload_ref", body, {"Content-Type": ctype})[2]).get("ref_id")
           for body, ctype in ((data, "audio/wav"), (multipart, f"multipart/form-data; boundary={boundary}"))]
    if ids[0] is None or ids[0] != ids[1]:
        fail(f"demo: raw and multipart uploads gave ref_ids {ids}")
    rid = ids[0]

    bodies = [dict(which, text=BATCH_TEXTS[0], uploaded_ref=rid, xvec_only=True, chunk_size=CHUNK,
                   max_new_tokens=SERVE_FRAMES),
              dict(which, text=BATCH_TEXTS[1], uploaded_ref=rid, ref_text=REF_TEXT, chunk_size=CHUNK,
                   max_new_tokens=SERVE_FRAMES)]
    out = [None] * len(bodies)
    threads = [threading.Thread(target=lambda i: out.__setitem__(i, demo_stream(port, bodies[i])), args=(i,))
               for i in range(len(bodies))]
    _reset_launches()
    t0 = time.perf_counter()
    with no_eager_frames("demo"), no_eager_prefills("demo"):
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    streams_s = time.perf_counter() - t0
    launches = _read_launches()
    if any(r is None or r["status"] != 200 for r in out):
        fail(f"demo: concurrent streams answered {out}")
    for r, name in zip(out, ("x-vector", "ICL")):
        r["name"] = name
    if sorted(r["position"] for r in out) != [0, 1]:
        fail(f"demo: queued positions {[r['position'] for r in out]}, expected 0 and 1")
    if launches["K1"] == 0 or launches["K2"] == 0:
        fail(f"demo: the streams did not go through both kernels: {launches}")

    t0 = time.perf_counter()
    status, _, raw = _demo_call(port, "POST", "/generate", dict(which, text=TEXT, ref_audio=str(long_ref),
                                                                 xvec_only=True, max_new_tokens=24))
    generate_ms = (time.perf_counter() - t0) * 1000.0
    if status != 200 or json.loads(raw)["sample_rate"] != 24000:
        fail(f"demo: /generate answered {status} {raw[:200]!r}")
    generate_samples = _wav_pcm16(base64.b64decode(json.loads(raw)["wav_b64"]), "/generate").size

    bad = [demo_stream(port, dict(which, text="x", chunk_size=5)),
           demo_stream(port, dict(which, text="x" * 1001))]
    if [r["status"] for r in bad] != [400, 400]:
        fail(f"demo: bad requests answered {bad}")
    leases0 = reg.leased()
    aborted = demo_stream(port, dict(which, text=BATCH_TEXTS[2], uploaded_ref=rid, xvec_only=True,
                                     max_new_tokens=4 * SERVE_FRAMES), abort=True)
    follow = demo_stream(port, dict(which, text=BATCH_TEXTS[3], uploaded_ref=rid, xvec_only=True, max_new_tokens=16))
    leases = reg.leased()
    if aborted["status"] != 200 or aborted["first_chunk_ms"] is None or leases != leases0:
        fail(f"demo: the client that left: {aborted}; graph sets leased before {leases0}, after the next "
             f"request {leases}")

    short = dict(which, text=BATCH_TEXTS[4], uploaded_ref=rid, xvec_only=True, max_new_tokens=8)
    quota_db = REPO / "build" / "demo_usage_quota.sqlite3"
    quota_db.unlink(missing_ok=True)
    srv.usage_db = UsageDB(quota_db, hash_secret=b"chip smoke", daily_free_limit=1)
    srv.oauth_parser = lambda h: {"sub": "smoke-user", "username": "smoke", "is_pro": False}
    srv.require_login = True
    quota = [demo_stream(port, short), demo_stream(port, short)]
    srv.require_login, srv.oauth_parser = False, None
    if [r["status"] for r in quota] != [200, 429] or quota[0]["usage"]["remaining"] != 0:
        fail(f"demo: a daily limit of 1 answered {quota}")
    srv.web_only = True
    refused = demo_stream(port, short)
    _, _, page = _demo_call(port, "GET", "/")
    marker = b"window.__FQ3T_WEB_TOKEN__ = "
    start = page.index(marker) + len(marker)
    token = json.loads(page[start: page.index(b";", start)])
    admitted = demo_stream(port, short, headers={"x-fq3t-web-token": token})
    srv.web_only = False
    if (refused["status"], admitted["status"]) != (403, 200):
        fail(f"demo: web-only answered {refused['status']} without the token, {admitted['status']} with it")
    st = json.loads(_demo_call(port, "GET", "/status")[2])
    total = _read_launches()  # every request from the streams on
    srv.shutdown()
    srv.server_close()
    th.join(timeout=60)
    if st["queue_depth"] != 0 or st["loaded_models"] != ["0.6b (Q8_0)"]:
        fail(f"demo: status {st}")
    report["demo"] = {
        "card": CARD, "load_ms": load_ms, "recaptured": recaptured, "streams": out, "streams_s": streams_s,
        "generate_ms": generate_ms, "generate_samples": int(generate_samples),
        "bad": [r["status"] for r in bad], "aborted": aborted, "after_abort": follow,
        "leased_after_abort": leases, "quota": [r["status"] for r in quota],
        "web_only": [refused["status"], admitted["status"]], "launches": launches,
        "launches_all_requests": total, "phase_s": time.perf_counter() - t_phase}
    return total


def demo_17b_phase(custom, design, report):
    """A `mode: "custom"` and a `mode: "design"` SSE request through the demo
    server over the 1.7B model (no eager frame or prefill) -> their launches."""
    t_phase = time.perf_counter()
    srv, th, port = _demo_server({("1.7b-custom", "Q8_0"): custom, ("1.7b-design", "Q8_0"): design})
    bodies = [{"mode": "custom", "model": "1.7b-custom", "quant": "Q8_0", "text": TEXT, "speaker": "aiden",
               "language": "English", "chunk_size": CHUNK, "max_new_tokens": SERVE_FRAMES},
              {"mode": "design", "model": "1.7b-design", "quant": "Q8_0", "text": TEXT, "instruct": DESIGN,
               "language": "English", "chunk_size": CHUNK, "max_new_tokens": SERVE_FRAMES}]
    _reset_launches()
    with no_eager_frames("demo 1.7B"), no_eager_prefills("demo 1.7B"):
        out = [demo_stream(port, body) for body in bodies]
    launches = _read_launches()
    srv.shutdown()
    srv.server_close()
    th.join(timeout=60)
    if any(r["status"] != 200 for r in out) or launches["K1"] == 0 or launches["K2"] == 0:
        fail(f"demo 1.7B: {out}, launches {launches}")
    report.setdefault("demo", {})["1.7B"] = {"streams": out, "launches": launches,
                                            "phase_s": time.perf_counter() - t_phase}
    return launches


def demo_line(report):
    """The one `demo` line: POST to first chunk event beside the event's
    ttfa_ms, done RTF and queued position of each stream, /generate ms,
    the phases' seconds and K1 / K2 launches."""
    d = report["demo"]
    streams = [dict(r, name=r.get("name", f"1.7B {r['mode']}")) for r in d["streams"] + d["1.7B"]["streams"]]
    parts = [f"{r['name']}: POST to first chunk {r['first_chunk_ms']:.1f} ms (ttfa_ms {r['ttfa_ms']:.1f}), "
             f"done RTF {r['rtf']:.3f}, {r['audio_s']:.2f} s in {r['chunks']} chunks, queued at {r['position']}"
             for r in streams]
    log(f"demo ({CARD}): {'; '.join(parts)}; /load (warm, cache hit) {d['load_ms']:.1f} ms, captures "
        f"{d['recaptured']}; the two concurrent streams {d['streams_s']:.2f} s; /generate {d['generate_ms']:.1f} ms "
        f"({d['generate_samples']} samples); 400s {d['bad']}; a client that left after its first chunk "
        f"({d['aborted']['first_chunk_ms']:.1f} ms), the next request {d['after_abort']['ms']:.1f} ms, graph sets "
        f"leased {d['leased_after_abort']}; quota {d['quota']}; web-only {d['web_only']}; phase "
        f"{d['phase_s']:.1f} s + 1.7B {d['1.7B']['phase_s']:.1f} s; launches K1 / K2: 0.6B streams "
        f"{d['launches']['K1']} / {d['launches']['K2']}, 1.7B {d['1.7B']['launches']['K1']} / "
        f"{d['1.7B']['launches']['K2']}")


TOKENIZER_FIXTURES = REPO / "tests" / "torch_fixtures"
QWEN2_TOKENIZER = TOKENIZER_FIXTURES / "qwen2_tokenizer"  # vocab.json + merges.txt + a Qwen2Tokenizer config
TOKENIZER_REPS = 20  # timed encodes a text, each way


@contextlib.contextmanager
def logged_warnings():
    """The messages of the WARNING (and worse) records any logger logs inside the block."""
    import logging

    seen = []

    class Catch(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())

    handler = Catch(logging.WARNING)
    logging.getLogger().addHandler(handler)
    try:
        yield seen
    finally:
        logging.getLogger().removeHandler(handler)


def bpe_reader(tokenizer):
    """The port's BPE reader a `load_tokenizer` result wraps, else None."""
    from faster_qwen3_tts_tpu_torch.utils import bpe

    inner = getattr(tokenizer, "tok", None)
    return inner if isinstance(inner, bpe.BPETokenizer) else None


def tokenizer_phase(report):
    """For both committed fixture layouts, `load_tokenizer(dir)` must pick the
    BPE reader with no WARNING logged, and give the ids and decodes of every
    fixed text that `AutoTokenizer` wrote into
    tests/torch_fixtures/tokenizer_expected.json. Timed: three loads (the
    first in the process also builds the Unicode class tables) and each
    text's encode, with the reader's word cache cleared (cold) and not
    (warm), median of TOKENIZER_REPS."""
    from faster_qwen3_tts_tpu_torch.utils import bpe
    from faster_qwen3_tts_tpu_torch.utils.tokenizer import load_tokenizer

    expected = json.loads((TOKENIZER_FIXTURES / "tokenizer_expected.json").read_text())
    texts = expected["texts"]
    t_phase = time.perf_counter()
    row = {"fixtures": {}, "card": CARD}
    bpe.unicode_classes.cache_clear()
    bpe.split_regex.cache_clear()
    for name, want in expected["fixtures"].items():
        loads = []
        with logged_warnings() as warned:
            for _ in range(3):
                t0 = time.perf_counter()
                tok = load_tokenizer(str(REPO / want["path"]))
                loads.append((time.perf_counter() - t0) * 1000.0)
        reader = bpe_reader(tok)
        if reader is None or warned:
            fail(f"tokenizer {name}: load_tokenizer gave {tok!r} (reason {getattr(tok, 'fallback_reason', None)}), "
                 f"warnings {warned}")
        encode = []
        for text, ids, decoded in zip(texts, want["ids"], want["decoded"]):
            if tok.encode(text) != ids or tok.decode(ids) != decoded:
                fail(f"tokenizer {name}: {text!r} -> {tok.encode(text)} / {tok.decode(ids)!r}, AutoTokenizer gave "
                     f"{ids} / {decoded!r}")
            cold, warm = [], []
            for _ in range(TOKENIZER_REPS):
                reader._cache.clear()
                t0 = time.perf_counter()
                tok.encode(text)
                t1 = time.perf_counter()
                tok.encode(text)
                cold.append((t1 - t0) * 1e6)
                warm.append((time.perf_counter() - t1) * 1e6)
            encode.append({"chars": len(text), "ids": len(ids), "cold_us": statistics.median(cold),
                           "warm_us": statistics.median(warm)})
        main = encode[texts.index(TEXT)]
        first = "compiles the split pattern" + ("" if row["fixtures"] else " and builds the Unicode tables")
        log(f"tokenizer {name} ({CARD}): load_tokenizer picked the BPE reader ({reader!r}), no warning; load "
            f"{loads[0]:.2f} ms (the first: it {first}), then {loads[1]:.2f} / {loads[2]:.2f} ms; {len(texts)} texts: "
            f"ids and decodes equal to AutoTokenizer's; encode of the {main['chars']}-character text {main['cold_us']:.1f} us cold, "
            f"{main['warm_us']:.1f} us warm; cold us per text (chars): "
            + ", ".join(f"{e['cold_us']:.0f} ({e['chars']})" for e in encode))
        row["fixtures"][name] = {"layout": reader.layout, "load_ms": loads, "encode": encode}
    row["phase_s"] = time.perf_counter() - t_phase
    log(f"tokenizer ({CARD}): phase {row['phase_s']:.2f} s")
    report["tokenizer"] = row


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
    # capture the lockstep graphs (greedy, no EOS before BATCH_FRAMES) before the timed runs;
    # the B = 8 capture records K1 and K2 at the pool's shapes
    warm = dict(chunk_sizes=(CHUNK,), first_chunk_size=FIRST_CHUNK, do_sample=False, subtalker_dosample=False,
                min_new_tokens=BATCH_FRAMES)
    t0 = time.perf_counter()
    if sizes[:-1]:
        model.warmup(batch_sizes=sizes[:-1], **warm)
    with shape_tally({}) as b8:
        model.warmup(batch_sizes=(8,), **warm)
    log(f"lockstep {quant}: graphs of B = {sizes} captured in {time.perf_counter() - t0:.1f} s; B = 8 capture "
        f"by shape {b8}")
    if quant == "Q8_0":
        for i, r in enumerate(reqs):
            rec, toks = run_request(model, seed=1, greedy=True, frames=AGREE_FRAMES, args=(r["text"], "English"),
                                    voice_clone_prompt=r["voice_clone_prompt"], min_new_tokens=BATCH_FRAMES)
            solo[i] = (rec, toks)
        log(f"slice {quant} solo greedy streams: RTF " + ", ".join(f"{solo[i][0]['stream_rtf']:.3f}" for i in solo))
    for B in sizes:
        with shape_tally({}) as tally, no_eager_frames(f"lockstep {quant} B={B}"), \
                no_eager_prefills(f"lockstep {quant} B={B}"):
            rec, toks = lockstep_run(model, reqs[:B], BATCH_FRAMES)
        for k in total:
            total[k] += rec["launches"][k]
        rec["shapes"] = tally
        logits0 = rec.pop("logits0")
        rec.pop("logits")
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
        if set(b8.get("K1", {})) != {8} or not {8, 16} <= set(b8.get("K2", {})):
            fail(f"B=8: K1 not launched at 8 lanes or K2 not at 8 and 16 rows: {b8}")
        # lanes are independent: the same requests in reverse lane order get the same tokens
        _, rtoks = lockstep_run(model, reqs[::-1], AGREE_FRAMES)
        for i, t in enumerate(rtoks[::-1]):
            n = min(len(t), len(toks[i]))
            if n < AGREE_FRAMES or not (t[:n] == toks[i][:n]).all():
                fail(f"lockstep B=8 in reverse lane order: request {i} got other tokens ({_agreement(toks[i], t)})")
        log(f"lockstep {quant} B=8 in reverse lane order: every request's {AGREE_FRAMES} frames equal")
        with no_eager_frames("the profiled lockstep B=8 run"), no_eager_prefills("the profiled lockstep B=8 run"):
            batch_profile(model, reqs, report, f"0.6B B=8 {quant}")
    report[f"lockstep_{quant}"] = {"runs": rows, "solo": {i: solo[i][0] for i in solo}, "b8_capture_shapes": b8}
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
    parser.add_argument("--restart-from", type=Path, metavar="BUNDLE",
                        help="the restart phase's fresh process: load BUNDLE, warm up, stream once, print "
                             "one RESTART line (no ok line)")
    args = parser.parse_args()
    if not (REPO / "faster_qwen3_tts_tpu_torch" / "csrc").is_dir():
        fail("faster_qwen3_tts_tpu_torch/ is not beside chip_smoke.py: run it from the repository")
    sys.path.insert(0, str(REPO))
    if args.restart_from:
        restart_child(args.restart_from)
        return
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
    k1_cases, k2_cases, k4_cases, k5_cases, k6_cases, k7_cases = kernel_phase(report)
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
    phase("examples")
    examples_phase(report)
    phase("mesh refusals")
    mesh_refusals(tiny_dir)
    phase("tokenizer")
    tokenizer_phase(report)
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
    demo_line(report)
    jaxish = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.") or
                    m == "faster_qwen3_tts_tpu" or m.startswith("faster_qwen3_tts_tpu."))
    if jaxish:
        fail(f"the port loaded jax or the JAX package: {jaxish[:8]}")
    # launches of every slice path: 0.6B Q8_0 x-vector, Q8_0 ICL, Q8_0 lockstep
    # and continuous batches, the server's and the demo server's requests,
    # 0.6B Q4_K_M and Q8_4 x-vector, BF16 x-vector and lockstep batch, 1.7B
    # Q8_0 CustomVoice / VoiceDesign / Base and the demo's custom and design
    # streams, the tiny engine streams held against parity_mode; K3's probe
    paths = (q8, icl, q8_batch, q4, bf16, bf16_batch, q8_17b, parity_launches)
    total = {k: sum(p.get(k, 0) for p in paths) for k in KERNELS}
    total["K3"] = k3_launches
    if any(total[k] == 0 for k in ("K5", "K6", "K7")):
        fail(f"the slice paths did not launch the glue kernels K5-K7: {total}")

    def entry(name, source, replaces, cases, launches, pick):
        c = cases[pick]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": max(c["max_abs_err"] for c in cases),
                "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                "bound_by": c["bound_by"], "library_ms": c["library_ms"]}

    # ms: K1 at 133 live talker slots, K2 and K4 at the 1.7B gate/up (M = 1), K3 at 704 MB, K5 at one
    # 1.7B hidden row with its residual, K6 at one lane (split), K7 at one 1.7B row (split)
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
        entry("add_rms_norm", "faster_qwen3_tts_tpu_torch/csrc/glue.cu", "none (XLA fused this glue)", k5_cases,
              total["K5"], 1),
        entry("qk_norm_rope_kv", "faster_qwen3_tts_tpu_torch/csrc/glue.cu", "none (XLA fused this glue)",
              k6_cases, total["K6"], 0),
        entry("silu_mul", "faster_qwen3_tts_tpu_torch/csrc/glue.cu", "none (XLA fused this glue)", k7_cases,
              total["K7"], 2),
    ]}
    report["record"] = record
    write_report(args.report, report)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
