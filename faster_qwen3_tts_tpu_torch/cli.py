"""Command line of the port: clone | custom | design | serve | bundle.

The JAX package's CLI (`faster_qwen3_tts_tpu/cli.py`) over this port:

    python -m faster_qwen3_tts_tpu_torch.cli clone "Hello." --model <dir or id> \\
        --ref-audio ref.wav --ref-text "What the reference says." --streaming -o out.wav
    python -m faster_qwen3_tts_tpu_torch.cli custom "Hello." --speaker aiden --model <1.7B CustomVoice>
    python -m faster_qwen3_tts_tpu_torch.cli design "Hello." --instruct "A calm low voice." ...
    python -m faster_qwen3_tts_tpu_torch.cli serve --ref-audio ref.wav --xvec-only   # stdin REPL
    python -m faster_qwen3_tts_tpu_torch.cli bundle OUT_DIR --model <dir or id> --quant Q8_0

`--model` takes a deploy bundle, an own-format or HF checkpoint directory
(strict unless `--no-strict`) or a model id, which random-inits. `bundle`
writes the loaded model (at `--quant`) as a deploy bundle, float32 leaves
stored as bfloat16 unless `--full-f32`; `--model OUT_DIR` then restarts
from it. `--device` defaults to
`cuda`. `--streaming` drains the streaming generator into one wav and prints
the time to first audio and the RTF. `--backend native` loads
`NativeQwen3TTS` (the voice-reference disk cache in `--ref-cache-dir`);
`--backend jax`, the JAX package's default, selects this engine. `--fuse-qkv`
loads the fused projection layout. Not here: the JAX package's `--attn`
and `--aot-cache` (TPU machinery).
"""
from __future__ import annotations

import argparse
import logging
import pickle
import sys
import time
from pathlib import Path

import numpy as np

from .utils import audio as audio_lib

logger = logging.getLogger(__name__)


def _add_global_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model", default="Qwen/Qwen3-TTS-12Hz-0.6B-Base",
                   help="model id (random init), deploy bundle, own-format checkpoint dir, or HF checkpoint dir")
    p.add_argument("--quant", default="BF16",
                   help="BF16 (default), Q8_0 (int8), Q4_K_M (int4) or Q8_4 (talker int8, predictor int4)")
    p.add_argument("--dtype", default="bf16", choices=["bf16", "fp16", "fp32"])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--strict", action=argparse.BooleanOptionalAction, default=None,
                   help="HF checkpoint dirs: fail on any missing or mismatched tensor (the default) "
                        "or, with --no-strict, random-init them")
    p.add_argument("--backend", default="torch", choices=["torch", "native", "jax"],
                   help="'torch' = this engine ('jax' selects it too); 'native' adds the host library and "
                        "the voice-reference cache")
    p.add_argument("--ref-cache-dir", default=None, help="voice-reference cache dir (native backend)")
    p.add_argument("--fuse-qkv", action="store_true",
                   help="fused projection layout (wqkv, w_gateup): 4 projections a layer instead of 7")
    p.add_argument("--max-seq-len", type=int, default=2048)
    p.add_argument("--output", "-o", default="output.wav")
    p.add_argument("--streaming", action="store_true",
                   help="use the streaming generator (drained to one wav, TTFA and RTF printed)")
    p.add_argument("--chunk-size", type=int, default=8)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--max-new-tokens", type=int, default=2048)
    p.add_argument("--temperature", type=float, default=0.9)
    p.add_argument("--top-k", type=int, default=50)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--repetition-penalty", type=float, default=1.05)
    p.add_argument("--language", default="English")
    p.add_argument("--non-streaming-mode", dest="nsm", default=None, action="store_const", const=True,
                   help="prefill the full text before decode")


def _load_model(args):
    from .model import FasterQwen3TTS

    kwargs = {}
    if args.backend == "native" and args.ref_cache_dir:
        kwargs["voice_ref_cache_dir"] = args.ref_cache_dir
    if args.fuse_qkv:
        kwargs["fuse_qkv"] = True
    return FasterQwen3TTS.from_pretrained(
        args.model, device=args.device, dtype=args.dtype, quant=args.quant,
        max_seq_len=args.max_seq_len, strict=args.strict,
        backend=args.backend, **kwargs,
    )


def _gen_kwargs(args):
    return dict(max_new_tokens=args.max_new_tokens, temperature=args.temperature, top_k=args.top_k,
                top_p=args.top_p, repetition_penalty=args.repetition_penalty, seed=args.seed)


def _run_and_save(model, args, non_streaming_fn, streaming_fn) -> Path:
    """Run either path, write the wav, print TTFA (streaming) and RTF."""
    out = Path(args.output)
    t0 = time.perf_counter()
    if args.streaming:
        pieces, ttfa, sr = [], None, model.sample_rate
        for audio, sr, _timing in streaming_fn(chunk_size=args.chunk_size):
            if ttfa is None:
                ttfa = time.perf_counter() - t0
            pieces.append(audio)
        wav = np.concatenate(pieces) if pieces else np.zeros(1, np.float32)
        wall = time.perf_counter() - t0
        rtf = (len(wav) / sr) / wall if wall > 0 else 0.0
        print(f"TTFA {(ttfa or 0.0) * 1000:.0f} ms | {len(wav) / sr:.2f}s audio in {wall:.2f}s (RTF {rtf:.2f})")
    else:
        audio_list, sr = non_streaming_fn()
        wav = audio_list[0]
        wall = time.perf_counter() - t0
        rtf = (len(wav) / sr) / wall if wall > 0 else 0.0
        print(f"{len(wav) / sr:.2f}s audio in {wall:.2f}s (RTF {rtf:.2f})")
    audio_lib.write_wav(out, wav, sr)
    print(f"wrote {out}")
    return out


def cmd_clone(args) -> int:
    if not args.voice_clone_prompt and not args.ref_audio:
        print("error: clone requires --ref-audio (or a precomputed prompt)", file=sys.stderr)
        return 2
    if args.ref_audio and not args.xvec_only and not args.ref_text:
        print("error: ICL cloning requires --ref-text (or pass --xvec-only)", file=sys.stderr)
        return 2
    model = _load_model(args)
    common = dict(ref_audio=args.ref_audio, ref_text=args.ref_text or "", xvec_only=args.xvec_only,
                  non_streaming_mode=args.nsm, append_silence=args.append_silence,
                  instruct=args.instruct, **_gen_kwargs(args))
    if args.voice_clone_prompt:
        with open(args.voice_clone_prompt, "rb") as f:
            common["voice_clone_prompt"] = pickle.load(f)
        common["ref_audio"] = None
    _run_and_save(
        model, args,
        lambda: model.generate_voice_clone(args.text, args.language, **common),
        lambda chunk_size: model.generate_voice_clone_streaming(
            args.text, args.language, chunk_size=chunk_size, **common),
    )
    return 0


def cmd_custom(args) -> int:
    model = _load_model(args)
    if args.list_speakers:
        for s in model.get_supported_speakers():
            print(s)
        return 0
    if not args.speaker:
        print("error: custom requires --speaker (see --list-speakers)", file=sys.stderr)
        return 2
    kw = _gen_kwargs(args)
    _run_and_save(
        model, args,
        lambda: model.generate_custom_voice(
            args.text, speaker=args.speaker, language=args.language, instruct=args.instruct,
            non_streaming_mode=args.nsm, **kw),
        lambda chunk_size: model.generate_custom_voice_streaming(
            args.text, speaker=args.speaker, language=args.language, instruct=args.instruct,
            non_streaming_mode=args.nsm, chunk_size=chunk_size, **kw),
    )
    return 0


def cmd_design(args) -> int:
    model = _load_model(args)
    kw = _gen_kwargs(args)
    _run_and_save(
        model, args,
        lambda: model.generate_voice_design(
            args.text, instruct=args.instruct, language=args.language, non_streaming_mode=args.nsm, **kw),
        lambda chunk_size: model.generate_voice_design_streaming(
            args.text, instruct=args.instruct, language=args.language, non_streaming_mode=args.nsm,
            chunk_size=chunk_size, **kw),
    )
    return 0


def cmd_serve(args) -> int:
    """Warm-model stdin REPL: one line of text -> outdir/out_%04d.wav."""
    model = _load_model(args)
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    kw = _gen_kwargs(args)
    print("ready: type text, an empty line or EOF quits", file=sys.stderr)
    for idx, line in enumerate(sys.stdin):
        text = line.strip()
        if not text:
            break
        t0 = time.perf_counter()
        if args.mode == "custom":
            audio, sr = model.generate_custom_voice(text, speaker=args.speaker, language=args.language,
                                                    non_streaming_mode=args.nsm, **kw)
        elif args.mode == "design":
            audio, sr = model.generate_voice_design(text, instruct=args.instruct, language=args.language,
                                                    non_streaming_mode=args.nsm, **kw)
        else:
            audio, sr = model.generate_voice_clone(text, args.language, ref_audio=args.ref_audio,
                                                   ref_text=args.ref_text or "", xvec_only=args.xvec_only,
                                                   non_streaming_mode=args.nsm, **kw)
        wall = time.perf_counter() - t0
        path = outdir / f"out_{idx:04d}.wav"
        audio_lib.write_wav(path, audio[0], sr)
        rtf = (len(audio[0]) / sr) / wall if wall > 0 else 0.0
        print(f"{path}  ({len(audio[0]) / sr:.2f}s, RTF {rtf:.2f})")
    return 0


def cmd_bundle(args) -> int:
    """Write a deploy bundle from any loadable checkpoint or model id at
    `--quant`, so that a serving restart skips the name mapping and the
    quantization."""
    model = _load_model(args)
    model.save_deploy_bundle(args.out_dir, compact_f32=not args.full_f32)
    print(f"deploy bundle written to {args.out_dir} "
          f"(quant={args.quant}, restart via from_pretrained({args.out_dir!r}))")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="faster-qwen3-tts-torch",
                                 description="Qwen3-TTS inference on PyTorch / CUDA")
    sub = ap.add_subparsers(dest="command", required=True)

    pc = sub.add_parser("clone", help="voice cloning from reference audio")
    _add_global_flags(pc)
    pc.add_argument("text")
    pc.add_argument("--ref-audio")
    pc.add_argument("--ref-text")
    pc.add_argument("--xvec-only", action="store_true", help="x-vector-only cloning (no ICL acoustic prompt)")
    pc.add_argument("--no-append-silence", dest="append_silence", action="store_false")
    pc.add_argument("--instruct", default=None)
    pc.add_argument("--voice-clone-prompt", default=None, help="pickled precomputed prompt items")
    pc.set_defaults(func=cmd_clone)

    pu = sub.add_parser("custom", help="predefined CustomVoice speakers")
    _add_global_flags(pu)
    pu.add_argument("text", nargs="?", default="")
    pu.add_argument("--speaker")
    pu.add_argument("--instruct", default=None)
    pu.add_argument("--list-speakers", action="store_true")
    pu.set_defaults(func=cmd_custom)

    pd = sub.add_parser("design", help="instruction-conditioned VoiceDesign")
    _add_global_flags(pd)
    pd.add_argument("text")
    pd.add_argument("--instruct", required=True)
    pd.set_defaults(func=cmd_design)

    ps = sub.add_parser("serve", help="stdin REPL writing out_%%04d.wav")
    _add_global_flags(ps)
    ps.add_argument("--mode", default="clone", choices=["clone", "custom", "design"])
    ps.add_argument("--ref-audio")
    ps.add_argument("--ref-text")
    ps.add_argument("--xvec-only", action="store_true")
    ps.add_argument("--speaker")
    ps.add_argument("--instruct", default=None)
    ps.add_argument("--outdir", default="outputs")
    ps.set_defaults(func=cmd_serve)

    pb = sub.add_parser("bundle", help="write a deploy bundle (packed, optionally quantized weights): a restart "
                                       "is one read and one copy to the card a dtype")
    _add_global_flags(pb)
    pb.add_argument("out_dir", help="bundle directory to create")
    pb.add_argument("--full-f32", action="store_true",
                    help="keep float32 leaves at full width (default: stored as bf16 and upcast at load, exact "
                         "for bf16-sourced checkpoints)")
    pb.set_defaults(func=cmd_bundle)
    return ap


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
