"""FasterQwen3TTS on PyTorch: voice clone, CustomVoice and VoiceDesign,
streaming and not.

A subset of faster_qwen3_tts_tpu/model.py's public API over this port's
engine, with the JAX package's signatures: `from_pretrained` (an own-format
or upstream HF checkpoint directory, or seeded random init at a published
geometry, 0.6B or 1.7B; no download), `warmup`,
`create_voice_clone_prompt`, `generate_voice_clone[_streaming]` (Base
models: a voice from a reference recording, `ref_audio` + `ref_text` for ICL
mode or `xvec_only=True`, or from a precomputed `voice_clone_prompt`),
`generate_custom_voice[_streaming]` (CustomVoice models: a preset speaker,
`get_supported_speakers`) and `generate_voice_design[_streaming]`
(VoiceDesign models: the voice described by an instruction). CustomVoice and
VoiceDesign put the whole text into the prefill unless `non_streaming_mode`
is False. Many streams share one engine batch through
`generate_voice_clone_streaming_batch` (lockstep) and `continuous_batcher`
(`serving.ContinuousBatcher`: requests join a running pool). Weights load in
BF16 / F32, Q8_0 (int8), Q4_K_M (int4) or Q8_4 (talker int8, predictor
int4). `parity_mode=True` on the voice-clone methods runs the independent
eager decode of `engine/parity.py` instead of the engine. A streaming
request's prompt is assembled on the device (`PromptBuilder.build_device`,
behind `_device_prompt_ok`); the lockstep batch, whole-text layouts and
`parity_mode` build it on the host. On the card the prefill and every
decode chunk are replays of CUDA graphs (`engine/graphs.py`), captured per
key of static shapes and arguments (the prefill per prompt bucket too):
`warmup` captures the set serving uses, any other key or bucket is
captured at its first use. The native backend's cached-reference kwargs
(`ref_spk`, `ref_rvq`, `ref_spk_emb`, `ref_codes`) are taken by
`native_backend.NativeQwen3TTS` (`from_pretrained(backend="native")`); this
class rejects them, as the JAX package's does. `from_pretrained(...,
fuse_qkv=True)` loads the fused projection layout. `save_deploy_bundle`
writes the parameters as a deploy bundle, which `from_pretrained` loads back
as a serving restart. `from_pretrained(dp=, tp=)` (or a
`parallel.mesh.shard_params` tree with its mesh) serves over a (dp, tp)
device mesh: tp-sharded weights, a lockstep batch's lanes split over dp; over
distinct cards one process a card (`parallel.procs`), this one rank 0.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time
from pathlib import Path
from typing import Any, Dict, Generator, List, Optional, Tuple, Union

import numpy as np
import torch

from faster_qwen3_tts_tpu_torch.config import Qwen3TTSConfig, get_config
from faster_qwen3_tts_tpu_torch.utils import audio as audio_lib
from faster_qwen3_tts_tpu_torch.utils import trace
from faster_qwen3_tts_tpu_torch.utils.logging_utils import format_timing
from faster_qwen3_tts_tpu_torch.utils.tokenizer import ByteTokenizer, PromptTokenizer, load_tokenizer

from . import weights as weights_lib
from .engine import generate as gen_lib
from .engine.fused_stream import codec_deficit
from .models import codec as codec_lib
from .ops import quant as quant_lib
from .parallel import mesh as mesh_lib
from .prompt import PromptBuilder

logger = logging.getLogger(__name__)

# fp16 maps to bf16, as in the JAX package
_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16, "fp16": torch.bfloat16,
           "fp32": torch.float32, "float32": torch.float32}


@dataclasses.dataclass
class VoiceClonePromptItem:
    """One reference-voice prompt item, as `create_voice_clone_prompt` returns."""

    ref_spk_embedding: np.ndarray  # [2048] x-vector
    ref_code: Optional[np.ndarray] = None  # [T, 16] codec tokens (ICL only)
    icl_mode: bool = False
    x_vector_only_mode: bool = True
    ref_text: str = ""


class SpeechTokenizerFacade:
    """Codec decode surface `decode({"audio_codes": [B, T, 16]})`. Every
    decode is padded to a power-of-two frame bucket (at least 32) by
    repeating the last frame and cut to the exact length, as in the JAX
    package, so both give the same samples."""

    def __init__(self, params, cfg: Qwen3TTSConfig):
        self._params = params
        self._cfg = cfg
        self.sample_rate = cfg.codec.sample_rate

    def decode(self, inputs: Dict[str, Any]) -> Tuple[List[np.ndarray], int]:
        codes = np.asarray(inputs["audio_codes"])
        if codes.ndim == 2:
            codes = codes[None]
        return [self._decode_one(c) for c in codes], self.sample_rate

    def _decode_one(self, codes: np.ndarray) -> np.ndarray:
        T = codes.shape[0]
        n = T * self._cfg.codec.total_upsample - codec_deficit(self._cfg.codec)
        bucket = 32
        while bucket < T:
            bucket *= 2
        codes = np.concatenate([codes, np.tile(codes[-1:], (bucket - T, 1))], axis=0)
        device = self._params["codec"]["code_embed"].device
        wav = codec_lib.decode_frames(
            self._params["codec"], self._cfg.codec, torch.as_tensor(codes[None], device=device)
        )
        return wav[0, :n].cpu().numpy()


class _StreamVocoder:
    """One stream's incremental host vocoder, with the host regimes of a
    stream: until 24 frames exist, an accumulated decode of every frame so
    far (ICL reference codes prepended, their share of the samples cut off
    proportionally); then a fixed 24-frame left-context window emitting the
    window-local samples [ctx*up - D, (ctx+n)*up - D). It keeps the
    stream's code history and its emitted-sample count."""

    _CTX = gen_lib.CONTEXT_FRAMES

    def __init__(self, speech_tokenizer: SpeechTokenizerFacade, codec_cfg, ref_codes: Optional[np.ndarray]):
        self._st = speech_tokenizer
        self._up = codec_cfg.total_upsample
        self._deficit = codec_deficit(codec_cfg)
        self._ref_codes = ref_codes
        self._codes: List[np.ndarray] = []
        self._prev_len = 0  # samples emitted, in generated-audio coordinates
        self._rid = trace.current_rid()  # a batcher lane's sid: its `voc.host` spans run outside its admission

    def add_vocoded(self, frames: np.ndarray, n_samples: int) -> None:
        """Record frames whose `n_samples` samples were vocoded elsewhere (on
        the device), so that later host chunks continue after them."""
        self._codes.append(np.asarray(frames, np.int32))
        self._prev_len += n_samples

    def vocode_new(self, frames: np.ndarray) -> np.ndarray:
        """Vocode `frames` [n, 16], the stream's newest frames -> their
        samples (a `voc.host` span)."""
        with trace.span("voc.host", rid=self._rid, value=int(frames.shape[0])):
            self._codes.append(np.asarray(frames, np.int32))
            all_flat = np.concatenate(self._codes, axis=0)
            n_new = frames.shape[0]
            ctx, up, D = self._CTX, self._up, self._deficit
            if all_flat.shape[0] - n_new >= ctx:
                (audio,), _ = self._st.decode({"audio_codes": all_flat[-(ctx + n_new):][None]})
                new_audio = audio[ctx * up - D:(ctx + n_new) * up - D]
                self._prev_len += len(new_audio)
                return new_audio
            rc = self._ref_codes
            codes_in = all_flat if rc is None else np.concatenate([rc, all_flat], axis=0)
            (audio,), _ = self._st.decode({"audio_codes": codes_in[None]})
            if rc is not None:
                audio = audio[int(rc.shape[0] / max(codes_in.shape[0], 1) * len(audio)):]
            new_audio = audio[self._prev_len:]
            self._prev_len = len(audio)
            return new_audio


def load_params(model_name: str, device, dtype, quant: str, seed: int, strict: Optional[bool],
                load_phases: Dict[str, float], check=None):
    """The parameter tree `from_pretrained` serves, on `device`: a deploy
    bundle, an own-format or HF checkpoint directory, or a seeded random
    init of a model id (on the device with FQ3T_DEVICE_INIT=1), quantized as
    `quant` says -> (params, config, coverage, the bundle's quant mode or
    None). `check(config)` runs before anything is placed. The seconds of
    each phase go into `load_phases`. Every process of a process mesh loads
    its tree with this, from the same arguments."""
    device = torch.device(device)
    if isinstance(dtype, str):
        dtype = _DTYPES[dtype.lower()]
    mode = quant_lib.resolve_quant_name(quant)
    last = [time.perf_counter()]

    def mark(name: str) -> None:
        now = time.perf_counter()
        load_phases[name] = round(now - last[0], 3)
        last[0] = now

    is_dir = os.path.isdir(model_name)
    coverage: Dict[str, str] = {}
    bundle_mode = tree = params = None
    if is_dir and weights_lib.is_deploy_bundle(model_name):
        # the serving restart: one read into pinned memory, one copy a
        # dtype section; the leaves keep the dtypes they were saved in
        blobs, manifest, config, bundle_mode = weights_lib.read_deploy_bundle(
            model_name, pin_memory=device.type == "cuda", mark=mark)
        load_phases["transfer_mb"] = round(sum(b.numel() * b.element_size() for b in blobs.values()) / 1e6, 1)
        if bundle_mode != "none" and mode not in ("none", bundle_mode):
            # re-quantizing quantized weights would be lossy
            raise ValueError(f"deploy bundle is quantized as {bundle_mode!r}; requested quant={quant!r} "
                             "conflicts")
    elif is_dir and weights_lib.is_own_checkpoint(model_name):
        tree, config = weights_lib.load_pretrained(model_name)
    else:
        config = get_config(model_name)
    if check is not None:
        check(config)
    if is_dir and tree is None and bundle_mode is None:
        tree = weights_lib.load_hf_checkpoint(
            model_name, config, dtype=dtype, strict=True if strict is None else strict,
            coverage=coverage)
    elif not is_dir:
        logger.warning("No local checkpoint for %s; using random-initialized weights (seed %d).",
                       model_name, seed)
        if os.environ.get("FQ3T_DEVICE_INIT", "0") == "1":
            # drawn on the device (another generator than the host init's, as in JAX)
            params = weights_lib.init_all_device(config, seed, dtype, device)
        else:
            tree = weights_lib.init_numpy(config, seed)
    mark("weights_read")
    if tree is not None:
        params = weights_lib.materialize(tree, dtype, mode, device, mark=mark)
        del tree
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        mark("device_transfer")
    else:
        if bundle_mode is not None:
            params = weights_lib._device_unpack(blobs, manifest, device)  # synchronizes
            del blobs
            mark("device_transfer")
        if mode != "none" and bundle_mode in (None, "none"):
            # an unquantized bundle or a device init: quantized on the device
            params = quant_lib.quantize_model_params(params, mode)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            mark("quantize")
    return params, config, coverage, bundle_mode


def _pool_bytes(regs) -> Optional[int]:
    """Bytes of the registries' graph pools, None where one is not known."""
    sizes = [r.memory()["pool_bytes"] for r in regs]
    return None if any(b is None for b in sizes) else sum(sizes)


class FasterQwen3TTS:
    """The PyTorch engine with the JAX package's API."""

    def __init__(self, params: Dict[str, Any], config: Qwen3TTSConfig, tokenizer: PromptTokenizer,
                 max_seq_len: int = 2048, mesh=None):
        placed = mesh_lib.mesh_of(params)
        if mesh is not None and placed is None:
            raise ValueError("mesh= needs parameters placed on it (parallel.mesh.shard_params)")
        if placed is not None and placed.processes and placed.workers is None:
            raise ValueError(f"{placed} has not started its workers: a process mesh is built by "
                             "from_pretrained(..., dp=, tp=) or from_pretrained(..., mesh=)")
        if params["talker"]["codec_embed"].device.type == "cuda":
            # Process-wide: float32 products and convolutions (the codec) in
            # full float32 (cuDNN defaults to TF32), bf16 products reduced in
            # float32, as the JAX package computes.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        self.params = params
        self.config = config
        self.tokenizer = tokenizer
        self.max_seq_len = max_seq_len
        # The (dp, tp) device mesh of sharded parameters (`from_pretrained(dp=, tp=)`, or a
        # `shard_params` tree, whose mesh it is when none is passed), or None on one device.
        self.mesh = mesh if mesh is not None else placed
        # the replicated leaves (dp group 0, tp rank 0) feed the prompt, the codec facade and the encoders
        local = params if placed is None else mesh_lib.local_tree(params)
        self.sample_rate = config.codec.sample_rate
        self.prompt_builder = PromptBuilder(local, config)
        self._speech_tokenizer = SpeechTokenizerFacade(local, config)
        self._local_params = local
        self.device_chunk = 32  # frames per chunk in non-streaming generation
        self._warmed_up = False
        self._voice_prompt_cache: Dict[Any, Any] = {}
        self._voice_extractor = None
        self._source_path: Optional[str] = None  # the checkpoint directory, for save_deploy_bundle

    @classmethod
    def from_pretrained(
        cls,
        model_name: str,
        device: str = "cuda",
        dtype: Union[str, torch.dtype] = "bfloat16",
        attn_implementation: str = "pallas",
        max_seq_len: int = 2048,
        backend: str = "torch",
        quant: str = "BF16",
        seed: int = 0,
        cache_dir: Optional[Union[str, Path]] = None,
        local_files_only: bool = False,
        strict: Optional[bool] = None,
        dp: Optional[int] = None,
        tp: Optional[int] = None,
        **kwargs,
    ) -> "FasterQwen3TTS":
        """Load a checkpoint directory, or random-init a published geometry.
        The parameters are the JAX package's, in its order.

        model_name: a deploy bundle directory (`save_deploy_bundle`, or the
        JAX package's: bundle.bin + bundle.json; its leaves keep the dtypes
        they were saved in, so `dtype` is not read; a quantized bundle takes
        quant "none" or its own mode and raises `ValueError` on another, an
        unquantized one is quantized on the device after the copy), a
        directory in the own format (`weights.save_pretrained`:
        model.safetensors with '/' keys + config.json), a directory of
        upstream HF safetensors (+ config.json; strict unless strict=False:
        a missing or mismatched tensor raises `weights.StrictLoadError`, and
        so does a directory with no safetensors at all), or a model id /
        preset name (`config.get_config`), which random-inits from `seed`:
        on the host, or with `FQ3T_DEVICE_INIT=1` in the environment on the
        device (`weights.init_all_device`: other values, the same tree),
        quantized there. The tokenizer is read from the directory; without
        its assets, or without `transformers` to read them, the byte tokenizer is used and
        a warning says so. Nothing is downloaded: `cache_dir` and
        `local_files_only` are accepted and not read, as in the JAX package.

        device "cuda" needs a card and raises without one; "cpu" runs the
        kernels' plain versions. attn_implementation: "pallas" or "xla", as
        in the JAX package; the port runs its decode-attention kernel (K1) on
        the card either way, so "xla" only logs a warning. backend: "torch"
        (this engine; the JAX package's names "jax" / "tpu" / "xla" select it
        too) or "native" (`native_backend.NativeQwen3TTS`: the engine plus
        the voice-reference disk cache and the host library; its cache
        directory comes in `voice_ref_cache_dir`). quant: the JAX package's
        names, "BF16" / "F32" (none), "Q8_0" / "int8" (weight-only int8 for
        the talker and predictor projections), "Q4_K_M" / "int4" (group-wise
        int4) or "Q8_4" / "mixed" (talker int8, predictor int4). dp / tp:
        serving over a (dp, tp) mesh (`parallel.mesh`; either set builds
        one): tp shards attention heads and MLP columns Megatron style
        (tp must divide num_key_value_heads of the talker and the
        predictor), dp splits a lockstep batch's lanes
        (`generate_voice_clone_streaming_batch`). On "cuda" dp * tp > 1
        needs that many visible cards (else the device-count ValueError)
        and builds the process form over cuda:0 .. cuda:n-1
        (`parallel.procs`): this process is rank 0 on cuda:0 and spawns one
        worker a card, each loading the same source with the same
        arguments; the tp collectives run over NCCL, captured in each
        rank's graphs; a script that does this must guard its entry with
        `if __name__ == "__main__":`, as the spawn start method needs; the
        model's `mesh.close()` (or the exit) stops the workers. "cpu" builds a
        one-process mesh of cpu entries, as the JAX tests' virtual devices
        (one card's one-process mesh is `parallel.mesh.make_mesh(
        devices=["cuda:0"] * n)` with `shard_params`). The tree is loaded
        (a bundle unpacked), quantized, then sharded; `fuse_qkv` under a
        mesh warns and keeps the unfused layout. kwargs: `fuse_qkv`
        (default False), the fused projection layout of the JAX package's
        `FQ3T_FUSE_QKV` (`quant.fuse_layer_weights`, applied after
        quantization), `mesh` (a `parallel.mesh.Mesh` to serve on instead
        of the one dp / tp build, e.g. a process mesh of cpu entries or of
        dp groups sharing one card, `make_mesh(..., processes=True)`), and
        `voice_ref_cache_dir` (native backend); any other key is ignored
        with a warning; a bundle keeps its saved layout, so `fuse_qkv` on
        one only warns. The model's `load_phases` holds the
        seconds of weights_read, quantize, device_transfer (and fuse; for a
        bundle also pin, the pinned buffer's allocation, and transfer_mb, the
        megabytes copied), and `load_coverage` an HF checkpoint's
        per-submodel coverage."""
        if backend == "native":
            from .native_backend import NativeQwen3TTS

            return NativeQwen3TTS.from_pretrained(
                model_name, device=device, dtype=dtype, attn_implementation=attn_implementation,
                max_seq_len=max_seq_len, quant=quant, seed=seed, cache_dir=cache_dir,
                local_files_only=local_files_only, strict=strict, dp=dp, tp=tp, **kwargs)
        if backend not in ("torch", "jax", "tpu", "xla"):
            raise ValueError(f"Unsupported backend {backend!r}. Expected 'torch' (default; 'jax' selects it "
                             "too) or 'native'.")
        if attn_implementation not in ("pallas", "xla"):
            raise ValueError("attn_implementation must be 'pallas' or 'xla'")
        if attn_implementation == "xla":
            logger.warning("attn_implementation='xla': the port always runs its decode-attention kernel "
                           "(K1) on the card; the argument is ignored.")
        fuse_qkv = bool(kwargs.pop("fuse_qkv", False))
        mesh = kwargs.pop("mesh", None)
        if kwargs.pop("voice_ref_cache_dir", None) is not None:
            logger.warning("voice_ref_cache_dir is read by backend='native' only; ignored.")
        for key in kwargs:
            logger.warning("from_pretrained: unknown argument %r ignored.", key)
        device = torch.device(device)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("device='cuda' requested but torch.cuda.is_available() is False")
        elif device.type != "cpu":
            raise ValueError(f"unsupported device {device}")
        if isinstance(dtype, str):
            dtype = _DTYPES[dtype.lower()]
        if mesh is not None:
            if (dp or mesh.shape["dp"]) != mesh.shape["dp"] or (tp or mesh.shape["tp"]) != mesh.shape["tp"]:
                raise ValueError(f"dp={dp}, tp={tp} disagree with mesh= {mesh}")
            if mesh.processes:
                device = mesh.device_of(0, 0)  # rank 0 is this process
        elif dp is not None or tp is not None:
            n = (dp or 1) * (tp or 1)
            visible = torch.cuda.device_count() if device.type == "cuda" else n  # cpu: a mesh of cpu entries
            if visible < n:
                raise ValueError(f"dp={dp or 1} x tp={tp or 1} needs {n} devices; only {visible} visible")
        ways = mesh.shape["tp"] if mesh is not None else (tp or 1)

        def check(config: Qwen3TTSConfig) -> None:  # before anything is placed
            if config.talker.num_key_value_heads % ways or config.predictor.num_key_value_heads % ways:
                raise ValueError(f"tp={ways} must divide num_key_value_heads")

        load_phases: Dict[str, float] = {}
        params, config, coverage, bundle_mode = load_params(model_name, device, dtype, quant, seed, strict,
                                                            load_phases, check)
        is_dir = os.path.isdir(model_name)
        tokenizer = PromptTokenizer(load_tokenizer(model_name if is_dir else None))
        if is_dir and isinstance(tokenizer.base, ByteTokenizer):
            logger.warning("%s: %s; falling back to the BYTE tokenizer: fine for random-init weights, wrong "
                           "for a real checkpoint.", model_name, tokenizer.base.fallback_reason)
        if mesh is None and (dp is not None or tp is not None):
            # on cards cuda:0 .. cuda:n-1, a process mesh when n > 1; on the CPU one process
            n = (dp or 1) * (tp or 1)
            mesh = mesh_lib.make_mesh(n, dp=dp or 1, tp=tp or 1,
                                      devices=None if device.type == "cuda" else [device] * n)
        last = [time.perf_counter()]

        def mark(name: str) -> None:
            now = time.perf_counter()
            load_phases[name] = round(now - last[0], 3)
            last[0] = now

        # after quantization, as the JAX package fuses; the unfused leaves go as each group is made (a
        # checkpoint saved fused is already in that layout)
        if fuse_qkv and bundle_mode is not None:
            logger.warning("fuse_qkv=True on a deploy bundle is ignored: a bundle keeps the layout it was "
                           "saved in.")
        elif fuse_qkv and mesh is not None:
            logger.warning("fuse_qkv=True is a one-device layout; ignored under a (dp, tp) mesh (tp shards "
                           "the unfused per-head projections).")
        elif fuse_qkv and "wq" in params["talker"]["layers"]:
            for sub in ("talker", "predictor"):
                quant_lib._fuse_layers(params[sub]["layers"])
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            mark("fuse")
        if mesh is not None:
            params = mesh_lib.shard_params(params, mesh)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            mark("shard")
        if mesh is not None and mesh.processes:
            # every other (dp group, tp rank) in a process of its own, loading the same source
            from .parallel import procs

            procs.start(mesh, dict(model_name=model_name, dtype=dtype, quant=quant, seed=seed, strict=strict))
            load_phases["workers_start"] = round(mesh.workers.start_s, 3)
        model = cls(params, config, tokenizer, max_seq_len=max_seq_len, mesh=mesh)
        model.load_phases = load_phases
        model.load_coverage = coverage  # per submodel, for an HF checkpoint
        model._source_path = model_name if is_dir else None
        return model

    def _unsharded_params(self) -> Dict[str, Any]:
        """The parameters as one tree: a sharded model's gathered from dp
        group 0 (`mesh.gather_params`; a process mesh's over its control
        plane), as the JAX package reads sharded arrays through
        `np.asarray`."""
        return self.params if self.mesh is None else mesh_lib.gather_params(self.params)

    def save_deploy_bundle(self, path, compact_f32: bool = True) -> None:
        """Write this model's parameters as they are now (quantized or not,
        fused or not) as a deploy bundle (`weights.save_deploy_bundle`, in
        the JAX layouts), so that `from_pretrained(path)` restarts with one
        read and one copy a section: no name mapping, no host quantization.
        compact_f32 stores the float32 leaves as bfloat16: exact for leaves
        that came from bfloat16 (a real checkpoint's codec), not for random
        float32 leaves or quantization scales. The tokenizer assets of the
        directory the model came from are copied beside it."""
        import shutil

        host = weights_lib.host_tree(self._unsharded_params())
        weights_lib.save_deploy_bundle(path, host, self.config, quant_mode=quant_lib.infer_quant_mode(host),
                                       compact_f32=compact_f32)
        del host
        src = self._source_path
        copied = 0
        if src and os.path.isdir(src):
            for f in ("tokenizer.json", "tokenizer_config.json", "vocab.json", "merges.txt",
                      "special_tokens_map.json"):
                if os.path.exists(os.path.join(src, f)):
                    shutil.copy2(os.path.join(src, f), os.path.join(path, f))
                    copied += 1
        if copied == 0:
            logger.warning("save_deploy_bundle(%s): no tokenizer assets to copy (source: %r); "
                           "from_pretrained on this bundle will use the byte tokenizer.", path, src)

    def warmup(self, prefill_len: int = 100, chunk_sizes: Optional[Tuple[int, ...]] = None,
               first_chunk_size: Optional[int] = None,
               batch_sizes: Tuple[int, ...] = (1,), pool_slots: int = 0, min_new_tokens: int = 2,
               temperature: float = 0.9, top_k: int = 50, top_p: float = 1.0, do_sample: bool = True,
               repetition_penalty: float = 1.05, subtalker_dosample: Optional[bool] = None,
               subtalker_top_k: Optional[int] = None, subtalker_top_p: Optional[float] = None,
               subtalker_temperature: Optional[float] = None) -> Dict[str, Any]:
        """Capture the graphs that serving replays (the JAX warmup's
        executable set). The leading parameters are the JAX package's:
        `prefill_len` adds the prompt bucket of that length
        (`gen_lib.prefill_bucket`) to those captured; `chunk_sizes` None
        warms the windows of chunks 8 and 12, and `first_chunk_size` None
        makes a stream's first chunk `chunk` (pass 4 for streams with a
        4-frame first chunk). Then: one short prefill of a device-assembled
        x-vector prompt (builds the kernels and the prefill's handles), then
        for each of `batch_sizes` the prefill graphs of the prompt buckets a
        server sees (`gen_lib.SERVED_PREFILL_BUCKETS` up to max_seq_len, and
        the bucket of `prefill_len`), the frame
        graph and the window graphs of `graphs.warmup_windows` (the first
        window, the growing contexts of an x-vector stream and the ICL first
        window, for each chunk size); with `pool_slots` also a continuous pool
        of that many lanes (its frame and the (chunk, 24) windows) and the
        B = 1 prefill graphs and frame of its admissions. Then the prompt
        builders once each as the JAX warmup runs them: the device assembly
        of an x-vector prompt and of a 90-frame ICL prompt, and the host
        build. Graphs are keyed on the sampling arguments and min_new_tokens
        too: these default to the generate methods'. Leaves the sets free
        for the requests that follow; a key or bucket it did not cover is
        captured at its first use. -> the phases' seconds, the captures (and
        of them the prefill graphs) with their seconds, the prefill buckets,
        and the graph memory (static buffers, and on the card the graph pool
        before and after, of every set of the model), also kept in
        `warmup_phases`. Nothing is captured on the CPU (no graphs there);
        the keys, windows and buckets are still noted."""
        from .engine import graphs as graphs_lib
        from .ops.sampling import SamplingParams

        t0 = time.perf_counter()
        last = [t0]
        phases: Dict[str, Any] = {}

        def mark(name: str) -> None:
            now = time.perf_counter()
            phases[name] = round(now - last[0], 3)
            last[0] = now

        sampling = SamplingParams(temperature, top_k, top_p, do_sample, repetition_penalty)
        pred = gen_lib.predictor_sampling(subtalker_dosample, subtalker_top_k, subtalker_top_p,
                                          subtalker_temperature)
        regs = graphs_lib.registries(self.params)
        stats0 = [dict(r.stats) for r in regs]
        pool0 = _pool_bytes(regs)
        xvec = {"ref_spk_embedding": [np.zeros(2048, np.float32)], "x_vector_only_mode": [True],
                "icl_mode": [False], "ref_code": [None]}
        tie, tam, tth, tpe, _ = self._prepare_generation("Warm up the engine.", voice_clone_prompt=xvec)
        sess = gen_lib.GenerationSession(self.params, self.config, tie, tam, tth, tpe, self.max_seq_len,
                                         sampling, pred, min_new_tokens, seed=0)
        try:
            sess.prefill()
        finally:
            sess.close()
        mark("prompt_and_prefill")
        if chunk_sizes is None:
            chunk_sizes = (8, 12)
        buckets = tuple(sorted({b for b in gen_lib.SERVED_PREFILL_BUCKETS if b <= self.max_seq_len}
                               | {gen_lib.prefill_bucket(prefill_len, self.max_seq_len)}))
        windows = graphs_lib.warmup_windows(chunk_sizes, first_chunk_size, gen_lib.CONTEXT_FRAMES)

        workers = mesh_lib.workers_of(self.params)
        worker_stats: List[Any] = []

        def warm(B: int, split: bool, windows, buckets) -> None:
            # the sets a batch of B lanes leases in every process (`gen_lib.warm_sets`)
            args = (B, split, self.max_seq_len, sess.key.text_rows, sampling, pred, min_new_tokens, windows, buckets)
            if workers is None:
                gen_lib.warm_sets(self.params, self.config, *args)
                return
            workers.send("warm", *args)
            with workers.guard():
                gen_lib.warm_sets(self.params, self.config, *args)
            worker_stats.append(workers.gather())

        for B in dict.fromkeys(batch_sizes):
            warm(B, True, windows, buckets)  # a lockstep batch splits over dp; a solo stream runs on group 0
            mark(f"graphs_B{B}")
        if pool_slots:
            ctx = gen_lib.CONTEXT_FRAMES
            # the pool is filled by lane copies, never prefilled
            warm(pool_slots, False, [(c, ctx) for c in chunk_sizes], ())
            warm(1, False, (), buckets)  # admission's prefill, solo chunk
            mark(f"graphs_pool{pool_slots}")
        warm_text = "The quick brown fox jumps over the lazy dog warms buckets."
        self._prepare_generation(warm_text, voice_clone_prompt=xvec, xvec_only=True)
        self._prepare_generation(warm_text, voice_clone_prompt=xvec, xvec_only=True, prefer_device=False)
        if self.max_seq_len >= 128:  # a 90-frame ICL prompt takes the 128-row bucket
            tc = self.config.talker
            icl = {"ref_spk_embedding": [np.zeros(2048, np.float32)], "x_vector_only_mode": [False],
                   "icl_mode": [True], "ref_code": [np.random.default_rng(0).integers(
                       0, tc.vocab_size - 1025, size=(90, tc.num_code_groups)).astype(np.int32)]}
            self._prepare_generation(warm_text, ref_text="warmup reference text", voice_clone_prompt=icl)
        if self.params["talker"]["codec_embed"].device.type == "cuda":
            torch.cuda.synchronize()
        mark("prompt_assembly")
        pool = _pool_bytes(regs)
        # every set of this model (of every dp group), not only these
        phases["graph_static_gb"] = sum(r.memory()["static_bytes"] for r in regs) / 1e9
        phases["graph_pool_gb_before"] = None if pool0 is None else pool0 / 1e9
        phases["graph_pool_gb"] = None if pool is None else pool / 1e9
        for name in ("captures", "prefill_captures", "capture_s"):
            phases[name] = sum(r.stats[name] - s0[name] for r, s0 in zip(regs, stats0))
        phases["capture_s"] = round(phases["capture_s"], 3)
        if worker_stats:  # each worker's captures, rank order
            phases["workers"] = [{k: sum(s[r][k] for s in worker_stats) for k in worker_stats[0][r]}
                                 for r in range(len(worker_stats[0]))]
        phases["prefill_buckets"] = list(buckets)
        phases["total_s"] = round(time.perf_counter() - t0, 3)
        self.warmup_phases = phases
        self._warmed_up = True
        logger.info("Warmup complete in %.1fs: %s", phases["total_s"], phases)
        return phases

    @property
    def speech_tokenizer(self) -> SpeechTokenizerFacade:
        return self._speech_tokenizer

    @staticmethod
    def _resolve_non_streaming_mode(non_streaming_mode: Optional[bool], *, default: bool) -> bool:
        """None -> the method's default: voice clone False (text step-fed),
        CustomVoice and VoiceDesign True (the whole text in the prefill)."""
        return default if non_streaming_mode is None else non_streaming_mode

    def generate(self, *args, **kwargs):
        raise NotImplementedError(
            "Default voice generation not implemented. Use generate_voice_clone(), "
            "generate_custom_voice(), or generate_voice_design()."
        )

    def _validate_languages(self, languages: List[str]) -> None:
        known = self.config.talker.codec_language_id
        for lang in languages:
            if lang is not None and lang.lower() != "auto" and lang.lower() not in known:
                raise NotImplementedError(f"Language {lang} not implemented")

    def _validate_speakers(self, speakers: List[str]) -> None:
        for s in speakers:
            if s and s.lower() not in self.config.talker.spk_id:
                raise NotImplementedError(f"Speaker {s} not implemented")

    def get_supported_speakers(self) -> List[str]:
        return sorted(self.config.talker.spk_id.keys())

    @property
    def tts_model_type(self) -> str:
        return self.config.model_type

    @property
    def tts_model_size(self) -> str:
        return self.config.model_size

    # -- voice-clone prompts ---------------------------------------------------

    def create_voice_clone_prompt(
        self,
        ref_audio: Union[str, Path, Tuple[np.ndarray, int]],
        ref_text: str = "",
        x_vector_only_mode: bool = False,
    ) -> List[VoiceClonePromptItem]:
        """Extract a voice-clone prompt from reference audio (a wav path or
        (samples, sample_rate)): the x-vector, and in ICL mode the reference
        codec tokens."""
        if isinstance(ref_audio, (str, Path)):
            audio, sr = audio_lib.read_wav(ref_audio)
        else:
            audio, sr = ref_audio
            audio = np.asarray(audio, np.float32)
        extractor = self._get_voice_extractor()
        xvec = extractor.extract_xvector(audio, sr)
        if x_vector_only_mode:
            return [VoiceClonePromptItem(ref_spk_embedding=xvec, icl_mode=False,
                                         x_vector_only_mode=True, ref_text="")]
        ref_code = extractor.extract_codes(audio, sr)
        return [VoiceClonePromptItem(ref_spk_embedding=xvec, ref_code=ref_code, icl_mode=True,
                                     x_vector_only_mode=False, ref_text=ref_text)]

    def _get_voice_extractor(self):
        """The two reference-audio encoders, built at first use in float32
        on the model's device."""
        if self._voice_extractor is None:
            from .models.voice_extract import VoiceExtractor

            self._voice_extractor = VoiceExtractor(self._local_params, self.config)
        return self._voice_extractor

    @staticmethod
    def _prompt_items_to_voice_clone_prompt(items: List[VoiceClonePromptItem]) -> Dict[str, Any]:
        return dict(
            ref_code=[i.ref_code for i in items],
            ref_spk_embedding=[i.ref_spk_embedding for i in items],
            x_vector_only_mode=[bool(i.x_vector_only_mode) for i in items],
            icl_mode=[bool(i.icl_mode) for i in items],
        )

    def _resolve_voice_clone_prompt(self, input_ids, ref_audio, ref_text, xvec_only, append_silence,
                                    voice_clone_prompt):
        """-> (voice_clone_prompt dict of per-item lists, ref_ids, using_icl)."""
        if voice_clone_prompt is not None:
            return self._resolve_precomputed(input_ids, ref_text, voice_clone_prompt)
        if ref_audio is None:
            raise ValueError("ref_audio is required when voice_clone_prompt is not provided")
        return self._resolve_from_reference(input_ids, ref_audio, ref_text, xvec_only, append_silence)

    def _resolve_precomputed(self, input_ids, ref_text, voice_clone_prompt):
        n = len(input_ids)
        if isinstance(voice_clone_prompt, list):
            if len(voice_clone_prompt) != n:
                raise ValueError(f"voice_clone_prompt must have length {n}, got {len(voice_clone_prompt)}")
            vcp = self._prompt_items_to_voice_clone_prompt(voice_clone_prompt)
            ref_ids = []
            for item in voice_clone_prompt:
                if bool(item.icl_mode):
                    item_text = item.ref_text or ref_text
                    if not item_text:
                        raise ValueError("ref_text is required when voice_clone_prompt uses ICL mode.")
                    ref_ids.append(self.tokenizer.ref_ids(item_text))
                else:
                    ref_ids.append(None)
            return vcp, ref_ids, any(vcp["icl_mode"])

        if "ref_spk_embedding" not in voice_clone_prompt:
            raise ValueError("voice_clone_prompt missing required keys: ['ref_spk_embedding']")
        for key in ("ref_spk_embedding", "x_vector_only_mode", "icl_mode", "ref_code"):
            v = voice_clone_prompt.get(key)
            if key in voice_clone_prompt and (not isinstance(v, list) or len(v) != n):
                raise ValueError(f"voice_clone_prompt[{key!r}] must be a list with length {n}")
        xvec_modes = [bool(v) for v in voice_clone_prompt.get("x_vector_only_mode", [True] * n)]
        if "icl_mode" in voice_clone_prompt:
            icl_modes = [bool(v) for v in voice_clone_prompt["icl_mode"]]
            for i, (xm, im) in enumerate(zip(xvec_modes, icl_modes)):
                if xm == im:
                    raise ValueError(
                        f"voice_clone_prompt has inconsistent mode flags at index {i}: "
                        "x_vector_only_mode and icl_mode must be opposites"
                    )
        else:
            icl_modes = [not m for m in xvec_modes]
        ref_codes = voice_clone_prompt.get("ref_code", [None] * n)
        for i, (xm, im, rc) in enumerate(zip(xvec_modes, icl_modes, ref_codes)):
            if xm and rc is not None:
                raise ValueError(f"voice_clone_prompt index {i}: ref_code must be None in x_vector_only mode")
            if im and rc is None:
                raise ValueError(f"voice_clone_prompt index {i}: ref_code is required in ICL mode")
        vcp = dict(ref_code=ref_codes, ref_spk_embedding=voice_clone_prompt["ref_spk_embedding"],
                   x_vector_only_mode=xvec_modes, icl_mode=icl_modes)
        using_icl = any(icl_modes)
        if not using_icl:
            return vcp, [None] * n, False
        if not ref_text:
            raise ValueError("ref_text is required when voice_clone_prompt uses ICL mode.")
        rid = self.tokenizer.ref_ids(ref_text)
        return vcp, [rid if im else None for im in icl_modes], True

    def _resolve_from_reference(self, input_ids, ref_audio, ref_text, xvec_only, append_silence):
        """Extract (or take from the per-model cache) the prompt of a
        reference recording. ICL mode appends 0.5 s of silence unless
        append_silence is False."""
        using_icl = not xvec_only
        cache_key = (str(ref_audio), ref_text, xvec_only, append_silence)
        if cache_key in self._voice_prompt_cache:
            vcp, ref_ids = self._voice_prompt_cache[cache_key]
            return vcp, ref_ids, using_icl
        if xvec_only:
            items = self.create_voice_clone_prompt(str(ref_audio), ref_text="", x_vector_only_mode=True)
            ref_ids = [None] * len(input_ids)
        else:
            if not ref_text:
                raise ValueError("ref_text is required for ICL voice clone from ref_audio "
                                 "(or pass xvec_only=True)")
            audio, sr = audio_lib.load_ref_audio(ref_audio, silence_secs=0.5 if append_silence else 0.0)
            items = self.create_voice_clone_prompt((audio, sr), ref_text=ref_text)
            ref_ids = [self.tokenizer.ref_ids(items[0].ref_text)]
        vcp = self._prompt_items_to_voice_clone_prompt(items)
        self._voice_prompt_cache[cache_key] = (vcp, ref_ids)
        return vcp, ref_ids, using_icl

    def _prepare_generation(self, text: str, ref_audio=None, ref_text: str = "", language: str = "English",
                            xvec_only: bool = False, non_streaming_mode: bool = False,
                            append_silence: bool = True, voice_clone_prompt=None,
                            instruct: Optional[str] = None, prefer_device: bool = True):
        """-> (tie, attention_mask, tth, tpe, ref_codes [R, 16] int32 or None).
        A streaming-layout request with prefer_device is assembled on the
        device (`PromptBuilder.build_device`: device tensors at the session's
        buckets); otherwise, and for more than one item, on the host (`build`:
        numpy at the prompt's own length). An `api.prompt` span, its value
        the prompt's rows."""
        with trace.span("api.prompt") as sp:
            input_ids = [self.tokenizer.assistant_ids(text)]
            instruct_ids = [self.tokenizer.instruct_ids(instruct)] if instruct else [None]
            vcp, ref_ids, using_icl = self._resolve_voice_clone_prompt(
                input_ids, ref_audio, ref_text, xvec_only, append_silence, voice_clone_prompt
            )
            if instruct and not using_icl:
                logger.warning("Base-model instruct with x-vector-only voice cloning is experimental; "
                               "prefer xvec_only=False (ICL mode).")
            languages = [language if language is not None else "Auto"]
            ref_codes = None
            if using_icl and vcp.get("ref_code") and vcp["ref_code"][0] is not None:
                ref_codes = np.asarray(vcp["ref_code"][0], np.int32)
            if self._device_prompt_ok(prefer_device, non_streaming_mode):
                dev = self.prompt_builder.build_device(input_ids, ref_ids, vcp, languages, None, instruct_ids,
                                                       self.max_seq_len)
                if dev is not None:
                    sp.value = int(dev[0].shape[1])
                    return (*dev, ref_codes)
            tie, tam, tth, tpe = self.prompt_builder.build(
                input_ids=input_ids, ref_ids=ref_ids, voice_clone_prompt=vcp, languages=languages, speakers=None,
                non_streaming_mode=non_streaming_mode, instruct_ids=instruct_ids,
            )
            sp.value = int(tie.shape[1])
            return tie, tam, tth, tpe, ref_codes

    def _device_prompt_ok(self, prefer_device: bool, non_streaming_mode: bool) -> bool:
        """The device-assembly gate: a streaming-layout request whose caller
        prefers it, on a model without a mesh. The lockstep batch pads its
        prompts in host numpy and `parity_mode` reads them on the host, so
        both pass prefer_device=False; a whole-text (non-streaming) layout is
        built on the host, and so is every prompt under a mesh (the session
        places each dp group's lanes on its device), as in the JAX package.
        Unlike the JAX package there is no switch to turn it off."""
        return prefer_device and not non_streaming_mode and self.mesh is None

    def _prepare_generation_custom(self, text, language, speaker, instruct=None, non_streaming_mode=True,
                                   prefer_device: bool = True):
        """Prompt of a CustomVoice (preset `speaker`) or VoiceDesign
        (speaker None, voice described by `instruct`) request -> (tie,
        attention_mask, tth, tpe), on the device for a streaming layout with
        prefer_device (as `_prepare_generation`); an `api.prompt` span."""
        with trace.span("api.prompt") as sp:
            input_ids = [self.tokenizer.assistant_ids(text)]
            instruct_ids = [self.tokenizer.instruct_ids(instruct) if instruct else None]
            languages = [language if language is not None else "Auto"]
            if self._device_prompt_ok(prefer_device, non_streaming_mode):
                dev = self.prompt_builder.build_device(input_ids, [None], None, languages, [speaker], instruct_ids,
                                                       self.max_seq_len)
                if dev is not None:
                    sp.value = int(dev[0].shape[1])
                    return dev
            out = self.prompt_builder.build(
                input_ids=input_ids, ref_ids=[None], voice_clone_prompt=None, languages=languages,
                speakers=[speaker], non_streaming_mode=non_streaming_mode, instruct_ids=instruct_ids,
            )
            sp.value = int(out[0].shape[1])
            return out

    # -- codec decode helpers --------------------------------------------------

    def _decode_audio(self, codec_ids: np.ndarray, ref_codes: Optional[np.ndarray]):
        """Whole-sequence codec decode; ICL reference codes are prepended and
        their share of the samples is cut off proportionally."""
        codes = codec_ids if ref_codes is None else np.concatenate([ref_codes, codec_ids], axis=0)
        audio_list, sr = self._speech_tokenizer.decode({"audio_codes": codes[None]})
        ref_len = 0 if ref_codes is None else ref_codes.shape[0]
        outs = []
        for a in audio_list:
            a = np.asarray(a).flatten()
            if ref_len > 0:
                a = a[int(ref_len / max(codes.shape[0], 1) * len(a)):]
            outs.append(a)
        return outs, sr

    def _log_rtf(self, timing: Dict[str, Any]) -> None:
        logger.info("%s", format_timing(timing, self.config.frame_rate))

    # -- generation ----------------------------------------------------------

    @staticmethod
    def _reject_unported(ref_spk=None, ref_rvq=None, ref_spk_emb=None, ref_codes=None) -> None:
        """The cached-reference kwargs belong to the native backend
        (`NativeQwen3TTS`); the JAX package accepts them in its signature and
        rejects them at call time, and so does the port."""
        if any(v is not None for v in (ref_spk, ref_rvq, ref_spk_emb, ref_codes)):
            raise NotImplementedError(
                "ref_spk/ref_rvq cached references require backend='native'. "
                "Use voice_clone_prompt for precomputed prompts."
            )

    def _require_unfused_for_parity(self) -> None:
        """`engine/parity.py` reads the unfused projections (wq/wk/wv,
        w_gate/w_up). The JAX package fails there with a KeyError on a fused
        tree; the port raises before any work."""
        if "wqkv" in self.params["talker"]["layers"]:
            raise ValueError("parity_mode needs the unfused projection layout; this model was loaded "
                             "with fuse_qkv=True")

    def generate_voice_clone(
        self,
        text: str,
        language: str,
        ref_audio: Optional[Union[str, Path]] = None,
        ref_text: str = "",
        max_new_tokens: int = 2048,
        min_new_tokens: int = 2,
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        do_sample: bool = True,
        repetition_penalty: float = 1.05,
        xvec_only: bool = False,
        non_streaming_mode: Optional[bool] = None,
        append_silence: bool = True,
        parity_mode: bool = False,
        instruct: Optional[str] = None,
        ref_spk: Optional[Union[str, Path]] = None,
        ref_rvq: Optional[Union[str, Path]] = None,
        ref_spk_emb: Optional[np.ndarray] = None,
        ref_codes: Optional[np.ndarray] = None,
        voice_clone_prompt=None,
        seed: Optional[int] = None,
    ) -> Tuple[List[np.ndarray], int]:
        """Voice-clone TTS -> ([waveform], sample_rate).

        parity_mode: the independent eager decode (`engine/parity.py`)
        instead of the engine, as in the JAX package."""
        self._reject_unported(ref_spk, ref_rvq, ref_spk_emb, ref_codes)
        if parity_mode:
            self._require_unfused_for_parity()
        nsm = self._resolve_non_streaming_mode(non_streaming_mode, default=False)
        tie, tam, tth, tpe, ref_codes = self._prepare_generation(
            text=text, ref_audio=ref_audio, ref_text=ref_text, language=language, xvec_only=xvec_only,
            non_streaming_mode=nsm, append_silence=append_silence,
            voice_clone_prompt=voice_clone_prompt, instruct=instruct, prefer_device=not parity_mode,
        )
        kw = dict(max_seq_len=self.max_seq_len, max_new_tokens=max_new_tokens,
                  min_new_tokens=min_new_tokens, temperature=temperature, top_k=top_k, top_p=top_p,
                  do_sample=do_sample, repetition_penalty=repetition_penalty, seed=seed)
        if parity_mode:
            from .engine import parity as parity_lib

            codec_ids, timing = parity_lib.parity_generate(self._unsharded_params(), self.config, tie, tam, tth,
                                                           tpe, **kw)
        else:
            codec_ids, timing = gen_lib.fast_generate(self.params, self.config, tie, tam, tth, tpe,
                                                      device_chunk=self.device_chunk, **kw)
        if codec_ids is None:
            logger.warning("Generation returned no tokens")
            return [np.zeros(1, np.float32)], self.sample_rate
        audio, sr = self._decode_audio(codec_ids, ref_codes)
        self._log_rtf(timing)
        return audio, sr

    def generate_voice_clone_streaming(
        self,
        text: str,
        language: str,
        ref_audio: Optional[Union[str, Path]] = None,
        ref_text: str = "",
        max_new_tokens: int = 2048,
        min_new_tokens: int = 2,
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        do_sample: bool = True,
        repetition_penalty: float = 1.05,
        chunk_size: int = 12,
        first_chunk_size: Optional[int] = None,
        xvec_only: bool = False,
        non_streaming_mode: Optional[bool] = None,
        append_silence: bool = True,
        parity_mode: bool = False,
        instruct: Optional[str] = None,
        ref_spk: Optional[Union[str, Path]] = None,
        ref_rvq: Optional[Union[str, Path]] = None,
        ref_spk_emb: Optional[np.ndarray] = None,
        ref_codes: Optional[np.ndarray] = None,
        voice_clone_prompt=None,
        seed: Optional[int] = None,
        subtalker_dosample: Optional[bool] = None,
        subtalker_top_k: Optional[int] = None,
        subtalker_top_p: Optional[float] = None,
        subtalker_temperature: Optional[float] = None,
    ) -> Generator[Tuple[np.ndarray, int, Dict[str, Any]], None, None]:
        """Streaming voice clone: yields (audio_chunk, sample_rate, timing)
        per chunk; chunks are sample-contiguous (up to the proportional cut
        of a short ICL reference). parity_mode: the frames come from the
        independent eager decode (`engine/parity.py`) and every chunk is
        vocoded on the host, as in the JAX package."""
        self._reject_unported(ref_spk, ref_rvq, ref_spk_emb, ref_codes)
        if parity_mode:
            self._require_unfused_for_parity()
        nsm = self._resolve_non_streaming_mode(non_streaming_mode, default=False)
        tie, tam, tth, tpe, ref_codes = self._prepare_generation(
            text=text, ref_audio=ref_audio, ref_text=ref_text, language=language, xvec_only=xvec_only,
            non_streaming_mode=nsm, append_silence=append_silence,
            voice_clone_prompt=voice_clone_prompt, instruct=instruct, prefer_device=not parity_mode,
        )
        kw = dict(max_seq_len=self.max_seq_len, max_new_tokens=max_new_tokens,
                  min_new_tokens=min_new_tokens, temperature=temperature, top_k=top_k, top_p=top_p,
                  do_sample=do_sample, repetition_penalty=repetition_penalty, chunk_size=chunk_size,
                  seed=seed, first_chunk_size=first_chunk_size, subtalker_dosample=subtalker_dosample,
                  subtalker_top_k=subtalker_top_k, subtalker_top_p=subtalker_top_p,
                  subtalker_temperature=subtalker_temperature)
        if parity_mode:
            from .engine import parity as parity_lib

            stream = ((frames, None, timing) for frames, timing in parity_lib.parity_generate_streaming(
                self._unsharded_params(), self.config, tie, tam, tth, tpe, **kw))
        else:
            stream = gen_lib.fast_generate_streaming_fused(
                self.params, self.config, tie, tam, tth, tpe,
                # x-vector streams and ICL streams with >= 24 reference frames
                # vocode every chunk on the device; a shorter reference keeps
                # the host decode that prepends it until 24 frames were generated
                fuse_first_chunk=ref_codes is None, ref_codes=ref_codes, **kw,
            )
        yield from self._stream_decode(stream, ref_codes)

    def _make_stream_vocoder(self, ref_codes: Optional[np.ndarray]) -> _StreamVocoder:
        return _StreamVocoder(self._speech_tokenizer, self.config.codec, ref_codes)

    def _stream_decode(self, stream, ref_codes: Optional[np.ndarray]):
        """Relays a stream's audio: fused chunks come vocoded on the device;
        plain chunks go through the stream's host vocoder (`_StreamVocoder`).
        The JAX package vocodes plain chunks on a worker thread; here they
        run inline, giving the same samples in the same order."""
        vocoder = self._make_stream_vocoder(ref_codes)
        for codec_chunk, fused_audio, timing in stream:
            if fused_audio is not None:
                vocoder.add_vocoded(codec_chunk, len(fused_audio))
                yield fused_audio, self.sample_rate, timing
            else:
                yield vocoder.vocode_new(codec_chunk), self.sample_rate, timing

    # -- many streams on one engine batch ----------------------------------------

    def continuous_batcher(self, **kwargs):
        """A `serving.ContinuousBatcher` over this model: requests join a
        running pool of lanes at chunk boundaries."""
        from .serving import ContinuousBatcher

        return ContinuousBatcher(self, **kwargs)

    def generate_voice_clone_streaming_batch(
        self,
        requests: List[Dict[str, Any]],
        chunk_size: int = 8,
        first_chunk_size: Optional[int] = None,
        max_new_tokens: int = 2048,
        min_new_tokens: int = 2,
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        do_sample: bool = True,
        repetition_penalty: float = 1.05,
        seed: Optional[int] = None,
        subtalker_dosample: Optional[bool] = None,
        subtalker_top_k: Optional[int] = None,
        subtalker_top_p: Optional[float] = None,
        subtalker_temperature: Optional[float] = None,
    ) -> Generator[Tuple[int, np.ndarray, int, Dict[str, Any]], None, None]:
        """B voice-clone streams decoded in lockstep on one engine batch.

        requests: dicts with the prompt fields of
        `generate_voice_clone_streaming`: text (required), language,
        ref_audio, ref_text, xvec_only, voice_clone_prompt, instruct,
        append_silence, non_streaming_mode. Sampling and chunk arguments are
        shared by the batch. Yields (slot, audio_chunk f32, sample_rate,
        timing) in chunk order; a slot stops appearing once its stream hit
        EOS. Every lane is vocoded on the device when all are x-vector or
        all carry >= 24 ICL reference frames; a mixed batch vocodes each lane
        with its own host vocoder. Under a mesh the lanes split over its dp
        groups when dp divides B (else dp group 0 runs them all)."""
        if not requests:
            return
        prepared = []
        for r in requests:
            nsm = self._resolve_non_streaming_mode(r.get("non_streaming_mode"), default=False)
            prepared.append(self._prepare_generation(
                text=r["text"], language=r.get("language", "English"), ref_audio=r.get("ref_audio"),
                ref_text=r.get("ref_text", ""), xvec_only=bool(r.get("xvec_only", False)),
                non_streaming_mode=nsm, append_silence=bool(r.get("append_silence", True)),
                voice_clone_prompt=r.get("voice_clone_prompt"), instruct=r.get("instruct"),
                prefer_device=False,  # the batch pads its prompts in host numpy below
            ))
        B = len(prepared)
        H = self.config.talker.hidden_size
        bucket = gen_lib.prefill_bucket(max(p[0].shape[1] for p in prepared), self.max_seq_len)
        tbucket = gen_lib.tth_bucket(max(p[2].shape[1] for p in prepared))
        tie = np.zeros((B, bucket, H), np.float32)
        mask = np.zeros((B, bucket), np.int32)
        tth = np.zeros((B, tbucket, H), np.float32)
        tpe = np.asarray(prepared[0][3], np.float32)  # the pad embedding is the model's
        ref_codes: List[Optional[np.ndarray]] = []
        for s, (tie_s, tam_s, tth_s, tpe_s, rc) in enumerate(prepared):
            P = tie_s.shape[1]
            tie[s, bucket - P:] = tie_s[0]
            mask[s, bucket - P:] = tam_s[0]
            tth[s] = gen_lib._pad_trailing(np.asarray(tth_s, np.float32), tpe_s, tbucket)[0]
            ref_codes.append(rc)
        stream = gen_lib.fast_generate_streaming_batch(
            self.params, self.config, tie, mask, tth, tpe, max_seq_len=self.max_seq_len,
            max_new_tokens=max_new_tokens, min_new_tokens=min_new_tokens, temperature=temperature,
            top_k=top_k, top_p=top_p, do_sample=do_sample, repetition_penalty=repetition_penalty,
            chunk_size=chunk_size, first_chunk_size=first_chunk_size, seed=seed, mesh=self.mesh,
            ref_codes_list=ref_codes, subtalker_dosample=subtalker_dosample,
            subtalker_top_k=subtalker_top_k, subtalker_top_p=subtalker_top_p,
            subtalker_temperature=subtalker_temperature,
        )
        up = self.config.codec.total_upsample
        D = codec_deficit(self.config.codec)
        vocoders: Optional[List[_StreamVocoder]] = None  # made for the first plain chunk
        ended = [False] * B
        for frames, valid, done, audio_b, timing in stream:
            for s in range(B):
                if ended[s]:
                    continue
                v = int(valid[:, s].sum())
                if v:
                    if audio_b is not None:
                        n_emit = max(v * up - D, 0) if timing["first_window"] else v * up
                        audio = np.asarray(audio_b[s, :n_emit], np.float32)
                    else:
                        if vocoders is None:
                            vocoders = [self._make_stream_vocoder(rc) for rc in ref_codes]
                        audio = vocoders[s].vocode_new(frames[valid[:, s], s])
                    t = dict(timing, slot=s, chunk_steps=v,
                             total_steps_so_far=int(timing["total_steps_so_far"][s]),
                             is_final=bool(done[s]) or bool(timing["is_final"]))
                    yield s, audio, self.sample_rate, t
                if done[s]:
                    ended[s] = True

    # -- CustomVoice and VoiceDesign -------------------------------------------

    def _generate_custom(self, text, language, speaker, instruct, nsm, **sampling):
        """Non-streaming CustomVoice / VoiceDesign -> ([waveform], sample_rate)."""
        tie, tam, tth, tpe = self._prepare_generation_custom(
            text, language, speaker, instruct=instruct, non_streaming_mode=nsm
        )
        codec_ids, timing = gen_lib.fast_generate(
            self.params, self.config, tie, tam, tth, tpe, max_seq_len=self.max_seq_len,
            device_chunk=self.device_chunk, **sampling,
        )
        if codec_ids is None:
            logger.warning("Generation returned no tokens")
            return [np.zeros(1, np.float32)], self.sample_rate
        audio, sr = self._decode_audio(codec_ids, None)
        self._log_rtf(timing)
        return audio, sr

    def _generate_custom_streaming(self, text, language, speaker, instruct, nsm, **sampling):
        """Streaming CustomVoice / VoiceDesign: every chunk, the first
        included, is vocoded on the device."""
        tie, tam, tth, tpe = self._prepare_generation_custom(
            text, language, speaker, instruct=instruct, non_streaming_mode=nsm
        )
        stream = gen_lib.fast_generate_streaming_fused(
            self.params, self.config, tie, tam, tth, tpe, max_seq_len=self.max_seq_len,
            fuse_first_chunk=True, **sampling,
        )
        yield from self._stream_decode(stream, None)

    def _custom_voice_request(self, speaker, language, instruct):
        """Checks of a CustomVoice request -> the instruction it keeps (a
        0.6B model takes none)."""
        if self.tts_model_type != "custom_voice":
            raise ValueError("Loaded model does not support custom voice generation")
        self._validate_languages([language])
        self._validate_speakers([speaker])
        # a substring test on the size name, as in the JAX package
        return None if self.tts_model_size in "0b6" else instruct

    def _voice_design_request(self, language):
        if self.tts_model_type != "voice_design":
            raise ValueError("Loaded model does not support voice design generation")
        self._validate_languages([language])

    def generate_custom_voice(
        self,
        text: str,
        speaker: str,
        language: str,
        instruct: Optional[str] = None,
        non_streaming_mode: Optional[bool] = None,
        max_new_tokens: int = 2048,
        min_new_tokens: int = 2,
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        do_sample: bool = True,
        repetition_penalty: float = 1.05,
        seed: Optional[int] = None,
    ) -> Tuple[List[np.ndarray], int]:
        """CustomVoice TTS with a preset speaker -> ([waveform], sample_rate)."""
        instruct = self._custom_voice_request(speaker, language, instruct)
        nsm = self._resolve_non_streaming_mode(non_streaming_mode, default=True)
        return self._generate_custom(
            text, language, speaker, instruct, nsm, max_new_tokens=max_new_tokens,
            min_new_tokens=min_new_tokens, temperature=temperature, top_k=top_k, top_p=top_p,
            do_sample=do_sample, repetition_penalty=repetition_penalty, seed=seed,
        )

    def generate_custom_voice_streaming(
        self,
        text: str,
        speaker: str,
        language: str,
        instruct: Optional[str] = None,
        non_streaming_mode: Optional[bool] = None,
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
    ) -> Generator[Tuple[np.ndarray, int, Dict[str, Any]], None, None]:
        """Streaming CustomVoice: yields (audio_chunk, sample_rate, timing)."""
        instruct = self._custom_voice_request(speaker, language, instruct)
        nsm = self._resolve_non_streaming_mode(non_streaming_mode, default=True)
        yield from self._generate_custom_streaming(
            text, language, speaker, instruct, nsm, max_new_tokens=max_new_tokens,
            min_new_tokens=min_new_tokens, temperature=temperature, top_k=top_k, top_p=top_p,
            do_sample=do_sample, repetition_penalty=repetition_penalty, chunk_size=chunk_size,
            first_chunk_size=first_chunk_size, seed=seed,
        )

    def generate_voice_design(
        self,
        text: str,
        instruct: str,
        language: str,
        non_streaming_mode: Optional[bool] = None,
        max_new_tokens: int = 2048,
        min_new_tokens: int = 2,
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        do_sample: bool = True,
        repetition_penalty: float = 1.05,
        seed: Optional[int] = None,
    ) -> Tuple[List[np.ndarray], int]:
        """VoiceDesign TTS, the voice described by `instruct` -> ([waveform], sample_rate)."""
        self._voice_design_request(language)
        nsm = self._resolve_non_streaming_mode(non_streaming_mode, default=True)
        return self._generate_custom(
            text, language, None, instruct, nsm, max_new_tokens=max_new_tokens,
            min_new_tokens=min_new_tokens, temperature=temperature, top_k=top_k, top_p=top_p,
            do_sample=do_sample, repetition_penalty=repetition_penalty, seed=seed,
        )

    def generate_voice_design_streaming(
        self,
        text: str,
        instruct: str,
        language: str,
        non_streaming_mode: Optional[bool] = None,
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
    ) -> Generator[Tuple[np.ndarray, int, Dict[str, Any]], None, None]:
        """Streaming VoiceDesign: yields (audio_chunk, sample_rate, timing)."""
        self._voice_design_request(language)
        nsm = self._resolve_non_streaming_mode(non_streaming_mode, default=True)
        yield from self._generate_custom_streaming(
            text, language, None, instruct, nsm, max_new_tokens=max_new_tokens,
            min_new_tokens=min_new_tokens, temperature=temperature, top_k=top_k, top_p=top_p,
            do_sample=do_sample, repetition_penalty=repetition_penalty, chunk_size=chunk_size,
            first_chunk_size=first_chunk_size, seed=seed,
        )
