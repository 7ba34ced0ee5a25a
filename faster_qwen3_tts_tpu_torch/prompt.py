"""Talker prompt assembly (host path): text, codec and speaker streams ->
prefill embeddings.

Port of `PromptBuilder.build` of faster_qwen3_tts_tpu/prompt.py for the
x-vector, ICL, preset-speaker (CustomVoice) and speakerless (VoiceDesign)
layouts. Per batch item, with text-lane and codec-lane vectors summed
position-wise:

    [instruct hiddens (optional)] [role hiddens (3)]
    [tts_pad x (k-2), tts_bos] + [codec think/language prefix, speaker, codec_pad]

The speaker slot holds a projected x-vector, the codec embedding of a preset
speaker's id, or nothing (VoiceDesign). A dialect speaker (`spk_is_dialect`)
asked for Chinese or Auto gets its dialect's language id in the prefix.
    then, for an ICL item, the reference block
          [ref text hiddens, then tts_pad] + [codec_bos, ref frame embeds (R)]
    then  streaming, x-vector: [first text token + codec_bos]  (trailing = text[1:] + eos)
          streaming, ICL:      nothing                        (trailing = text + eos)
          non-streaming: [(text + eos) + codec_pad ..., tts_pad + codec_bos]
                                                              (trailing = tts_pad)

Embedding lookups run on the model's device at bucketed lengths; the
composition happens in host numpy and the finished prompt goes to the device
once per request. Constant pieces (codec control-id embeds, projected
x-vectors) are cached per builder, and each voice's ICL pieces in an LRU of
16. This host build is the port's only builder (the JAX package's
`build_device` is not ported).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from faster_qwen3_tts_tpu.config import Qwen3TTSConfig

from .models import predictor as predictor_lib
from .models import talker as talker_lib

_REF_PROMPT_CACHE_MAX = 16  # voices whose ICL prompt pieces stay cached


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class PromptBuilder:
    """Builds (talker_input_embeds, attention_mask, trailing_text_hiddens,
    tts_pad_embed) for a batch of requests."""

    def __init__(self, params: Dict[str, Any], cfg: Qwen3TTSConfig):
        self.params = params
        self.cfg = cfg
        self.device = params["talker"]["codec_embed"].device
        self._specials: Optional[Dict[str, np.ndarray]] = None
        self._codec_embed_cache: Dict[tuple, np.ndarray] = {}
        self._xvec_cache: Dict[bytes, np.ndarray] = {}
        self._ref_prompt_cache: "OrderedDict[tuple, Tuple[np.ndarray, np.ndarray]]" = OrderedDict()

    def _h(self) -> int:
        return self.cfg.talker.hidden_size

    def _text_hidden(self, ids: np.ndarray) -> np.ndarray:
        """ids [1, L] -> projected hiddens [L, H] (numpy f32)."""
        L = ids.shape[1]
        if L == 0:
            return np.zeros((0, self._h()), np.float32)
        padded = np.zeros((1, _bucket(L)), np.int64)
        padded[:, :L] = ids
        out = talker_lib.text_hidden(self.params["talker"], torch.as_tensor(padded, device=self.device))
        return out.float().cpu().numpy()[0, :L]

    def _codec_embed(self, ids: Sequence[int]) -> np.ndarray:
        key = tuple(int(i) for i in np.asarray(ids).reshape(-1))
        hit = self._codec_embed_cache.get(key)
        if hit is None:
            idx = torch.as_tensor(key, dtype=torch.long, device=self.device)
            hit = talker_lib.embed_codec(self.params["talker"], idx).float().cpu().numpy()
            self._codec_embed_cache[key] = hit
        return hit

    def specials(self) -> Dict[str, np.ndarray]:
        """Projected tts_bos / tts_eos / tts_pad text embeddings, cached."""
        if self._specials is None:
            c = self.cfg
            ids = np.array([[c.tts_bos_token_id, c.tts_eos_token_id, c.tts_pad_token_id]])
            h = self._text_hidden(ids)
            self._specials = {"bos": h[0], "eos": h[1], "pad": h[2]}
        return self._specials

    def speaker_embed_from_xvector(self, xvec: np.ndarray) -> np.ndarray:
        """2048-d x-vector -> talker hidden, cached per x-vector."""
        key = np.ascontiguousarray(xvec, np.float32).tobytes()
        hit = self._xvec_cache.get(key)
        if hit is None:
            x = torch.as_tensor(np.asarray(xvec, np.float32).reshape(1, -1), device=self.device)
            hit = talker_lib.speaker_project(self.params["talker"], x).float().cpu().numpy()[0]
            self._xvec_cache[key] = hit
        return hit

    def _frame_embeds(self, codes: np.ndarray) -> np.ndarray:
        """Reference frames [T, 16] -> [T, H] f32: the talker's codebook-0
        embedding plus the predictor's sum over codebooks 1-15, the input the
        decode loop builds for every generated frame."""
        T = codes.shape[0]
        padded = np.zeros((_bucket(T), codes.shape[1]), np.int64)
        padded[:T] = codes
        idx = torch.as_tensor(padded, device=self.device)
        cb0 = talker_lib.embed_codec(self.params["talker"], idx[:, 0])
        rest = predictor_lib.embed_frame_sum(self.params["predictor"], idx[:, 1:])
        return (cb0 + rest.to(cb0.dtype)).float().cpu().numpy()[:T]

    def _ref_prompt(self, rid: np.ndarray, ref_code: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(reference-text hiddens, reference-frame embeds) of one voice,
        LRU-cached: repeat requests for a voice skip both device passes."""
        key = (rid.tobytes(), rid.shape, ref_code.tobytes(), ref_code.shape)
        hit = self._ref_prompt_cache.get(key)
        if hit is not None:
            self._ref_prompt_cache.move_to_end(key)
            return hit
        hit = (self._text_hidden(rid[:, 3:-2]), self._frame_embeds(ref_code))
        self._ref_prompt_cache[key] = hit
        if len(self._ref_prompt_cache) > _REF_PROMPT_CACHE_MAX:
            self._ref_prompt_cache.popitem(last=False)
        return hit

    def _item_codec_block(self, index: int, language: Optional[str], speaker: Optional[str],
                          voice_clone_prompt: Optional[Dict[str, Any]]) -> np.ndarray:
        """One item's codec control block [k, H] f32: think/language prefix,
        the speaker embedding (x-vector and ICL prompts, or a preset
        speaker), then (codec_pad, codec_bos)."""
        tc = self.cfg.talker
        speaker_embed = None
        if voice_clone_prompt is not None:
            if voice_clone_prompt["x_vector_only_mode"][index] or voice_clone_prompt["icl_mode"][index]:
                xv = np.asarray(voice_clone_prompt["ref_spk_embedding"][index], np.float32)
                # a vector of the talker width is taken as an already-projected embedding
                speaker_embed = (xv if xv.ndim == 1 and xv.shape[0] == self._h()
                                 else self.speaker_embed_from_xvector(xv))
        elif speaker:  # a preset (CustomVoice) speaker: the codec embedding of its id
            if speaker.lower() not in tc.spk_id:
                raise NotImplementedError(f"Speaker {speaker} not implemented")
            speaker_embed = self._codec_embed([tc.spk_id[speaker.lower()]])[0]

        if language is None:
            raise ValueError("language is required")
        lang_key = language.lower()
        if lang_key == "auto":
            language_id = None
        elif lang_key in tc.codec_language_id:
            language_id = tc.codec_language_id[lang_key]
        else:
            raise NotImplementedError(f"Language {language} not implemented")
        # a dialect speaker speaks its dialect when the language is Chinese or Auto
        dialect = tc.spk_is_dialect.get(speaker.lower()) if speaker else None
        if lang_key in ("chinese", "auto") and dialect:
            language_id = tc.codec_language_id[dialect]
        if language_id is None:
            prefix_ids = [tc.codec_nothink_id, tc.codec_think_bos_id, tc.codec_think_eos_id]
        else:
            prefix_ids = [tc.codec_think_id, tc.codec_think_bos_id, language_id, tc.codec_think_eos_id]
        codec_seq = [self._codec_embed(prefix_ids)]
        if speaker_embed is not None:
            codec_seq.append(speaker_embed.reshape(1, -1))
        codec_seq.append(self._codec_embed([tc.codec_pad_id, tc.codec_bos_id]))
        return np.concatenate(codec_seq, axis=0)

    def build(
        self,
        input_ids: List[np.ndarray],
        ref_ids: List[Optional[np.ndarray]],
        voice_clone_prompt: Optional[Dict[str, Any]],
        languages: List[str],
        speakers: Optional[List[Optional[str]]],
        non_streaming_mode: bool,
        instruct_ids: Optional[List[Optional[np.ndarray]]] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Returns (tie [B, P, H], attn_mask [B, P], tth [B, T, H], tpe [1, 1, H]),
        numpy f32, left-padded across the batch. `voice_clone_prompt` holds
        per-item lists (ref_spk_embedding, x_vector_only_mode, icl_mode,
        ref_code); `ref_ids` the reference-text ids of each ICL item."""
        tc = self.cfg.talker
        sp = self.specials()
        tts_bos, tts_eos, tts_pad = sp["bos"], sp["eos"], sp["pad"]
        n = len(input_ids)
        speakers = speakers if speakers is not None else [None] * n
        instruct_ids = instruct_ids if instruct_ids is not None else [None] * n

        embeds_per_item, trailing_per_item = [], []
        for index, (ids, language, speaker) in enumerate(zip(input_ids, languages, speakers)):
            parts: List[np.ndarray] = []
            if instruct_ids[index] is not None:  # the instruction turn goes first
                parts.append(self._text_hidden(np.asarray(instruct_ids[index]).reshape(1, -1)))
            codec_emb = self._item_codec_block(index, language, speaker, voice_clone_prompt)
            full_h = self._text_hidden(np.asarray(ids).reshape(1, -1))
            k = codec_emb.shape[0]
            text_lane = np.concatenate([np.tile(tts_pad[None, :], (k - 2, 1)), tts_bos[None, :]], axis=0)
            item = parts + [full_h[:3], text_lane + codec_emb[:-1]]
            text_hiddens = full_h[3:-5]
            icl = (voice_clone_prompt is not None and voice_clone_prompt.get("ref_code") is not None
                   and voice_clone_prompt["icl_mode"][index]
                   and voice_clone_prompt["ref_code"][index] is not None)
            if icl:
                ref_text_h, frame_embs = self._ref_prompt(
                    np.asarray(ref_ids[index]), np.asarray(voice_clone_prompt["ref_code"][index], np.int32))
                Tc = frame_embs.shape[0]
                # text lane across the ICL block: the reference text, then tts_pad
                lane = np.tile(tts_pad[None, :], (Tc + 1, 1))
                m = min(ref_text_h.shape[0], Tc + 1)
                lane[:m] = ref_text_h[:m]
                item.append(lane + np.concatenate([self._codec_embed([tc.codec_bos_id]), frame_embs], axis=0))
            if non_streaming_mode:
                pad_codec = self._codec_embed([tc.codec_pad_id])[0]
                block = np.concatenate([text_hiddens, tts_eos[None, :]], axis=0) + pad_codec
                tail = (tts_pad + self._codec_embed([tc.codec_bos_id])[0])[None, :]
                item.extend([block, tail])
                trailing = tts_pad[None, :]
            elif icl:  # the whole text is step-fed
                trailing = np.concatenate([text_hiddens, tts_eos[None, :]], axis=0)
            else:  # the first text token sits in the prompt
                item.append(full_h[3:4] + codec_emb[-1:])
                trailing = np.concatenate([full_h[4:-5], tts_eos[None, :]], axis=0)
            embeds_per_item.append(np.concatenate(item, axis=0))
            trailing_per_item.append(trailing)

        H = self._h()
        max_len = max(e.shape[0] for e in embeds_per_item)
        tie = np.zeros((n, max_len, H), np.float32)
        mask = np.zeros((n, max_len), np.int32)
        for b, e in enumerate(embeds_per_item):
            tie[b, max_len - e.shape[0]:] = e
            mask[b, max_len - e.shape[0]:] = 1
        max_t = max(t.shape[0] for t in trailing_per_item)
        tth = np.tile(tts_pad[None, None, :], (n, max_t, 1))
        for b, t in enumerate(trailing_per_item):
            tth[b, : t.shape[0]] = t
        return tie, mask, tth, tts_pad[None, None, :]
