"""Talker prompt assembly: text, codec and speaker streams -> prefill
embeddings, on the host (`build`) or on the device (`build_device`).

Port of `PromptBuilder` of faster_qwen3_tts_tpu/prompt.py for the x-vector,
ICL, preset-speaker (CustomVoice) and speakerless (VoiceDesign) layouts. Per
batch item, with text-lane and codec-lane vectors summed position-wise:

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

`build` (every layout, any batch): embedding lookups run on the model's
device at bucketed lengths, the composition happens in host numpy, and the
finished prompt goes to the device once per request. Constant pieces (codec
control-id embeds, projected x-vectors) are cached per builder, and each
voice's ICL pieces in an LRU of 16.

`build_device` (one streaming request): the request's ids go up once and the
whole prompt is assembled on the device (`_assemble_streaming`), at the
exact prefill and trailing-text buckets the session replays, with no read to
the host; a voice's ICL block is computed on the device once
(`_icl_block`), and the device copies of the constants and of each codec
control block are cached (LRUs of 16). Positions come from index arithmetic
and clamped gathers, so a segment length may be a Python int or a device
scalar; lane sums are taken in float32 in `build`'s order and rounded once
to the parameter dtype, so on one device the result equals `build` plus
the session's padding bit for bit, wherever the text projection gives the
same bits at both row counts (it projects the request's ids at 256 or more
rows, `build` at `_bucket(L)` rows and the instruction apart).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from faster_qwen3_tts_tpu_torch.config import Qwen3TTSConfig

from .engine import generate as gen_lib
from .models import predictor as predictor_lib
from .models import talker as talker_lib

_REF_PROMPT_CACHE_MAX = 16  # voices (and codec control blocks) whose prompt pieces stay cached
_CODEC_BLOCK_ROWS = 8  # a codec control block padded to this many rows on the device (k <= 7)


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _take(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of `src` at `idx`, clamped into range (the JAX `jnp.take` of a
    clipped index)."""
    return src[idx.clamp(0, src.shape[0] - 1)]


def _assemble_streaming(
    tparams,
    ids: torch.Tensor,  # [1, Lb] int64: [instruct ids | request ids | 0-pad]
    i_len,  # instruct token count (0 when absent)
    l_len,  # request token count (role + text + suffix)
    k,  # codec control block rows
    icl_len,  # ICL block rows (Tc + 1; 0 when not ICL)
    codec_emb: torch.Tensor,  # [8, H] f32: the padded codec control block
    specials: torch.Tensor,  # [3, H] f32: (tts_pad, tts_bos, tts_eos)
    icl_block: Optional[torch.Tensor],  # [Rb, H] f32: the voice's ICL block (icl only)
    pb: int,  # prefill bucket
    tb: int,  # trailing-text bucket
    icl: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The streaming prompt of one request, assembled on the device: the
    counterpart of the JAX `_assemble_streaming_jit`.

    Layout as `PromptBuilder.build`, right-aligned at `pb`:
    [pad... | instruct | role (3) | text lane + codec block (k - 1) | the
    first-token row, or the ICL block], and the trailing text hiddens
    [text tokens fed per step, eos, pad...] at `tb`. Each position selects
    its segment's row (`torch.where`), so no sum is taken over padding.
    Returns (tie [1, pb, H], mask [1, pb] int32, tth [1, tb, H]), tie and tth
    in the parameter dtype."""
    full = talker_lib.text_hidden(tparams, ids).float()[0]  # [Lb, H]
    pad_e, bos_e, eos_e = specials[0], specials[1], specials[2]
    device = full.device

    P = i_len + k + ((2 + icl_len) if icl else 3)  # the item's rows
    j = torch.arange(pb, device=device)
    jp = j - (pb - P)  # position within the item; negative = left padding

    # segment 1: the instruct and the role header, a copy of full[0 : i_len + 3]
    seg1 = (jp >= 0) & (jp < i_len + 3)
    part1 = _take(full, jp)
    # segment 2: the codec control block under the (pad ... pad, bos) text lane
    m = jp - (i_len + 3)
    seg2 = (m >= 0) & (m < k - 1)
    part2 = torch.where((m == k - 2)[:, None], bos_e, pad_e) + _take(codec_emb, m)
    if icl:  # segment 3: the voice's ICL block (reference text lane + bos / frame lane)
        r = jp - (i_len + k + 2)
        seg3 = (r >= 0) & (r < icl_len)
        part3 = _take(icl_block, r)
    else:  # segment 3: the single (first text token + codec_bos) row
        seg3 = jp == (i_len + k + 2)
        part3 = _take(full, jp - (k - 1)) + _take(codec_emb, m)  # rows i_len + 3 and k - 1 there
    tie = torch.where(seg1[:, None], part1,
                      torch.where(seg2[:, None], part2, torch.where(seg3[:, None], part3, 0.0)))
    mask = (j >= (pb - P)).to(torch.int32)

    # trailing text: non-ICL streaming feeds text[1:] (the first token sits in
    # the prompt), ICL the whole text; then eos, then pad
    start = i_len + (3 if icl else 4)
    n_text = l_len - (8 if icl else 9)
    t = torch.arange(tb, device=device)
    tth = torch.where((t < n_text)[:, None], _take(full, start + t),
                      torch.where((t == n_text)[:, None], eos_e, pad_e))
    dt = tparams["codec_embed"].dtype
    return tie[None].to(dt), mask[None], tth[None].to(dt)


def _icl_block(
    tparams,
    pparams,
    rid: torch.Tensor,  # [1, RLb] int64: reference text ids (the [3:-2] slice), 0-padded
    rlen,  # reference text tokens
    codes: torch.Tensor,  # [1, Cb, 16] int64: reference frames, 0-padded
    tc_len,  # reference frames Tc
    consts: torch.Tensor,  # [2, H] f32: (codec_bos embed, tts_pad embed)
    rb: int,  # the block's bucket (>= Tc + 1)
) -> torch.Tensor:
    """A voice's ICL block [rb, H] f32 on the device, the counterpart of the
    JAX `_icl_block_jit`: row m = (reference text hidden m if m < min(rlen,
    Tc + 1), else tts_pad) + (codec_bos if m == 0, else frame embed m - 1),
    the frame embed being the talker's codebook-0 embedding plus the
    predictor's sum over codebooks 1-15 (`_frame_embeds`)."""
    rth = talker_lib.text_hidden(tparams, rid).float()[0]  # [RLb, H]
    cb0 = talker_lib.embed_codec(tparams, codes[0, :, 0])  # [Cb, H]
    rest = predictor_lib.embed_frame_sum(pparams, codes[0, :, 1:])
    fe = (cb0 + rest.to(cb0.dtype)).float()
    bos_e, pad_e = consts[0], consts[1]
    m = torch.arange(rb, device=rth.device)
    lane = torch.where(((m < rlen) & (m < tc_len + 1))[:, None], _take(rth, m), pad_e)
    codec_lane = torch.where((m == 0)[:, None], bos_e, _take(fe, m - 1))
    return lane + codec_lane


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
        # build_device: device copies of the constants, kept across requests
        self._specials_device: Optional[torch.Tensor] = None  # [3, H] f32 (pad, bos, eos)
        self._codec_block_cache: "OrderedDict[bytes, torch.Tensor]" = OrderedDict()
        self._icl_block_cache: "OrderedDict[tuple, Tuple[torch.Tensor, int]]" = OrderedDict()

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

    # -- device assembly (one streaming request) ----------------------------------------------

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the builder's device; on the card through pinned
        memory, queued without waiting for the device."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _specials_dev(self) -> torch.Tensor:
        """(tts_pad, tts_bos, tts_eos) [3, H] f32 on the device, made once."""
        if self._specials_device is None:
            sp = self.specials()
            self._specials_device = self._upload(np.stack([sp["pad"], sp["bos"], sp["eos"]]).astype(np.float32))
        return self._specials_device

    @staticmethod
    def _lru_put(cache: OrderedDict, key, value) -> None:
        cache[key] = value
        if len(cache) > _REF_PROMPT_CACHE_MAX:
            cache.popitem(last=False)

    def _codec_block_dev(self, codec_emb: np.ndarray) -> torch.Tensor:
        """A codec control block [k, H] padded to [8, H] f32 on the device,
        once per distinct (language, speaker or voice): an LRU of 16."""
        key = codec_emb.tobytes()
        hit = self._codec_block_cache.get(key)
        if hit is not None:
            self._codec_block_cache.move_to_end(key)
            return hit
        padded = np.zeros((_CODEC_BLOCK_ROWS, self._h()), np.float32)
        padded[: codec_emb.shape[0]] = codec_emb
        hit = self._upload(padded)
        self._lru_put(self._codec_block_cache, key, hit)
        return hit

    def _icl_block_device(self, rid: np.ndarray, ref_code: np.ndarray) -> Tuple[torch.Tensor, int]:
        """A voice's ICL block on the device and its rows (Tc + 1), computed
        once per voice with no read to the host (`_icl_block`): an LRU of 16,
        the device analog of `_ref_prompt`'s cache."""
        rid = np.asarray(rid)
        ref_code = np.asarray(ref_code, np.int32)
        key = (rid.tobytes(), rid.shape, ref_code.tobytes(), ref_code.shape)
        hit = self._icl_block_cache.get(key)
        if hit is not None:
            self._icl_block_cache.move_to_end(key)
            return hit
        Tc = ref_code.shape[0]
        ref_part = rid[:, 3:-2]
        rlen = ref_part.shape[1]
        rid_padded = np.zeros((1, _bucket(max(rlen, 1))), np.int64)
        rid_padded[0, :rlen] = ref_part[0]
        codes = np.zeros((1, _bucket(max(Tc, 1)), ref_code.shape[1]), np.int64)
        codes[0, :Tc] = ref_code
        consts = np.stack([self._codec_embed([self.cfg.talker.codec_bos_id])[0], self.specials()["pad"]])
        block = _icl_block(self.params["talker"], self.params["predictor"], self._upload(rid_padded), rlen,
                           self._upload(codes), Tc, self._upload(consts.astype(np.float32)), _bucket(Tc + 1))
        hit = (block, Tc + 1)
        self._lru_put(self._icl_block_cache, key, hit)
        return hit

    def build_device(
        self,
        input_ids: List[np.ndarray],
        ref_ids: List[Optional[np.ndarray]],
        voice_clone_prompt: Optional[Dict[str, Any]],
        languages: List[str],
        speakers: Optional[List[Optional[str]]],
        instruct_ids: Optional[List[Optional[np.ndarray]]],
        max_seq_len: int,
    ) -> Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, np.ndarray]]:
        """The streaming prompt of one request, assembled on the device.

        Returns (tie [1, pb, H], mask [1, pb] int32, tth [1, tb, H], tpe
        [1, 1, H]): the first three device tensors at the exact buckets
        `prefill_bucket` and `tth_bucket` pick (a `GenerationSession` passes
        them through with no pad, cast or upload), tie and tth in the
        parameter dtype, tpe the host f32 pad embedding. The request's ids
        (the instruct's first) go up once, in one bucket of at least 256,
        `max(256, _bucket(I + L))`. Returns None for a batch of more than one
        request (the lockstep batch pads prompts in host numpy)."""
        if len(input_ids) != 1:
            return None
        ids = np.asarray(input_ids[0]).reshape(1, -1)
        L = ids.shape[1]
        iid = instruct_ids[0] if instruct_ids else None
        iarr = np.zeros((1, 0), np.int64) if iid is None else np.asarray(iid).reshape(1, -1)
        I = iarr.shape[1]
        speaker = speakers[0] if speakers else None
        codec_emb = self._item_codec_block(0, languages[0], speaker, voice_clone_prompt)
        k = codec_emb.shape[0]
        icl = (voice_clone_prompt is not None and voice_clone_prompt.get("ref_code") is not None
               and voice_clone_prompt["icl_mode"][0] and voice_clone_prompt["ref_code"][0] is not None)
        icl_block, icl_len = (self._icl_block_device(ref_ids[0], voice_clone_prompt["ref_code"][0]) if icl
                              else (None, 0))
        combined = np.zeros((1, max(256, _bucket(I + L))), np.int64)
        combined[0, :I] = iarr[0]
        combined[0, I:I + L] = ids[0]
        pb = gen_lib.prefill_bucket(I + k + ((2 + icl_len) if icl else 3), max_seq_len)
        tb = gen_lib.tth_bucket(L - (8 if icl else 9) + 1)
        tie, mask, tth = _assemble_streaming(
            self.params["talker"], self._upload(combined), I, L, k, icl_len, self._codec_block_dev(codec_emb),
            self._specials_dev(), icl_block, pb, tb, icl)
        return tie, mask, tth, self.specials()["pad"][None, None, :]
