"""Batched MGP-STR, LISTER and LevOCR inference (port of
`advancedliteratemachinery_tpu/engine/infer.py` `MGPSTRInference`,
`LISTERInference` and `LevOCRInference`).

On the device: normalize → forward → greedy ids and cumulative confidence
per head. With `fused_decode="auto"` a head goes through the fused vocab
kernel (`ops/vocab_decode.py`), so that its [B, T, V] logits never reach
memory, wherever `supports_fused_decode` passes: on the card in bf16, the
BPE and WordPiece heads. Every other head, and every head under
`fused_decode="never"`, is decoded in plain tensor code from its logits.
On the host: id → string decode and the fusion that picks the most
confident head.

LISTER: on the device, normalize → an all-ones mask → the forward → greedy
ids (first on ties), max-prob and the cumulative confidence of the last
decode; on the host, `EosSeqCodec.decode`.

LevOCR: on the device, normalize (float32, the JAX engine's input dtype)
→ `LevOCR.refine` (vision prediction, then the fixed rounds of Levenshtein
refinement); on the host, `LevtDictionary.decode` and the confidence, exp
of the mean of the final scores with non-finite ones counted as 0, in
float64.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Tuple, Union

import numpy as np
import torch

from advancedliteratemachinery_tpu_torch.codecs.char_codec import CharCodec
from advancedliteratemachinery_tpu_torch.codecs.seq_codec import EosSeqCodec
from advancedliteratemachinery_tpu_torch.core.device import resolve_device
from advancedliteratemachinery_tpu_torch.models.layers import (
    cast_matmul_weights, linear)
from advancedliteratemachinery_tpu_torch.models.levocr import LevtDictionary
from advancedliteratemachinery_tpu_torch.ops.image import (
    as_device_tensor, normalize_crops)
from advancedliteratemachinery_tpu_torch.ops.vocab_decode import (
    matmul_greedy_decode, supports_fused_decode)

# per-head EOS ids (char [s]=1, GPT-2 BPE eos=2 in the MGP-STR layout,
# BERT [SEP]=102)
EOS_IDS = {"char": 1, "bpe": 2, "wp": 102}


def conf_from_pmax(pred: torch.Tensor, pmax: torch.Tensor, eos_id: int
                   ) -> torch.Tensor:
    """Cumulative max-prob confidence up to the first EOS; 0 when the
    sequence never emits EOS."""
    is_eos = pred == eos_id
    any_eos = is_eos.any(dim=1)
    eos_pos = is_eos.to(torch.int32).argmax(dim=1)       # first True
    pos = torch.arange(pred.shape[1], device=pred.device)[None, :]
    conf = torch.where(pos <= eos_pos[:, None], pmax,
                       torch.ones_like(pmax)).prod(dim=1)
    return torch.where(any_eos, conf, torch.zeros_like(conf))


class MGPSTRInference:
    """Greedy multi-granularity inference for MGP-STR.

    The engine keeps its own copy of `model`, on `device` (the GPU unless
    `device="cpu"`), with the inference policy — logits in the compute
    dtype and the unsafe-softmax attention — and every weight cast to the
    compute dtype once. `fused_decode` is the JAX engine's: "auto" fuses
    each head that `supports_fused_decode` admits, "never" none."""

    def __init__(self, model, codec: CharCodec, bpe_codec=None,
                 wp_codec=None, input_dtype: torch.dtype = torch.bfloat16,
                 device: Union[str, torch.device, None] = None,
                 fused_decode: str = "auto"):
        if fused_decode not in ("auto", "never"):
            raise ValueError(f"fused_decode must be 'auto' or 'never', got "
                             f"{fused_decode!r}")
        self.device = resolve_device(device)
        pol = dataclasses.replace(
            model.policy, output_dtype=model.policy.compute_dtype,
            unsafe_softmax=True)
        model = copy.deepcopy(model)
        for m in model.modules():
            if hasattr(m, "policy"):
                m.policy = pol
        self.model = model.to(self.device, pol.compute_dtype).eval()
        self.model.requires_grad_(False)
        self.codec = codec
        self.bpe_codec = bpe_codec
        self.wp_codec = wp_codec
        self.input_dtype = input_dtype
        cfg = model.config
        self.true_vocab = {"char": cfg.num_char_classes,
                           "bpe": cfg.bpe_vocab_size,
                           "wp": cfg.wp_vocab_size}
        self.heads = tuple(cfg.heads)
        dim = cfg.vit_config().embed_dim
        self.fused_heads = tuple(
            h for h in self.heads if fused_decode == "auto"
            and supports_fused_decode(dim,
                                      cfg.padded_vocab(self.true_vocab[h]),
                                      pol.compute_dtype, self.device))

    @torch.inference_mode()
    def _decode_all(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Normalized images → per-head (ids, conf) on the device. Shared by
        the batched engine and the end-to-end spotting path."""
        out = self.model(x, decode_tokens=bool(self.fused_heads))
        c = self.model.policy.compute_dtype
        res = {}
        for head in self.heads:
            hp = getattr(self.model, f"{head}_head")
            if head in self.fused_heads:
                tok = out[head][:, 1:, :]               # drop the [GO] slot
                B, T, D = tok.shape
                ids, pmax = matmul_greedy_decode(
                    tok.reshape(B * T, D).contiguous(), hp.weight, hp.bias,
                    self.true_vocab[head])
                ids, pmax = ids.reshape(B, T), pmax.reshape(B, T)
                conf = conf_from_pmax(ids, pmax, EOS_IDS[head])
            else:
                logits = out[head]
                if self.fused_heads:     # model returned tokens
                    logits = linear(logits, hp, c)
                ids, conf = self._head_decode(logits, head,
                                              self.true_vocab[head])
            res[f"{head}_ids"] = ids
            res[f"{head}_conf"] = conf
        return res

    @staticmethod
    def _head_decode(logits: torch.Tensor, head: str, true_vocab: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Greedy ids (positions 1:) + cumulative max-prob confidence up to
        the head's EOS; vocab-padding columns (≥ true_vocab) are masked."""
        if logits.shape[-1] > true_vocab:
            pad = torch.arange(logits.shape[-1],
                               device=logits.device) >= true_vocab
            logits = logits.masked_fill(pad, float("-inf"))
        logits = logits[:, 1:, :]
        pred = torch.argmax(logits, dim=-1).to(torch.int32)   # first max
        lf = logits.float()
        pmax = torch.exp(lf.amax(-1) - torch.logsumexp(lf, -1))
        return pred, conf_from_pmax(pred, pmax, EOS_IDS[head])

    def run(self, images_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        """uint8 [B, 32, 128, 3] tensor on the device → device tensors."""
        return self._decode_all(normalize_crops(images_u8, self.input_dtype))

    def __call__(self, images_u8) -> Dict[str, np.ndarray]:
        """images_u8: [B, 32, 128, 3] uint8 (numpy or tensor) → dict of
        numpy arrays."""
        x = as_device_tensor(images_u8, self.device)
        return {k: v.cpu().numpy() for k, v in self.run(x).items()}

    def recognize(self, images_u8):
        """Full fused recognition → list of (text, confidence, head)."""
        out = self(images_u8)
        char_strs = self.codec.decode(out["char_ids"])
        B = len(char_strs)
        bpe_strs = (self.bpe_codec.decode(out["bpe_ids"]) if self.bpe_codec
                    else [None] * B)
        wp_strs = [None] * B
        if self.wp_codec:
            wp_strs = [s.split("[SEP]")[0]
                       for s in self.wp_codec.decode(out["wp_ids"])]
        results = []
        for i in range(B):
            cands = [(char_strs[i].split("[s]")[0],
                      float(out["char_conf"][i]), "char")]
            if bpe_strs[i] is not None:
                cands.append((bpe_strs[i], float(out["bpe_conf"][i]), "bpe"))
            if wp_strs[i] is not None:
                cands.append((wp_strs[i], float(out["wp_conf"][i]), "wp"))
            results.append(max(cands, key=lambda c: c[1]))
        return results


class LISTERInference:
    """Batched LISTER recognition (the JAX `LISTERInference`; reference
    test.py:23). The engine keeps its own copy of `model` on `device` (the
    GPU unless `device="cpu"`) with every weight cast to the compute dtype
    once; it reads the last decode, the refined one when `iters > 0`."""

    def __init__(self, model, codec: EosSeqCodec = None,
                 input_dtype: torch.dtype = torch.bfloat16,
                 device: Union[str, torch.device, None] = None):
        self.device = resolve_device(device)
        model = copy.deepcopy(model)
        self.model = model.to(self.device, model.policy.compute_dtype).eval()
        self.model.requires_grad_(False)
        self.codec = codec or EosSeqCodec()
        self.input_dtype = input_dtype

    @torch.inference_mode()
    def run(self, images_u8: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """uint8 [B, 32, W, 3] tensor on the device → (ids [B, L] int32,
        conf [B]) on the device."""
        x = normalize_crops(images_u8, self.input_dtype)
        mask = torch.ones(x.shape[:3], dtype=x.dtype, device=x.device)
        logits = self.model(x, mask)[-1]["logits"].float()
        ids = torch.argmax(logits, dim=-1).to(torch.int32)
        pmax = torch.softmax(logits, dim=-1).amax(dim=-1)
        return ids, conf_from_pmax(ids, pmax, EosSeqCodec.EOS_ID)

    def recognize(self, images_u8):
        """uint8 crops (numpy or tensor) → list of (text, confidence,
        "lister")."""
        x = as_device_tensor(images_u8, self.device)
        ids, conf = self.run(x)
        texts = self.codec.decode(ids.cpu().numpy())
        return [(t, float(c), "lister") for t, c in zip(texts, conf.cpu())]


class LevOCRInference:
    """Batched LevOCR (the JAX `LevOCRInference`; reference eval.py:139
    generate loop): vision prediction and Levenshtein refinement on the
    device, strings through the fairseq-style dictionary on the host. The
    engine keeps its own copy of `model` on `device` (the GPU unless
    `device="cpu"`), with its Linear and conv weights cast to the compute
    dtype once. Crops are normalized in float32, the JAX engine's default
    `input_dtype`."""

    def __init__(self, model,
                 device: Union[str, torch.device, None] = None):
        self.device = resolve_device(device)
        self.model = cast_matmul_weights(
            copy.deepcopy(model).to(self.device).eval(),
            model.policy.compute_dtype)
        self.model.requires_grad_(False)
        self.dictionary = LevtDictionary(max_len=model.config.max_len)

    @torch.inference_mode()
    def run(self, images_u8: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """uint8 [B, 32, 128, 3] tensor on the device → (tokens [B, L]
        int32, scores [B, L] float32) on the device."""
        out = self.model.refine(normalize_crops(images_u8, torch.float32))
        return out["tokens"], out["scores"]

    def recognize(self, images_u8):
        """uint8 crops (numpy or tensor) → list of (text, confidence,
        "levocr")."""
        x = as_device_tensor(images_u8, self.device)
        tokens, scores = self.run(x)
        texts = self.dictionary.decode(tokens.cpu().numpy())
        s = scores.cpu().numpy().astype(np.float64)
        conf = np.exp(np.where(np.isfinite(s), s, 0.0).mean(axis=-1))
        return [(t, float(c), "levocr") for t, c in zip(texts, conf)]
