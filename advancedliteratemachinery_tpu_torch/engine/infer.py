"""Batched MGP-STR inference (port of
`advancedliteratemachinery_tpu/engine/infer.py` `MGPSTRInference`).

On the device: normalize → forward → greedy ids and cumulative confidence
per head. With `fused_decode="auto"` a head goes through the fused vocab
kernel (`ops/vocab_decode.py`), so that its [B, T, V] logits never reach
memory, wherever `supports_fused_decode` passes: on the card in bf16, the
BPE and WordPiece heads. Every other head, and every head under
`fused_decode="never"`, is decoded in plain tensor code from its logits.
On the host: id → string decode and the fusion that picks the most
confident head.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Tuple, Union

import numpy as np
import torch

from advancedliteratemachinery_tpu_torch.codecs.char_codec import CharCodec
from advancedliteratemachinery_tpu_torch.core.device import resolve_device
from advancedliteratemachinery_tpu_torch.models.layers import linear
from advancedliteratemachinery_tpu_torch.ops.image import normalize_crops
from advancedliteratemachinery_tpu_torch.ops.vocab_decode import (
    matmul_greedy_decode, supports_fused_decode)

# per-head EOS ids (char [s]=1, GPT-2 BPE eos=2 in the MGP-STR layout,
# BERT [SEP]=102)
EOS_IDS = {"char": 1, "bpe": 2, "wp": 102}


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
                conf = self._conf_from_pmax(ids, pmax, EOS_IDS[head])
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
        return pred, MGPSTRInference._conf_from_pmax(pred, pmax,
                                                     EOS_IDS[head])

    @staticmethod
    def _conf_from_pmax(pred: torch.Tensor, pmax: torch.Tensor, eos_id: int
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

    def run(self, images_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        """uint8 [B, 32, 128, 3] tensor on the device → device tensors."""
        return self._decode_all(normalize_crops(images_u8, self.input_dtype))

    def __call__(self, images_u8) -> Dict[str, np.ndarray]:
        """images_u8: [B, 32, 128, 3] uint8 (numpy or tensor) → dict of
        numpy arrays."""
        x = torch.as_tensor(np.asarray(images_u8)).to(self.device)
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
