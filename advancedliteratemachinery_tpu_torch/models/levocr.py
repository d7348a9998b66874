"""LevOCR inference: scene-text recognition as iterative Levenshtein
refinement (port of `advancedliteratemachinery_tpu/models/levocr.py`;
reference OCR/LevOCR).

- The ABINet vision branch (`models/abinet.py`) predicts a first text and
  a feature map; two 2x2 convs (stride (2, 1) padding (0, 1), then stride
  1 padding 0) turn its 8x32x512 map into 96 image tokens (models.py:160).
- LevT (levt/levenshtein_transformer.py): a text stack (:387, BERT-style
  embeddings and self-attention layers over the tokens) and a fusion stack
  (:540: text features + positions + type 0, beside the projected image
  tokens + positions + type 1) with three heads: mask-ins (paired features
  → 256 counts, :622), word-ins (the tied output projection, :639) and
  word-del (binary, :653).
- `refine` (forward_decoder :245, eval.py:139): max_iter + 1 rounds of
  delete (p(del) > 0.5) → insert placeholders → fill words, starting from
  the vision prediction, on fixed [B, L] buffers with the masked edit ops
  of `ops/levenshtein.py`: no host sync and no data-dependent shape.

The fairseq dictionary order is kept (bos 0, pad 1, eos 2, unk 3). Each
attention layer rounds as the JAX einsum: Q·Kᵀ in the compute dtype,
divided by √hd there, pads at -1e9, softmax in float32, cast back. Argmax
takes the first index on ties, as `jnp.argmax`. Submodules carry the flax
names, so `engine/convert.py` maps a flax tree onto them. Training
(`levt_losses`, `text_forward`) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from advancedliteratemachinery_tpu_torch.core.device import resolve_device
from advancedliteratemachinery_tpu_torch.core.precision import (
    DEFAULT_POLICY, Policy)
from advancedliteratemachinery_tpu_torch.core.registry import CODECS, MODELS
from advancedliteratemachinery_tpu_torch.models.abinet import (
    ABINetVision, ABINetVisionConfig, ConvBN)
from advancedliteratemachinery_tpu_torch.models.layers import (
    LN_EPS, init_params, layer_norm, linear)
from advancedliteratemachinery_tpu_torch.ops.levenshtein import (
    apply_del_words, apply_ins_masks, apply_ins_words)

BOS, PAD, EOS, UNK = 0, 1, 2, 3  # fairseq Dictionary order
IMG_TOKENS = 96                  # 3 x 32 from an 8x32 map
MASK_INS_CLASSES = 256


@CODECS.register("levt_dict")
class LevtDictionary:
    """fairseq-convention dictionary over a charset (levt/dictionary.py)."""

    def __init__(self, charset: str = "abcdefghijklmnopqrstuvwxyz0123456789",
                 max_len: int = 28):
        self.itos = ["<s>", "<pad>", "</s>", "<unk>"] + list(charset)
        self.stoi = {c: i for i, c in enumerate(self.itos)}
        self.max_len = max_len  # includes bos/eos

    def __len__(self):
        return len(self.itos)

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        out = np.full((len(texts), self.max_len), PAD, np.int32)
        for i, t in enumerate(texts):
            seq = ([BOS] + [self.stoi.get(c, UNK) for c in t][: self.max_len
                                                              - 2] + [EOS])
            out[i, : len(seq)] = seq
        return out

    def decode(self, ids: np.ndarray) -> List[str]:
        texts = []
        for row in np.asarray(ids):
            chars = []
            for i in row:
                i = int(i)
                if i == EOS:
                    break
                if i in (BOS, PAD, UNK):
                    continue
                chars.append(self.itos[i])
            texts.append("".join(chars))
        return texts


@dataclasses.dataclass(frozen=True)
class LevOCRConfig:
    charset: str = "abcdefghijklmnopqrstuvwxyz0123456789"
    max_len: int = 28             # bos + 26 + eos (embed_len_text)
    d_model: int = 512
    heads: int = 8
    ffn: int = 2048
    layers: int = 6               # decoder_layers (utils.py:165)
    max_iter: int = 2             # utils.py:187
    del_threshold: float = 0.5    # utils.py:189 --th
    vision: ABINetVisionConfig = ABINetVisionConfig()

    @property
    def vocab_size(self) -> int:
        return 4 + len(self.charset)


class PostNormSelfAttnLayer(nn.Module):
    """fairseq TransformerDecoderLayer without cross-attention, post-norm;
    `pad_mask` is True at padded keys."""

    def __init__(self, dim: int, heads: int, ffn: int,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.heads = heads
        for name in ("q", "k", "v", "out"):
            setattr(self, name, nn.Linear(dim, dim))
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ff1 = nn.Linear(dim, ffn)
        self.ff2 = nn.Linear(ffn, dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.policy.compute_dtype
        B, T, C = x.shape
        hd = C // self.heads
        q, k, v = (linear(x, getattr(self, n), c).view(B, T, self.heads, hd)
                   for n in ("q", "k", "v"))
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / hd ** 0.5
        if pad_mask is not None:
            s = s.masked_fill(pad_mask[:, None, None, :], -1e9)
        a = torch.softmax(s.float(), dim=-1).to(c)
        o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, T, C)
        x = layer_norm(x + linear(o, self.out, c), self.norm1, c)
        h = linear(F.relu(linear(x, self.ff1, c)), self.ff2, c)
        return layer_norm(x + h, self.norm2, c)


class LevtTextEncoder(nn.Module):
    """Token stack: BERT-style embeddings and self-attention layers over
    the tokens, pads masked (levenshtein_transformer.py:387)."""

    def __init__(self, cfg: LevOCRConfig, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.word_emb = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.pos_emb = nn.Embedding(cfg.max_len, cfg.d_model)
        self.emb_ln = nn.LayerNorm(cfg.d_model, eps=LN_EPS)
        self.layers = []
        for i in range(cfg.layers):
            layer = PostNormSelfAttnLayer(cfg.d_model, cfg.heads, cfg.ffn,
                                          policy)
            setattr(self, f"layer_{i}", layer)
            self.layers.append(layer)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, T] int32 → [B, T, d] in the compute dtype."""
        c = self.policy.compute_dtype
        T = tokens.shape[1]
        emb = self.word_emb(tokens.long()).float() + \
            self.pos_emb.weight[:T].float()
        x = layer_norm(emb, self.emb_ln, c)
        pad_mask = tokens == PAD
        for layer in self.layers:
            x = layer(x, pad_mask)
        return x


class LevtFusionDecoder(nn.Module):
    """The multimodal stack and its three heads
    (levenshtein_transformer.py:540). Each head runs the stack once on
    the text features beside the image tokens."""

    def __init__(self, cfg: LevOCRConfig, img_dim: int,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        d = cfg.d_model
        self.word_emb_out = nn.Embedding(cfg.vocab_size, d)  # tied out proj
        self.mask_ins_emb = nn.Embedding(MASK_INS_CLASSES, 2 * d)
        self.word_del_emb = nn.Embedding(2, d)
        self.type_emb = nn.Embedding(2, d)
        self.img_proj = nn.Linear(img_dim, d, bias=False)
        self.text_pos = nn.Parameter(torch.zeros(1, cfg.max_len, d))
        self.img_pos = nn.Parameter(torch.zeros(1, IMG_TOKENS, d))
        self.layers = []
        for i in range(cfg.layers):
            layer = PostNormSelfAttnLayer(d, cfg.heads, cfg.ffn, policy)
            setattr(self, f"layer_{i}", layer)
            self.layers.append(layer)

    def fuse(self, text_feature: torch.Tensor,
             img_feature: torch.Tensor) -> torch.Tensor:
        c = text_feature.dtype
        T = text_feature.shape[1]
        t = (text_feature + self.text_pos[:, :T].to(c)
             + self.type_emb.weight[0].to(c))
        Ti = img_feature.shape[1]
        im = linear(img_feature, self.img_proj, self.policy.compute_dtype)
        im = im + self.img_pos[:, :Ti].to(im.dtype) + \
            self.type_emb.weight[1].to(im.dtype)
        x = torch.cat([t, im], dim=1)
        for layer in self.layers:
            x = layer(x)
        return x

    def _head(self, feats: torch.Tensor, table: nn.Embedding
              ) -> torch.Tensor:
        return torch.einsum("btc,vc->btv", feats,
                            table.weight.to(feats.dtype)).float()

    def mask_ins(self, text_feature, img_feature) -> torch.Tensor:
        feats = self.fuse(text_feature, img_feature)
        T = text_feature.shape[1]
        pair = torch.cat([feats[:, :T - 1], feats[:, 1:T]], dim=-1)
        return self._head(pair, self.mask_ins_emb)

    def word_ins(self, text_feature, img_feature) -> torch.Tensor:
        T = text_feature.shape[1]
        return self._head(self.fuse(text_feature, img_feature)[:, :T],
                          self.word_emb_out)

    def word_del(self, text_feature, img_feature) -> torch.Tensor:
        T = text_feature.shape[1]
        return self._head(self.fuse(text_feature, img_feature)[:, :T],
                          self.word_del_emb)


def first_argmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """`jnp.argmax`: the first index of the maximum, as int32."""
    return torch.argmax(x, dim=dim).to(torch.int32)


@MODELS.register("levocr")
class LevOCR(nn.Module):
    """The ABINet vision branch, the image-token convs and LevT. Built on
    `device` (the GPU unless `device="cpu"`) with random weights from
    `seed`, in eval mode; load real weights with
    `engine.checkpoint.import_levocr` or `engine.convert`."""

    def __init__(self, config: LevOCRConfig = LevOCRConfig(),
                 policy: Policy = DEFAULT_POLICY,
                 device: Union[str, torch.device, None] = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        self.policy = policy
        self.vision = ABINetVision(cfg.vision, policy, device, seed)
        vdim = cfg.vision.d_model
        self.img_conv1 = ConvBN(vdim, vdim, (2, 2), (2, 1), padding=(0, 1),
                                policy=policy)
        self.img_conv2 = ConvBN(vdim, vdim, (2, 2), (1, 1), padding=(0, 0),
                                policy=policy)
        self.text_encoder = LevtTextEncoder(cfg, policy)
        self.decoder = LevtFusionDecoder(cfg, vdim, policy)
        gen = torch.Generator().manual_seed(seed + 1)
        for part in (self.img_conv1, self.img_conv2, self.text_encoder,
                     self.decoder):
            init_params(part, gen)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("emb.weight") or name.endswith(
                        "emb_out.weight"):
                    nn.init.normal_(p, 0.0, p.shape[1] ** -0.5,
                                    generator=gen)
                elif name.endswith(("text_pos", "img_pos")):
                    nn.init.trunc_normal_(p, 0.0, 0.02, -0.04, 0.04,
                                          generator=gen)
        self.to(device).eval()

    def extract_img_feature(self, fmap: torch.Tensor) -> torch.Tensor:
        """NHWC [B, 8, 32, E] → [B, 96, E] in H-major order
        (models.py:160), as the JAX reshape of its NHWC map."""
        x = self.img_conv2(self.img_conv1(fmap.permute(0, 3, 1, 2)))
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, x.shape[1])

    def encode_image(self, images: torch.Tensor):
        out = self.vision(images)
        return out, self.extract_img_feature(out["features"])

    def forward(self, images: torch.Tensor, noised_tokens: torch.Tensor,
                masked_tgt_tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The heads forward of the JAX `__call__` in eval mode, with no
        word predictions: vision logits, and the mask-ins and word-del
        logits on the noised tokens, the word-ins logits on the masked
        target."""
        out, img = self.encode_image(images)
        dec, enc = self.decoder, self.text_encoder
        noised = enc(noised_tokens)
        return {
            "vision_logits": out["logits"],
            "mask_ins_logits": dec.mask_ins(noised, img),
            "word_ins_logits": dec.word_ins(enc(masked_tgt_tokens), img),
            "word_del_logits": dec.word_del(noised, img)}

    def vision_tokens(self, logits: torch.Tensor) -> torch.Tensor:
        """Vision logits [B, Tv, classes] → LevT tokens [B, L]: bos, the
        characters before the first null (charset id c → c + 3), eos,
        pads."""
        L = self.config.max_len
        vis_ids = first_argmax(logits)                       # [B, Tv]
        B, Tv = vis_ids.shape
        is_null = vis_ids == 0
        first_null = first_argmax(is_null.to(torch.int32), dim=1)
        length = torch.where(is_null.any(1), first_null, Tv).clamp(max=L - 2)
        pos = torch.arange(L, device=logits.device)[None, :]
        padded = F.pad(vis_ids, (0, L))[:, :L]
        char_pos = pos - 1
        char_ids = padded.gather(1, char_pos.clamp(0, L - 1).expand(B, L)) + 3
        tokens = torch.where(pos == 0, BOS, PAD).to(torch.int32).expand(
            B, L)
        in_char = (char_pos >= 0) & (char_pos < length[:, None])
        tokens = torch.where(in_char, char_ids, tokens)
        return torch.where(pos == length[:, None] + 1, EOS, tokens)

    def delete(self, tokens: torch.Tensor, scores: torch.Tensor,
               img: torch.Tensor):
        """Delete the tokens whose p(del) passes the threshold (bos/eos
        kept), on rows with more than 2 tokens; also returns p(del)."""
        dec, enc = self.decoder, self.text_encoder
        p_del = torch.softmax(dec.word_del(enc(tokens), img), -1)[..., 1]
        can = ((tokens != PAD).sum(1) > 2)[:, None]
        t2, s2 = apply_del_words(tokens, scores,
                                 p_del > self.config.del_threshold, PAD,
                                 BOS, EOS)
        return torch.where(can, t2, tokens), torch.where(can, s2, scores), \
            p_del

    def insert(self, tokens: torch.Tensor, scores: torch.Tensor,
               img: torch.Tensor):
        """Insert the predicted number of placeholders after each token, on
        rows shorter than the buffer; also returns the count logits."""
        dec, enc = self.decoder, self.text_encoder
        logits = dec.mask_ins(enc(tokens), img)
        can = ((tokens != PAD).sum(1) < self.config.max_len)[:, None]
        t2, s2 = apply_ins_masks(tokens, scores, first_argmax(logits), PAD,
                                 UNK)
        return torch.where(can, t2, tokens), torch.where(can, s2, scores), \
            logits

    def fill(self, tokens: torch.Tensor, scores: torch.Tensor,
             img: torch.Tensor):
        """Fill the placeholders with the most likely words and their log
        probabilities; also returns the log probabilities."""
        dec, enc = self.decoder, self.text_encoder
        logp = torch.log_softmax(dec.word_ins(enc(tokens), img), -1)
        score, _ = logp.max(-1)
        has_unk = (tokens == UNK).any(1, keepdim=True)
        t2, s2 = apply_ins_words(tokens, scores, first_argmax(logp), score,
                                 UNK)
        return (torch.where(has_unk, t2, tokens),
                torch.where(has_unk, s2, scores), logp)

    def one_round(self, tokens: torch.Tensor, scores: torch.Tensor,
                  img: torch.Tensor):
        """delete → insert placeholders → fill words, each masked per row
        (forward_decoder, levenshtein_transformer.py:245)."""
        for step in (self.delete, self.insert, self.fill):
            tokens, scores, _ = step(tokens, scores, img)
        return tokens, scores

    def refine(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Images NHWC → the vision prediction, then max_iter + 1 rounds of
        refinement: final tokens [B, L] int32 and their scores [B, L]
        float32, the vision tokens and logits."""
        out, img = self.encode_image(images)
        tokens = self.vision_tokens(out["logits"])
        vision_tokens = tokens
        scores = torch.zeros(tokens.shape, dtype=torch.float32,
                             device=tokens.device)
        for _ in range(self.config.max_iter + 1):
            tokens, scores = self.one_round(tokens, scores, img)
        return {"tokens": tokens, "scores": scores,
                "vision_tokens": vision_tokens,
                "vision_logits": out["logits"]}
