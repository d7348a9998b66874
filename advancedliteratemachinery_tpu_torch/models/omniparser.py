"""OmniParser: unified text spotting + KIE as point-conditioned sequence
decoding (port of `advancedliteratemachinery_tpu/models/omniparser.py`;
reference OCR/OmniParser).

- Swin-B → FPN (fpn.py: laterals + nearest upsample, concat 4 maps at the
  c3 scale → 1024ch) → 1x1 stride-2 input_proj → d_model memory
  (omniparser.py:7-31).
- DETR-style pre-norm decoder (transformer.py:430 forward_pre), 4 layers,
  d_model 512, 8 heads, ffn 2048.
- Shared token embedding + per-task position embeddings with embedding
  LayerNorm (transformer.py:283-328 DecoderEmbeddings).
- 3-stage greedy decode (transformer.py:102, :254-289): point seq
  (parity-masked bins/eos) → per-point polygon seq (bins only) → per-point
  content seq (char vocab only), each stage KV-cached: a prefill of the
  prompt, then one step per token.

Arithmetic follows the JAX modules: attention scores in the compute dtype,
divided by √hd there, masks at NEG = -1e9 cast to it, softmax in float32,
cast back before P·V; LayerNorms in float32 with flax's epsilon; the token
and position embeddings stay float32, so the decoder's residual stream is
float32 and each Linear rounds its input to the compute dtype; the heads
return float32. Encoder memory of batch 1 is shared by a batch of queries
through broadcasting matmuls, never copied. Argmax takes the first index on
ties, as `jnp.argmax`. Submodules carry the flax names, so
`engine/convert.py` maps a flax tree onto them. Inference only:
`omniparser_loss` and training are not ported yet, and the configs hold
no dropout or stochastic-depth rate.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from advancedliteratemachinery_tpu_torch.codecs.coords import CoordSeqVocab
from advancedliteratemachinery_tpu_torch.core.device import resolve_device
from advancedliteratemachinery_tpu_torch.core.precision import (
    DEFAULT_POLICY, Policy)
from advancedliteratemachinery_tpu_torch.core.registry import MODELS
from advancedliteratemachinery_tpu_torch.models.layers import (
    LN_EPS, init_params, layer_norm, linear)
from advancedliteratemachinery_tpu_torch.models.swin import (
    SWIN_VARIANTS, SwinConfig, SwinTransformer, resize_nearest)

NEG = -1e9
# `_greedy` with an eos_id reads "has every row finished?" on the host once
# every this many steps (each read waits for the device); the steps it runs
# past the last EOS leave the JAX while-loop's defaults behind
EOS_CHECK_EVERY = 8


def sine_position_embedding(mask: torch.Tensor, dim: int,
                            temperature: float = 10000.0) -> torch.Tensor:
    """DETR sine embedding from a validity mask [B, H, W] → [B, H, W, dim]
    (reference model/backbone/position_embedding.py): sin and cos
    interleaved, [pos_y, pos_x]."""
    y_embed = torch.cumsum(mask, dim=1)
    x_embed = torch.cumsum(mask, dim=2)
    eps = 1e-6
    scale = 2 * math.pi
    y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale
    half = dim // 2
    dim_t = temperature ** (2 * (torch.arange(half, device=mask.device) // 2)
                            / half)
    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    pos_x = torch.stack([torch.sin(pos_x[..., 0::2]),
                         torch.cos(pos_x[..., 1::2])],
                        dim=-1).reshape(*mask.shape, half)
    pos_y = torch.stack([torch.sin(pos_y[..., 0::2]),
                         torch.cos(pos_y[..., 1::2])],
                        dim=-1).reshape(*mask.shape, half)
    return torch.cat([pos_y, pos_x], dim=-1)


class FPN(nn.Module):
    """1x1 laterals + top-down nearest, concat at c3 scale (fpn.py:12);
    `lat0` reads c5, `lat3` c2."""

    def __init__(self, in_dims: Tuple[int, ...], out_dim: int = 256,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        for i in range(4):
            self.add_module(f"lat{i}", nn.Linear(in_dims[3 - i], out_dim))

    def forward(self, feats: List[torch.Tensor]) -> torch.Tensor:
        c = self.policy.compute_dtype
        c2, c3, c4, c5 = feats

        def lat(i, x):
            return linear(x, getattr(self, f"lat{i}"), c)

        p5 = lat(0, c5)
        p4 = lat(1, c4) + resize_nearest(p5, c4.shape[1:3])
        p3 = lat(2, c3) + resize_nearest(p4, c3.shape[1:3])
        p2 = lat(3, c2) + resize_nearest(p3, c2.shape[1:3])

        def bil_to(x):
            # half-pixel bilinear, no antialias on the downscale (fpn.py:
            # 40-42 resizes p2 down to c3), as jax.image.resize with
            # antialias=False
            return F.interpolate(x.permute(0, 3, 1, 2), size=c3.shape[1:3],
                                 mode="bilinear", align_corners=False
                                 ).permute(0, 2, 3, 1)

        return torch.cat([bil_to(p2), p3, bil_to(p4), bil_to(p5)], dim=-1)


@dataclasses.dataclass(frozen=True)
class OmniParserConfig:
    swin_variant: str = "base"
    d_model: int = 512
    nhead: int = 8
    dec_layers: int = 4
    dim_feedforward: int = 2048
    max_position_embeddings: int = 1024
    num_bins: int = 1000
    chars: str = ""                  # default → CoordSeqVocab default charset
    vie_categories: int = 0
    use_char_window_prompt: bool = True
    pt_seq_length: int = 1024
    poly_length: int = 32
    rec_length: int = 25
    max_instances: int = 128
    # explicit backbone override (None → the named swin_variant)
    swin: Optional[SwinConfig] = None

    def vocab(self) -> CoordSeqVocab:
        kw = dict(num_bins=self.num_bins, vie_categories=self.vie_categories)
        if self.chars:
            kw["chars"] = self.chars
        return CoordSeqVocab(**kw)

    def swin_config(self) -> SwinConfig:
        return self.swin if self.swin is not None else SWIN_VARIANTS[
            self.swin_variant]


class DecoderLayer(nn.Module):
    """Pre-norm DETR decoder layer with KV caching (transformer.py:430
    forward_pre). `prefill` returns the self-attention cache [B, L, H, hd]
    padded to L; `step` and `step_ragged` write it in place and return it."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.d_model = d_model
        self.nhead = nhead
        for name in ("sa_q", "sa_k", "sa_v", "sa_out", "ca_q", "ca_k",
                     "ca_v", "ca_out"):
            self.add_module(name, nn.Linear(d_model, d_model))
        self.ff1 = nn.Linear(d_model, dim_feedforward)
        self.ff2 = nn.Linear(dim_feedforward, d_model)
        for name in ("norm1", "norm2", "norm3"):
            self.add_module(name, nn.LayerNorm(d_model, eps=LN_EPS))

    def _lin(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return linear(x, getattr(self, name), self.policy.compute_dtype)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        return x.reshape(B, T, self.nhead, C // self.nhead)

    def _attn(self, q, k, v, bias=None):
        """k/v may have batch 1 while q has batch B (shared encoder memory
        for instance-batched decode): the matmuls then broadcast it without
        making B copies of K/V."""
        hd = q.shape[-1]
        shared = k.shape[0] == 1 and q.shape[0] != 1
        if shared:
            s = torch.einsum("bqhd,khd->bhqk", q, k[0]) / (hd ** 0.5)
        else:
            s = torch.einsum("bqhd,bkhd->bhqk", q, k) / (hd ** 0.5)
        if bias is not None:
            s = s + bias.to(s.dtype)
        a = torch.softmax(s.float(), -1).to(q.dtype)
        if shared:
            o = torch.einsum("bhqk,khd->bqhd", a, v[0])
        else:
            o = torch.einsum("bhqk,bkhd->bqhd", a, v)
        B, T = q.shape[0], q.shape[1]
        return o.reshape(B, T, self.d_model)

    def _self_qkv(self, tgt, query_pos):
        h = layer_norm(tgt, self.norm1, self.policy.compute_dtype)
        qk_in = h + query_pos
        return (self._heads(self._lin("sa_q", qk_in)),
                self._heads(self._lin("sa_k", qk_in)),
                self._heads(self._lin("sa_v", h)))

    def _cross_ffn(self, tgt, query_pos, mem_k, mem_v, mem_bias):
        c = self.policy.compute_dtype
        h = layer_norm(tgt, self.norm2, c)
        q = self._heads(self._lin("ca_q", h + query_pos))
        tgt = tgt + self._lin("ca_out", self._attn(q, mem_k, mem_v, mem_bias))
        h = layer_norm(tgt, self.norm3, c)
        return tgt + self._lin("ff2", F.relu(self._lin("ff1", h)))

    @staticmethod
    def _causal_bias(T: int, device) -> torch.Tensor:
        cm = torch.tril(torch.ones((T, T), dtype=torch.bool, device=device))
        return torch.where(cm, 0.0, NEG)[None, None]

    def forward(self, tgt, query_pos, memory, mem_pos, mem_valid):
        """Teacher-forced causal full-sequence pass. tgt [B,T,C]; memory
        [Bm,S,C] (Bm == B or 1, broadcast); mem_valid [Bm,S]."""
        B, T, _ = tgt.shape
        q, k, v = self._self_qkv(tgt, query_pos)
        tgt = tgt + self._lin("sa_out", self._attn(
            q, k, v, self._causal_bias(T, tgt.device)))

        if memory.shape[0] == 1 and B != 1:
            memory = memory.expand(B, *memory.shape[1:])
            mem_pos = mem_pos.expand(B, *mem_pos.shape[1:])
            mem_valid = mem_valid.expand(B, *mem_valid.shape[1:])
        mem_k, mem_v = self.mem_kv(memory, mem_pos)
        bias = torch.where(mem_valid[:, None, None, :] > 0, 0.0, NEG)
        return self._cross_ffn(tgt, query_pos, mem_k, mem_v, bias)

    def prefill(self, tgt, query_pos, mem_k, mem_v, mem_bias, cache_len: int):
        """Causal pass over the prompt that also returns the self-attention
        cache padded to cache_len. Returns (out, (k_cache, v_cache))."""
        T = tgt.shape[1]
        q, k, v = self._self_qkv(tgt, query_pos)
        tgt = tgt + self._lin("sa_out", self._attn(
            q, k, v, self._causal_bias(T, tgt.device)))
        pad = (0, 0, 0, 0, 0, cache_len - T)
        caches = (F.pad(k, pad), F.pad(v, pad))
        return self._cross_ffn(tgt, query_pos, mem_k, mem_v, mem_bias), caches

    def step(self, tgt_t, query_pos_t, caches, pos_idx: int, mem_k, mem_v,
             mem_bias):
        """One incremental decode step. tgt_t [B,1,C]; caches (k,v)
        [B,L,H,hd], written in place at `pos_idx`, the current absolute
        position."""
        k_cache, v_cache = caches
        q, k_t, v_t = self._self_qkv(tgt_t, query_pos_t)
        k_cache[:, pos_idx] = k_t[:, 0]
        v_cache[:, pos_idx] = v_t[:, 0]
        L = k_cache.shape[1]
        valid = torch.arange(L, device=tgt_t.device) <= pos_idx
        bias = torch.where(valid, 0.0, NEG)[None, None, None, :]
        tgt_t = tgt_t + self._lin("sa_out",
                                  self._attn(q, k_cache, v_cache, bias))
        return self._cross_ffn(tgt_t, query_pos_t, mem_k, mem_v,
                               mem_bias), caches

    def step_ragged(self, tgt_t, query_pos_t, caches, pos_vec, mem_k, mem_v,
                    mem_bias):
        """Like step, but every batch row sits at its own absolute position
        (pos_vec [B]): the primitive for cross-request continuous batching,
        where slots in one device batch decode different requests."""
        k_cache, v_cache = caches
        B = tgt_t.shape[0]
        q, k_t, v_t = self._self_qkv(tgt_t, query_pos_t)
        rows = torch.arange(B, device=tgt_t.device)
        k_cache[rows, pos_vec] = k_t[:, 0]
        v_cache[rows, pos_vec] = v_t[:, 0]
        L = k_cache.shape[1]
        valid = torch.arange(L, device=tgt_t.device)[None] <= pos_vec[:, None]
        bias = torch.where(valid[:, None, None, :], 0.0, NEG)
        tgt_t = tgt_t + self._lin("sa_out",
                                  self._attn(q, k_cache, v_cache, bias))
        return self._cross_ffn(tgt_t, query_pos_t, mem_k, mem_v,
                               mem_bias), caches

    def mem_kv(self, memory, mem_pos):
        return (self._heads(self._lin("ca_k", memory + mem_pos)),
                self._heads(self._lin("ca_v", memory)))


class SeqDecoder(nn.Module):
    """One task decoder: N pre-norm layers + final norm + 3-layer MLP head
    (transformer.py:340 TransformerDecoder + MLP pred layer)."""

    def __init__(self, cfg: OmniParserConfig, num_classes: int,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.layers = []
        for i in range(cfg.dec_layers):
            layer = DecoderLayer(cfg.d_model, cfg.nhead, cfg.dim_feedforward,
                                 policy)
            self.add_module(f"layer_{i}", layer)
            self.layers.append(layer)
        self.final_norm = nn.LayerNorm(cfg.d_model, eps=LN_EPS)
        self.head1 = nn.Linear(cfg.d_model, cfg.d_model)
        self.head2 = nn.Linear(cfg.d_model, cfg.d_model)
        self.head3 = nn.Linear(cfg.d_model, num_classes)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        c = self.policy.compute_dtype
        x = layer_norm(x, self.final_norm, x.dtype)
        h = F.relu(linear(x, self.head1, c))
        h = F.relu(linear(h, self.head2, c))
        return linear(h, self.head3, c).float()

    def forward(self, tgt, query_pos, memory, mem_pos, mem_valid):
        for layer in self.layers:
            tgt = layer(tgt, query_pos, memory, mem_pos, mem_valid)
        return self._head(tgt)

    def prefill(self, tgt, query_pos, mem_kvs, mem_bias, cache_len: int):
        caches = []
        for layer, (mk, mv) in zip(self.layers, mem_kvs):
            tgt, cache = layer.prefill(tgt, query_pos, mk, mv, mem_bias,
                                       cache_len)
            caches.append(cache)
        return self._head(tgt), tuple(caches)

    def step(self, tgt_t, query_pos_t, caches, pos_idx: int, mem_kvs,
             mem_bias):
        for layer, cache, (mk, mv) in zip(self.layers, caches, mem_kvs):
            tgt_t, _ = layer.step(tgt_t, query_pos_t, cache, pos_idx, mk, mv,
                                  mem_bias)
        return self._head(tgt_t), caches

    def step_ragged(self, tgt_t, query_pos_t, caches, pos_vec, mem_kvs,
                    mem_bias):
        """Per-row-position incremental step (see DecoderLayer.step_ragged)."""
        for layer, cache, (mk, mv) in zip(self.layers, caches, mem_kvs):
            tgt_t, _ = layer.step_ragged(tgt_t, query_pos_t, cache, pos_vec,
                                         mk, mv, mem_bias)
        return self._head(tgt_t), caches

    def mem_kvs(self, memory, mem_pos):
        return tuple(layer.mem_kv(memory, mem_pos) for layer in self.layers)


class TokenEmbedding(nn.Module):
    """Shared word embedding + per-task positions + LN
    (transformer.py:283 DecoderEmbeddings), all float32."""

    def __init__(self, cfg: OmniParserConfig, num_classes: int):
        super().__init__()
        self.word = nn.Embedding(num_classes, cfg.d_model)
        for t in ("pt", "poly", "rec"):
            self.add_module(f"{t}_pos", nn.Embedding(
                cfg.max_position_embeddings, cfg.d_model))
        self.ln = nn.LayerNorm(cfg.d_model, eps=LN_EPS)

    def _embed(self, ids, pe):
        we = self.word(ids.long())
        return layer_norm(we + pe, self.ln, we.dtype), pe

    def _pos(self, task: str, positions: torch.Tensor) -> torch.Tensor:
        """The task's position rows; NaN past the table, as flax's `Embed`
        (`jnp.take`, mode "fill") gives there: a decode that runs past
        max_position_embeddings (a prompt of 7 and 1024 pt steps) reads no
        memory out of bounds."""
        table = getattr(self, f"{task}_pos").weight
        n = table.shape[0]
        pe = table[positions.long().clamp(max=n - 1)]
        return torch.where((positions < n)[..., None], pe, float("nan"))

    def forward(self, ids: torch.Tensor, task: str, pos_offset: int = 0):
        """ids [B,T] → (embeddings [B,T,C], query_pos [B,T,C])."""
        positions = torch.arange(ids.shape[1], device=ids.device) + pos_offset
        emb, pe = self._embed(ids, self._pos(task, positions)[None])
        return emb, pe.expand_as(emb).to(emb.dtype)

    def embed_at(self, ids_t: torch.Tensor, task: str,
                 positions: torch.Tensor):
        """Single-token embed with a per-row position (ids_t [B,1],
        positions [B]) for ragged continuous decode."""
        emb, pe = self._embed(ids_t, self._pos(task, positions)[:, None])
        return emb, pe.to(emb.dtype)


@MODELS.register("omniparser")
class OmniParser(nn.Module):
    """Swin + FPN encoder, the token embedding and the three task decoders.
    Built on `device` (the GPU unless `device="cpu"`) with random weights
    from `seed` (flax's default init), in eval mode; load real weights with
    `engine.checkpoint.import_omniparser` or `engine.convert`."""

    def __init__(self, config: OmniParserConfig = OmniParserConfig(),
                 policy: Policy = DEFAULT_POLICY,
                 device: Union[str, torch.device, None] = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        c = self.config = config
        self.policy = policy
        self.vocab_layout = c.vocab()
        nc = self.vocab_layout.num_classes
        swin_cfg = c.swin_config()
        self.backbone = SwinTransformer(swin_cfg, policy)
        self.fpn = FPN(swin_cfg.stage_dims, 256, policy)
        self.input_proj = nn.Conv2d(4 * 256, c.d_model, 1, stride=2)
        self.embedding = TokenEmbedding(c, nc)
        self.pt_decoder = SeqDecoder(c, nc, policy)
        self.poly_decoder = SeqDecoder(c, nc, policy)
        self.rec_decoder = SeqDecoder(c, nc, policy)
        gen = torch.Generator().manual_seed(seed)
        init_params(self, gen)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.startswith("embedding.") and not name.startswith(
                        "embedding.ln"):
                    nn.init.normal_(p, 0.0, p.shape[1] ** -0.5,
                                    generator=gen)
                elif name.endswith("relative_position_bias_table"):
                    nn.init.trunc_normal_(p, 0.0, 0.02, -0.04, 0.04,
                                          generator=gen)
        self.to(device).eval()

    def encode(self, images: torch.Tensor,
               mask: Optional[torch.Tensor] = None):
        """images [B, H, W, 3] → (memory [B,S,C], mem_pos [B,S,C],
        mem_valid [B,S])."""
        c = self.policy.compute_dtype
        feats, masks = self.backbone(images, mask)
        src = self.fpn(feats)                       # c3 scale, 1024ch
        ip = self.input_proj                        # stride 2 → c4 scale
        src = F.conv2d(src.to(c).permute(0, 3, 1, 2), ip.weight.to(c),
                       ip.bias.to(c), stride=ip.stride).permute(0, 2, 3, 1)
        fmask = masks[1][:, ::2, ::2]               # c3/2 == c4 scale
        fmask = fmask[:, :src.shape[1], :src.shape[2]]
        pos = sine_position_embedding(fmask, self.config.d_model)
        B, H, W, C = src.shape
        return (src.reshape(B, H * W, C),
                pos.reshape(B, H * W, C).to(src.dtype),
                fmask.reshape(B, H * W))

    def forward(self, images: torch.Tensor,
                input_seqs: Dict[str, torch.Tensor],
                mask: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """Teacher-forced forward. input_seqs: {"pt" [B,Tp], "poly" [B,Ty],
        "rec" [B,Tr]} → logits dict (float32)."""
        memory, mem_pos, mem_valid = self.encode(images, mask)
        out = {}
        for task in ("pt", "poly", "rec"):
            emb, qpos = self.embedding(input_seqs[task], task)
            out[task] = getattr(self, f"{task}_decoder")(
                emb, qpos, memory, mem_pos, mem_valid)
        return out

    # ----- greedy KV-cached decode (eval) -----

    def _greedy(self, dec: SeqDecoder, task: str, prompt_ids, memory,
                mem_pos, mem_valid, steps: int,
                mask_fn: Callable[[int, torch.Tensor], torch.Tensor],
                eos_id: Optional[int] = None):
        """prompt_ids [B,P]; mask_fn(step_i, logits) → masked logits.
        Returns (tokens [B,steps], probs [B,steps], finished_before
        [B,steps]).

        With an eos_id the decode stops once every row has emitted EOS;
        the host reads that every EOS_CHECK_EVERY steps. Steps the JAX
        while-loop never runs keep its buffer defaults: token =
        padding_index, finished_before = True, prob = 0; the steps run
        here past the last EOS write exactly those values. Without an
        eos_id every step runs, as the JAX scan."""
        v = self.vocab_layout
        B, P = prompt_ids.shape
        dev = prompt_ids.device
        mem_kvs = dec.mem_kvs(memory, mem_pos)
        # memory batch may be 1 while B = max_instances — _attn broadcasts
        mem_bias = torch.where(mem_valid[:, None, None, :] > 0, 0.0, NEG)

        emb, qpos = self.embedding(prompt_ids, task)
        logits, caches = dec.prefill(emb, qpos, mem_kvs, mem_bias, P + steps)
        last = logits[:, -1]
        toks = torch.full((B, steps), v.padding_index, dtype=torch.int32,
                          device=dev)
        probs = torch.zeros((B, steps), dtype=last.dtype, device=dev)
        fin = torch.ones((B, steps), dtype=torch.bool, device=dev)
        finished = torch.zeros((B,), dtype=torch.bool, device=dev)
        for i in range(steps):
            if (eos_id is not None and i % EOS_CHECK_EVERY == 0 and i > 0
                    and bool(finished.all())):
                break
            ml = mask_fn(i, last)
            tok = torch.argmax(ml, dim=-1).to(torch.int32)
            tokp = torch.softmax(ml, dim=-1).gather(1, tok[:, None].long())[
                :, 0]
            was_finished = finished
            if eos_id is not None:
                finished = finished | (tok == eos_id)
                # a step after every row finished is one JAX never ran
                tokp = torch.where(was_finished.all(), 0.0, tokp)
            out_tok = torch.where(was_finished, v.padding_index, tok)
            toks[:, i] = out_tok
            probs[:, i] = tokp
            fin[:, i] = was_finished
            emb_t, qpos_t = self.embedding(out_tok[:, None], task,
                                           pos_offset=P + i)
            step_logits, caches = dec.step(emb_t, qpos_t, caches, P + i,
                                           mem_kvs, mem_bias)
            last = step_logits[:, 0]
        return toks, probs, fin

    def _masked(self, allow: torch.Tensor) -> Callable:
        """mask_fn for a fixed [V] allow mask."""
        return lambda i, logits: torch.where(allow[None], logits, NEG)

    def _decode_pt(self, memory, mem_pos, mem_valid, period: int,
                   allow_at: Tuple[torch.Tensor, ...]):
        """The point sequence (B=1), with allow_at[i % period] the classes
        step i may emit."""
        c, v = self.config, self.vocab_layout
        prompt = torch.as_tensor(v.pt_prompt(c.use_char_window_prompt),
                                 device=memory.device)[None]
        return self._greedy(
            self.pt_decoder, "pt", prompt, memory, mem_pos, mem_valid,
            c.pt_seq_length,
            lambda i, logits: torch.where(allow_at[i % period][None], logits,
                                          NEG),
            eos_id=v.pt_eos_index)

    def _instances(self, pt_toks, pt_fin, period: int):
        """The pt tokens before EOS ([Lp] bool), `at(src, j, fill)`: per
        instance the entry of `src` at offset j of its group of `period`
        tokens (`fill` past the last instance), and the instance validity
        [max_instances]."""
        c, v = self.config, self.vocab_layout
        valid_tok = (~pt_fin[0]) & (pt_toks[0] != v.pt_eos_index)
        n_tok = valid_tok.sum()
        n_inst = torch.clamp(n_tok // period, max=c.max_instances)
        idx = torch.arange(c.max_instances, device=pt_toks.device)
        inst_valid = idx < n_inst
        last = c.pt_seq_length - 1

        def at(src, j, fill):
            return torch.where(inst_valid,
                               src[0, torch.clamp(idx * period + j, max=last)],
                               fill)
        return valid_tok, at, inst_valid

    def _allow(self, ids_pred) -> torch.Tensor:
        ids = torch.arange(self.vocab_layout.num_classes,
                           device=self.input_proj.weight.device)
        return ids_pred(ids)

    def infer_spotting(self, images: torch.Tensor,
                       mask: Optional[torch.Tensor] = None
                       ) -> Dict[str, torch.Tensor]:
        """Full spotting inference (B=1): pt seq → per-point polygons +
        recs. Returns fixed-shape tensors + validity masks (the host
        detokenizes, `eval.spotting_eval.decode_spotting_outputs`)."""
        c, v = self.config, self.vocab_layout
        memory, mem_pos, mem_valid = self.encode(images, mask)
        coord = self._allow(lambda ids: ids < c.num_bins)
        eos = self._allow(lambda ids: ids == v.pt_eos_index)
        pt_toks, pt_probs, pt_fin = self._decode_pt(
            memory, mem_pos, mem_valid, 2, (coord | eos, coord))
        # points: pairs of coordinate tokens before EOS
        valid_tok, at, inst_valid = self._instances(pt_toks, pt_fin, 2)
        pairs = torch.stack([at(pt_toks, 0, 0), at(pt_toks, 1, 0)], dim=1)
        poly, rec = self._decode_poly_rec(pairs, memory, mem_pos, mem_valid)
        return {
            "pt_tokens": pt_toks, "pt_valid": valid_tok[None],
            "points": pairs[None], "instance_valid": inst_valid[None],
            "polygons": poly[0][None], "poly_probs": poly[1][None],
            "rec_tokens": rec[0][None], "rec_probs": rec[1][None],
        }

    def _decode_poly_rec(self, pairs, memory, mem_pos, mem_valid):
        """Per-point polygon + content decode, batched over max_instances
        (the reference loops per point, transformer.py:153-190; here all
        instances share one KV-cached decode). pairs [N,2] bin tokens."""
        c, v = self.config, self.vocab_layout
        N = c.max_instances

        def prompt(sos):
            return torch.cat([pairs.to(torch.int32), torch.full(
                (N, 1), sos, dtype=torch.int32, device=pairs.device)], dim=1)

        # the VIE branch's logits[:-vie_categories] slice is subsumed by the
        # bins-only mask
        poly_toks, poly_probs, _ = self._greedy(
            self.poly_decoder, "poly", prompt(v.poly_sos_index), memory,
            mem_pos, mem_valid, c.poly_length,
            self._masked(self._allow(lambda ids: ids < c.num_bins)))
        # `ids <= rec_eos_index` also excludes the trailing VIE categories
        rec_allow = self._allow(lambda ids: (
            (ids >= c.num_bins) & (ids <= v.rec_eos_index)
            & (ids != v.pt_eos_index) & (ids != v.poly_eos_index)))
        rec_toks, rec_probs, _ = self._greedy(
            self.rec_decoder, "rec", prompt(v.rec_sos_index), memory,
            mem_pos, mem_valid, c.rec_length, self._masked(rec_allow))
        return (poly_toks, poly_probs), (rec_toks, rec_probs)

    def infer_vie(self, images: torch.Tensor,
                  mask: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
        """KIE/VIE inference (B=1). The pt decode emits strict (x, y, class)
        triplets — the reference's period-3 masking (transformer.py:116-124:
        step%3==0 coordinate-or-EOS, ==1 coordinate, ==2 one of the trailing
        vie_categories class tokens) — then every point gets a batched
        polygon + content decode (decode_vie_pt_poly_rec_seq,
        transformer.py:143-215). `eval.spotting_eval.decode_vie_outputs`
        assembles host-side entities."""
        c, v = self.config, self.vocab_layout
        if c.vie_categories <= 0:
            raise ValueError("infer_vie requires vie_categories > 0")
        cls_base = v.num_classes - c.vie_categories
        memory, mem_pos, mem_valid = self.encode(images, mask)
        coord = self._allow(lambda ids: ids < c.num_bins)
        eos = self._allow(lambda ids: ids == v.pt_eos_index)
        cls = self._allow(lambda ids: ids >= cls_base)
        pt_toks, pt_probs, pt_fin = self._decode_pt(
            memory, mem_pos, mem_valid, 3, (coord | eos, coord, cls))
        # triplets (x, y, class) before EOS; masking guarantees the layout
        valid_tok, at, inst_valid = self._instances(pt_toks, pt_fin, 3)
        pairs = torch.stack([at(pt_toks, 0, 0), at(pt_toks, 1, 0)], dim=1)
        classes = at(pt_toks, 2, cls_base)
        class_probs = at(pt_probs, 2, 0.0)
        poly, rec = self._decode_poly_rec(pairs, memory, mem_pos, mem_valid)
        return {
            "pt_tokens": pt_toks, "pt_valid": valid_tok[None],
            "points": pairs[None], "instance_valid": inst_valid[None],
            "classes": classes[None], "class_probs": class_probs[None],
            "polygons": poly[0][None], "poly_probs": poly[1][None],
            "rec_tokens": rec[0][None], "rec_probs": rec[1][None],
        }
