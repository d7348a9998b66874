"""Drive the PyTorch/H100 port (`advancedliteratemachinery_tpu_torch`) on one
CUDA card and check it.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. build the CUDA kernels from `advancedliteratemachinery_tpu_torch/csrc/`;
2. fused-qkv attention kernel against its plain version, at the recognizer's
   shapes (B=256 and 512, S=257, D=768, H=12, safe and unsafe) and at odd
   small shapes (S = 17, 64, 100, 700, and 1, 63, 65, 129, 257, 320, 768
   on either side of its 64-row tiles and 16-key short last chunk, safe
   and unsafe); two calls on the same input must give the same bits; K1
   and K5 timed at S=272 and S=273, which differ only in the form of the
   last key chunk (16 keys: the short form; 17: the full one);
3. vocab matmul + greedy decode kernel against its plain version, at the
   BPE (V=50304, true 50257) and WordPiece (V=30592, true 30522) heads for
   256 and 512 crops and at shapes off its tiles (a single row, M = 127,
   129, 300, true_vocab inside the last tile), with crafted rows whose
   maximum is an exact tie, within a tile, across tiles and across a
   chunk boundary;
4. recognition only: MGP-STR-base at full width and depth (D=768, 12
   layers) with seeded random weights, B=256 crops/s and B=1 latency, an
   encoder check against a float32 run on the CPU, and `recognize()`;
5. end-to-end spotting, the first slice's main path: P=8 uint8 pages of
   640² → DB → box extraction → crop_rects → MGP-STR-base → greedy decode,
   with the page copy to the card inside the timed loop, as `bench.py`'s
   spotting stage; extraction is checked against the CPU on one page, and a
   torch.profiler trace of three more steps gives device time by kernel and
   the device's idle share;
6. modulated deformable conv kernel against its plain version, at the
   seven layer shapes of LORE's DLA neck at B=8 and 768² pages, at odd
   shapes (pixels, Cin and Cout off every tile: Cin 5, 8, 40, 200, 512,
   Cout 7, 72, 100, 128, 200, 256, 300) and with offsets of ±40 px,
   samples wholly outside the image, a zero mask and offsets beyond ±3;
7. LORE-TSR table structure, the second slice's main path: the full
   `LoreConfig()` (DLA-34 + DCN neck, six heads, Processor 4+4 layers) in
   bf16 with seeded random weights and its offset/mask convs re-seeded away
   from zero, `LORE.infer` on B=8 f32 pages of 768² as `bench.py`'s
   lore_tsr stage; head maps of one 256² page are checked against a float32
   run of the same weights on the CPU, with stage times and a profile;
   then the f32 models: MGP-STR-base, `MGPSTRInference` and LORE's
   `DLASeg` under FP32_POLICY on the card, which no kernel takes, must
   launch nothing and agree with the same weights in f32 on the CPU;
8. fused-qkv attention backward kernel (K4) against its plain version at
   S = 1, 8, 16, 17, 63, 64, 65, 257, 272, 273, 320, 321, 700, 768 (both
   sides of its 64-row tiles and of its 16-row short last chunk) with
   H = 1, 3, 12, and at a scale that is no power of two; two calls on the
   same input must give the same bits, and both must lie within the
   plain-version bounds; timed at the train step's shape (B=128, S=257,
   H=12) and at B=16, S=768, beside the backward of
   `scaled_dot_product_attention`; then the K4 stress (`k4_repeats`):
   1,000 pairs at the train shape, each pair after nothing, another K4
   shape, K1 and K5, or another shape and a synchronize, beside a side
   stream of bf16 matmuls: no call may differ from the first in its bits,
   and the phase must take at most 15 s;
9. short-sequence MHA kernel (K5) on strided q/k/v views against its plain
   version at S = 17, 300, 1000, 257 (B=128) and 1024, and at S = 1, 64,
   65, 257, 513, 640, 1024 (both sides of its resident/streamed threshold)
   with q, k, v as views of one projection, as q plus views of a kv
   projection, and as [B, H, S, 64] tensors through `.transpose(1, 2)`;
   two calls on the same input must give the same bits;
10. MGP-STR-base training, the third slice's main path (`bench.py`'s
    train_bench setting: B=128, seeded uint8 crops and char/BPE/WordPiece
    ids, Adam at lr 1e-4 on a 1000-step cosine, clip 5.0, bf16 compute,
    f32 parameters): one step's gradients through K1/K4 against the same
    step with the attention swapped for the plain versions in f32, per
    parameter group; best of 3 repetitions of 10 steps of
    `make_mgp_str_train_step` (samples/s, the forward/backward/optimiser
    split, peak memory, model-FLOP utilisation, a profile); the loss must
    fall and stay finite;
11. `fit()` with `mgp_str_recipe_u8` on MGP-STR-base in a temporary
    directory: 4 steps saving every 2 and keeping 1; a restore of the last
    checkpoint equals the live state; a resume to step 6 against an
    uninterrupted 6-step run;
12. (right after the build) the golden replay: tests/golden/{mgp_str,
    lore,lister,levocr}.pth through the port's loader and importers into the
    port's models in f32 on the card, against the committed outputs at
    the golden tolerances, with no launch;
13. (after the f32 models) reference checkpoints at full width: a
    reference-layout MGP-STR-base state dict (timm keys, `module.`, heads
    of 38, 50257 and 30522) and a LORE pair (DLASeg at the full
    `LoreConfig()` and the Processor) written to a temporary directory,
    dropped from the page cache, loaded and imported, each timed (a
    user's cold start where the filesystem lets the cache go, with the
    share still cached beside it; the load is timed from the cache too);
    the imported LORE must equal the weights it was written from, the
    importers must leave no tensor unused, `MGPSTRInference` with the
    mini BPE and WordPiece codecs runs `recognize()` on 256 crops (12 K1
    + 2 K2 a forward, no padded id), and the imported LORE runs `infer`
    at B=8 x 768² (16 K3) and is checked against the CPU; a full-width
    reference-layout LevOCR state dict (`vision.*`, `conv4_*`/`bn4_*`,
    `levt.encoder.*`, `levt.decoder.*` with its tied embedding) goes the
    same way into `LevOCR` (an untied copy must be refused) and runs
    `recognize()` on 64 crops with no launch;
14. LISTER, the fourth path: `LISTERConfig()` (FocalNet-B) in bf16 with
    seeded weights, `LISTERInference` crops/s at B=256 and B=1 latency,
    logits against f32 on the CPU with iters 0 and 2, a profile; LISTER
    has no Pallas kernel, so it must launch none;
15. LevOCR, the fifth path: `LevOCRConfig()` (ABINet vision with
    ResNet45 to 512 channels; LevT d 512, 6 + 6 layers, 3 rounds) in bf16
    on f32 crops with seeded weights, `LevOCRInference` crops/s at B=256
    and B=1 latency, a profile; on 16 crops the bf16 vision logits against
    f32 on the CPU, and the f32 model on the card (TF32 off) against the
    CPU: vision logits and final tokens (a crop that differs is printed
    with its smallest decision margin); no port kernel may launch;
16. OmniParser, the sixth path: `OmniParserConfig()` (Swin-B + FPN,
    three 4-layer decoders, d 512, 1000 bins) in bf16 on 8 seeded 640²
    pages, made readable by `readable_omniparser` so that the pages stop
    after 4-60 points, at counts that differ, and some words end: the
    encode at B=1 and B=8, `infer_spotting` pages/s and latency at B=1 (+
    profile), `SpottingService` pages/s with 8 pages in flight and its
    slot occupancy, at 8 and at 32 pt slots, where every place its results
    leave infer_spotting's must be a choice between two classes within
    bf16's rounding; the f32 model on the card (TF32 off) against the CPU
    on page 0 (equal tokens; probabilities and teacher-forced logits) and
    its service against its infer_spotting on all 8 pages; bf16
    teacher-forced logits against the CPU's own bf16 error; no port kernel
    may launch. The golden replay and the reference checkpoints take
    `omniparser.pth` and a full-width OmniParser file too;
17. OmniParser's tasks (`omniparser_tasks`, after `omniparser`), the
    default config in bf16 with readable weights: `infer_vie` on CORD's
    categories at B=1 on the 8 pages (pages/s, p50/p99, the f32 model on
    the card against the CPU on page 0); the CLI's `table-eval` on 8
    seeded PNG tables labelled by their own decode (TEDS = S-TEDS = 1.0,
    a control with one cell's text changed a table below 1; stages by
    `StepTimer`) and `table-html` in a fresh process (cold start, equal
    to its in-process decode); `SpottingService(encode_batch=1,
    mem_len=...)` on 640², 480x640 and 512² pages at once (f32 equal to
    `infer_spotting` a page, bf16 parting only within bf16's rounding; a
    704x640 page refused); LISTER's baseline heads at B=256 on LISTER-B's
    feature map; `models --cost mgp_str --variant base`;
18. the document pipelines, the seventh path (`docxchain`): DocXLayout
    (`DocXLayoutConfig()`), LORE (`LoreConfig()` on 512² resizes), DB
    (`DBConfig()` at 640²) and MGP-STR-base in bf16 on 8 seeded 1024x768
    document pages and 8 table pages, the weights made readable (DB by
    hand to an ink detector, so every page gives 20-64 words, and a dense
    page 150-300; the DLAs' BatchNorms at He's gain, their heat readouts
    fitted to the ink and lifted so that every table keeps 10-100 cells
    and every page 1-100 regions above 0.3; cell- and region-sized
    boxes): pages/s and p50/p99 of `GeneralTextReading`, `TableParsing`
    and `DocumentStructurization`, stage times by CUDA events, 12 K1 +
    2 K2 a recognizer batch (several on the dense page, whose strings
    must be the engine's on the same batches) and 16 K3 a LORE forward;
    the f32 pipelines on the card (no launch) against the port on the CPU
    (equal results); every bf16 keep, class and character decision that
    parts from f32 within FLIP_RMS_BOUND times the map's RMS bf16 error,
    LORE's features through K3 within 1.5x the same model's error on the
    plain DCN, and controls (K3 fed offsets shifted half a pixel must fail
    that bound); a released-layout DocXLayout file through
    `import_docxlayout`; `cli table` in a fresh process (equal JSON, its
    cold start); `RecognitionHTTPServer` with 64 concurrent
    `/v1/recognize` and 4 `/v1/read` requests (one a JPEG body), equal to
    `recognize` on the same crops. The golden replay takes
    `docxlayout.pth` too. The pages enter as files through `load_image`:
    all 16 as PNGs whose rows alternate the Paeth and Average filters
    (decoded equal to the seeded pages), and page 0 of each kind as the
    committed baseline JPEG (`tests/fixtures/smoke_*_q90.jpg`, decoded to
    PIL's recorded hash); the host decode and the host box extraction
    (`models/db.py` `extract_boxes`, the JAX CLI's) are timed a page, the
    detect stage split into the model and the extraction, and the f32
    detect function on the card must give page 0 the CPU's boxes; a
    1240x1754 page with one 1200x40 line and one 40x600 column among its
    words has its crops' peak card memory held under CROP_BYTES_PER_PIXEL
    bytes a pixel of the rectified crops;
19. the evaluation surface (`evaluation`, after `docxchain`): six LMDB
    STR eval sets of the standard names and sizes (IIIT5k_3000, SVT,
    IC13_857, IC15_1811, SVTP, CUTE80: 7,248 crops of 16-96 x 32-384 px,
    two thirds seeded PNGs written with `zlib`, one third the committed
    JPEG crops `tests/fixtures/smoke_crop*.jpg`) written by the CLI's
    `create-lmdb`; `eval` through the CLI at batch 64 on MGP-STR-base in
    bf16 (12 K1 + 2 K2 a forward, 117 forwards) collects every crop's
    string; the sets are written again with those strings as labels,
    EVAL_ALTERED altered a set, and `benchmark_all_eval` on the card must
    read exactly (n - k)/n a set and in total with the same strings (timed
    at batch 64 with its split: LMDB read, host decode, collate with the
    resize on the card, recognize, scoring), and a control with every
    label altered read 0 (timed at batch 256); then the CC-OCR harness:
    `ccocr-collect --model pipeline` over a CC-OCR-format tree of the
    docxchain phase's 16 page files at 1 and 4 workers sharing the card
    (equal responses and launches, every page read), `ccocr-eval` against
    ground truth from the first run (1 within CCOCR_EXACT) and a control
    with one word dropped a page (below 1); the same for a `doc_parsing`
    set of the 8 table pages through `--model import:chip_smoke:
    table_html` (the docxchain phase's TableParsing, 16 K3 a page),
    scored by TEDS (1 on its own run; below 1 with one cell's text
    changed a page).

Every checked kernel call (K1-K5, and each K4 call of the stress) runs on
poisoned memory: what the caching allocator is about to hand the wrapper
is filled with 0xFF bytes first (`poisoned`), so an element the kernel
never writes comes back NaN or -1; each output must land in the poisoned
blocks, be finite everywhere (ids in range), and agree with the plain
version elementwise.

Launch counts are zeroed just before each main path and read just after:
every recognizer forward must launch the attention kernel 12 times and the
vocab kernel twice, every LORE forward the deformable conv kernel 16
times and nothing else, every train step the attention kernel and its
backward kernel 12 times each and nothing else, each document pipeline
its recognizer's and (tables) LORE's kernels, and the f32 models, the
golden replay, LISTER, LevOCR, OmniParser (its tasks too), LISTER's
baseline heads and DocXLayout nothing at all,
and the STR eval pass at batch 64 the recognizer's kernels for each of its
117 forwards.
Every time printed is this card's own, taken with CUDA events or, end to
end, with the host clock after a synchronize.
The second-to-last line is one JSON object `{"kernels": [...]}`; the last is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import copy
import ctypes
import dataclasses
import hashlib
import json
import mmap
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from advancedliteratemachinery_tpu_torch.codecs.char_codec import CharCodec
from advancedliteratemachinery_tpu_torch.codecs.subword import (
    BpeCodec, WordpieceCodec)
from advancedliteratemachinery_tpu_torch.core.precision import (
    DEFAULT_POLICY, FP32_POLICY)
from advancedliteratemachinery_tpu_torch.engine.batches import (
    mgp_str_recipe_u8)
from advancedliteratemachinery_tpu_torch.engine.fit import (
    FitConfig, fit, restore_train_state)
from advancedliteratemachinery_tpu_torch.engine.checkpoint import (
    dcn_offset_perm, import_dla, import_docxlayout, import_levocr,
    import_levt, import_lister, import_lore_processor, import_mgp_str,
    import_omniparser, load_torch_state_dict)
from advancedliteratemachinery_tpu_torch.engine.infer import (
    LevOCRInference, LISTERInference, MGPSTRInference)
from advancedliteratemachinery_tpu_torch.engine.serving import (
    SpottingService)
from advancedliteratemachinery_tpu_torch.engine.train import (
    TrainState, make_mgp_str_train_step, make_optimizer, mgp_str_loss)
from advancedliteratemachinery_tpu_torch.models import layers
from advancedliteratemachinery_tpu_torch.models.abinet import (
    ABINetVisionConfig)
from advancedliteratemachinery_tpu_torch.models.db import DBConfig, DBDetector
from advancedliteratemachinery_tpu_torch.models.dla import (
    DLAConfig, DLASeg, DLASegConfig)
from advancedliteratemachinery_tpu_torch.models.docxlayout import (
    DocXLayout, DocXLayoutConfig, make_layout_predict_fn)
from advancedliteratemachinery_tpu_torch.models.focalnet import (
    FocalNetConfig)
from advancedliteratemachinery_tpu_torch.models.levocr import (
    PAD, UNK, LevOCR, LevOCRConfig)
from advancedliteratemachinery_tpu_torch.models.lister import (
    LISTER, LISTERConfig)
from advancedliteratemachinery_tpu_torch.models.lore import LORE, LoreConfig
from advancedliteratemachinery_tpu_torch.models.mgp_str import (
    MGPSTR, MGPSTRConfig)
from advancedliteratemachinery_tpu_torch.models.omniparser import (
    EOS_CHECK_EVERY, NEG, OmniParser, OmniParserConfig)
from advancedliteratemachinery_tpu_torch.models.swin import SwinConfig
from advancedliteratemachinery_tpu_torch.models.vit import ViTConfig
from advancedliteratemachinery_tpu_torch.ops import _kernels
from advancedliteratemachinery_tpu_torch.ops.attention import (
    fused_qkv_attention, fused_qkv_attention_bwd,
    fused_qkv_attention_bwd_plain, fused_qkv_attention_plain, mha_short_seq,
    mha_short_seq_plain)
from advancedliteratemachinery_tpu_torch.ops.cc_extract import (
    extract_boxes_device)
from advancedliteratemachinery_tpu_torch.ops import deform_conv as dcn_module
from advancedliteratemachinery_tpu_torch.ops.deform_conv import (
    DeformConv2d, deform_conv2d, deform_conv2d_plain, supports_deform_conv)
from advancedliteratemachinery_tpu_torch.ops.heatmap import (
    heatmap_peaks, sigmoid_clamped)
from advancedliteratemachinery_tpu_torch.ops.image import (
    crop_rects, normalize_crops)
from advancedliteratemachinery_tpu_torch.ops.vocab_decode import (
    matmul_greedy_decode, matmul_greedy_decode_plain)
from advancedliteratemachinery_tpu_torch.pipelines.modules import (
    order_point)

# published H100 SXM peaks (NVIDIA data sheet) for the roofline bounds
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

K1_TOL = 2e-2          # bf16 output rounding and bf16 probabilities
K2_TIE_GAP = 1e-3      # rows whose plain top-2 logits are closer may differ
K2_PMAX_RTOL = 1e-3    # losing BPE's ragged last chunk moves pmax ~1.6e-3
ENCODER_RTOL = 5e-2    # bf16 through 12 layers vs float32, relative RMS
# K3 against its f32 plain version on the same bf16 inputs, relative to the
# output's RMS. The kernel rounds each sample to bf16 before the contraction
# and the output once more, each at most 2^-9 of the value: together ~2e-3
# of the RMS, and at the largest outputs (~5x the RMS) up to ~2e-2
K3_RMS_TOL = 5e-3
K3_MAX_TOL = 4e-2
LORE_RTOL = 5e-2       # bf16 DLA-34 + DCN neck vs float32, relative RMS
# the f32 models on the card (TF32 off for matmuls and cuDNN convs) against
# f32 on the CPU, relative RMS: the same arithmetic summed in other
# orders, through 12 layers (MGP-STR) or 34 layers and a neck (DLA); cuDNN
# may pick Winograd or FFT convs, whose f32 error is larger than a direct
# sum's
F32_RTOL = 1e-3
# K4 against its plain version on the same bf16 inputs, per output (dq, dk,
# dv), relative to the output's RMS. The plain version rounds where the
# kernel does (qs, p, dS, the output: bf16), in f32 summed in another order,
# so a rounding may flip by one bf16 ulp (2^-8 of an element). Against the
# plain version in f32 throughout (no bf16 rounding of p and dS) the RMS
# error is also held to K4_RMS_TOL; its largest error is only reported:
# dS sums to zero along a row, and where dq = dS k cancels, the bf16
# rounding of dS stands out against a small result.
K4_RMS_TOL = 1e-2
K4_MAX_TOL = 5e-2
# K4's sequence lengths: on both sides of its 64-row tiles and of a last
# chunk of at most 16 rows, up to its longest
K4_SEQS = (1, 8, 16, 17, 63, 64, 65, 257, 272, 273, 320, 321, 700, 768)
# one train step's gradients through K1/K4 against the same step with the
# attention swapped for the plain versions in f32, per parameter group,
# relative RMS: K1/K4 round p and dS to bf16 where the f32 plain versions
# do not (~2.4e-3 relative RMS at the attention), and the difference
# travels back through 12 bf16 layers
TRAIN_GRAD_RTOL = 2e-2
# LISTER's logits in bf16 on the card against f32 on the CPU, relative RMS:
# bf16 through FocalNet-B's 15 blocks and the 36-step walk; the same
# comparison in bf16 on the CPU gave 6.7e-3 (iters 0) and 9.7e-3 (iters 2)
LISTER_RTOL = 3e-2
# LevOCR's vision logits in bf16 on the card against f32 on the CPU,
# relative RMS: bf16 activations through ResNet45's 45 convs, 3 transformer
# layers and the position attention, as the recognizer's encoder
# (ENCODER_RTOL) and LORE's DLA (LORE_RTOL)
LEVOCR_BF16_RTOL = 5e-2
# LevOCR's three heads in bf16 on the card against f32 on the CPU, relative
# RMS, at most this multiple of the same model's error in bf16 on the CPU
# on the same inputs: the fused text features are nearly one vector on
# every token (the mean's norm is ~99 % of a token's), so a head with few
# classes reads small differences and its relative error is bf16's own,
# not a fixed share (the deletion head's is several times the others')
LEVOCR_BF16_HEADS_RATIO = 1.5
# the same in f32 on the card (TF32 off for matmuls and cuDNN convs): the
# same arithmetic summed in other orders
LEVOCR_F32_RTOL = 1e-4
# final tokens of the f32 card run equal to the CPU's on at least this many
# of the 16 crops (a decision that sits on a near-tie may flip); the scores
# of the crops whose tokens are equal within LEVOCR_F32_RTOL of their RMS
LEVOCR_F32_MIN_EQUAL = 15
# readable check weights (`readable_levocr`): the share of vision positions
# that predict the null class, and of the first round's tokens deleted
LEVOCR_NULL_SHARE = 0.1
LEVOCR_DEL_SHARE = 0.3
# K4's bounded stress phase: pairs of calls at the train shape
K4_STRESS_PAIRS = 1000
# OmniParser: seeded 640² pages, and the points each emits with the
# weights made readable (`readable_omniparser`)
OMNI_PAGES = 8
OMNI_POINTS = (4, 60)
# the SpottingService's pt slots in the timed runs: the default 8 (32 poly
# and rec slots), and 32 (128 poly and rec slots, infer_spotting's
# max_instances rows)
OMNI_SERVICE_SLOTS = (8, 32)
# the factor on the pt decoder's self-attention queries that
# `readable_omniparser` sharpens them by
OMNI_PT_SHARPEN = 16
# the f32 run on the card against the CPU: decode probabilities and the
# teacher-forced logits, relative RMS (the same arithmetic summed in other
# orders, through Swin-B's 24 blocks and 4 decoder layers)
OMNI_F32_RTOL = 1e-4
# the bf16 teacher-forced logits on the card against f32 on the CPU,
# relative RMS, at most this multiple of the same model's error in bf16 on
# the CPU (as LEVOCR_BF16_HEADS_RATIO)
OMNI_BF16_RATIO = 1.5

# The golden artifacts' configurations (tests/golden/{mgp_str,lore,lister,
# levocr,omniparser}.pth), copied from the JAX tests that build them:
# tests/test_checkpoint_import.py:20 (D, HEADS, DEPTH, T = 32, 2, 2, 9),
# tests/test_dla_import.py:24-27, tests/golden_common.py:82-86 and
# :106-109 with tests/test_levocr_import.py:19-22 (DV, DL, MAXLEN = 64, 32,
# 10), tests/golden_common.py:143-166 with
# tests/test_omniparser_import.py:27-31; and their tolerances,
# tests/golden_common.py:391
GOLDEN_MGP_STR = MGPSTRConfig(batch_max_length=7, bpe_vocab_size=64,
                              wp_vocab_size=64,
                              vit=ViTConfig(embed_dim=32, depth=2,
                                            num_heads=2))
GOLDEN_DLASEG = DLASegConfig(dla=DLAConfig(levels=(1, 1, 1, 2, 2, 1),
                                           channels=(4, 8, 16, 32, 64, 128)),
                             head_conv=8, heads=(("hm", 2), ("reg", 2)))
GOLDEN_LISTER = LISTERConfig(
    max_ch=6, iters=1, nhead=2, window_size=5,
    focalnet=FocalNetConfig(embed_dim=8, depths=(1, 1, 1, 1),
                            layerscale_value=1e-2))
GOLDEN_LEVOCR = LevOCRConfig(
    max_len=10, d_model=32, heads=2, ffn=64, layers=1,
    vision=ABINetVisionConfig(max_length=6, num_classes=37, d_model=64,
                              ffn=256))
GOLDEN_OMNIPARSER = OmniParserConfig(
    d_model=32, nhead=2, dec_layers=2, dim_feedforward=48,
    max_position_embeddings=64, num_bins=16, pt_seq_length=8,
    poly_length=4, rec_length=4, max_instances=4,
    swin=SwinConfig(embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8),
                    window_size=4))
GOLDEN_DOCXLAYOUT = DocXLayoutConfig(
    num_classes=3, num_secondary_classes=2, top_k=8, top_k_sub=4,
    dla=DLAConfig(levels=(1, 1, 1, 2, 2, 1),
                  channels=(4, 8, 16, 32, 64, 128)), head_conv=8)
GOLDEN_TOL = {"mgp_str": 2e-4, "lore": 2e-3, "lister": 1e-5,
              "levocr": 3e-3, "omniparser": 2e-3, "docxlayout": 2e-3}

ATTN_SRC = "advancedliteratemachinery_tpu_torch/csrc/fused_qkv_attention.cu"
DECODE_SRC = "advancedliteratemachinery_tpu_torch/csrc/vocab_greedy_decode.cu"
DCN_SRC = "advancedliteratemachinery_tpu_torch/csrc/deform_conv.cu"
BWD_SRC = ("advancedliteratemachinery_tpu_torch/csrc/"
           "fused_qkv_attention_bwd.cu")
MHA_SRC = "advancedliteratemachinery_tpu_torch/csrc/mha_short_seq.cu"
# (B, H=W, Cin, Cout, layers per forward) of LORE's 16 DCN layers at 768²
DCN_PATH_SHAPES = ((8, 24, 512, 256, 1), (8, 48, 256, 256, 1),
                   (8, 48, 256, 128, 2), (8, 48, 256, 64, 1),
                   (8, 96, 128, 128, 2), (8, 96, 128, 64, 4),
                   (8, 192, 64, 64, 5))


# the __global__ functions of csrc/, each in an anonymous namespace
PORT_KERNELS = tuple(f"(anonymous namespace)::{name}" for name in (
    "attn::attention_kernel", "bwd_kernel", "deform_conv_kernel",
    "vocab_partial_kernel", "vocab_merge_kernel"))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_attention(B, S, H, safe, gen, time_it=True):
    D = H * 64
    qkv = torch.randn(B, S, 3 * D, generator=gen, device="cuda").bfloat16()
    out, in_poison = poisoned(lambda: fused_qkv_attention(qkv, H, safe=safe))
    again = fused_qkv_attention(qkv, H, safe=safe)
    qkv32 = qkv.float()
    want = fused_qkv_attention_plain(qkv32, H, safe=safe)
    torch.cuda.synchronize()
    err = (out.float() - want).abs().max().item()
    rec = {"phase": "attention", "B": B, "S": S, "H": H, "safe": safe,
           "max_abs_err": err, "tol": K1_TOL, "poisoned": in_poison,
           "nonfinite": positions(~torch.isfinite(out.view(B, S, H, 64)),
                                  ("batches", "rows", "heads")),
           "repeat_equal": torch.equal(out, again)}
    require(out.shape == (B, S, D) and err <= K1_TOL and rec["repeat_equal"]
            and in_poison and rec["nonfinite"]["n"] == 0,
            f"fused_qkv_attention disagrees with its plain version: {rec}")
    if time_it:
        views = qkv.view(B, S, 3, H, 64).permute(2, 0, 3, 1, 4)
        q, k, v = (t.contiguous() for t in views)
        rec["ms"] = cuda_ms(lambda: fused_qkv_attention(qkv, H, safe=safe))
        rec["plain_ms"] = cuda_ms(
            lambda: fused_qkv_attention_plain(qkv32, H, safe=safe), iters=3)
        # yardsticks: SDPA on contiguous BHSD copies made outside the timed
        # window, and SDPA on strided views of qkv, the bytes K1 reads
        rec["library_ms"] = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v))
        rec["library_strided_ms"] = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(*views))
        rec["bound_ms"], rec["bound_by"] = bound(
            B * S * 4 * D * 2, 4 * B * H * S * S * 64)
    emit(rec)
    return rec


def short_tail_probe(gen):
    """Whether the short form of the last key chunk pays: S=272 ends on a
    16-key chunk (Q K^T by m64n16k16, one P V step), S=273 on a 17-key one
    (the full m64n64k16 form); both have 5 query tiles and 5 chunks and
    differ by one key in bytes. K1 unsafe at B=256, K5 at B=128, H=12."""
    rec = {"phase": "attention_short_tail"}
    for S in (272, 273):
        qkv = torch.randn(256, S, 3 * 768, generator=gen,
                          device="cuda").bfloat16()
        rec[f"k1_ms_s{S}"] = cuda_ms(
            lambda: fused_qkv_attention(qkv, 12, safe=False), iters=20)
        q, k, v = qkv[:128].view(128, S, 3, 12, 64).unbind(2)
        rec[f"k5_ms_s{S}"] = cuda_ms(lambda: mha_short_seq(q, k, v),
                                     iters=20)
    emit(rec)


def rel_errors(got, want):
    """(RMS error, largest error), each over the RMS of `want`; both 0 when
    `got` equals an all-zero `want` (dq and dk at S=1, where dS is 0)."""
    err = (got.float() - want).abs()
    rms = want.pow(2).mean().sqrt().item()
    if rms == 0.0:
        return (0.0, 0.0) if err.max().item() == 0.0 else (np.inf, np.inf)
    return err.pow(2).mean().sqrt().item() / rms, err.max().item() / rms


def positions(mask, names):
    """How many elements of the boolean `mask` are set, and for each named
    dimension (None skips one) the first indices, at most 32, where one
    is."""
    nz = mask.nonzero()
    rec = {"n": len(nz)}
    for axis, name in enumerate(names):
        if name:
            rec[name] = sorted(set(nz[:, axis].tolist()))[:32]
    return rec


def k4_diff(a, b, H):
    """Where two K4 outputs [B, S, 3 * H * 64] differ: how many elements,
    the largest difference, and which parts (0 dq, 1 dk, 2 dv), batches,
    rows and heads."""
    B, S, _ = a.shape
    d = (a.float() - b.float()).abs().view(B, S, 3, H, 64)
    return {"max": d.max().item(),
            **positions(d != 0, ("batches", "rows", "parts", "heads"))}


def k4_nonfinite(out, H):
    """The non-finite elements of a K4 output, by part, batch, row and
    head (`positions`)."""
    B, S, _ = out.shape
    return positions(~torch.isfinite(out.view(B, S, 3, H, 64)),
                     ("batches", "rows", "parts", "heads"))


def alloc_plan(fn):
    """What the caching allocator hands out and takes back during one call
    of `fn` (its result is dropped), in order: ("alloc", bytes) and
    ("free", index of the alloc), from the allocator's own trace
    (`torch.cuda.memory._record_memory_history`)."""
    mem = torch.cuda.memory
    dev = torch.cuda.current_device()
    torch.cuda.synchronize()
    mem._record_memory_history(enabled="all", context=None, stacks="python")
    try:
        n0 = len(mem._snapshot()["device_traces"][dev])
        out = fn()
        trace = mem._snapshot()["device_traces"][dev][n0:]
    finally:
        mem._record_memory_history(enabled=None)
    del out
    plan, live = [], {}
    for ev in trace:
        if ev["action"] == "alloc":
            live[ev["addr"]] = sum(step[0] == "alloc" for step in plan)
            plan.append(("alloc", ev["size"]))
        elif ev["action"] == "free_requested" and ev["addr"] in live:
            plan.append(("free", live.pop(ev["addr"])))
    return plan


def poison(plan):
    """Fill with 0xFF bytes (NaN in f32 and bf16, -1 in int32) the blocks
    that a call which allocates and frees as `plan` says will get: the same
    sizes are allocated and freed in the same order, each block filled
    through a uint8 tensor, and the rest freed at the end. The caching
    allocator is then back in the state it was in, so the call's own
    `torch.empty`s get exactly these blocks. Returns their data_ptrs."""
    blocks, ptrs = [], []
    for step in plan:
        if step[0] == "alloc":
            blocks.append(torch.empty(step[1], dtype=torch.uint8,
                                      device="cuda").fill_(0xFF))
            ptrs.append(blocks[-1].data_ptr())
        else:
            blocks[step[1]] = None
    return ptrs


def poisoned(fn, plan=None):
    """fn() on poisoned memory (`poison`; the plan from a first call when
    none is given) → (its result, whether every tensor it returns lies in
    a poisoned block: the proof that the poison reached the kernel)."""
    ptrs = poison(plan if plan is not None else alloc_plan(fn))
    out = fn()
    outs = out if isinstance(out, tuple) else (out,)
    return out, all(t.data_ptr() in ptrs for t in outs)


def check_attention_bwd(B, S, H, gen, time_it=False, scale=None):
    """K4 against its plain version in f32 on the same bf16 inputs; two
    calls on the same input must give the same bits."""
    D = H * 64
    qkv = torch.randn(B, S, 3 * D, generator=gen, device="cuda").bfloat16()
    dout = torch.randn(B, S, D, generator=gen, device="cuda").bfloat16()
    # both calls on poisoned output and statistics memory
    plan = alloc_plan(lambda: fused_qkv_attention_bwd(qkv, dout, H, scale))
    got, in_poison = poisoned(
        lambda: fused_qkv_attention_bwd(qkv, dout, H, scale), plan)
    again, again_in_poison = poisoned(
        lambda: fused_qkv_attention_bwd(qkv, dout, H, scale), plan)
    want = fused_qkv_attention_bwd_plain(qkv, dout, H, scale).float()
    want32 = fused_qkv_attention_bwd_plain(qkv.float(), dout.float(), H,
                                           scale)
    torch.cuda.synchronize()
    rec = {"phase": "attention_bwd", "B": B, "S": S, "H": H, "scale": scale,
           "max_abs_err": (got.float() - want).abs().max().item(),
           "tol": [K4_RMS_TOL, K4_MAX_TOL],
           "poisoned": [in_poison, again_in_poison],
           "nonfinite": [k4_nonfinite(got, H), k4_nonfinite(again, H)],
           "repeat_equal": torch.equal(got, again)}
    again_ok = True
    for i, name in enumerate(("dq", "dk", "dv")):
        sl = slice(i * D, (i + 1) * D)
        rec[f"{name}_rel_rms_err"], rec[f"{name}_max_err_over_rms"] = (
            rel_errors(got[..., sl], want[..., sl]))
        rec[f"{name}_vs_f32"] = rel_errors(got[..., sl], want32[..., sl])
        # the second call is held to the same bounds, so that a repeat
        # mismatch says which call left the plain version
        rms, top = rel_errors(again[..., sl], want[..., sl])
        rec[f"{name}_again_errs"] = [rms, top]
        again_ok = again_ok and rms <= K4_RMS_TOL and top <= K4_MAX_TOL
    if not rec["repeat_equal"]:
        rec["repeat_diff"] = k4_diff(got, again, H)
    require(got.shape == qkv.shape and rec["repeat_equal"] and again_ok
            and in_poison and again_in_poison
            and not any(n["n"] for n in rec["nonfinite"]) and all(
        rec[f"{n}_rel_rms_err"] <= K4_RMS_TOL
        and rec[f"{n}_max_err_over_rms"] <= K4_MAX_TOL
        and rec[f"{n}_vs_f32"][0] <= K4_RMS_TOL
        for n in ("dq", "dk", "dv")),
        f"fused_qkv_attention_bwd disagrees with its plain version: {rec}")
    if time_it:
        rec["ms"] = cuda_ms(lambda: fused_qkv_attention_bwd(qkv, dout, H),
                            iters=20)
        rec["plain_ms"] = cuda_ms(
            lambda: fused_qkv_attention_bwd_plain(qkv, dout, H), iters=3)
        # yardstick: SDPA's backward on strided views of the same q/k/v
        leaf = qkv.detach().requires_grad_()
        q, k, v = leaf.view(B, S, 3, H, 64).permute(2, 0, 3, 1, 4)
        o = torch.nn.functional.scaled_dot_product_attention(q, k, v)
        do = dout.view(B, S, H, 64).transpose(1, 2)
        rec["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
            o, leaf, do, retain_graph=True))
        rec["bound_ms"], rec["bound_by"] = bound(
            7 * B * S * D * 2, 10 * B * H * S * S * 64)
    emit(rec)
    return rec


def mha_inputs(B, S, H, gen, layout):
    """q, k, v [B, S, H, 64] bf16 read in place by K5: views of one
    [B, S, 3, H, 64] projection ("qkv"), a contiguous q beside views of a
    [B, S, 2, H, 64] kv projection ("q+kv"), or [B, H, S, 64] tensors
    through `.transpose(1, 2)` ("bhsd")."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()
    if layout == "qkv":
        return randn(B, S, 3, H, 64).unbind(2)
    if layout == "q+kv":
        return (randn(B, S, H, 64), *randn(B, S, 2, H, 64).unbind(2))
    return tuple(randn(B, H, S, 64).transpose(1, 2) for _ in range(3))


def check_mha(B, S, H, gen, time_it=False, layout="qkv"):
    """K5 against its plain version in f32 on the same bf16 inputs, read
    in place through their strides (`mha_inputs`)."""
    q, k, v = mha_inputs(B, S, H, gen, layout)
    out, in_poison = poisoned(lambda: mha_short_seq(q, k, v))
    again = mha_short_seq(q, k, v)
    f32 = [t.float() for t in (q, k, v)]
    want = mha_short_seq_plain(*f32)
    torch.cuda.synchronize()
    rec = {"phase": "mha_short_seq", "B": B, "S": S, "H": H,
           "layout": layout,
           "max_abs_err": (out.float() - want).abs().max().item(),
           "tol": K1_TOL, "poisoned": in_poison,
           "nonfinite": positions(~torch.isfinite(out),
                                  ("batches", "rows", "heads")),
           "repeat_equal": torch.equal(out, again)}
    rec["rel_rms_err"] = rel_errors(out, want)[0]
    require(out.shape == (B, S, H, 64) and rec["max_abs_err"] <= K1_TOL
            and rec["repeat_equal"] and in_poison
            and rec["nonfinite"]["n"] == 0,
            f"mha_short_seq disagrees with its plain version: {rec}")
    if time_it:
        rec["ms"] = cuda_ms(lambda: mha_short_seq(q, k, v))
        rec["plain_ms"] = cuda_ms(lambda: mha_short_seq_plain(*f32), iters=3)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        rec["library_ms"] = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt))
        rec["bound_ms"], rec["bound_by"] = bound(
            4 * B * S * H * 64 * 2, 4 * B * H * S * S * 64)
    emit(rec)
    return rec


def k4_stress(gen, pairs):
    """K4's repeatability under load: `pairs` pairs of calls at the train
    shape (B=128, S=257, H=12) on fixed inputs, each call's bits against a
    first reference call's, each on poisoned output and statistics memory
    (`poison`; a call that left an element unwritten would return NaN
    there). Before each pair, in turn: nothing, a K4 call at another shape
    (the scaled-q path among them), K1 and K5, or another K4 shape and a
    synchronize; a side stream keeps bf16 matmuls running beside the
    calls. The flags stay on the card and are read once every 10 pairs;
    the first differing call is described by `k4_diff`, the first
    non-finite one by `k4_nonfinite`. Also driven by `k4_repeats.py`."""
    t0 = time.perf_counter()
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()
    big = (randn(128, 257, 3 * 768), randn(128, 257, 768))
    ref = fused_qkv_attention_bwd(*big, 12)
    plan = alloc_plan(lambda: fused_qkv_attention_bwd(*big, 12))
    others = [((randn(B, S, 3 * H * 64), randn(B, S, H * 64)), H, scale)
              for B, S, H, scale in ((1, 768, 2, 0.3), (2, 257, 3, 0.1),
                                     (3, 63, 1, None), (1, 768, 12, None))]
    k1_in = randn(256, 257, 3 * 768)
    side, a = torch.cuda.Stream(), randn(8192, 8192)
    a.record_stream(side)
    bad, nonfinite, unpoisoned = 0, 0, 0
    first, first_nonfinite = None, None
    group = 10
    for g0 in range(0, pairs, group):
        with torch.cuda.stream(side):
            for _ in range(4):
                torch.mm(a, a)
        outs = []
        for i in range(g0, min(g0 + group, pairs)):
            kind = i % 4
            if kind in (1, 3):
                (qkv, dout), H, scale = others[i // 4 % len(others)]
                fused_qkv_attention_bwd(qkv, dout, H, scale)
                if kind == 3:
                    torch.cuda.synchronize()
            elif kind == 2:
                fused_qkv_attention(k1_in, 12, safe=bool(i % 8 == 2))
                q, k, v = k1_in[:128].view(128, 257, 3, 12, 64).unbind(2)
                mha_short_seq(q, k, v)
            for _ in range(2):
                out, in_poison = poisoned(
                    lambda: fused_qkv_attention_bwd(*big, 12), plan)
                outs.append(out)
                unpoisoned += not in_poison
        flags = torch.stack([torch.stack([(o != ref).any(),
                                          ~torch.isfinite(o).all()])
                             for o in outs]).cpu()
        bad += int(flags[:, 0].sum())
        nonfinite += int(flags[:, 1].sum())
        if first is None and flags[:, 0].any():
            at = int(flags[:, 0].nonzero()[0, 0])
            first = {"pair": g0 + at // 2, **k4_diff(outs[at], ref, 12)}
        if first_nonfinite is None and flags[:, 1].any():
            at = int(flags[:, 1].nonzero()[0, 0])
            first_nonfinite = {"pair": g0 + at // 2,
                               **k4_nonfinite(outs[at], 12)}
    side.synchronize()
    return {"phase": "k4_repeats", "pairs": pairs, "calls": 2 * pairs,
            "calls_differing": bad, "first_diff": first,
            "calls_nonfinite": nonfinite, "first_nonfinite": first_nonfinite,
            "calls_not_on_poison": unpoisoned,
            "seconds": time.perf_counter() - t0}


def k4_repeats_phase(gen):
    rec = k4_stress(gen, K4_STRESS_PAIRS)
    emit(rec)
    require(rec["calls_differing"] == 0 and rec["calls_nonfinite"] == 0
            and rec["calls_not_on_poison"] == 0 and rec["seconds"] <= 15.0,
            f"K4 repeat stress: {rec}")


def check_decode(M, V, true_v, gen, time_it=True, extra_pairs=()):
    D = 768
    tok = torch.randn(M, D, generator=gen, device="cuda")
    w = torch.randn(V, D, generator=gen, device="cuda") * 0.05
    b = torch.randn(V, generator=gen, device="cuda") * 0.1
    # crafted exact ties: columns j2 copy j1 (same tile, same chunk, other
    # chunk; `extra_pairs` more), and row i is steered onto its pair; the
    # lower index must win. As many pairs as there are rows and columns.
    pairs = [(j1, j2) for j1, j2 in ((3, 77), (200, 900),
                                     (1000, true_v - 60), *extra_pairs)
             if j1 < j2 < true_v][:M]
    for i, (j1, j2) in enumerate(pairs):
        s = torch.sign(torch.randn(D, generator=gen, device="cuda")) * 0.5
        tok[i] = s
        w[j1] = w[j2] = 0.1 * s
        b[j2] = b[j1]
    tok, w, b = tok.bfloat16(), w.bfloat16(), b.bfloat16()
    (ids, pmax), in_poison = poisoned(
        lambda: matmul_greedy_decode(tok, w, b, true_v))
    pids, ppmax = matmul_greedy_decode_plain(tok, w, b, true_v)
    logits = (tok.float() @ w.float().t() + b.float())[:, :true_v]
    top2 = logits.topk(2, dim=-1).values
    near = (top2[:, 0] - top2[:, 1]) < K2_TIE_GAP
    del logits
    differ = ids != pids
    n_bad = int((differ & ~near).sum())
    pmax_err = (pmax - ppmax).abs()
    rec = {"phase": "vocab_decode", "M": M, "D": D, "V": V,
           "true_vocab": true_v, "near_tie_rows": int(near.sum()),
           "id_mismatches": int(differ.sum()), "id_mismatches_off_ties": n_bad,
           "tie_rows": [int(ids[i]) for i in range(len(pairs))],
           "max_abs_err": pmax_err.max().item(),
           "max_rel_err": (pmax_err / ppmax).max().item(),
           "poisoned": in_poison,
           "ids_out_of_range": positions((ids < 0) | (ids >= true_v),
                                         ("rows",)),
           "pmax_not_in_0_1": positions(~((pmax > 0) & (pmax <= 1)),
                                        ("rows",))}
    require(in_poison and rec["ids_out_of_range"]["n"] == 0
            and rec["pmax_not_in_0_1"]["n"] == 0,
            f"vocab_greedy_decode left ids or probabilities unwritten: "
            f"{rec}")
    require(n_bad == 0, f"ids differ off near-ties: {rec}")
    require([j1 for j1, _ in pairs] == rec["tie_rows"]
            == [int(pids[i]) for i in range(len(pairs))],
            f"exact ties must go to the lower index: {rec}")
    require(rec["max_rel_err"] <= K2_PMAX_RTOL, f"pmax off: {rec}")
    if time_it:
        wt = w.t()
        rec["ms"] = cuda_ms(lambda: matmul_greedy_decode(tok, w, b, true_v))
        rec["plain_ms"] = cuda_ms(
            lambda: matmul_greedy_decode_plain(tok, w, b, true_v), iters=3)
        rec["library_ms"] = cuda_ms(lambda: torch.matmul(tok, wt))
        rec["bound_ms"], rec["bound_by"] = bound(
            M * D * 2 + V * D * 2 + V * 2 + M * 8, 2 * M * D * true_v)
    emit(rec)
    return rec


def check_deform_conv(B, H, W, Cin, Cout, gen, case="normal",
                      time_it=False, time_plain=False):
    """K3 against its plain version in f32 on the same bf16 inputs.
    `case`: normal (offsets N(0, 2²) px), far (uniform ±40 px), beyond3
    (every offset 3-6 px), outside (every sample wholly off the image) or
    zero_mask; the last two must give exactly the bias."""
    dev = "cuda"
    x = torch.randn(B, H, W, Cin, generator=gen, device=dev).bfloat16()
    shape = (B, H, W, 9, 2)
    if case == "far":
        off = torch.rand(shape, generator=gen, device=dev) * 80 - 40
    elif case == "beyond3":
        off = (torch.sign(torch.randn(shape, generator=gen, device=dev))
               * (3 + 3 * torch.rand(shape, generator=gen, device=dev)))
    elif case == "outside":
        off = torch.full(shape, 1000.0, device=dev)
    else:
        off = torch.randn(shape, generator=gen, device=dev) * 2
    off = off.bfloat16()
    mask = torch.rand(B, H, W, 9, generator=gen, device=dev).bfloat16()
    if case == "zero_mask":
        mask.zero_()
    w = (torch.randn(3, 3, Cin, Cout, generator=gen, device=dev)
         / (9 * Cin) ** 0.5).bfloat16()
    b = torch.randn(Cout, generator=gen, device=dev).bfloat16()
    out, in_poison = poisoned(lambda: deform_conv2d(x, off, mask, w, b))
    f32 = [t.float() for t in (x, off, mask, w, b)]
    want = deform_conv2d_plain(*f32)
    torch.cuda.synchronize()
    err = (out.float() - want).abs()
    rms = want.pow(2).mean().sqrt().item()
    rec = {"phase": "deform_conv", "B": B, "H": H, "W": W, "Cin": Cin,
           "Cout": Cout, "case": case, "max_abs_err": err.max().item(),
           "rel_rms_err": err.pow(2).mean().sqrt().item() / rms,
           "max_err_over_rms": err.max().item() / rms,
           "tol": [K3_RMS_TOL, K3_MAX_TOL], "poisoned": in_poison,
           "nonfinite": positions(~torch.isfinite(out),
                                  ("batches", "rows", "cols"))}
    require(out.shape == (B, H, W, Cout) and in_poison
            and rec["nonfinite"]["n"] == 0
            and rec["rel_rms_err"] <= K3_RMS_TOL
            and rec["max_err_over_rms"] <= K3_MAX_TOL,
            f"deform_conv disagrees with its plain version: {rec}")
    if case in ("outside", "zero_mask"):
        require(torch.equal(out, b.expand_as(out)),
                f"deform_conv must give exactly the bias: {rec}")
    if time_it:
        rec["ms"] = cuda_ms(lambda: deform_conv2d(x, off, mask, w, b))
        xc, wc = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous()
        # the yardstick: DCN at zero offsets and a unit mask is this conv
        rec["library_ms"] = cuda_ms(
            lambda: torch.nn.functional.conv2d(xc, wc, b, padding=1))
        rec["bound_ms"], rec["bound_by"] = bound(
            2 * (x.numel() + off.numel() + mask.numel() + w.numel()
                 + b.numel() + B * H * W * Cout),
            2 * B * H * W * 9 * Cin * Cout)
    if time_plain:
        rec["plain_ms"] = cuda_ms(lambda: deform_conv2d_plain(*f32), iters=3)
    emit(rec)
    return rec


def counted(fn):
    """Run `fn` with every launch count zeroed just before; return its
    result and the counts read just after."""
    torch.cuda.synchronize()
    _kernels.LAUNCHES.clear()
    result = fn()
    torch.cuda.synchronize()
    return result, dict(_kernels.LAUNCHES)


def require_counts(counts, forwards, path):
    want = {"fused_qkv_attention": 12 * forwards,
            "vocab_greedy_decode": 2 * forwards}
    require(counts == want, f"{path}: launches {counts}, expected {want}")


def rec_only(engine, images):
    """bench.py rec_only_bench + latency_bench on the port."""
    dev_images = torch.from_numpy(images).cuda()
    engine.run(dev_images)["char_ids"].cpu()            # warm up
    iters = 20

    def loop():
        t0 = time.perf_counter()
        for _ in range(iters):
            out = engine.run(dev_images)
        out["char_ids"].cpu()
        return len(images) * iters / (time.perf_counter() - t0)

    crops_s, counts = counted(loop)
    require_counts(counts, iters, "rec-only")
    one = dev_images[:1]
    engine.run(one)["char_ids"].cpu()
    lats = []
    for _ in range(60):
        t0 = time.perf_counter()
        engine.run(one)["char_ids"].cpu()
        lats.append((time.perf_counter() - t0) * 1e3)
    rec = {"phase": "rec_only", "batch": len(images), "crops_per_s": crops_s,
           "p50_ms_b1": float(np.percentile(lats, 50)),
           "p99_ms_b1": float(np.percentile(lats, 99)), "launches": counts}
    emit(rec)
    return rec


def check_encoder(engine, cfg, images):
    """The card's bf16 encoder (through the attention kernel) against a
    float32 run of the same seeded weights on the CPU, on two crops."""
    ref = MGPSTR(cfg, policy=FP32_POLICY, device="cpu", seed=0)
    x = normalize_crops(torch.from_numpy(images[:2]), torch.float32)
    with torch.inference_mode():
        want = ref.encoder(x)
        got = engine.model.encoder(x.cuda().bfloat16()).float().cpu()
    err = ((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())
    rec = {"phase": "encoder_vs_cpu_f32", "rel_rms_err": err.item(),
           "tol": ENCODER_RTOL}
    emit(rec)
    require(bool(torch.isfinite(got).all()) and err.item() <= ENCODER_RTOL,
            f"encoder disagrees with the CPU reference: {rec}")


def e2e_spotting(engine):
    """bench.py e2e_spotting_bench on the port; the main path."""
    P, PH, PW, K, iters = 8, 640, 640, 64, 10
    det = DBDetector(DBConfig(), seed=1)
    with torch.no_grad():   # background ≈ sigmoid(-8), still data-dependent
        det.prob_up2.weight.fill_(1e-4)
        det.prob_up2.bias.fill_(-8.0)
    template = torch.zeros(PH, PW, device="cuda")
    for r in range(8):
        for c in range(8):
            x0, y0 = 16 + c * 76, 24 + r * 74
            template[y0:y0 + 20, x0:x0 + 64] = 1.0
    rng = np.random.default_rng(0)
    pages_np = [rng.integers(0, 256, (P, PH, PW, 3), dtype=np.uint8)
                for _ in range(iters)]

    @torch.inference_mode()
    def spot_step(pages_u8, stages=None):
        mark = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        mark[0].record()
        prob = torch.maximum(det(pages_u8)["prob"][..., 0], template)
        mark[1].record()
        quads, _, valid = extract_boxes_device(prob, max_boxes=K)
        mark[2].record()
        crops = crop_rects(pages_u8, quads, out_hw=(32, 128))
        mark[3].record()
        out = dict(engine._decode_all(crops.reshape(P * K, 32, 128, 3)))
        mark[4].record()
        out["n_valid"] = valid.sum()
        if stages is not None:
            stages.append(mark)
        return out

    pages0 = torch.from_numpy(pages_np[0]).cuda()
    out0 = spot_step(pages0)
    n0 = int(out0["n_valid"])
    require(n0 >= P * K // 2, f"extraction found only {n0} boxes")
    require(out0["char_ids"].shape == (P * K, 26)
            and bool(torch.isfinite(out0["char_conf"]).all()),
            "recognizer output malformed")

    # extraction on the card against the same function on the CPU
    with torch.inference_mode():
        prob = torch.maximum(det(pages0[:1])["prob"][..., 0], template)
        gq, gs, gv = extract_boxes_device(prob, max_boxes=K)
        cq, cs, cv = extract_boxes_device(prob.cpu(), max_boxes=K)
    q_err = (gq.cpu() - cq).abs().max().item()
    emit({"phase": "extract_vs_cpu", "valid": int(gv.sum()),
          "max_abs_quad_err": q_err})
    require(torch.equal(gv.cpu(), cv) and q_err <= 1e-2,
            "extraction on the card disagrees with the CPU")

    def timed_loop():
        t0 = time.perf_counter()
        outs = [spot_step(torch.from_numpy(p).cuda()) for p in pages_np]
        total = 0
        for o in outs:                        # drain: ids + box counts
            o["char_ids"].cpu()
            total += int(o["n_valid"])
        return total / (time.perf_counter() - t0)

    reps, counts = counted(lambda: [timed_loop() for _ in range(3)])
    require_counts(counts, 3 * iters, "e2e spotting")
    stages = []
    for p in pages_np[:3]:
        spot_step(torch.from_numpy(p).cuda(), stages)
    torch.cuda.synchronize()
    names = ("det", "extract", "crop", "recognize")
    stage_ms = {n: float(np.mean([m[i].elapsed_time(m[i + 1])
                                  for m in stages]))
                for i, n in enumerate(names)}
    rec = {"phase": "e2e_spotting", "pages": P, "page_hw": [PH, PW],
           "max_boxes": K, "valid_boxes_first_step": n0,
           "crops_per_s_reps": reps, "crops_per_s_best": max(reps),
           "stage_ms": stage_ms, "launches": counts,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(rec)
    profile_steps("e2e_profile", [
        lambda p=p: spot_step(torch.from_numpy(p).cuda())["char_ids"].cpu()
        for p in pages_np[:3]])
    return rec, counts


def profile_steps(phase, steps, step_ms=None):
    """Device time by kernel name over a few steps (torch.profiler; each
    step ends in a copy to the host), and the share of their wall time in
    which no kernel or copy ran (the profiler's own overhead counts into
    the wall time). Given the unprofiled time of a step, also the share of
    that time the device was not busy."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for step in steps:
            step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.key_averages()        # kernels and copies,
              if e.device_type == torch.autograd.DeviceType.CUDA  # not the
              and not e.is_user_annotation]    # ranges user code annotates
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:15]
    rec = {"phase": phase, "steps": len(steps),
           "wall_ms_per_step": wall_ms / len(steps),
           "device_busy_ms_per_step": busy_ms / len(steps),
           "device_idle_share": (1.0 - busy_ms / wall_ms) if wall_ms else None,
           "top_device_ms_per_step": [
               [e.key[:90], e.self_device_time_total / 1e3 / len(steps)]
               for e in top],
           # the port's own kernels, by name (PyTorch declares kernels in
           # anonymous namespaces too)
           "port_kernels_ms_per_step": [
               [e.key[:90], e.self_device_time_total / 1e3 / len(steps)]
               for e in device
               if e.key.removeprefix("void ").startswith(PORT_KERNELS)]}
    if step_ms is not None:
        rec["unprofiled_step_ms"] = step_ms
        rec["device_idle_share_unprofiled"] = (
            1.0 - busy_ms / len(steps) / step_ms)
    emit(rec)


def reseed_offsets(model, seed):
    """Spread every DCN's offsets over several pixels, a share of them
    beyond ±3, and its mask around 0.5. The JAX init zeroes the offset/mask
    conv, which would make every DCN a plain conv and hide a broken
    sampler."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, DeformConv2d):
                com = m.conv_offset_mask
                K = com.out_channels // 3
                com.weight.normal_(0, com.weight[0].numel() ** -0.5,
                                   generator=g)
                com.bias[:2 * K].normal_(0, 2.5, generator=g)
                com.bias[2 * K:].normal_(0, 1, generator=g)


def check_lore_vs_cpu(model):
    """Head maps of one 256² page: the card's bf16 model (through K3)
    against a float32 run of the same weights on the CPU (the plain DCN);
    also the share of DCN offsets beyond ±3 on that page."""
    ref = LORE(LoreConfig(), policy=FP32_POLICY, device="cpu")
    ref.load_state_dict(model.state_dict())
    x = torch.randn(1, 256, 256, 3, generator=torch.Generator().manual_seed(3))
    beyond, biggest = [], []

    def hook(mod, inp, _):
        com = mod.conv_offset_mask
        om = torch.nn.functional.conv2d(
            inp[0].permute(0, 3, 1, 2), com.weight.to(inp[0].dtype),
            com.bias.to(inp[0].dtype), padding=1)[:, :2 * 9].float()
        beyond.append((om.abs() > 3).float().mean().item())
        biggest.append(om.abs().max().item())

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, DeformConv2d)]
    with torch.inference_mode():
        got = {k: v.float().cpu() for k, v in model(x.cuda()).items()}
        want = ref(x)
    for h in handles:
        h.remove()
    errs = {k: ((got[k] - want[k]).pow(2).mean().sqrt()
                / want[k].pow(2).mean().sqrt()).item() for k in want}
    rec = {"phase": "lore_vs_cpu_f32", "page_hw": [256, 256],
           "rel_rms_err": errs, "tol": LORE_RTOL, "dcn_layers": len(beyond),
           "offsets_beyond_3_share": [min(beyond), max(beyond)],
           "offsets_max_abs": max(biggest)}
    emit(rec)
    require(all(bool(torch.isfinite(v).all()) for v in got.values())
            and max(errs.values()) <= LORE_RTOL,
            f"LORE head maps disagree with the CPU reference: {rec}")
    require(len(beyond) == 16 and min(beyond) > 0.0,
            f"every DCN must see offsets beyond ±3: {rec}")


def lore_tsr(model):
    """bench.py lore_tsr_bench on the port; the second slice's main path."""
    B, S, iters = 8, 768, 10
    cfg = model.config
    gen = torch.Generator(device="cuda").manual_seed(5)
    pages = torch.randn(B, S, S, 3, device="cuda", generator=gen)
    with torch.inference_mode():
        out = model.infer(pages)
    torch.cuda.synchronize()
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    require(shapes == {"detections": (B, cfg.top_k, 10),
                       "logic": (B, cfg.top_k, 4),
                       "raw_logic": (B, cfg.top_k, 4),
                       "scores": (B, cfg.top_k),
                       "corners": (B, cfg.corner_k, 8),
                       "corner_scores": (B, cfg.corner_k, 1)}
            and all(bool(torch.isfinite(v).all()) for v in out.values()),
            f"LORE.infer output malformed: {shapes}")

    @torch.inference_mode()
    def timed_loop():
        t0 = time.perf_counter()
        for _ in range(iters):
            o = model.infer(pages)
        o["logic"].cpu()
        return B * iters / (time.perf_counter() - t0)

    torch.cuda.reset_peak_memory_stats()
    reps, counts = counted(lambda: [timed_loop() for _ in range(3)])
    require(counts == {"deform_conv": 16 * 3 * iters},
            f"LORE: launches {counts}, expected 16 deform_conv a forward")
    peak = torch.cuda.max_memory_allocated() / 1e9

    marks = []           # stage boundaries by CUDA events, on module hooks

    def mark(*_):
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()

    handles = [model.backbone.register_forward_pre_hook(mark),
               model.backbone.register_forward_hook(mark),
               model.processor.register_forward_pre_hook(mark),
               model.processor.register_forward_hook(mark)]
    with torch.inference_mode():
        for _ in range(3):
            model.infer(pages)
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    stage_ms = {n: float(np.mean([marks[4 * s + i].elapsed_time(
                    marks[4 * s + i + 1]) for s in range(3)]))
                for i, n in enumerate(("backbone_and_neck", "decode",
                                       "processor"))}
    rec = {"phase": "lore_tsr", "pages": B, "page_hw": [S, S],
           "pages_per_s_reps": reps, "pages_per_s_best": max(reps),
           "stage_ms": stage_ms, "launches": counts, "peak_mem_gb": peak}
    emit(rec)
    with torch.inference_mode():
        profile_steps("lore_profile",
                      [lambda: model.infer(pages)["logic"].cpu()] * 3,
                      step_ms=1e3 * B / max(reps))
    return rec, counts


def f32_models_phase():
    """MGP-STR-base (its encoder, heads and `MGPSTRInference`) and LORE's
    DLA-34 + DCN neck (`DLASeg`, offsets re-seeded) under FP32_POLICY on
    the card: no kernel takes f32, so every module must take its plain path
    (no launch at all) and agree with the same weights in f32 on the CPU."""
    cfg = MGPSTRConfig(variant="base")
    gpu = MGPSTR(cfg, policy=FP32_POLICY, seed=0)
    cpu = MGPSTR(cfg, policy=FP32_POLICY, device="cpu", seed=0)
    images = np.random.default_rng(4).integers(0, 256, (4, 32, 128, 3),
                                               dtype=np.uint8)
    x = normalize_crops(torch.from_numpy(images), torch.float32)

    @torch.inference_mode()
    def on_card(model, inp):
        return {k: v.float().cpu() for k, v in model(inp.cuda()).items()}

    got, counts = counted(lambda: on_card(gpu, x))
    with torch.inference_mode():
        want = cpu(x)
    errs = {f"mgp_str_{k}": rel_errors(got[k], want[k])[0] for k in want}

    gpu_engine = MGPSTRInference(gpu, CharCodec(), input_dtype=torch.float32)
    cpu_engine = MGPSTRInference(cpu, CharCodec(), input_dtype=torch.float32,
                                 device="cpu")
    u8 = torch.from_numpy(images)
    out, engine_counts = counted(lambda: {
        k: v.cpu() for k, v in gpu_engine.run(u8.cuda()).items()})
    ref = cpu_engine.run(u8)
    id_mismatches, conf_err = 0, 0.0
    for head in cfg.heads:
        # greedy ids may differ only where the CPU's top two logits nearly
        # tie (the two sum in other orders)
        logits = want[head][:, 1:, :cpu_engine.true_vocab[head]]
        top2 = logits.topk(2, dim=-1).values
        near = (top2[..., 0] - top2[..., 1]) < K2_TIE_GAP
        differ = out[f"{head}_ids"] != ref[f"{head}_ids"]
        id_mismatches += int((differ & ~near).sum())
        conf_err = max(conf_err, (out[f"{head}_conf"]
                                  - ref[f"{head}_conf"]).abs().max().item())
    del gpu, cpu, gpu_engine, cpu_engine

    dla = DLASeg(LoreConfig().backbone, policy=FP32_POLICY, seed=0)
    reseed_offsets(dla, seed=8)
    dla_cpu = DLASeg(LoreConfig().backbone, policy=FP32_POLICY, device="cpu")
    dla_cpu.load_state_dict(dla.state_dict())
    page = torch.randn(1, 256, 256, 3,
                       generator=torch.Generator().manual_seed(6))
    got, dla_counts = counted(lambda: on_card(dla, page))
    with torch.inference_mode():
        want = dla_cpu(page)
    errs.update({f"dla_{k}": rel_errors(got[k], want[k])[0] for k in want})
    rec = {"phase": "f32_models", "rel_rms_err": errs, "tol": F32_RTOL,
           "engine_id_mismatches_off_ties": id_mismatches,
           "engine_conf_max_abs_err": conf_err,
           "launches": [counts, engine_counts, dla_counts]}
    emit(rec)
    require(counts == engine_counts == dla_counts == {},
            f"f32 models launched a kernel: {rec}")
    require(max(errs.values()) <= F32_RTOL and id_mismatches == 0
            and conf_err <= F32_RTOL,
            f"f32 models on the card disagree with the CPU: {rec}")
    del dla, dla_cpu
    torch.cuda.empty_cache()


GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "golden")
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "fixtures")


def golden_replay():
    """tests/golden/{mgp_str,lore,lister,levocr,omniparser,docxlayout}.pth
    through the port's `load_torch_state_dict` and importers into the
    port's models in f32 on the card (which no kernel takes), against the
    committed outputs of the reference's math at the golden tolerances
    (rtol = atol)."""
    t0 = time.perf_counter()

    def load(family):
        return (load_torch_state_dict(os.path.join(GOLDEN_DIR,
                                                   f"{family}.pth")),
                np.load(os.path.join(GOLDEN_DIR, f"{family}.npz")))

    @torch.inference_mode()
    def run():
        outs = {}
        sd, data = load("mgp_str")
        model = MGPSTR(GOLDEN_MGP_STR, policy=FP32_POLICY)
        import_mgp_str(sd, model)
        got = model(torch.from_numpy(data["in_image"]).cuda())
        outs["mgp_str"] = {h: (got[h], data[f"out_{h}"])
                           for h in ("char", "bpe", "wp")}
        sd, data = load("lore")
        model = DLASeg(GOLDEN_DLASEG, policy=FP32_POLICY)
        import_dla(sd, model)
        got = model(torch.from_numpy(data["in_image"]).cuda())
        outs["lore"] = {h: (got[h], data[f"out_{h}"]) for h in ("hm", "reg")}
        sd, data = load("lister")
        model = LISTER(GOLDEN_LISTER, policy=FP32_POLICY)
        import_lister(sd, model)
        got = model(torch.from_numpy(data["in_image"]).cuda(),
                    torch.from_numpy(data["in_mask"]).cuda())
        outs["lister"] = {"logits": (got[-1]["logits"], data["out_logits"])}
        sd, data = load("levocr")
        model = LevOCR(GOLDEN_LEVOCR, policy=FP32_POLICY)
        import_levocr(sd, model)
        got = model(*(torch.from_numpy(data[f"in_{k}"]).cuda()
                      for k in ("image", "noised", "masked")))
        outs["levocr"] = {k: (got[k], data[f"out_{k}"]) for k in (
            "vision_logits", "mask_ins_logits", "word_ins_logits",
            "word_del_logits")}
        sd, data = load("omniparser")
        model = OmniParser(GOLDEN_OMNIPARSER, policy=FP32_POLICY)
        import_omniparser(sd, model)
        got = model(torch.from_numpy(data["in_image"]).cuda(),
                    {k: torch.from_numpy(data[f"in_seq_{k}"]).cuda()
                     for k in ("pt", "poly", "rec")})
        outs["omniparser"] = {k: (got[k], data[f"out_{k}"])
                              for k in ("pt", "poly", "rec")}
        sd, data = load("docxlayout")
        model = DocXLayout(GOLDEN_DOCXLAYOUT, policy=FP32_POLICY)
        import_docxlayout(sd, model)
        got = model(torch.from_numpy(data["in_image"]).cuda())
        outs["docxlayout"] = {k: (got[k], data[f"out_{k}"]) for k in (
            "hm", "cls", "ftype", "wh", "reg", "hm_sub", "wh_sub",
            "reg_sub")}
        return outs

    outs, counts = counted(run)
    rec = {"phase": "golden_replay", "launches": counts, "families": {}}
    ok = counts == {}
    for family, pairs in outs.items():
        tol = GOLDEN_TOL[family]
        abs_err, over = 0.0, 0.0
        for got, want in pairs.values():
            got = got.float().cpu().numpy()[..., :want.shape[-1]]
            err = np.abs(got - want)
            abs_err = max(abs_err, float(err.max()))
            # at most 1 where assert_allclose(rtol=tol, atol=tol) passes
            over = max(over, float((err / (tol + tol * np.abs(want))).max()))
        rec["families"][family] = {"max_abs_err": abs_err, "rtol": tol,
                                   "atol": tol, "err_over_bound": over}
        ok = ok and over <= 1.0
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    require(ok, f"golden replay on the card failed: {rec}")


def reference_mgp_str_state(cfg, gen):
    """A reference-layout MGP-STR state dict for `cfg`: timm ViT keys, the
    TokenLearners' grouped 1x1 convs (groups 8) and unpadded heads, values
    drawn from `gen`."""
    vit = cfg.vit_config()
    D, P, T = vit.embed_dim, vit.patch_size, cfg.max_tokens
    Dg = D // 8
    hidden = int(D * vit.mlp_ratio)
    sd = {}

    def rnd(*shape, std=0.02):
        return torch.randn(*shape, generator=gen) * std

    def lin(name, o, i):
        sd[f"{name}.weight"] = rnd(o, i, std=i ** -0.5)
        sd[f"{name}.bias"] = rnd(o)

    def norm(name):
        sd[f"{name}.weight"] = 1.0 + rnd(D, std=0.1)
        sd[f"{name}.bias"] = rnd(D)

    sd["patch_embed.proj.weight"] = rnd(D, vit.in_chans, P, P, std=0.1)
    sd["patch_embed.proj.bias"] = rnd(D)
    sd["cls_token"] = rnd(1, 1, D)
    sd["pos_embed"] = rnd(1, vit.seq_len, D)
    for i in range(vit.depth):
        pre = f"blocks.{i}."
        norm(pre + "norm1")
        lin(pre + "attn.qkv", 3 * D, D)
        lin(pre + "attn.proj", D, D)
        norm(pre + "norm2")
        lin(pre + "mlp.fc1", hidden, D)
        lin(pre + "mlp.fc2", D, hidden)
    vocab = {"char": cfg.num_char_classes, "bpe": cfg.bpe_vocab_size,
             "wp": cfg.wp_vocab_size}
    for head in cfg.heads:
        pre = f"{head}_tokenLearner."
        norm(pre + "token_norm")
        sd[pre + "tokenLearner.0.weight"] = rnd(D, Dg, 1, 1, std=Dg ** -0.5)
        sd[pre + "tokenLearner.1.weight"] = rnd(T, D, 1, 1, std=D ** -0.5)
        sd[pre + "feat.weight"] = rnd(D, Dg, 1, 1, std=Dg ** -0.5)
        norm(pre + "norm")
        lin(f"{head}_head", vocab[head], D)
    return sd


def reference_levocr_state(cfg, gen):
    """A reference-layout LevOCR state dict (OCR/LevOCR models.py:145
    LevOCRModel) for `cfg`, written from the reference's module names
    independently of the importers: `vision.` BaseVision (resnet45, the
    ResTranformer's nn.TransformerEncoderLayers, PositionAttention with its
    conv biases), `conv4_*`/`bn4_*`, `levt.encoder.` (BertEmbeddings with a
    64-row position table and its `position_ids`, fairseq layers) and
    `levt.decoder.` (embed_tokens and output_projection one tensor, a 64-row
    text position table, `version`); BatchNorms with running statistics and
    counters. Values drawn from `gen`."""
    sd = {}
    v, d = cfg.vision, cfg.d_model
    D, P = v.d_model, 64

    def rnd(*shape, std=0.02):
        return torch.randn(*shape, generator=gen) * std

    def conv(name, o, i, k, bias=False):
        sd[f"{name}.weight"] = rnd(o, i, k, k, std=(i * k * k) ** -0.5)
        if bias:
            sd[f"{name}.bias"] = rnd(o, std=0.1)

    def bn(name, c):
        sd[f"{name}.weight"] = 1.0 + rnd(c, std=0.1)
        sd[f"{name}.bias"] = rnd(c, std=0.1)
        sd[f"{name}.running_mean"] = rnd(c, std=0.1)
        sd[f"{name}.running_var"] = 0.5 + torch.rand(c, generator=gen)
        sd[f"{name}.num_batches_tracked"] = torch.tensor(1000)

    def lin(name, o, i, bias=True):
        sd[f"{name}.weight"] = rnd(o, i, std=i ** -0.5)
        if bias:
            sd[f"{name}.bias"] = rnd(o)

    def norm(name, c):
        sd[f"{name}.weight"] = 1.0 + rnd(c, std=0.1)
        sd[f"{name}.bias"] = rnd(c)

    w = D // 16
    conv("vision.backbone.resnet.conv1", w, 3, 3)
    bn("vision.backbone.resnet.bn1", w)
    ci = w
    for s, (mult, blocks, stride) in enumerate(
            ((1, 3, 2), (2, 4, 1), (4, 6, 2), (8, 6, 1), (16, 3, 1))):
        for b in range(blocks):
            pre, planes = f"vision.backbone.resnet.layer{s + 1}.{b}.", mult * w
            conv(pre + "conv1", planes, ci, 1)
            bn(pre + "bn1", planes)
            conv(pre + "conv2", planes, planes, 3)
            bn(pre + "bn2", planes)
            if b == 0 and (stride != 1 or ci != planes):
                conv(pre + "downsample.0", planes, ci, 1)
                bn(pre + "downsample.1", planes)
            ci = planes
    for i in range(v.backbone_layers):
        pre = f"vision.backbone.transformer.layers.{i}."
        sd[pre + "self_attn.in_proj_weight"] = rnd(3 * D, D, std=D ** -0.5)
        sd[pre + "self_attn.in_proj_bias"] = rnd(3 * D)
        lin(pre + "self_attn.out_proj", D, D)
        lin(pre + "linear1", v.ffn, D)
        lin(pre + "linear2", D, v.ffn)
        norm(pre + "norm1", D)
        norm(pre + "norm2", D)
    for j in range(4):
        conv(f"vision.attention.k_encoder.{j}.0", 64, D if j == 0 else 64, 3,
             bias=True)
        bn(f"vision.attention.k_encoder.{j}.1", 64)
        conv(f"vision.attention.k_decoder.{j}.1", D if j == 3 else 64, 64, 3,
             bias=True)
        bn(f"vision.attention.k_decoder.{j}.2", D if j == 3 else 64)
    lin("vision.attention.project", D, D)
    lin("vision.cls", v.num_classes, D)
    for n in ("1", "2"):
        conv(f"conv4_{n}", D, D, 2)
        bn(f"bn4_{n}", D)
    e = "levt.encoder.text_embeddings."
    sd[e + "word_embeddings.weight"] = rnd(cfg.vocab_size, d)
    sd[e + "position_embeddings.weight"] = rnd(P, d)
    sd[e + "token_type_embeddings.weight"] = rnd(2, d)
    sd[e + "position_ids"] = torch.arange(P)[None]
    norm(e + "LayerNorm", d)
    for i in range(cfg.layers):
        for part in ("encoder", "decoder"):
            pre = f"levt.{part}.layers.{i}."
            for n in ("q", "k", "v", "out"):
                lin(f"{pre}self_attn.{n}_proj", d, d)
            norm(pre + "self_attn_layer_norm", d)
            lin(pre + "fc1", cfg.ffn, d)
            lin(pre + "fc2", d, cfg.ffn)
            norm(pre + "final_layer_norm", d)
    tied = rnd(cfg.vocab_size, d, std=d ** -0.5)
    sd["levt.decoder.embed_tokens.weight"] = tied
    sd["levt.decoder.output_projection.weight"] = tied
    sd["levt.decoder.embed_mask_ins.weight"] = rnd(256, 2 * d)
    sd["levt.decoder.embed_word_del.weight"] = rnd(2, d)
    sd["levt.decoder.token_type_embeddings.weight"] = rnd(2, d)
    lin("levt.decoder.img_embed_dim", d, D, bias=False)
    sd["levt.decoder.text_pos_emb"] = rnd(1, P, d)
    sd["levt.decoder.img_pos_emb"] = rnd(1, 96, d)
    sd["levt.decoder.version"] = torch.tensor([3.0])
    return sd


def reference_omniparser_state(cfg, gen):
    """A reference-layout OmniParser state dict (OCR/OmniParser
    model/omniparser.py) for `cfg`, written from the reference's module
    names independently of the importers: the Swin backbone as the
    Joiner's element 0 (`backbone.0.`: patch_embed, layers.{s}.blocks.{b}
    with their relative_position_index buffers, layers.{s}.downsample,
    the stage norms norm{s}), the FPN laterals (fpn.fpn_in.{i}: 1x1 convs
    without bias, c5 first), input_proj, `transformer.embedding.` (word and
    four position tables, `other` among them, and LayerNorm), and per task
    `transformer.{t}_decoder.` (nn.MultiheadAttention's packed in_proj,
    linear1/2, norm1-3, norm) and `transformer.{t}_pred_layer.layers.{j}`.
    Values drawn from `gen`."""
    sd = {}
    sw, d = cfg.swin_config(), cfg.d_model
    nc = cfg.vocab().num_classes

    def rnd(*shape, std=0.02):
        return torch.randn(*shape, generator=gen) * std

    def lin(name, o, i, bias=True):
        sd[f"{name}.weight"] = rnd(o, i, std=i ** -0.5)
        if bias:
            sd[f"{name}.bias"] = rnd(o)

    def norm(name, c):
        sd[f"{name}.weight"] = 1.0 + rnd(c, std=0.1)
        sd[f"{name}.bias"] = rnd(c)

    b0, E, w = "backbone.0.", sw.embed_dim, sw.window_size
    sd[b0 + "patch_embed.proj.weight"] = rnd(E, 3, 4, 4, std=48 ** -0.5)
    sd[b0 + "patch_embed.proj.bias"] = rnd(E)
    norm(b0 + "patch_embed.norm", E)
    n = w * w
    coords = torch.stack(torch.meshgrid(torch.arange(w), torch.arange(w),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + w - 1
    rpi = rel[..., 0] * (2 * w - 1) + rel[..., 1]
    for s, depth in enumerate(sw.depths):
        dim, heads = sw.stage_dims[s], sw.num_heads[s]
        for b in range(depth):
            pre = f"{b0}layers.{s}.blocks.{b}."
            norm(pre + "norm1", dim)
            lin(pre + "attn.qkv", 3 * dim, dim)
            lin(pre + "attn.proj", dim, dim)
            sd[pre + "attn.relative_position_bias_table"] = rnd(
                (2 * w - 1) ** 2, heads)
            sd[pre + "attn.relative_position_index"] = rpi.reshape(n, n)
            norm(pre + "norm2", dim)
            lin(pre + "mlp.fc1", 4 * dim, dim)
            lin(pre + "mlp.fc2", dim, 4 * dim)
        if s < len(sw.depths) - 1:
            pre = f"{b0}layers.{s}.downsample."
            lin(pre + "reduction", 2 * dim, 4 * dim, bias=False)
            norm(pre + "norm", 4 * dim)
        norm(f"{b0}norm{s}", dim)
    for i in range(4):
        cin = sw.stage_dims[3 - i]
        sd[f"fpn.fpn_in.{i}.weight"] = rnd(256, cin, 1, 1, std=cin ** -0.5)
    sd["input_proj.weight"] = rnd(d, 1024, 1, 1, std=1024 ** -0.5)
    sd["input_proj.bias"] = rnd(d)
    e = "transformer.embedding."
    sd[e + "word_embeddings.weight"] = rnd(nc, d, std=1.0)
    for t in ("pt", "poly", "rec", "other"):
        sd[f"{e}{t}_position_embeddings.weight"] = rnd(
            cfg.max_position_embeddings, d)
    norm(e + "LayerNorm", d)
    for t in ("pt", "poly", "rec"):
        for i in range(cfg.dec_layers):
            pre = f"transformer.{t}_decoder.layers.{i}."
            for attn in ("self_attn", "multihead_attn"):
                sd[f"{pre}{attn}.in_proj_weight"] = rnd(3 * d, d,
                                                        std=d ** -0.5)
                sd[f"{pre}{attn}.in_proj_bias"] = rnd(3 * d)
                lin(f"{pre}{attn}.out_proj", d, d)
            lin(pre + "linear1", cfg.dim_feedforward, d)
            lin(pre + "linear2", d, cfg.dim_feedforward)
            for k in ("norm1", "norm2", "norm3"):
                norm(pre + k, d)
        norm(f"transformer.{t}_decoder.norm", d)
        for j, o in enumerate((d, d, nc)):
            lin(f"transformer.{t}_pred_layer.layers.{j}", o, d)
    return sd


# the port's LORE keys → the reference's (pose_dla_dcn.py DLASeg;
# classifier.py Processor with transformer.py), applied in order: the
# reference layout written out here, independently of the importers
DLA_TO_REFERENCE = (
    (r"^(base\.(?:base_layer|level[01]))\.conv\.", r"\1.0."),
    (r"^(base\.(?:base_layer|level[01]))\.bn\.", r"\1.1."),
    (r"\.project\.conv\.", ".project.0."),
    (r"\.project\.bn\.", ".project.1."),
    (r"\.root\.conv\.conv\.", ".root.conv."),
    (r"\.root\.conv\.bn\.", ".root.bn."),
    (r"\.conv([12])\.conv\.", r".conv\1."),
    (r"\.conv([12])\.bn\.", r".bn\1."),
    (r"\.dcn\.", ".conv."),
    (r"\.((?:proj|node)_\d+)\.bn\.", r".\1.actf.0."),
    (r"\.(up_\d+)\.kernel$", r".\1.weight"),
    (r"^(\w+)_conv1\.", r"\1.0."),
    (r"^(\w+)_out\.", r"\1.2."))
PROCESSOR_TO_REFERENCE = (
    (r"^x_pe\.", "x_position_embeddings."),
    (r"^y_pe\.", "y_position_embeddings."),
    (r"^logi_enc1\.", "stacker.logi_encoder.0."),
    (r"^logi_enc2\.", "stacker.logi_encoder.2."),
    (r"^stacker_tsfm\.", "stacker.tsfm."),
    (r"\.in_proj\.", ".linear."),
    (r"\.layer_(\d+)\.norm([12])_", r".encoder.layers.\1.norm_\2."),
    (r"\.layer_(\d+)\.([qkv])\.", r".encoder.layers.\1.attn.\2_linear."),
    (r"\.layer_(\d+)\.out\.", r".encoder.layers.\1.attn.out."),
    (r"\.layer_(\d+)\.ff([12])\.", r".encoder.layers.\1.ff.linear_\2."),
    (r"\.dec1\.", ".decoder.linear.0."),
    (r"\.dec2\.", ".decoder.linear.2."))


def reference_lore_pair(model):
    """The weights of a port LORE in the reference's two files: the DCN
    offset rows interleaved (y_k, x_k), the up kernels [C, 1, 2f, 2f], and
    the Processor's never-applied Encoder members that real checkpoints
    carry."""
    def rename(sd, rules):
        out = {}
        for k, v in sd.items():
            for pattern, repl in rules:
                k = re.sub(pattern, repl, k)
            out[k] = v.detach().cpu()
        return out

    inverse = torch.argsort(dcn_offset_perm(9))
    dla = rename(model.backbone.state_dict(), DLA_TO_REFERENCE)
    for k, v in dla.items():
        if ".conv_offset_mask." in k:
            dla[k] = v[inverse]
        elif re.search(r"\.up_\d+\.weight$", k):
            dla[k] = v.permute(2, 0, 1)[:, None].contiguous()
    proc = rename(model.processor.state_dict(), PROCESSOR_TO_REFERENCE)
    for t in ("tsfm_axis", "stacker.tsfm"):
        hid = proc[f"{t}.linear.bias"].shape[0]
        proc[f"{t}.encoder.norm.alpha"] = torch.ones(hid)
        proc[f"{t}.encoder.norm.bias"] = torch.zeros(hid)
        proc[f"{t}.encoder.pe.pe"] = torch.zeros(1, 900, hid)
    return dla, proc


def page_cache_share(path):
    """Share of the file's pages that sit in the page cache (mincore(2))."""
    libc = ctypes.CDLL(None, use_errno=True)
    libc.mmap.restype = ctypes.c_void_p
    libc.mmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_long]
    libc.mincore.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                             ctypes.c_void_p]
    libc.munmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    size = os.path.getsize(path)
    pages = -(-size // mmap.PAGESIZE)
    vec = (ctypes.c_ubyte * pages)()
    fd = os.open(path, os.O_RDONLY)
    try:
        addr = libc.mmap(None, size, mmap.PROT_READ, mmap.MAP_SHARED, fd, 0)
        if addr in (None, ctypes.c_void_p(-1).value):
            raise OSError(ctypes.get_errno(), f"mmap of {path}")
        rc = libc.mincore(ctypes.c_void_p(addr), size, vec)
        libc.munmap(ctypes.c_void_p(addr), size)
        if rc:
            raise OSError(ctypes.get_errno(), f"mincore of {path}")
    finally:
        os.close(fd)
    return float((np.frombuffer(vec, np.uint8) & 1).mean())


def evict_from_page_cache(path):
    """Writes the file back and drops its pages from the page cache, so
    that the next read comes from storage, as a user's first load does;
    returns the share of its pages still cached (0 once evicted; tmpfs,
    and a 9p mount that ignores the advice, keep them all)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)
    return page_cache_share(path)


def timed_load(path):
    """Seconds of `load_torch_state_dict` on a file in the page cache."""
    t0 = time.perf_counter()
    load_torch_state_dict(path)
    return time.perf_counter() - t0


def reference_checkpoints():
    """A user's start from reference checkpoints at full width: an
    MGP-STR-base state dict in the reference layout (timm keys under
    `module.` in {"model": ...}, heads of 38, 50257 and 30522) and a LORE
    pair (DLASeg at the full LoreConfig() and the Processor, in
    {"state_dict": ...}) written to a temporary directory, dropped from the
    page cache (`cached_share_after_evict` says how much stayed), read
    back by `load_torch_state_dict` and imported, each timed (the load
    once more from the cache); then
    `MGPSTRInference` with the mini BPE/WordPiece codecs runs `recognize()`
    on 256 crops through K1 and K2, and the imported LORE runs `infer` at
    B=8 x 768² through K3 and is checked against the CPU."""
    t_phase = time.perf_counter()
    rec = {"phase": "reference_checkpoints"}
    cfg = MGPSTRConfig(variant="base")
    with tempfile.TemporaryDirectory() as tmp, \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mgp_path = os.path.join(tmp, "mgp_str_base.pth")
        torch.save({"model": {f"module.{k}": v for k, v in
                              reference_mgp_str_state(
                                  cfg, torch.Generator().manual_seed(11)
                              ).items()}}, mgp_path)
        source = LORE(LoreConfig(), seed=3)
        reseed_offsets(source, seed=12)
        dla_sd, proc_sd = reference_lore_pair(source)
        dla_path = os.path.join(tmp, "model_best.pth")
        proc_path = os.path.join(tmp, "processor_best.pth")
        torch.save({"epoch": 1, "state_dict": {f"module.{k}": v
                                               for k, v in dla_sd.items()}},
                   dla_path)
        torch.save({"epoch": 1, "state_dict": proc_sd}, proc_path)
        # a cold start reads the files from storage, not from the page
        # cache that torch.save just filled
        rec["cached_share_after_evict"] = max(
            evict_from_page_cache(p) for p in (mgp_path, dla_path, proc_path))

        t0 = time.perf_counter()
        sd = load_torch_state_dict(mgp_path)
        t1 = time.perf_counter()
        model = MGPSTR(cfg, seed=1)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        import_mgp_str(sd, model)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        rec["mgp_str_s"] = {"load_after_evict": t1 - t0,
                            "load_cached": timed_load(mgp_path),
                            "build": t2 - t1, "import": t3 - t2,
                            "file_mb": os.path.getsize(mgp_path) / 1e6}
        t0 = time.perf_counter()
        dla_loaded = load_torch_state_dict(dla_path)
        proc_loaded = load_torch_state_dict(proc_path)
        t1 = time.perf_counter()
        lore = LORE(LoreConfig(), seed=4)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        import_dla(dla_loaded, lore.backbone)
        import_lore_processor(proc_loaded, lore.processor)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        rec["lore_s"] = {"load_after_evict": t1 - t0,
                         "load_cached": (timed_load(dla_path)
                                         + timed_load(proc_path)),
                         "build": t2 - t1, "import": t3 - t2,
                         "file_mb": (os.path.getsize(dla_path)
                                     + os.path.getsize(proc_path)) / 1e6}
        del sd, dla_loaded, proc_loaded
        lev_cfg = LevOCRConfig()
        lev_sd = reference_levocr_state(lev_cfg,
                                        torch.Generator().manual_seed(16))
        lev_path = os.path.join(tmp, "levocr.pth")
        torch.save({"model": {f"module.{k}": v for k, v in lev_sd.items()}},
                   lev_path)
        rec["levocr_cached_share_after_evict"] = evict_from_page_cache(
            lev_path)
        t0 = time.perf_counter()
        sd = load_torch_state_dict(lev_path)
        t1 = time.perf_counter()
        levocr = LevOCR(lev_cfg, seed=5)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        import_levocr(sd, levocr)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        rec["levocr_s"] = {"load_after_evict": t1 - t0,
                           "load_cached": timed_load(lev_path),
                           "build": t2 - t1, "import": t3 - t2,
                           "file_mb": os.path.getsize(lev_path) / 1e6}
        untied = dict(sd)
        untied["levt.decoder.embed_tokens.weight"] = sd[
            "levt.decoder.embed_tokens.weight"] + 1.0
        try:                 # refused before anything loads into `levocr`
            import_levt(untied, levocr)
            rec["levocr_untied_refused"] = False
        except ValueError as e:
            rec["levocr_untied_refused"] = "embed_tokens" in str(e)
        del sd, untied
        omni_cfg = OmniParserConfig()
        omni_sd = reference_omniparser_state(
            omni_cfg, torch.Generator().manual_seed(18))
        omni_path = os.path.join(tmp, "omniparser.pth")
        torch.save({"model": {f"module.{k}": v for k, v in omni_sd.items()}},
                   omni_path)
        rec["omniparser_cached_share_after_evict"] = evict_from_page_cache(
            omni_path)
        t0 = time.perf_counter()
        sd = load_torch_state_dict(omni_path)
        t1 = time.perf_counter()
        omni = OmniParser(omni_cfg, seed=6)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        import_omniparser(sd, omni)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        rec["omniparser_s"] = {"load_after_evict": t1 - t0,
                               "load_cached": timed_load(omni_path),
                               "build": t2 - t1, "import": t3 - t2,
                               "file_mb": os.path.getsize(omni_path) / 1e6}
        del sd
    rec["unused_key_warnings"] = [str(w.message) for w in caught]
    want = source.state_dict()
    rec["lore_round_trip_equal"] = all(
        torch.equal(v, want[k]) for k, v in lore.state_dict().items())
    del source
    true_vocab = {"char": cfg.num_char_classes, "bpe": cfg.bpe_vocab_size,
                  "wp": cfg.wp_vocab_size}
    rec["padded_bias_minus_1e4"] = all(
        bool((getattr(model, f"{h}_head").bias[v:] == -1e4).all())
        for h, v in true_vocab.items())

    engine = MGPSTRInference(
        model, CharCodec(),
        BpeCodec.from_files(os.path.join(FIXTURES, "mini_gpt2_vocab.json"),
                            os.path.join(FIXTURES, "mini_gpt2_merges.txt")),
        WordpieceCodec.from_file(os.path.join(FIXTURES,
                                              "mini_bert_vocab.txt")))
    del model
    images = np.random.default_rng(13).integers(0, 256, (256, 32, 128, 3),
                                                dtype=np.uint8)
    (out, texts), counts = counted(lambda: (engine(images),
                                            engine.recognize(images)))
    rec["recognizer_launches"] = counts
    rec["recognize_first"] = texts[:4]
    rec["padded_ids_returned"] = sum(
        int((out[f"{h}_ids"] >= v).sum()) for h, v in true_vocab.items())
    rec["heads_won"] = {h: sum(r[2] == h for r in texts)
                        for h in ("char", "bpe", "wp")}
    del engine
    torch.cuda.empty_cache()

    check_lore_vs_cpu(lore)
    gen = torch.Generator(device="cuda").manual_seed(14)
    pages = torch.randn(8, 768, 768, 3, device="cuda", generator=gen)
    with torch.inference_mode():
        res, lore_counts = counted(lambda: lore.infer(pages))
    rec["lore_launches"] = lore_counts
    rec["lore_finite"] = all(bool(torch.isfinite(v).all())
                             for v in res.values())
    del lore, res
    torch.cuda.empty_cache()

    lev_want = {"decoder.word_emb_out.weight":
                lev_sd["levt.decoder.output_projection.weight"],
                "vision.cls.weight": lev_sd["vision.cls.weight"],
                "img_conv2.bn.running_var": lev_sd["bn4_2.running_var"]}
    got = levocr.state_dict()
    rec["levocr_tensors_as_written"] = all(
        torch.equal(got[k].cpu(), v) for k, v in lev_want.items())
    lev_engine = LevOCRInference(levocr)
    del levocr, lev_sd
    lev_texts, lev_counts = counted(lambda: lev_engine.recognize(
        images[:64]))
    rec["levocr_launches"] = lev_counts
    rec["levocr_recognize_first"] = lev_texts[:4]
    del lev_engine
    got = omni.state_dict()
    b = "backbone.0.layers.2.blocks.17."
    omni_want = {
        "embedding.word.weight":
            omni_sd["transformer.embedding.word_embeddings.weight"],
        "backbone.stage2_block17.attn.relative_position_bias_table":
            omni_sd[b + "attn.relative_position_bias_table"],
        "fpn.lat3.weight": omni_sd["fpn.fpn_in.3.weight"][:, :, 0, 0],
        "rec_decoder.layer_3.ca_v.bias": omni_sd[
            "transformer.rec_decoder.layers.3.multihead_attn.in_proj_bias"
        ][1024:]}
    rec["omniparser_tensors_as_written"] = all(
        torch.equal(got[k].cpu(), v) for k, v in omni_want.items())
    del omni_sd
    gen = torch.Generator(device="cuda").manual_seed(20)
    page = torch.randn(1, 640, 640, 3, generator=gen, device="cuda")
    with torch.inference_mode():
        enc, omni_counts = counted(lambda: omni.encode(page))
    rec["omniparser_launches"] = omni_counts
    rec["omniparser_memory_finite"] = all(
        bool(torch.isfinite(t).all()) for t in enc)
    del omni, enc
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    torch.cuda.empty_cache()
    require(not rec["unused_key_warnings"],
            f"importers left checkpoint tensors unused: {rec}")
    require(rec["lore_round_trip_equal"] and rec["padded_bias_minus_1e4"]
            and rec["padded_ids_returned"] == 0,
            f"imported weights malformed: {rec}")
    require(counts == {"fused_qkv_attention": 24, "vocab_greedy_decode": 4},
            f"recognizer: launches {counts}, expected 12 K1 + 2 K2 a "
            f"forward (two forwards)")
    require(len(texts) == 256 and all(
        0.0 <= c <= 1.0 and h in ("char", "bpe", "wp") for _, c, h in texts),
        f"recognize() output malformed: {texts[:4]}")
    require(lore_counts == {"deform_conv": 16} and rec["lore_finite"],
            f"LORE.infer: launches {lore_counts}, expected 16 deform_conv")
    require(rec["levocr_untied_refused"] and rec["levocr_tensors_as_written"],
            f"imported LevOCR malformed: {rec}")
    require(lev_counts == {} and len(lev_texts) == 64 and all(
        0.0 <= c <= 1.0 and h == "levocr" for _, c, h in lev_texts),
        f"imported LevOCR: launches {lev_counts}, or recognize() "
        f"malformed: {lev_texts[:4]}")
    require(rec["omniparser_tensors_as_written"] and omni_counts == {}
            and rec["omniparser_memory_finite"],
            f"imported OmniParser malformed: {rec}")


def lister_phase():
    """LISTER, the fourth path: the JAX default LISTERConfig() (FocalNet-B:
    embed 96, depths 2-2-9-2; nhead 8, window 11, max_ch 36), seeded
    weights, `LISTERInference` in bf16 on 32x128 crops: crops/s at B=256
    (best of 3 repetitions of 10 batches), p50/p99 latency at B=1, the
    logits of 8 crops against the same weights in f32 on the CPU with
    iters 0 and 2, and a profile of one batch. LISTER has no Pallas kernel,
    so nothing may launch a port kernel."""
    t_phase = time.perf_counter()
    cfg = LISTERConfig()
    fcfg = cfg.focalnet_config()
    require(fcfg.embed_dim == 96 and fcfg.depths == (2, 2, 9, 2)
            and cfg.nhead == 8 and cfg.window_size == 11
            and cfg.max_ch == 36, "not the default LISTERConfig")
    B, iters = 256, 10
    images = np.random.default_rng(15).integers(0, 256, (B, 32, 128, 3),
                                                dtype=np.uint8)
    dev_images = torch.from_numpy(images).cuda()
    errs = {}
    for n_iters in (2, 0):             # the timed engine is the default's
        model = LISTER(dataclasses.replace(cfg, iters=n_iters), seed=0)
        engine = LISTERInference(model)
        ref = LISTER(model.config, policy=FP32_POLICY, device="cpu")
        ref.load_state_dict(model.state_dict())
        x = normalize_crops(torch.from_numpy(images[:8]), torch.float32)
        mask = torch.ones(x.shape[:3])
        with torch.inference_mode():
            got = engine.model(x.cuda().bfloat16(), mask.cuda().bfloat16())
            want = ref(x, mask)
        errs[f"iters{n_iters}"] = [rel_errors(g["logits"].cpu(),
                                              w["logits"])[0]
                                   for g, w in zip(got, want)]
        del ref, model
    engine.run(dev_images)[0].cpu()                       # warm up

    def loop():
        t0 = time.perf_counter()
        for _ in range(iters):
            ids, _ = engine.run(dev_images)
        ids.cpu()
        return B * iters / (time.perf_counter() - t0)

    reps, counts = counted(lambda: [loop() for _ in range(3)])
    one = dev_images[:1]
    engine.run(one)[0].cpu()
    lats = []
    for _ in range(60):
        t0 = time.perf_counter()
        engine.run(one)[0].cpu()
        lats.append((time.perf_counter() - t0) * 1e3)
    texts = engine.recognize(images[:8])
    rec = {"phase": "lister", "config": "LISTERConfig(): FocalNet-B, iters 0",
           "batch": B, "crops_per_s_reps": reps,
           "crops_per_s_best": max(reps),
           "p50_ms_b1": float(np.percentile(lats, 50)),
           "p99_ms_b1": float(np.percentile(lats, 99)),
           "logits_rel_rms_err_vs_cpu_f32": errs, "tol": LISTER_RTOL,
           "launches": counts, "recognize_first": texts[:4],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    profile_steps("lister_profile",
                  [lambda: engine.run(dev_images)[0].cpu()],
                  step_ms=1e3 * B / max(reps))
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    del engine
    torch.cuda.empty_cache()
    require(counts == {}, f"LISTER launched a port kernel: {counts}")
    require(max(max(v) for v in errs.values()) <= LISTER_RTOL,
            f"LISTER on the card disagrees with the CPU: {errs}")
    require(len(texts) == 8 and all(0.0 <= c <= 1.0 and h == "lister"
                                    for _, c, h in texts),
            f"LISTER recognize() output malformed: {texts}")


def readable_levocr(model, x):
    """Make seeded random LevOCR weights read `x` so that refine edits.
    As drawn, every crop's vision branch predicts one class at all 26
    positions (a near-uniform attention map), which fills the 28-slot
    buffer, so nothing is inserted, and p(del) stays below 0.5, so nothing
    is deleted: the rounds would leave the tokens as they came. As the CPU
    tests' `readable_vision`, sharpen the position queries (x16) and the
    classifier (x4). Then, from a run on `x`, raise the null class's bias
    so that it wins on LEVOCR_NULL_SHARE of the positions (the predictions
    end at varying places), and set the deletion head's second row to the
    first plus their difference with its component along the mean fused
    text feature u removed (the fused features share u, which kept the
    difference's sign on every token), plus the multiple of u that makes
    p(del) pass 0.5 on about LEVOCR_DEL_SHARE of the first round's live
    tokens."""
    vis, dec = model.vision, model.decoder
    with torch.no_grad():
        vis.attention.project.weight.mul_(16)
        vis.cls.weight.mul_(4)
        logits = vis(x)["logits"]
        margin = logits[..., 1:].amax(-1) - logits[..., 0]
        vis.cls.bias[0] += torch.quantile(margin.flatten(),
                                          LEVOCR_NULL_SHARE)
        out, img = model.encode_image(x)
        tokens = model.vision_tokens(out["logits"])
        L = tokens.shape[1]
        feats = dec.fuse(model.text_encoder(tokens), img)[:, :L].float()
        live = feats[tokens != PAD]
        e = dec.word_del_emb.weight
        u = live.mean(0)
        d = (e[1] - e[0]).float()
        d -= (d @ u) / (u @ u) * u
        lift = -torch.quantile(live @ d, 1 - LEVOCR_DEL_SHARE) / (u @ u)
        e[1] = e[0] + (d + lift * u).to(e.dtype)


def levocr_walk(model, x):
    """A refine of `model` on x, round by round: the smallest decision
    margin of each crop (over every round, the gap between the top two
    vision logits, |p(del) - threshold| at the live tokens, the gap between
    the top two insertion counts at each slot and between the top two
    words at the placeholders), and the tokens each round deleted,
    inserted (placeholders) and filled, summed over the crops."""
    def gap(logits):
        top = logits.float().topk(2, dim=-1).values
        return top[..., 0] - top[..., 1]

    def live(t):
        return int((t != PAD).sum())

    big = torch.finfo(torch.float32).max
    edits = []
    with torch.inference_mode():
        out, img = model.encode_image(x)
        margin = gap(out["logits"]).amin(1)
        tokens = model.vision_tokens(out["logits"])
        scores = torch.zeros(tokens.shape, device=tokens.device)
        for _ in range(model.config.max_iter + 1):
            n0 = live(tokens)
            alive = tokens != PAD
            tokens, scores, p_del = model.delete(tokens, scores, img)
            margin = torch.minimum(margin, torch.where(
                alive, (p_del - model.config.del_threshold).abs(),
                big).amin(1))
            n1 = live(tokens)
            slots = (tokens != PAD)[:, 1:]
            tokens, scores, ins = model.insert(tokens, scores, img)
            margin = torch.minimum(margin, torch.where(
                slots, gap(ins), big).amin(1))
            unk = tokens == UNK
            tokens, scores, logp = model.fill(tokens, scores, img)
            margin = torch.minimum(margin, torch.where(
                unk, gap(logp), big).amin(1))
            edits.append({"deleted": n0 - n1,
                          "inserted": live(tokens) - n1,
                          "filled": int((unk & (tokens != UNK)).sum())})
        return margin.cpu(), edits


def levocr_phase():
    """LevOCR, the fifth path: the JAX default LevOCRConfig() (ABINet
    vision: ResNet45 to 512 channels, 3 layers, 26 queries, 37 classes;
    LevT d 512, 8 heads, ffn 2048, 6 + 6 layers, max_len 28, max_iter 2:
    3 rounds), seeded weights, `LevOCRInference` in bf16 on 32x128 crops:
    crops/s at B=256 (best of 3 repetitions of 10 batches), p50/p99
    latency at B=1 over 60 synchronised calls, a profile of one batch. On
    16 crops, with the weights made readable (`readable_levocr`: the
    rounds must delete, insert and fill, on crops that read differently):
    the bf16 vision logits and heads against the same weights in f32 on
    the CPU (the heads beside the same in bf16 on the CPU), and the f32
    model on the card (TF32 off) against the CPU: vision logits, final
    tokens and their scores, with the smallest decision margin of any crop
    whose tokens differ. LevOCR has no Pallas kernel, so nothing may launch
    a port kernel."""
    t_phase = time.perf_counter()
    cfg = LevOCRConfig()
    v = cfg.vision
    require(cfg.d_model == 512 and cfg.heads == 8 and cfg.ffn == 2048
            and cfg.layers == 6 and cfg.max_len == 28 and cfg.max_iter == 2
            and v.d_model == 512 and v.backbone_layers == 3
            and v.max_length == 26 and v.num_classes == 37,
            "not the default LevOCRConfig")
    B, iters, n_check = 256, 10, 16
    images = np.random.default_rng(17).integers(0, 256, (B, 32, 128, 3),
                                                dtype=np.uint8)
    dev_images = torch.from_numpy(images).cuda()
    model = LevOCR(cfg, seed=0)
    x = normalize_crops(torch.from_numpy(images[:n_check]), torch.float32)
    readable_levocr(model, x.cuda())
    engine = LevOCRInference(model)

    def refine_all():
        with torch.inference_mode():
            return engine.model.refine(x.cuda())
    bf16_out, counts_check = counted(refine_all)
    cpu = LevOCR(cfg, policy=FP32_POLICY, device="cpu")
    cpu.load_state_dict(model.state_dict())
    card32 = LevOCR(cfg, policy=FP32_POLICY)
    card32.load_state_dict(model.state_dict())
    del model
    with torch.inference_mode():
        t0 = time.perf_counter()
        want = cpu.refine(x)
        cpu_s = time.perf_counter() - t0
    f32_out, counts_f32 = counted(lambda: card32.refine(x.cuda()))
    del card32
    # the heads forward, bf16 on the card and on the CPU against f32 on the
    # CPU, on the CPU's vision tokens (mask-ins, word-del) and final tokens
    # (word-ins)
    heads_in = (x, want["vision_tokens"], want["tokens"])

    def bf16_heads():
        with torch.inference_mode():
            return engine.model(*(t.cuda() for t in heads_in))
    heads, counts_heads = counted(bf16_heads)
    cpu16 = LevOCR(cfg, device="cpu")
    cpu16.load_state_dict(cpu.state_dict())
    with torch.inference_mode():
        heads_cpu, heads_cpu16 = cpu(*heads_in), cpu16(*heads_in)
    del cpu16
    head_names = ("mask_ins_logits", "word_ins_logits", "word_del_logits")
    margins, edits = levocr_walk(cpu, x)
    tok32, tok_cpu = f32_out["tokens"].cpu(), want["tokens"]
    differ = (tok32 != tok_cpu).any(1)
    lengths = lambda t: (t != PAD).sum(1)
    rec_acc = {
        "bf16_vision_logits_rel_rms_vs_cpu_f32": rel_errors(
            bf16_out["vision_logits"].cpu(), want["vision_logits"])[0],
        "bf16_heads_rel_rms_vs_cpu_f32": {
            k: rel_errors(heads[k].cpu(), heads_cpu[k])[0]
            for k in head_names},
        "cpu_bf16_heads_rel_rms_vs_cpu_f32": {
            k: rel_errors(heads_cpu16[k], heads_cpu[k])[0]
            for k in head_names},
        "bf16_tokens_equal_to_cpu": int((bf16_out["tokens"].cpu()
                                         == tok_cpu).all(1).sum()),
        "f32_vision_logits_rel_rms_vs_cpu": rel_errors(
            f32_out["vision_logits"].cpu(), want["vision_logits"])[0],
        "f32_tokens_equal_to_cpu": int((~differ).sum()), "crops": n_check,
        "f32_scores_rel_rms_vs_cpu": rel_errors(
            f32_out["scores"].cpu()[~differ], want["scores"][~differ])[0],
        "cpu_edits_by_round": edits,
        "cpu_length_changed": int((lengths(want["tokens"]) != lengths(
            want["vision_tokens"])).sum()),
        "cpu_nonzero_scores": int((want["scores"] != 0).sum()),
        "cpu_distinct_strings": len({tuple(r) for r in tok_cpu.tolist()}),
        "cpu_f32_refine_s": cpu_s,
        "tol": {"bf16": LEVOCR_BF16_RTOL,
                "bf16_heads_ratio": LEVOCR_BF16_HEADS_RATIO,
                "f32": LEVOCR_F32_RTOL,
                "f32_min_equal": LEVOCR_F32_MIN_EQUAL}}
    if differ.any():
        rec_acc["f32_differing_crops"] = [
            {"crop": int(i), "card": tok32[i].tolist(),
             "cpu": tok_cpu[i].tolist(),
             "smallest_margin": float(margins[i])}
            for i in differ.nonzero()[:, 0]]
    del cpu
    engine.run(dev_images)[0].cpu()                       # warm up

    def loop():
        t0 = time.perf_counter()
        for _ in range(iters):
            tokens, _ = engine.run(dev_images)
        tokens.cpu()
        return B * iters / (time.perf_counter() - t0)

    reps, counts = counted(lambda: [loop() for _ in range(3)])
    one = dev_images[:1]
    engine.run(one)[0].cpu()
    lats = []
    for _ in range(60):
        t0 = time.perf_counter()
        engine.run(one)[0].cpu()
        lats.append((time.perf_counter() - t0) * 1e3)
    texts = engine.recognize(images[:8])
    rec = {"phase": "levocr", "config": "LevOCRConfig(): ABINet vision "
           "(ResNet45-512, 3 layers) + LevT 6+6 layers d 512, 3 rounds",
           "batch": B, "crops_per_s_reps": reps,
           "crops_per_s_best": max(reps),
           "p50_ms_b1": float(np.percentile(lats, 50)),
           "p99_ms_b1": float(np.percentile(lats, 99)),
           "launches": counts,
           "launches_checks": [counts_check, counts_f32, counts_heads],
           **rec_acc, "recognize_first": texts[:4],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    profile_steps("levocr_profile",
                  [lambda: engine.run(dev_images)[0].cpu()],
                  step_ms=1e3 * B / max(reps))
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    del engine
    torch.cuda.empty_cache()
    require(counts == {} and all(c == {} for c in rec["launches_checks"]),
            f"LevOCR launched a port kernel: {rec['launches_checks']}, "
            f"{counts}")
    # the check weights must make every kind of edit, on crops that read
    # differently, or the comparisons below hold nothing
    require(all(sum(r[k] for r in edits) > 0
                for k in ("deleted", "inserted", "filled"))
            and rec["cpu_length_changed"] > 0
            and rec["cpu_nonzero_scores"] > 0
            and rec["cpu_distinct_strings"] > 1,
            f"LevOCR's check crops were not edited: {rec_acc}")
    require(rec["bf16_vision_logits_rel_rms_vs_cpu_f32"] <= LEVOCR_BF16_RTOL
            and all(rec["bf16_heads_rel_rms_vs_cpu_f32"][k]
                    <= LEVOCR_BF16_HEADS_RATIO
                    * rec["cpu_bf16_heads_rel_rms_vs_cpu_f32"][k]
                    for k in head_names)
            and rec["f32_vision_logits_rel_rms_vs_cpu"] <= LEVOCR_F32_RTOL
            and rec["f32_tokens_equal_to_cpu"] >= LEVOCR_F32_MIN_EQUAL
            and rec["f32_scores_rel_rms_vs_cpu"] <= LEVOCR_F32_RTOL,
            f"LevOCR on the card disagrees with the CPU: {rec_acc}")
    require(len(texts) == 8 and all(0.0 <= c <= 1.0 and h == "levocr"
                                    for _, c, h in texts),
            f"LevOCR recognize() output malformed: {texts}")


class _Capped(Exception):
    """Raised by a mask function to cut a decode at a step cap."""


def _capped(mask, cap):
    def fn(i, logits):
        if i >= cap:
            raise _Capped
        return mask(i, logits)
    return fn


def readable_omniparser(model, pages, points=OMNI_POINTS, period=2):
    """Make seeded random OmniParser weights decode `pages` [P, H, W, 3]
    into something worth comparing: with `period` 2, `infer_spotting`'s
    (x, y) points; with 3, `infer_vie`'s (x, y, class) triplets, whose
    class step reads the trailing category band. As drawn, the pt head's
    EOS never wins, so a page's point sequence would run to
    pt_seq_length, and no word ends. Raising an EOS class's bias by b ends a sequence at the first
    step whose margin of the best allowed class over EOS is below b, and
    changes nothing before it. But as drawn the pt decoder's self-attention
    is near uniform, each page's point sequence soon settles into a few
    repeated tokens, and its margin reaches its low within the first few
    points, so that any b ends most pages at the same 3 or so points. As
    `readable_levocr` sharpens its position queries, multiply the pt
    decoder's self-attention queries by OMNI_PT_SHARPEN: each step then
    attends to a few earlier tokens, the sequences keep changing, and the
    margins' running minima fall at steps that differ from page to page.
    Every decode here runs on the shapes `infer_spotting` decodes (one page
    with a cache of pt_seq_length steps, cut at a step cap; then
    max_instances rows), whose products it repeats bit for bit. So:
    1. pt: decode each page's points with EOS masked out for
       period·(points[1] + 1) steps, recording the margin at each step
       where EOS may come (the first of each group). Each midpoint b
       between the pages' running minima predicts every page's point
       count; the candidates whose counts all lie in
       [points[0], points[1]] are tried in order (most distinct counts,
       then widest gap): with b added to the bias, each page is decoded
       for real, up to the cap, and the first b with which every page
       stops within those bounds, at counts that differ (two instances
       at least, for step 2), is kept. (A
       lifted logit rounds to bf16 anew, so a page whose margin lies
       within a rounding of b may stop elsewhere.)
    2. rec: on those points, decode each page's words with EOS masked out,
       recording each row's smallest margin; b is the midpoint of the
       widest gap among the middle half of those, so that about half the
       words end before rec_length.
    Returns what it chose, the points per page and the half-gaps."""
    c, v = model.config, model.vocab_layout
    lo, hi = points
    dev = pages.device
    ids = torch.arange(v.num_classes, device=dev)
    coord = ids < c.num_bins
    coord_or_eos = coord | (ids == v.pt_eos_index)
    allow_at = (coord, coord, ids >= v.num_classes - c.vie_categories)
    rec_other = ((ids >= c.num_bins) & (ids < v.rec_eos_index)
                 & (ids != v.pt_eos_index) & (ids != v.poly_eos_index))
    prompt = torch.as_tensor(v.pt_prompt(c.use_char_window_prompt),
                             device=dev)[None]
    bias = model.pt_decoder.head3.bias
    with torch.no_grad():
        for layer in model.pt_decoder.layers:
            layer.sa_q.weight.mul_(OMNI_PT_SHARPEN)
            layer.sa_q.bias.mul_(OMNI_PT_SHARPEN)

    def pt_decode(mem, mask, cap, eos_id=None):
        """The page's point decode as infer_spotting runs it, cut at
        `cap` steps: its tokens, or None when cut."""
        try:
            return model._greedy(model.pt_decoder, "pt", prompt, *mem,
                                 c.pt_seq_length, _capped(mask, cap),
                                 eos_id=eos_id)[0][0]
        except _Capped:
            return None

    def rec_record(margins):
        def mask(i, logits):
            other = torch.where(rec_other[None], logits, NEG)
            margins.append(other.amax(-1) - logits[:, v.rec_eos_index])
            return other
        return mask

    with torch.inference_mode():
        mems, toks, lows = [], [], []
        for page in pages:
            mem = model.encode(page[None])
            margins, chosen = [], []

            def record(i, logits):
                if i % period == 0:
                    margins.append(logits[0, :c.num_bins].amax()
                                   - logits[0, v.pt_eos_index])
                masked = torch.where(allow_at[i % period][None], logits, NEG)
                chosen.append(torch.argmax(masked, dim=-1)[0])
                return masked

            pt_decode(mem, record, period * (hi + 1))
            mems.append(mem)
            toks.append(torch.stack(chosen).to(torch.int32))
            lows.append(torch.stack(margins).cummin(0).values.cpu())
        lows = torch.stack(lows)                                 # [P, K]

        def n_points(b):
            below = lows < b
            return [int(r.nonzero()[0, 0]) if r.any() else lows.shape[1]
                    for r in below]

        r = torch.unique(lows.flatten()).tolist()
        candidates = []
        for a, b in zip(r, r[1:]):
            n = n_points((a + b) / 2)
            if all(lo <= k <= hi for k in n):
                candidates.append(((len(set(n)), (b - a) / 2), (a + b) / 2))
        candidates.sort(reverse=True)
        n_candidates = len(candidates)
        real_mask = lambda i, logits: torch.where(
            (coord_or_eos if i % period == 0 else allow_at[i % period])[None],
            logits, NEG)
        tried, pt_lift = [], None
        for key, b in candidates[:6]:
            with torch.no_grad():
                bias[v.pt_eos_index] += b
            n = []
            for mem in mems:
                t = pt_decode(mem, real_mask,
                              period * (hi + 1) + EOS_CHECK_EVERY,
                              v.pt_eos_index)
                hit = (None if t is None
                       else (t == v.pt_eos_index).nonzero())
                n.append(None if hit is None or not len(hit)
                         else int(hit[0, 0]) // period)
            tried.append({"lift": b, "half_gap": key[1],
                          "predicted": n_points(b), "points": n})
            if (None not in n and lo <= min(n) and max(n) <= hi
                    and len(set(n)) > 1 and sum(n) > 1):
                pt_lift = b
                break
            with torch.no_grad():
                bias[v.pt_eos_index] -= b
        require(pt_lift is not None, f"no EOS lift ends every page "
                f"within {lo}-{hi} points: {tried}")
        rec_lows = []
        for p, mem in enumerate(mems):
            pairs = torch.zeros((c.max_instances, 2), dtype=torch.int32,
                                device=dev)
            pairs[:n[p]] = toks[p][:period * n[p]].reshape(n[p], period)[
                :, :2]
            rec_prompt = torch.cat([pairs, torch.full(
                (c.max_instances, 1), v.rec_sos_index, dtype=torch.int32,
                device=dev)], 1)
            margins = []
            model._greedy(model.rec_decoder, "rec", rec_prompt, *mem,
                          c.rec_length, rec_record(margins))
            rec_lows.append(torch.stack(margins, 1)[:n[p]].amin(1).cpu())
        rec_lows = torch.sort(torch.cat(rec_lows)).values
        q = len(rec_lows)
        mid = rec_lows[q // 4:3 * q // 4 + 1]
        j = int((mid[1:] - mid[:-1]).argmax())
        rec_lift = float(mid[j] + mid[j + 1]) / 2
        with torch.no_grad():
            model.rec_decoder.head3.bias[v.rec_eos_index] += rec_lift
    return {"pt_lift": pt_lift, "pt_candidates": n_candidates,
            "pt_tried": tried, "points": n,
            "rec_lift": rec_lift,
            "rec_half_gap": float(mid[j + 1] - mid[j]) / 2,
            "rec_rows_ending_early": int((rec_lows < rec_lift).sum()),
            "rec_rows": q}


def spotting_summary(out, vocab):
    """One infer_spotting result on the host: the points, the words up to
    EOS (tokens and strings) and whether each ended by EOS."""
    n = int(out["instance_valid"].sum())
    recs = out["rec_tokens"][0, :n].tolist()
    words = [r[:r.index(vocab.rec_eos_index)] if vocab.rec_eos_index in r
             else r for r in recs]
    return {"points": out["points"][0, :n].tolist(),
            "polygons": out["polygons"][0, :n].tolist(), "words": words,
            "strings": [vocab.decode_text(w) for w in words],
            "ended": [vocab.rec_eos_index in r for r in recs]}


def served_equal(served, summary):
    """Whether a SpottingService result holds an infer_spotting summary's
    points, polygons and words up to EOS."""
    return (served["points"].tolist() == summary["points"]
            and [list(p) for p in served["polygons"]] == summary["polygons"]
            and [list(w) for w in served["rec_tokens"]] == summary["words"])


def divergences(served, out, vocab):
    """Where a SpottingService result leaves infer_spotting's `out` on the
    same page: the first differing decision of the pt sequence, or, when
    the points agree, of each polygon and word row (the rows decode
    independently). Each is {stage, row, step, the prefix infer_spotting
    decoded before it, its token ("want") and the service's ("got")}.
    Sequences are compared up to and including their EOS."""
    def upto(seq, eos):
        return seq[:seq.index(eos) + 1] if eos in seq else seq

    def first(want, got):
        for j, (a, b) in enumerate(zip(want, got)):
            if a != b:
                return j
        return None

    def div(stage, row, want, got):
        j = first(want, got)
        return [] if j is None else [{"stage": stage, "row": row, "step": j,
                                      "prefix": want[:j], "want": want[j],
                                      "got": got[j]}]
    v = vocab
    pts = served["points"].tolist()
    found = div("pt", 0, upto(out["pt_tokens"][0].tolist(), v.pt_eos_index),
                [t for xy in pts for t in xy] + [v.pt_eos_index])
    if found:
        return found
    for r, xy in enumerate(pts):
        found += div("poly", r, out["polygons"][0, r].tolist(),
                     list(served["polygons"][r]))
        want = out["rec_tokens"][0, r].tolist()
        got = list(served["rec_tokens"][r])
        found += div("rec", r, upto(want, v.rec_eos_index),
                     got + [v.rec_eos_index] * (len(got) < len(want)))
    for d in found:
        d["xy"] = pts[d["row"]] if d["stage"] != "pt" else None
    return found


def divergence_margin(d, page, bf16, f32):
    """At a divergence `d` (see `divergences`) of the bf16 service from
    bf16 infer_spotting on `page` [1, H, W, 3]: the f32 model's logit gap
    between the two tokens chosen there, and the largest error of the bf16
    model's logits against f32 over the classes allowed there, both from
    teacher-forced passes over the common prefix. Two bf16 paths can part
    there through rounding alone only if the gap is at most twice that
    error."""
    c, v = f32.config, f32.vocab_layout
    task = d["stage"]
    if task == "pt":
        prompt = list(v.pt_prompt(c.use_char_window_prompt))
    else:
        prompt = d["xy"] + [v.poly_sos_index if task == "poly"
                            else v.rec_sos_index]
    ids = torch.tensor([prompt + d["prefix"]], dtype=torch.int32,
                       device=page.device)
    logits = []
    with torch.inference_mode():
        for mdl in (bf16, f32):
            emb, qpos = mdl.embedding(ids, task)
            logits.append(getattr(mdl, f"{task}_decoder")(
                emb, qpos, *mdl.encode(page))[0, -1].float())
    k = torch.arange(v.num_classes, device=page.device)
    if task == "rec":
        allow = ((k >= c.num_bins) & (k <= v.rec_eos_index)
                 & (k != v.pt_eos_index) & (k != v.poly_eos_index))
    else:
        allow = (k < c.num_bins) | ((k == v.pt_eos_index) & (task == "pt")
                                    & (d["step"] % 2 == 0))
    err = (logits[0] - logits[1])[allow].abs().max().item()
    gap = abs(logits[1][d["want"]] - logits[1][d["got"]]).item()
    return {"stage": task, "row": d["row"], "step": d["step"],
            "want": d["want"], "got": d["got"], "f32_gap": gap,
            "bf16_err": err}


def serve_pages(model, pages, n_slots):
    """`pages` (host arrays) submitted at once to a SpottingService of
    `model` with `n_slots` pt slots (4 x n_slots poly and rec slots), after
    one page to warm it up: the results, {pages/s, slot occupancy and
    ticks per stage}, and the kernel launches of the timed run."""
    svc = SpottingService(model, n_slots=n_slots,
                          encode_batch=len(pages)).start()
    try:
        svc(pages[:1], timeout=300)                              # warm up
        for srv in (svc.pt_server, svc.poly_server, svc.rec_server):
            srv.stats = {k: 0 for k in srv.stats}

        def serve():
            t0 = time.perf_counter()
            futs = [svc.submit(p) for p in pages]
            res = [f.result(timeout=300) for f in futs]
            return res, time.perf_counter() - t0
        (served, seconds), counts = counted(serve)
        return served, {
            "pages_per_s": len(pages) / seconds,
            "occupancy": svc.occupancy,
            "ticks": {n: srv.stats["ticks"] for n, srv in (
                ("pt", svc.pt_server), ("poly", svc.poly_server),
                ("rec", svc.rec_server))}}, counts
    finally:
        svc.stop()


def omniparser_phase():
    """OmniParser, the sixth path: the JAX default OmniParserConfig()
    (Swin-B: embed 128, depths 2-2-18-2, window 7; FPN to 1024 channels;
    three decoders of 4 layers, d 512, 8 heads, ffn 2048; 1000 bins, pt
    length 1024, poly 32, rec 25, 128 instances) in bf16 on seeded 640²
    pages (the JAX CLI's default --image-size), with seeded weights made
    readable (`readable_omniparser`): the encode at B=1 and B=8 (CUDA
    events), `infer_spotting` at B=1 (pages/s, p50/p99 latency, the decode
    steps each stage ran, a profile), and `SpottingService` on the 8 pages
    submitted at once, at each of OMNI_SERVICE_SLOTS (pages/s, slot
    occupancy), against infer_spotting page by page: bf16 rounds
    differently on the service's batch shapes, so each place where a
    result parts from infer_spotting's must be a choice whose f32 gap is
    at most twice the bf16 error there (`divergence_margin`); the f32
    model on the card (TF32 off): its service equal
    to its infer_spotting on all 8 pages, and on page 0 against the CPU:
    equal tokens, probabilities and teacher-forced logits within
    OMNI_F32_RTOL; the bf16
    teacher-forced logits against f32 on the CPU beside the CPU's own bf16
    error, and bf16 tokens against f32 (reported). OmniParser has no
    Pallas kernel, so nothing may launch a port kernel."""
    t_phase = time.perf_counter()
    cfg = OmniParserConfig()
    sw = cfg.swin_config()
    require(sw.embed_dim == 128 and sw.depths == (2, 2, 18, 2)
            and sw.window_size == 7 and cfg.d_model == 512
            and cfg.nhead == 8 and cfg.dec_layers == 4
            and cfg.dim_feedforward == 2048 and cfg.num_bins == 1000
            and cfg.pt_seq_length == 1024 and cfg.poly_length == 32
            and cfg.rec_length == 25 and cfg.max_instances == 128,
            "not the default OmniParserConfig")
    v = cfg.vocab()
    gen = torch.Generator(device="cuda").manual_seed(19)
    pages = torch.randn(OMNI_PAGES, 640, 640, 3, generator=gen,
                        device="cuda")
    model = OmniParser(cfg, seed=0)
    t0 = time.perf_counter()
    readable, counts_readable = counted(
        lambda: readable_omniparser(model, pages))
    readable["seconds"] = time.perf_counter() - t0
    state = {k: t.cpu() for k, t in model.state_dict().items()}
    layers.cast_matmul_weights(model, torch.bfloat16)
    model.requires_grad_(False)
    rec = {"phase": "omniparser",
           "config": "OmniParserConfig(): Swin-B + FPN, 3 x 4 decoder "
                     "layers d 512, 1000 bins", "pages": "640x640 f32",
           "readable": readable}

    with torch.inference_mode():
        rec["encode_ms_b1"] = cuda_ms(lambda: model.encode(pages[:1]))
        rec["encode_ms_b8"] = cuda_ms(lambda: model.encode(pages), iters=5)

        def spot_all():
            outs, lats = [], []
            for rnd in range(2):
                for i in range(OMNI_PAGES):
                    t0 = time.perf_counter()
                    out = model.infer_spotting(pages[i:i + 1])
                    out = {k: t.cpu() for k, t in out.items()}
                    lats.append((time.perf_counter() - t0) * 1e3)
                    if rnd:
                        outs.append(out)
            return outs, lats

        model.infer_spotting(pages[:1])["rec_tokens"].cpu()     # warm up
        (outs, lats), counts_spot = counted(spot_all)
    summaries = [spotting_summary(o, v) for o in outs]

    def pt_steps(out):
        """The steps of the pt decode up to its EOS, which JAX's while
        loop runs."""
        hits = (out["pt_tokens"][0] == v.pt_eos_index).nonzero()
        return int(hits[0, 0]) + 1 if len(hits) else cfg.pt_seq_length
    rec.update({
        "infer_spotting_pages_per_s": 1e3 * len(lats) / sum(lats),
        "p50_ms_b1": float(np.percentile(lats, 50)),
        "p99_ms_b1": float(np.percentile(lats, 99)),
        "latencies_ms": lats,
        "steps": {"pt": [pt_steps(o) for o in outs],
                  "poly": cfg.poly_length,
                  "rec": cfg.rec_length,
                  "pt_eos_check_every": EOS_CHECK_EVERY},
        "points": [len(s["points"]) for s in summaries],
        "strings_first": summaries[0]["strings"][:6],
        "distinct_strings": len({w for s in summaries
                                 for w in s["strings"]}),
        "words_ended_by_eos": sum(sum(s["ended"]) for s in summaries),
        "words": sum(len(s["ended"]) for s in summaries)})
    profile_steps("omniparser_profile",
                  [lambda: model.infer_spotting(pages[:1])[
                      "rec_tokens"].cpu()],
                  step_ms=float(np.mean(lats[:OMNI_PAGES])))

    pages_np = [p.cpu().numpy() for p in pages]
    served, counts_svc = {}, []
    for n_slots in OMNI_SERVICE_SLOTS:
        served[n_slots], stats, counts = serve_pages(model, pages_np, n_slots)
        rec[f"service_{n_slots}_slots"] = stats
        counts_svc.append(counts)
        rec[f"bf16_service_{n_slots}_slots_equal_to_infer_spotting_pages"] = (
            sum(served_equal(r, s) for r, s in zip(served[n_slots],
                                                   summaries)))

    # page 0 in f32: the card against the CPU, the f32 service against
    # f32 infer_spotting, and the bf16 teacher-forced logits
    card32 = OmniParser(cfg, policy=FP32_POLICY)
    card32.load_state_dict(state)
    cpu = OmniParser(cfg, policy=FP32_POLICY, device="cpu")
    cpu.load_state_dict(state)
    page = pages[:1]
    with torch.inference_mode():
        outs32, counts_f32 = counted(lambda: [
            {k: t.cpu() for k, t in card32.infer_spotting(p[None]).items()}
            for p in pages])
        got32 = outs32[0]
        t0 = time.perf_counter()
        want = cpu.infer_spotting(page.cpu())
        cpu_s = time.perf_counter() - t0
    # every place where the bf16 service left bf16 infer_spotting, with
    # the f32 gap between the two choices there and the bf16 error
    divs = {n: [divergence_margin(d, pages[i:i + 1], model, card32)
                for i, (r, o) in enumerate(zip(served[n], outs))
                for d in divergences(r, o, v)] for n in served}
    rec["bf16_service_divergences"] = {n: {
        "count": {t: sum(d["stage"] == t for d in ds)
                  for t in ("pt", "poly", "rec")},
        "largest_gap_over_err": max(
            [d["f32_gap"] / d["bf16_err"] for d in ds], default=0.0),
        "smallest_err": min([d["bf16_err"] for d in ds], default=None),
        "widest": sorted(ds, key=lambda d: d["f32_gap"] / d["bf16_err"])[-2:]}
        for n, ds in divs.items()}
    # teacher-forced inputs from the CPU's decode: the pt prompt and
    # sequence, and instance 0's polygon and word after their prompts
    pt_seq = torch.cat([torch.as_tensor(v.pt_prompt())[None],
                        want["pt_tokens"][:, :pt_steps(want)]], 1)
    xy = want["points"][0, :1]
    seqs = {"pt": pt_seq,
            "poly": torch.cat([xy, torch.tensor([[v.poly_sos_index]]),
                               want["polygons"][0, :1]], 1),
            "rec": torch.cat([xy, torch.tensor([[v.rec_sos_index]]),
                              want["rec_tokens"][0, :1]], 1)}
    seqs = {k: t.to(torch.int32) for k, t in seqs.items()}
    cpu16 = OmniParser(cfg, device="cpu")
    cpu16.load_state_dict(state)
    served32, _, counts_svc32 = serve_pages(card32, pages_np, 8)
    with torch.inference_mode():
        tf_cpu = cpu(page.cpu(), seqs)
        tf_cpu16 = cpu16(page.cpu(), seqs)
        (tf32, tf16), counts_tf = counted(lambda: (
            card32(page, {k: t.cuda() for k, t in seqs.items()}),
            model(page, {k: t.cuda() for k, t in seqs.items()})))
        got16 = {k: t.cpu() for k, t in model.infer_spotting(page).items()}
    del cpu, cpu16
    tok_keys = ("pt_tokens", "points", "instance_valid", "polygons",
                "rec_tokens")
    rec_acc = {
        "f32_tokens_equal_to_cpu": {k: torch.equal(got32[k], want[k])
                                    for k in tok_keys},
        "f32_probs_rel_rms_vs_cpu": {
            k: rel_errors(got32[k], want[k])[0]
            for k in ("poly_probs", "rec_probs")},
        "f32_tf_logits_rel_rms_vs_cpu": {
            k: rel_errors(tf32[k].cpu(), tf_cpu[k])[0] for k in tf_cpu},
        "bf16_tf_logits_rel_rms_vs_cpu_f32": {
            k: rel_errors(tf16[k].cpu(), tf_cpu[k])[0] for k in tf_cpu},
        "cpu_bf16_tf_logits_rel_rms_vs_cpu_f32": {
            k: rel_errors(tf_cpu16[k], tf_cpu[k])[0] for k in tf_cpu},
        "bf16_tokens_equal_to_f32": {k: torch.equal(got16[k], want[k])
                                     for k in tok_keys},
        "f32_service_equal_to_infer_spotting_pages": sum(
            served_equal(r, spotting_summary(o, v))
            for r, o in zip(served32, outs32)),
        "f32_points": [int(o["instance_valid"].sum()) for o in outs32],
        "cpu_f32_infer_spotting_s": cpu_s,
        "tol": {"f32": OMNI_F32_RTOL, "bf16_ratio": OMNI_BF16_RATIO}}
    rec.update(rec_acc)
    rec["launches"] = [counts_readable, counts_spot, *counts_svc, counts_f32,
                       counts_svc32, counts_tf]
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    torch.cuda.empty_cache()
    require(all(c == {} for c in rec["launches"]),
            f"OmniParser launched a port kernel: {rec['launches']}")
    require(all(bool(torch.isfinite(o[k]).all()) for o in outs
                for k in ("poly_probs", "rec_probs")),
            "OmniParser probabilities not finite")
    # the readable weights must give pages with different point counts,
    # words that differ and words ended by EOS, or the comparisons below
    # hold nothing
    require(len(set(rec["points"])) > 1
            and all(OMNI_POINTS[0] <= n <= OMNI_POINTS[1]
                    for n in rec["points"])
            and rec["distinct_strings"] >= 2
            and 0 < rec["words_ended_by_eos"] < rec["words"],
            f"OmniParser's check pages decode nothing worth comparing: "
            f"{rec}")
    require(all(rec_acc["f32_tokens_equal_to_cpu"].values())
            and all(e <= OMNI_F32_RTOL for e in
                    rec_acc["f32_probs_rel_rms_vs_cpu"].values())
            and all(e <= OMNI_F32_RTOL for e in
                    rec_acc["f32_tf_logits_rel_rms_vs_cpu"].values())
            and rec_acc["f32_service_equal_to_infer_spotting_pages"]
            == OMNI_PAGES,
            f"OmniParser f32 on the card disagrees with the CPU: {rec_acc}")
    require(all(rec_acc["bf16_tf_logits_rel_rms_vs_cpu_f32"][k]
                <= OMNI_BF16_RATIO
                * rec_acc["cpu_bf16_tf_logits_rel_rms_vs_cpu_f32"][k]
                for k in tf_cpu),
            f"OmniParser bf16 logits off: {rec_acc}")
    require(all(len(res) == OMNI_PAGES and all(
        len(r["polygons"]) == len(r["points"]) == len(r["rec_tokens"])
        for r in res) for res in served.values()),
        f"SpottingService output malformed: "
        f"{served[OMNI_SERVICE_SLOTS[0]][:1]}")
    # bf16 rounds differently on the service's batch shapes, so its
    # results may leave infer_spotting's, but only where two choices lie
    # within bf16's rounding of each other
    beyond = [d for ds in divs.values() for d in ds
              if d["f32_gap"] > 2 * d["bf16_err"]]
    require(not beyond, f"the bf16 service parts from infer_spotting "
            f"beyond bf16 rounding: {beyond}")
    return model, card32, pages



# OmniParser's KIE and table tasks, mixed page sizes and LISTER's heads
# (`omniparser_tasks`): the triplets a KIE page and the cells a table
# stop within, with readable weights
OMNI_TASK_INSTANCES = (4, 40)
# the KIE model's seed: with CORD's categories, no EOS lift ends all 8
# pages within OMNI_TASK_INSTANCES for seeds 0 and 2; seed 1 gives 4-9
# triplets a page, seed 3 5-27 (probed on the H100)
OMNI_VIE_SEED = 3
TABLE_PAGES = 8
TASK_SIZE = 640                     # the JAX CLI's default --image-size
# page shapes served within one memory budget (the first one's), and one
# past it
MIXED_SHAPES = ((640, 640), (480, 640), (512, 512))
MIXED_OVER = (704, 640)
# LISTER's baseline heads on LISTER-B's feature map: the batch, and the
# bf16 logits on the card against f32 on the CPU, relative RMS (one to
# three bf16 Dense; the RNN runs in f32 on both)
HEADS_BATCH = 256
HEADS_RTOL = 3e-2
HEADS_CPU_ROWS = 8


def readable_task_keys(state):
    """The tensors `readable_omniparser` changes: the pt decoder's
    self-attention queries and the pt and rec heads' biases."""
    return {k: t for k, t in state.items()
            if (k.startswith("pt_decoder.") and ".sa_q." in k)
            or k in ("pt_decoder.head3.bias", "rec_decoder.head3.bias")}


class ReadableOmniCLI:
    """Within the block, every OmniParser the port CLI builds (seeded as
    the CLI seeds it) carries the readable tensors in `deltas`, by its
    number of categories; the CLI's own code runs as it is."""

    def __init__(self, deltas):
        from advancedliteratemachinery_tpu_torch.models import omniparser
        self.module, self.deltas = omniparser, deltas

    def __enter__(self):
        base, deltas = self.module.OmniParser, self.deltas
        self.saved = base

        class Readable(base):
            def __init__(self, config=OmniParserConfig(), *a, **k):
                super().__init__(config, *a, **k)
                self.load_state_dict(deltas[config.vie_categories],
                                     strict=False)

        self.module.OmniParser = Readable
        return self

    def __exit__(self, *exc):
        self.module.OmniParser = self.saved


def readable_omni_cli_main(argv):
    """`cli.main(argv[1:])` with the readable tensors of the file argv[0]
    (a dict: number of categories → tensors) in the OmniParser the CLI
    builds."""
    from advancedliteratemachinery_tpu_torch import cli
    with ReadableOmniCLI(torch.load(argv[0])):
        return cli.main(argv[1:])


def cli_json(argv, timer=None):
    """The port CLI's command `argv` in this process → its JSON (a
    non-zero exit fails the run); `table-eval` gets `timer`."""
    import contextlib
    import io
    from advancedliteratemachinery_tpu_torch import cli
    args = cli.parse_args(argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = (cli.cmd_table_eval(args, timer=timer)
              if args.command == "table-eval" else cli.COMMANDS[
                  args.command](args))
    require(rc == 0, f"cli {argv[0]} exited {rc}")
    out = buf.getvalue()
    return json.loads(out) if out.lstrip().startswith(("{", "[")) else out


def table_images(n, seed=23):
    """n seeded uint8 table images of sizes around a page column: ruled
    rows and columns, ink blocks, noise."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        h, w = int(rng.integers(240, 720)), int(rng.integers(320, 960))
        img = np.full((h, w, 3), 235, np.int64)
        rows = rng.choice(np.arange(4, h - 4), int(rng.integers(3, 12)),
                          replace=False)
        img[np.sort(rows)] = 20
        cols = rng.choice(np.arange(4, w - 4), int(rng.integers(2, 8)),
                          replace=False)
        img[:, np.sort(cols)] = 20
        for _ in range(int(rng.integers(10, 60))):
            y, x = int(rng.integers(0, h - 8)), int(rng.integers(0, w - 20))
            img[y:y + int(rng.integers(3, 8)),
                x:x + int(rng.integers(5, 20))] = int(rng.integers(0, 120))
        img += rng.integers(-20, 21, img.shape)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def pubtabnet_record(name, cells, alter=None):
    """A PubTabNet jsonl record whose ground-truth HTML
    (`data/pubtabnet.py` `gt_table_html`) is `table_html` of decoded
    `cells` and their texts: the rows split where a cell starts one, the
    leading header rows in <thead>, spans as split `<td` attributes, empty
    cells without a bbox. With `alter`, that cell's text gains a '#'."""
    rows = []
    for i, c in enumerate(cells):
        if c["row_start"] or not rows:
            rows.append([])
        rows[-1].append(i)
    n_head = 0
    while n_head < len(rows) and cells[rows[n_head][0]]["header"]:
        n_head += 1

    def row_tokens(rs):
        toks = []
        for r in rs:
            toks.append("<tr>")
            for i in r:
                attrs = [f' {k}="{cells[i][k]}"' for k in ("colspan",
                                                            "rowspan")
                         if cells[i][k] > 1]
                toks += (["<td", *attrs, ">"] if attrs else ["<td>"])
                toks.append("</td>")
            toks.append("</tr>")
        return toks

    tokens = []
    if n_head:
        tokens += ["<thead>", *row_tokens(rows[:n_head]), "</thead>"]
    if rows[n_head:]:
        tokens += ["<tbody>", *row_tokens(rows[n_head:]), "</tbody>"]
    gt = []
    for i, c in enumerate(cells):
        text = c["text"] + ("#" if i == alter else "")
        if c["empty"] and i != alter:
            gt.append({"tokens": []})
        else:
            x, y = c["center"] or (1.0, 1.0)
            gt.append({"tokens": list(text),
                       "bbox": [x - 1.0, y - 1.0, x + 1.0, y + 1.0]})
    return {"filename": name, "split": "val",
            "html": {"structure": {"tokens": tokens}, "cells": gt}}


def teacher_forced_seqs(want, v):
    """From a CPU decode: the pt prompt and sequence up to its EOS, and
    instance 0's polygon and word after their prompts."""
    hits = (want["pt_tokens"][0] == v.pt_eos_index).nonzero()
    n = int(hits[0, 0]) + 1 if len(hits) else want["pt_tokens"].shape[1]
    xy = want["points"][0, :1]
    seqs = {"pt": torch.cat([torch.as_tensor(v.pt_prompt())[None],
                             want["pt_tokens"][:, :n]], 1),
            "poly": torch.cat([xy, torch.tensor([[v.poly_sos_index]]),
                               want["polygons"][0, :1]], 1),
            "rec": torch.cat([xy, torch.tensor([[v.rec_sos_index]]),
                              want["rec_tokens"][0, :1]], 1)}
    return {k: t.to(torch.int32) for k, t in seqs.items()}


def vie_task(cfg, pages):
    """KIE: OmniParser with CORD's categories, readable weights for
    `infer_vie`'s triplets, timed at B=1 on the pages after a warm-up,
    the f32 model on the card against the CPU on page 0."""
    from advancedliteratemachinery_tpu_torch.codecs.coords import (
        CORD_CLASSES)
    from advancedliteratemachinery_tpu_torch.eval.spotting_eval import (
        decode_vie_outputs)
    vcfg = dataclasses.replace(cfg, vie_categories=len(CORD_CLASSES))
    v = vcfg.vocab()
    model = OmniParser(vcfg, seed=OMNI_VIE_SEED)
    t0 = time.perf_counter()
    readable, counts_readable = counted(lambda: readable_omniparser(
        model, pages, OMNI_TASK_INSTANCES, period=3))
    readable["seconds"] = time.perf_counter() - t0
    state = {k: t.cpu() for k, t in model.state_dict().items()}
    layers.cast_matmul_weights(model, torch.bfloat16)
    model.requires_grad_(False)
    with torch.inference_mode():
        model.infer_vie(pages[:1])["rec_tokens"].cpu()          # warm up

        def vie_all():
            outs, lats = [], []
            for i in range(len(pages)):
                t0 = time.perf_counter()
                outs.append({k: t.cpu() for k, t in
                             model.infer_vie(pages[i:i + 1]).items()})
                lats.append((time.perf_counter() - t0) * 1e3)
            return outs, lats
        (outs, lats), counts_vie = counted(vie_all)
    entities = [decode_vie_outputs({k: t.numpy() for k, t in o.items()}, v,
                                   CORD_CLASSES, (TASK_SIZE, TASK_SIZE))
                for o in outs]
    del model
    cpu = OmniParser(vcfg, policy=FP32_POLICY, device="cpu")
    cpu.load_state_dict(state)
    card32 = copy.deepcopy(cpu).cuda()
    with torch.inference_mode():
        got, counts_f32 = counted(lambda: {
            k: t.cpu() for k, t in card32.infer_vie(pages[:1]).items()})
        t0 = time.perf_counter()
        want = cpu.infer_vie(pages[:1].cpu())
        cpu_s = time.perf_counter() - t0
        seqs = teacher_forced_seqs(want, v)
        tf_cpu = cpu(pages[:1].cpu(), seqs)
        tf32 = card32(pages[:1], {k: t.cuda() for k, t in seqs.items()})
    del card32, cpu
    tok_keys = ("pt_tokens", "points", "instance_valid", "classes",
                "polygons", "rec_tokens")
    rec = {
        "readable": readable,
        "pages_per_s": 1e3 * len(lats) / sum(lats),
        "p50_ms_b1": float(np.percentile(lats, 50)),
        "p99_ms_b1": float(np.percentile(lats, 99)),
        "pt_steps": [int((o["pt_tokens"][0] != v.padding_index).sum())
                     for o in outs],
        "instances": [int(o["instance_valid"].sum()) for o in outs],
        "entities": [len(e) for e in entities],
        "entity_first": entities[0][:2],
        "f32_tokens_equal_to_cpu": {k: torch.equal(got[k], want[k])
                                    for k in tok_keys},
        "f32_probs_rel_rms_vs_cpu": {
            k: rel_errors(got[k], want[k])[0]
            for k in ("class_probs", "poly_probs", "rec_probs")},
        "f32_tf_logits_rel_rms_vs_cpu": {
            k: rel_errors(tf32[k].cpu(), tf_cpu[k])[0] for k in tf_cpu},
        "cpu_f32_infer_vie_s": cpu_s,
        "launches": [counts_readable, counts_vie, counts_f32]}
    require(all(rec["f32_tokens_equal_to_cpu"].values())
            and all(e <= OMNI_F32_RTOL for e in
                    rec["f32_probs_rel_rms_vs_cpu"].values())
            and all(e <= OMNI_F32_RTOL for e in
                    rec["f32_tf_logits_rel_rms_vs_cpu"].values()),
            f"infer_vie f32 on the card disagrees with the CPU: {rec}")
    require(all(OMNI_TASK_INSTANCES[0] <= n <= OMNI_TASK_INSTANCES[1]
                for n in rec["instances"]) and min(rec["entities"]) > 0,
            f"infer_vie's pages decode nothing worth comparing: {rec}")
    return rec


def table_task(cfg, card, tmp):
    """Tables: OmniParser with the 800-class table band, readable weights
    for the 8 seeded PNG tables as `table-eval` resizes them; each
    table's own decode (through the CLI's run_page) is its ground truth,
    so `table-eval` must score TEDS = S-TEDS = 1.0, and a control set with
    one cell's text changed a table below 1 (S-TEDS still 1); `table-html`
    in a fresh process on table 0 (cold start) equal to its in-process
    decode. The stages of `table-eval` by `StepTimer`."""
    from advancedliteratemachinery_tpu_torch import cli
    from advancedliteratemachinery_tpu_torch.data.pubtabnet import (
        N_TABLE_CLASSES, decode_table_outputs)
    from advancedliteratemachinery_tpu_torch.ops.image import (
        resize_bicubic_u8)
    from advancedliteratemachinery_tpu_torch.pipelines.file_loading import (
        load_image)
    from advancedliteratemachinery_tpu_torch.utils.profiling import (
        StepTimer)
    tcfg = dataclasses.replace(cfg, vie_categories=N_TABLE_CLASSES)
    names = []
    for i, img in enumerate(table_images(TABLE_PAGES)):
        names.append(f"table{i}.png")
        with open(os.path.join(tmp, names[-1]), "wb") as f:
            f.write(png_bytes(img, PAGE_PNG_FILTERS))
    images = [load_image(os.path.join(tmp, n)) for n in names]
    pages = torch.stack([normalize_crops(resize_bicubic_u8(
        im, (TASK_SIZE, TASK_SIZE), "cuda")[None], torch.float32)[0]
        for im in images])
    model = OmniParser(tcfg)                  # seeded as the CLI seeds it
    t0 = time.perf_counter()
    readable, counts_readable = counted(lambda: readable_omniparser(
        model, pages, OMNI_TASK_INSTANCES, period=3))
    readable["seconds"] = time.perf_counter() - t0
    deltas = {N_TABLE_CLASSES: readable_task_keys(
        {k: t.cpu() for k, t in model.state_dict().items()})}
    del model
    delta_path = os.path.join(tmp, "readable.pt")
    torch.save(deltas, delta_path)
    args = ["--variant", "base", "--image-size", str(TASK_SIZE)]
    with ReadableOmniCLI(deltas):
        (_, v, run_page), counts_build = counted(
            lambda: cli._build_table_model(cli.parse_args(
                ["table-html", names[0], *args])))
        decoded = [decode_table_outputs(run_page(resize_bicubic_u8(
            im, (TASK_SIZE, TASK_SIZE), "cuda")), v, im.shape[:2])
            for im in images]
        del run_page
        recs = {"self": [], "control": []}
        for name, d in zip(names, decoded):
            cells = d["cells"]
            alter = next((i for i, c in enumerate(cells) if not c["empty"]),
                         0)
            recs["self"].append(pubtabnet_record(name, cells))
            recs["control"].append(pubtabnet_record(name, cells, alter))
        scores, timers = {}, {}
        for kind, rs in recs.items():
            path = os.path.join(tmp, f"{kind}.jsonl")
            with open(path, "w") as f:
                f.write("".join(json.dumps(r) + "\n" for r in rs))
            timers[kind] = StepTimer()
            t0 = time.perf_counter()
            scores[kind], counts = counted(lambda: cli_json(
                ["table-eval", path, "--img-root", tmp, "--per-sample",
                 *args], timer=timers[kind]))
            scores[kind]["seconds"] = time.perf_counter() - t0
            scores[kind]["launches"] = counts
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; sys.exit("
         "chip_smoke.readable_omni_cli_main(sys.argv[1:]))", delta_path,
         "table-html", os.path.join(tmp, names[0]), *args],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=300)
    cold_s = time.perf_counter() - t0
    require(proc.returncode == 0, f"table-html exited {proc.returncode}: "
            f"{proc.stderr[-2000:]}")
    html = json.loads(proc.stdout)
    want = json.loads(json.dumps(
        {"image": os.path.join(tmp, names[0]), "html": decoded[0]["html"],
         "structure_html": decoded[0]["structure_html"],
         "cells": decoded[0]["cells"]}, default=float))
    per_table = timers["self"].totals
    loop_s = sum(per_table.values())
    rec = {
        "card": card, "readable": readable,
        "tables": [list(im.shape[:2]) for im in images],
        "cells": [len(d["cells"]) for d in decoded],
        "empty_cells": [sum(c["empty"] for c in d["cells"])
                        for d in decoded],
        "rows": [sum(c["row_start"] for c in d["cells"]) for d in decoded],
        "teds": scores["self"]["teds"], "s_teds": scores["self"]["s_teds"],
        "control_teds": scores["control"]["teds"],
        "control_s_teds": scores["control"]["s_teds"],
        "control_per_table_teds": [s["teds"] for s in
                                   scores["control"]["per_sample"]],
        "tables_per_s": TABLE_PAGES / loop_s,
        "stage_ms_per_table": {k: 1e3 * t / TABLE_PAGES
                               for k, t in per_table.items()},
        "table_eval_s": {k: s["seconds"] for k, s in scores.items()},
        "table_html_cold_start_s": cold_s,
        "table_html_equal_to_in_process": html == want,
        "table_html_first": html["html"][:200],
        "launches": [counts_readable, counts_build,
                     scores["self"]["launches"],
                     scores["control"]["launches"]]}
    require(rec["teds"] == 1.0 and rec["s_teds"] == 1.0
            and all(s["teds"] == 1.0 and s["s_teds"] == 1.0
                    for s in scores["self"]["per_sample"]),
            f"table-eval on the tables' own decodes is not 1.0: {scores}")
    require(all(t < 1.0 for t in rec["control_per_table_teds"])
            and rec["control_s_teds"] == 1.0,
            f"table-eval's control set scores 1: {scores['control']}")
    require(rec["table_html_equal_to_in_process"]
            and html["html"].startswith("<table>") and html["cells"],
            f"table-html in a fresh process: {proc.stdout[:2000]}")
    require(rec["cells"] == readable["points"],
            f"the CLI's tables are not the readable model's: {rec['cells']} "
            f"cells, {readable['points']} chosen")
    return rec


def mixed_sizes_task(bf16, card32):
    """`SpottingService(encode_batch=1, mem_len=<a 640² page's memory>)`
    on seeded pages of MIXED_SHAPES submitted at once, for the bf16 and
    the f32 model of the omniparser phase, each result against
    `infer_spotting` on that page alone (f32 equal; bf16 where it parts
    within `divergence_margin`'s rule); a page of MIXED_OVER fails with
    the JAX message."""
    gen = torch.Generator(device="cuda").manual_seed(29)
    pages = [torch.randn(h, w, 3, generator=gen, device="cuda")
             for h, w in MIXED_SHAPES]
    v = bf16.vocab_layout
    with torch.inference_mode():
        mem_len = int(bf16.encode(pages[0][None])[0].shape[1])
        lens = [int(bf16.encode(p[None])[0].shape[1]) for p in pages]
    pages_np = [p.cpu().numpy() for p in pages]
    rec = {"shapes": [list(s) for s in MIXED_SHAPES], "mem_len": mem_len,
           "mem_lens": lens, "launches": []}
    served = {}
    for name, model in (("bf16", bf16), ("f32", card32)):
        svc = SpottingService(model, n_slots=8, encode_batch=1,
                              mem_len=mem_len).start()
        try:
            svc(pages_np[:1], timeout=300)                      # warm up

            def serve():
                t0 = time.perf_counter()
                futs = [svc.submit(p) for p in pages_np]
                return ([f.result(timeout=300) for f in futs],
                        time.perf_counter() - t0)
            (served[name], seconds), counts = counted(serve)
            over = svc.submit(np.zeros((*MIXED_OVER, 3), np.float32))
            try:
                over.result(timeout=300)
                over_error = None
            except ValueError as e:
                over_error = str(e)
        finally:
            svc.stop()
        rec[f"{name}_pages_per_s"] = len(pages) / seconds
        rec[f"{name}_over_budget_error"] = over_error
        rec["launches"].append(counts)
    with torch.inference_mode():
        alone, counts = counted(lambda: {name: [
            {k: t.cpu() for k, t in m.infer_spotting(p[None]).items()}
            for p in pages] for name, m in (("bf16", bf16),
                                             ("f32", card32))})
    rec["launches"].append(counts)
    rec["points"] = [int(o["instance_valid"].sum()) for o in alone["bf16"]]
    rec["f32_equal_pages"] = sum(
        served_equal(r, spotting_summary(o, v))
        for r, o in zip(served["f32"], alone["f32"]))
    rec["bf16_equal_pages"] = sum(
        served_equal(r, spotting_summary(o, v))
        for r, o in zip(served["bf16"], alone["bf16"]))
    divs = [divergence_margin(d, pages[i][None], bf16, card32)
            for i, (r, o) in enumerate(zip(served["bf16"], alone["bf16"]))
            for d in divergences(r, o, v)]
    rec["bf16_divergences"] = {
        "count": len(divs),
        "largest_gap_over_err": max(
            [d["f32_gap"] / d["bf16_err"] for d in divs], default=0.0)}
    require(rec["f32_equal_pages"] == len(pages),
            f"f32 service on mixed sizes parts from infer_spotting: {rec}")
    require(all(d["f32_gap"] <= 2 * d["bf16_err"] for d in divs),
            f"bf16 service on mixed sizes parts from infer_spotting beyond "
            f"bf16 rounding: {divs}")
    require(all(rec[f"{n}_over_budget_error"] is not None
                and "exceeds the server budget"
                in rec[f"{n}_over_budget_error"] for n in ("bf16", "f32")),
            f"a page past the budget was served: {rec}")
    require(len(set(lens)) == len(lens) and max(lens) == mem_len,
            f"the mixed pages share a memory length: {lens}")
    return rec


def lister_heads_task():
    """LISTER's CTC, parallel-attention and RNN-attention heads at
    B=HEADS_BATCH on LISTER-B's feature map of seeded crops (bf16 from the
    FocalNet-B encoder): ms a call (CUDA events), and each head's bf16
    logits on the card against f32 on the CPU on the same features
    (HEADS_CPU_ROWS crops; the RNN teacher-forced on the CPU's greedy
    ids)."""
    from advancedliteratemachinery_tpu_torch.models.lister_baselines import (
        CTCDecoder, ParallelAttention, RNNAttention)
    cfg = LISTERConfig()
    enc = LISTER(cfg, seed=0).encoder
    images = np.random.default_rng(31).integers(
        0, 256, (HEADS_BATCH, 32, 128, 3), dtype=np.uint8)
    x = normalize_crops(torch.from_numpy(images).cuda())
    with torch.inference_mode():
        feat, fmask = enc(x, torch.ones(x.shape[:3], device="cuda",
                                        dtype=x.dtype))
    del enc
    B, h, w, C = feat.shape
    rec = {"feature_map": [B, h, w, C], "num_classes": cfg.num_classes,
           "ms": {}, "rel_rms_vs_cpu_f32": {}, "launches": []}
    for name, cls in (("ctc", CTCDecoder), ("pat", ParallelAttention),
                      ("rnn", RNNAttention)):
        head = cls(cfg.num_classes, C, seed=0)
        ref = cls(cfg.num_classes, C, policy=FP32_POLICY, device="cpu")
        ref.load_state_dict(head.state_dict())
        with torch.inference_mode():
            ms, counts = counted(lambda: cuda_ms(lambda: head(feat, fmask)))
            got = head(feat, fmask)["logits"][:HEADS_CPU_ROWS].cpu()
            f32 = feat[:HEADS_CPU_ROWS].float().cpu()
            m32 = fmask[:HEADS_CPU_ROWS].float().cpu()
            want = ref(f32, m32)["logits"]
            if name == "rnn":            # the card's greedy ids, forced
                got = head(feat[:HEADS_CPU_ROWS], fmask[:HEADS_CPU_ROWS],
                           want.argmax(-1).cuda())["logits"].cpu()
        rec["ms"][name] = ms
        rec["rel_rms_vs_cpu_f32"][name] = rel_errors(got, want)[0]
        rec["launches"].append(counts)
        del head, ref
    require(all(e <= HEADS_RTOL for e in rec["rel_rms_vs_cpu_f32"].values()),
            f"LISTER heads on the card disagree with the CPU: {rec}")
    return rec


def omniparser_tasks_phase(card, spot_bf16, spot_f32, pages):
    """OmniParser's KIE and table tasks on the card (`vie_task`,
    `table_task` through the CLI's `table-eval` and `table-html`), the
    `SpottingService` on mixed page sizes (`mixed_sizes_task`, on the
    omniparser phase's readable bf16 and f32 models), LISTER's baseline
    heads (`lister_heads_task`) and `models --cost mgp_str --variant base`,
    all with the JAX default OmniParserConfig() (Swin-B, 640²) in bf16.
    None reaches a Pallas kernel, so none may launch a port kernel."""
    t_phase = time.perf_counter()
    cfg = OmniParserConfig()
    rec = {"phase": "omniparser_tasks", "card": card,
           "config": "OmniParserConfig(): Swin-B, 640² pages"}
    t0 = time.perf_counter()
    rec["vie"] = vie_task(cfg, pages)
    rec["vie"]["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        rec["tables"] = table_task(cfg, card, tmp)
    rec["tables"]["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec["mixed_sizes"] = mixed_sizes_task(spot_bf16, spot_f32)
    rec["mixed_sizes"]["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec["lister_heads"] = lister_heads_task()
    rec["lister_heads"]["seconds"] = time.perf_counter() - t0
    cost, counts = counted(lambda: cli_json(
        ["models", "--cost", "mgp_str", "--variant", "base"]))
    rec["models_cost"] = cost.splitlines()[-1]
    rec["models_cost_launches"] = counts
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    torch.cuda.empty_cache()
    launches = (rec["vie"]["launches"] + rec["tables"]["launches"]
                + rec["mixed_sizes"]["launches"]
                + rec["lister_heads"]["launches"] + [counts])
    require(all(c == {} for c in launches),
            f"OmniParser's tasks or LISTER's heads launched a port kernel: "
            f"{launches}")
    require(rec["models_cost"].startswith("cost[mgp_str-base]: params="),
            f"models --cost: {cost}")


class PlainAttention(torch.autograd.Function):
    """The plain versions of K1 and K4 in f32 on the card, as one autograd
    Function: the reference step of the train phase."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale=None, safe=True):
        ctx.save_for_backward(qkv)
        ctx.num_heads = num_heads
        return fused_qkv_attention_plain(qkv.float(), num_heads, scale,
                                         safe).to(qkv.dtype)

    @staticmethod
    def backward(ctx, dout):
        (qkv,) = ctx.saved_tensors
        return (fused_qkv_attention_bwd_plain(
            qkv.float(), dout.float(), ctx.num_heads).to(qkv.dtype),
            None, None, None)


def param_group(name):
    for key, group in ((".attn.qkv.", "qkv"), (".attn.proj.", "proj"),
                       (".mlp.", "mlp"), ("token_learner", "token_learners"),
                       ("_head.", "heads"), (".norm", "norms")):
        if key in name:
            return group
    return "embed"            # patch embedding, cls token, positions


def one_step_grads(model, loss_fn, batch):
    model.train()
    model.zero_grad(set_to_none=True)
    loss, _ = loss_fn(batch, None)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def train_flops(cfg, B):
    """Products of one train step (forward + backward = 3 forwards)."""
    vit = cfg.vit_config()
    D, S, L, T = vit.embed_dim, vit.seq_len, vit.depth, cfg.max_tokens
    hidden = int(D * vit.mlp_ratio)
    layer = 2 * S * D * (3 * D + D + 2 * hidden) + 4 * S * S * D
    patch = 2 * vit.num_patches * vit.patch_size ** 2 * vit.in_chans * D
    learner = 2 * (2 * S * D * D // 8) + 2 * S * D * T + 2 * T * S * D
    heads = sum(2 * T * D * v + learner for v in cfg.head_sizes().values())
    return 3 * B * (L * layer + patch + heads)


def train_step_phase():
    """bench.py train_bench on the port: MGP-STR-base, B=128, bf16 compute
    and f32 parameters, Adam at lr 1e-4 on a cosine over 1000 steps, clip
    5.0; the third slice's main path."""
    B, T, iters = 128, 27, 10
    cfg = MGPSTRConfig(variant="base")
    model = MGPSTR(cfg, seed=0)
    rng = np.random.default_rng(0)
    host = {"images": rng.integers(0, 256, (B, 32, 128, 3), dtype=np.uint8),
            "char_ids": rng.integers(0, 38, (B, T)).astype(np.int32),
            "bpe_ids": rng.integers(0, 50257, (B, T)).astype(np.int32),
            "wp_ids": rng.integers(0, 30522, (B, T)).astype(np.int32)}
    batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    loss_fn, _ = mgp_str_recipe_u8(model)

    # (a) one step's gradients through K1/K4 against the same step with the
    # attention swapped for the plain versions in f32
    (loss, grads), counts = counted(
        lambda: one_step_grads(model, loss_fn, batch))
    require(counts == {"fused_qkv_attention": 12,
                       "fused_qkv_attention_bwd": 12},
            f"train step: launches {counts}, expected 12 K1 + 12 K4")
    require(all(bool(g.abs().sum() > 0) for g in grads.values()),
            "a parameter got a zero gradient")
    swapped = layers.fused_qkv_attention
    layers.fused_qkv_attention = (
        lambda qkv, num_heads, scale=None, safe=True:
        PlainAttention.apply(qkv, num_heads, scale, safe))
    try:
        ref_loss, ref = one_step_grads(model, loss_fn, batch)
    finally:
        layers.fused_qkv_attention = swapped
    num, den = {}, {}
    for n, g in grads.items():
        k = param_group(n)
        num[k] = num.get(k, 0.0) + (g - ref[n]).pow(2).sum().item()
        den[k] = den.get(k, 0.0) + ref[n].pow(2).sum().item()
    errs = {k: (num[k] / den[k]) ** 0.5 for k in num}
    rec = {"phase": "train_grads_vs_plain_attention", "loss": loss,
           "plain_loss": ref_loss, "rel_rms_err": errs,
           "tol": TRAIN_GRAD_RTOL, "launches": counts}
    emit(rec)
    require(max(errs.values()) <= TRAIN_GRAD_RTOL,
            f"train gradients disagree with the plain attention: {rec}")
    del grads, ref

    # (b)-(d) the timed loop of make_mgp_str_train_step on a repeated batch
    state = TrainState.create(model, make_optimizer(
        lr=1e-4, total_steps=1000, grad_clip=5.0))
    step = make_mgp_str_train_step(model, state)
    fbatch = {**batch, "images": normalize_crops(batch["images"])}
    losses = [step(fbatch)["loss"] for _ in range(2)]          # warm up
    torch.cuda.reset_peak_memory_stats()

    def timed_loop():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            losses.append(step(fbatch)["loss"])
        torch.cuda.synchronize()
        return B * iters / (time.perf_counter() - t0)

    reps, counts = counted(lambda: [timed_loop() for _ in range(3)])
    require(counts == {"fused_qkv_attention": 12 * 3 * iters,
                       "fused_qkv_attention_bwd": 12 * 3 * iters},
            f"train loop: launches {counts}, expected 12 K1 + 12 K4 a step")
    peak = torch.cuda.max_memory_allocated() / 1e9
    split = []                        # forward, backward, optimiser
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        ev[0].record()
        out = mgp_str_loss(model(fbatch["images"]), fbatch)["loss"]
        ev[1].record()
        out.backward()
        ev[2].record()
        state.apply_gradients()
        ev[3].record()
        split.append(ev)
    torch.cuda.synchronize()
    split_ms = {n: float(np.mean([e[i].elapsed_time(e[i + 1])
                                  for e in split]))
                for i, n in enumerate(("forward", "backward", "optimizer"))}
    losses = [v.item() for v in losses]
    step_ms = 1e3 * B / max(reps)
    flops = train_flops(cfg, B)
    rec = {"phase": "train_step", "batch": B, "samples_per_s_reps": reps,
           "samples_per_s_best": max(reps), "step_ms": step_ms,
           "split_ms": split_ms, "tflop_per_step": flops / 1e12,
           "mfu": flops / (step_ms * 1e-3) / BF16_FLOP_PER_S,
           "peak_mem_gb": peak, "launches": counts,
           "loss_first": losses[0], "loss_last": losses[-1],
           "losses": losses}
    emit(rec)
    require(all(np.isfinite(losses)), f"non-finite train loss: {losses}")
    require(np.mean(losses[-5:]) < np.mean(losses[:5]),
            f"the loss does not fall over {len(losses)} steps: {losses}")
    profile_steps("train_profile",
                  [lambda: step(fbatch)["loss"].item()] * 3, step_ms=step_ms)
    del state, step
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    return rec, counts, host


def fit_phase(host):
    """fit() with mgp_str_recipe_u8 on MGP-STR-base: 4 steps saving every
    2 and keeping 1, then a restore of the last checkpoint into a fresh
    state equals the live one; a resume to step 6 equals an uninterrupted
    6-step run (the backward is deterministic)."""

    def batches():
        while True:
            yield host

    def run(total, ckpt_dir, resume=False):
        model = MGPSTR(MGPSTRConfig(variant="base"), seed=0)
        loss_fn, tx = mgp_str_recipe_u8(model)
        return fit(loss_fn, tx, model, batches(),
                   FitConfig(total_steps=total, log_interval=2,
                             save_interval=2, keep_last=1, ckpt_dir=ckpt_dir,
                             resume=resume), log_fn=lambda m: None)

    with tempfile.TemporaryDirectory() as tmp:
        a = os.path.join(tmp, "a")
        t0 = time.perf_counter()
        first = run(4, a)
        fit_s = time.perf_counter() - t0
        kept = sorted(d for d in os.listdir(a) if d.startswith("step_"))
        fresh = TrainState.create(MGPSTR(MGPSTRConfig(variant="base"),
                                         seed=1), first.state.tx)
        restore_train_state(os.path.join(a, "step_4"), fresh)
        params_equal = all(torch.equal(p, q) for p, q in zip(
            fresh.model.state_dict().values(),
            first.state.model.state_dict().values()))
        opt_equal = all(
            torch.equal(s[k], t[k].to(s[k].device)) for s, t in zip(
                fresh.optimizer.state.values(),
                first.state.optimizer.state.values()) for k in s)
        del fresh, first
        resumed = run(6, a, resume=True)
        straight = run(6, None)
        resume_diff = max((p - q).abs().max().item() for p, q in zip(
            resumed.state.model.state_dict().values(),
            straight.state.model.state_dict().values()))
        rec = {"phase": "fit", "steps": 4, "fit_s": fit_s, "kept": kept,
               "restore_params_equal": params_equal,
               "restore_opt_state_equal": opt_equal,
               "resumed_steps_run": resumed.steps_run,
               "resume_vs_uninterrupted_max_abs_diff": resume_diff,
               "last_metrics": straight.last_metrics}
        emit(rec)
    require(kept == ["step_4"] and params_equal and opt_equal
            and resumed.steps_run == 2,
            f"fit checkpoints malformed: {rec}")
    require(np.isfinite(straight.last_metrics["loss"]),
            f"fit loss not finite: {rec}")
    return rec


# ---------------- the document pipelines (docxchain) ----------------

DOC_PAGES = 8
DOC_HW = (1024, 768)          # pages, a multiple of 32
DOC_WORDS = (20, 64)          # words a page through the detect function
DENSE_WORDS = (150, 300)      # words on the dense page: 3-5 recognizer
#                               forwards of 64 crops
TABLE_CELLS = (10, 100)       # cells above the score threshold a table
LAYOUT_REGIONS = (1, 100)     # layout regions above the threshold a page
TABLE_INPUT = 512             # make_table_predict_fn's page size
# readable DB: prob = sigmoid(gain * ink - bias), ink = 1 - the page's
# mean channel value in [0, 1]
DB_INK_GAIN, DB_INK_BIAS = 12.0, 6.0
# readable heat heads: the spread of their logits, and the least distance
# in logits between the threshold and any peak (bf16 values) that
# `lift_heat_bias` accepts: far above the error of the decode's float32
# sigmoid, below a bf16 step there
HEAT_SPREAD = 1.5
HEAT_MARGIN = 1e-3
# readable boxes: half a table cell's width and height on LORE's map of a
# TABLE_INPUT page, half a layout region's on DocXLayout's map of a page
LORE_CELL_HALF = (10.0, 5.0)
LAYOUT_REGION_HALF = (24.0, 24.0)
DOC_BF16_RTOL = 5e-2          # bf16 features and logits vs f32, rel. RMS
# LORE's bf16 features (through K3) against f32: at most this times the
# error of the same bf16 model on the plain DCN (K3's rounding points)
DOC_K3_RATIO = 1.5
# K3 fed offsets shifted by these pixels (a sampling fault, the first a
# half-pixel centre convention): the first must fail DOC_K3_RATIO
K3_CONTROL_SHIFTS = (0.5, 0.1)
# a bf16 decision that parts from f32 is a rounding flip when its f32
# margin (in logits) is within the errors of two positions, its own and a
# neighbour's or the other class's: at most this many times the RMS of
# the bf16 error over the map (two Gaussian errors pass 12 sigma
# together with odds of ~1e-9 a position)
FLIP_RMS_BOUND = 12.0
DOC_POLY_TOL = 1e-2           # f32 card vs CPU polygon coordinates, pixels
# rows of the PNG pages: Paeth, then Average, alternating
PAGE_PNG_FILTERS = (4, 3)
# the committed baseline JPEG pages (PIL, quality 90, 4:2:0) and the
# sha256 of PIL's RGB decode of each
PAGE_JPEGS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "fixtures")
# the mixed page: A4 at 150 dpi, words among one long line and one column
MIXED_HW = (1754, 1240)
MIXED_WORDS = (150, 400)      # crops the detect function gives it
# card memory the crops of a page may take a pixel of the rectified crops
# (Σ wᵢ·hᵢ): the bound tests/test_torch_pipelines.py holds on the host
CROP_BYTES_PER_PIXEL = 1024


def _word(page, rng, y, x, h, w):
    """A dark textured block: a word as the detector sees it."""
    page[y:y + h, x:x + w] = rng.integers(0, 90, (h, w, 3), dtype=np.uint8)


def word_crop(rng, h, w):
    """A seeded uint8 [h, w, 3] word crop: a light background with a little
    noise and 2-12 dark glyph strokes between a cap line and a base line."""
    crop = np.clip(rng.integers(150, 256, 3) + rng.normal(0, 6, (h, w, 3)),
                   0, 255)
    ink = rng.integers(0, 100, 3)
    n = int(rng.integers(2, 13))
    top, base = int(h * 0.2), int(h * 0.8) + 1
    edges = np.linspace(0.05 * w, 0.95 * w, n + 1)
    for a, b in zip(edges[:-1], edges[1:]):
        x0 = int(a + 0.15 * (b - a))
        x1 = max(x0 + 1, int(b - 0.15 * (b - a)))
        y0 = top + int(rng.integers(0, max(1, (base - top) // 3)))
        crop[y0:base, x0:x1] = ink
    return crop.astype(np.uint8)


def document_pages(n, hw=DOC_HW, seed=0):
    """`n` seeded pages: paper noise, a title of 2-3 large words, then two
    columns of 5-7 lines of 2-4 words."""
    rng = np.random.default_rng(seed)
    H, W = hw
    pages = []
    for _ in range(n):
        page = rng.integers(228, 256, (H, W, 3), dtype=np.uint8)
        x = int(W * 0.08)
        for _ in range(int(rng.integers(2, 4))):
            w = int(rng.integers(W // 8, W // 5))
            _word(page, rng, int(H * 0.06), x, int(H * 0.04), w)
            x += w + int(W * 0.05)
        col_w = W // 2 - int(W * 0.1)
        for c in range(2):
            x0 = int(W * 0.06) + c * (W // 2)
            y = int(H * 0.18) + int(rng.integers(0, H // 20))
            for _ in range(int(rng.integers(5, 8))):
                x = x0
                for _ in range(int(rng.integers(2, 5))):
                    w = int(rng.integers(W // 16, W // 8))
                    if x + w > x0 + col_w:
                        break
                    _word(page, rng, y, x, int(H * 0.022), w)
                    x += w + int(W * 0.04)
                y += int(H * 0.07)
        pages.append(page)
    return np.stack(pages)


def dense_page(hw=DOC_HW, seed=3):
    """A seeded page of small print: two columns of 25 lines of 3-6 words,
    150-300 words in all, so that a page takes several recognizer
    forwards of 64 crops."""
    rng = np.random.default_rng(seed)
    H, W = hw
    page = rng.integers(228, 256, (H, W, 3), dtype=np.uint8)
    col_w = W // 2 - int(W * 0.1)
    for c in range(2):
        x0 = int(W * 0.06) + c * (W // 2)
        for y in range(int(H * 0.05), int(H * 0.95), int(H * 0.036)):
            x = x0 + int(rng.integers(0, W // 40))
            while True:
                w = int(rng.integers(W // 24, W // 12))
                if x + w > x0 + col_w:
                    break
                _word(page, rng, y, x, int(H * 0.014), w)
                x += w + int(W * 0.026)
    return page


def table_pages(n, hw=DOC_HW, seed=1):
    """`n` seeded pages, each a ruled table (light gray lines) of 5-8 rows
    by 4-6 columns with one word a cell, under a caption of 2 words."""
    rng = np.random.default_rng(seed)
    H, W = hw
    pages = []
    for _ in range(n):
        page = rng.integers(228, 256, (H, W, 3), dtype=np.uint8)
        for i in range(2):
            _word(page, rng, int(H * 0.07), int(W * (0.08 + 0.2 * i)),
                  int(H * 0.03), int(W * 0.15))
        rows, cols = int(rng.integers(5, 9)), int(rng.integers(4, 7))
        x0, x1 = int(W * 0.06), int(W * 0.94)
        y0, rh = int(H * 0.16), int(H * 0.08)
        cw = (x1 - x0) // cols
        for r in range(rows + 1):
            page[y0 + r * rh:y0 + r * rh + 2, x0:x0 + cols * cw] = 200
        for c in range(cols + 1):
            page[y0:y0 + rows * rh, x0 + c * cw:x0 + c * cw + 2] = 200
        for r in range(rows):
            for c in range(cols):
                w = int(cw * rng.uniform(0.3, 0.7))
                _word(page, rng, y0 + r * rh + int(rh * 0.35),
                      x0 + c * cw + int((cw - w) * rng.uniform(0.2, 0.8)),
                      int(H * 0.022), w)
        pages.append(page)
    return np.stack(pages)


def readable_db(model):
    """Set a DB detector's weights by hand to an ink detector, since random
    weights give no word-shaped components: channel 0 carries the page's
    darkness (1 - the mean of its channels at the stem's centre tap)
    through every layer (the residual blocks' convs zero, so each block
    passes its input on; the downsampling 1x1 convs, the stride-4 lateral,
    its smoothing conv and the head's 3x3 conv pick channel 0), the other
    channels are zero, and the head ends in
    sigmoid(DB_INK_GAIN * ink - DB_INK_BIAS), so dark blocks on paper
    become components of probability near 1."""
    p = model
    with torch.no_grad():
        for m in p.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.zero_()
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0 - m.eps)
        k = p.stem.conv.kernel_size[0] // 2
        p.stem.conv.weight[0, :, k, k] = -1.0 / 3.0
        p.stem.bn.bias[0] = 1.0
        for m in p.modules():
            if getattr(m, "down", None) is not None:
                m.down.conv.weight[0, 0, 0, 0] = 1.0
        p.lat0.weight[0, 0, 0, 0] = 1.0
        p.smooth0.weight[0, 0, 1, 1] = 1.0
        p.prob_c.conv.weight[0, 0, 1, 1] = 1.0
        p.prob_up1.weight[0:4, 0, 0, 0] = 1.0
        p.prob_up2.weight[0:4, 0, 0, 0] = DB_INK_GAIN
        p.prob_up2.bias[:] = -DB_INK_BIAS


def readable_dla(model):
    """A DLA-34 as drawn (lecun-normal convs, BatchNorm at unit scale)
    halves the second moment of its activations at every ReLU, so after
    its ~30 layers the heads see features near zero and every head map is
    its bias: the heat is flat and its peaks are the top-K's ties (the
    map's first row). Every BatchNorm scale times sqrt(2) (He's gain)
    keeps the features at the input's scale, so the heads answer the
    page."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.mul_(2.0 ** 0.5)


def head_features(seg, images, head):
    """The input of `head`'s last conv in a DLASeg or DLASegV0 `seg` for
    NHWC `images` (the neck's map through the head's 3x3 conv and ReLU),
    in float32 [B, C, h, w]: what the head's 1x1 conv reads."""
    c = seg.policy.compute_dtype
    x = images.to(c).permute(0, 3, 1, 2)
    feats = seg.base(x)
    if isinstance(seg, DLASeg):
        pyramid = seg.dla_up(feats[seg.first:])
        feat = seg.ida_up(pyramid[:seg.config.last_level - seg.first])[-1]
    else:
        feat = seg.dla_up(feats[seg.first:])
    return torch.relu(layers.conv2d(feat, getattr(seg, f"{head}_conv1"),
                                    c)).float()


def fit_heat_readout(seg, inputs, pages, blur, ridge=1e-3):
    """Readable heat for a random DLA head: the `hm` head's channel 0
    readout (its 1x1 conv's weights and bias) fitted by ridge least
    squares to the ink of the pages (1 - the channel mean, pooled to the
    map and box-blurred over `blur` cells), so that its peaks sit on text
    rather than on the features' noise. `inputs` are the model's inputs
    (float [1, H, W, 3] each), `pages` the uint8 pages they came from.
    Returns the fit's R²."""
    A, t = [], []
    with torch.inference_mode():
        for x, page in zip(inputs, pages):
            h = head_features(seg, x, "hm")[0]                 # [C, h, w]
            ink = 1.0 - torch.from_numpy(page).to(h.device).float().mean(
                -1) / 255.0
            ink = torch.nn.functional.adaptive_avg_pool2d(
                ink[None, None], h.shape[1:])
            ink = torch.nn.functional.avg_pool2d(
                ink, blur, 1, blur // 2, count_include_pad=False)[0, 0]
            A.append(h.reshape(h.shape[0], -1).t())
            t.append(ink.reshape(-1))
    A = torch.cat(A).double()
    A = torch.cat([A, torch.ones_like(A[:, :1])], 1)
    t = torch.cat(t).double()
    G = A.t() @ A
    G += ridge * torch.diag(G).mean() * torch.eye(len(G), device=G.device,
                                                   dtype=G.dtype)
    w = torch.linalg.solve(G, A.t() @ t)
    r2 = 1.0 - ((A @ w - t).pow(2).mean() / t.var()).item()
    conv = seg.hm_out
    with torch.no_grad():
        conv.weight[0, :, 0, 0] = w[:-1].float()
        conv.bias[0] = float(w[-1])
    return r2


def readable_boxes(wh, half):
    """A corner-offset head (`wh`, the last conv of LORE's or DocXLayout's
    wh head) as drawn gives boxes of a pixel or two on the map, which hold
    no word: its weights are scaled by 0.1 and its bias set to the corners
    of a box of `half` (width, height) around each center (x - d0, y - d1
    the top left, clockwise), so that cells and regions cover words."""
    hx, hy = half
    with torch.no_grad():
        wh.weight.mul_(0.1)
        wh.bias.copy_(torch.tensor([hx, hy, -hx, hy, -hx, -hy, hx, -hy]))


def heat_keep(logits, thr, strict, delta=0.0):
    """One heat channel's logits [B, h, w] → the positions a decode keeps
    (a 3x3 peak of the clamped sigmoid whose score passes `thr`, `>` when
    `strict`, else `>=`) after adding `delta` to the logits, and the
    clamped sigmoid."""
    hm = sigmoid_clamped(logits.float() + delta)[..., None]
    peaks = heatmap_peaks(hm)[..., 0]
    return (peaks > thr) if strict else (peaks >= thr), hm[..., 0]


def lift_heat_bias(conv, channel, logits_fn, pages, bounds, thr, strict,
                   top_k, tries=12):
    """Make a heat head readable: scale the weights of its `channel` (in
    `conv`, its last 1x1 conv) so that its logits spread by HEAT_SPREAD
    (standard deviation over the pages; random features vary little), then
    shift the channel's bias so that every page keeps between bounds[0]
    and bounds[1] positions above `thr`. Peaks do not move with either
    change (the first is monotone, the second a shift of every logit), so
    a shift's counts and its least distance from any peak to the
    threshold can be predicted; the shifts are tried farthest first and
    each is verified by a real run (in bf16 the bias and the logits round),
    until one keeps every page in bounds with every peak at least
    HEAT_MARGIN logits from the threshold. Returns {the gain, the lift,
    the margin, the counts}."""
    t = float(np.log(thr / (1.0 - thr)))

    def peak_logits():
        out = []
        for page in pages:
            lg = logits_fn(page).float()
            _, hm = heat_keep(lg, 0.0, False)
            is_peak = heatmap_peaks(hm[..., None])[..., 0] > 0
            out.append(torch.sort(lg[is_peak], descending=True)
                       .values[:top_k + 1].cpu().numpy())
        return out

    def counts(vals, delta=0.0):     # up to top_k + 1: past bounds
        return [int(((v + delta > t) if strict else (v + delta >= t)).sum())
                for v in vals]

    std = torch.cat([logits_fn(p).float().reshape(-1)
                     for p in pages]).std().item()
    gain = HEAT_SPREAD / max(std, 1e-6)
    with torch.no_grad():
        conv.weight[channel] *= gain
    vals = peak_logits()
    edges = np.unique(np.concatenate([t - v for v in vals]))
    cands = sorted(((float(g), float(d)) for d, g in zip(
        (edges[1:] + edges[:-1]) / 2, (edges[1:] - edges[:-1]) / 2)
        if all(bounds[0] <= n <= bounds[1] for n in counts(vals, d))),
        reverse=True)
    base = conv.bias[channel].item()
    tried = []
    for predicted, delta in cands[:tries]:
        with torch.no_grad():
            conv.bias[channel] = base + delta
        real = peak_logits()
        n = counts(real)
        margin = min(float(np.abs(v - t).min()) for v in real)
        tried.append([predicted, margin, n])
        if (all(bounds[0] <= c <= bounds[1] for c in n)
                and margin >= HEAT_MARGIN):
            return {"logit_std": std, "gain": gain, "lift": delta,
                    "margin_logits": margin, "counts": n,
                    "tried": len(tried)}
    with torch.no_grad():
        conv.bias[channel] = base
    near = {round(float(d), 3): counts(vals, d)
            for d in np.quantile((edges[1:] + edges[:-1]) / 2,
                                 [0.01, 0.03, 0.1, 0.3])} if len(edges) > 1 \
        else {}
    require(False, f"no heat bias lift keeps every page within {bounds} "
                   f"and HEAT_MARGIN from the threshold: tried {tried}; "
                   f"counts by lift {near}")


class StageClock:
    """CUDA events at the stage boundaries of pipeline calls: `wrap` marks
    the end of a module callable (or, with `before`, its start too)."""

    def __init__(self):
        self.calls = []

    def start(self):
        self.calls.append([("start", self._event())])

    @staticmethod
    def _event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def mark(self, name):
        self.calls[-1].append((name, self._event()))

    def wrap(self, name, fn, before=None):
        def timed(*a, **k):
            if before:
                self.mark(before)
            out = fn(*a, **k)
            self.mark(name)
            return out
        return timed

    def stage_ms(self):
        torch.cuda.synchronize()
        ms = {}
        for marks in self.calls:
            for (_, a), (name, b) in zip(marks, marks[1:]):
                ms.setdefault(name, []).append(a.elapsed_time(b))
        return {k: float(np.mean(v)) for k, v in ms.items()}


class MemoRecognizer:
    """`recognize` remembered by its crops: the CPU reference reads one
    page twice (reading, structurization), with the same crops, and
    pays for the f32 recognizer once."""

    def __init__(self, engine):
        self.engine = engine
        self.seen = {}

    def recognize(self, crops):
        key = hashlib.sha1(np.asarray(crops).tobytes()).hexdigest()
        if key not in self.seen:
            self.seen[key] = self.engine.recognize(crops)
        return self.seen[key]


def doc_pipelines(engine, det_fn, table_fn, layout_fn, device=None,
                  clock=None):
    """GeneralTextReading, TableParsing and DocumentStructurization over
    the given module callables (timed by `clock` when given; the detect
    function's stage ends after its box extraction, "det_extract", whose
    start `docxchain_phase` marks as the end of "det_model")."""
    from advancedliteratemachinery_tpu_torch.pipelines import (
        DocumentStructurization, GeneralTextReading, LayoutAnalysis,
        TableParsing, TableStructureRecognition, TextDetection,
        TextRecognition)
    rec_fn = engine.recognize
    if clock is not None:
        det_fn = clock.wrap("det_extract", det_fn)
        table_fn = clock.wrap("table", table_fn)
        layout_fn = clock.wrap("layout", layout_fn)
        rec_fn = clock.wrap("rec", rec_fn, before="crop")
    det = TextDetection(det_fn)
    rec = TextRecognition(rec_fn, device=device)
    return {"reading": GeneralTextReading(det, rec),
            "table": TableParsing(TableStructureRecognition(table_fn), det,
                                  rec),
            "structurization": DocumentStructurization(
                LayoutAnalysis(layout_fn), det, rec, device=device)}


def json_form(out):
    return json.loads(json.dumps(out, default=float))


def same_result(a, b, path="", exact=False):
    """Pipeline outputs (JSON form) equal: every string, integer and
    structure exactly, polygon coordinates within DOC_POLY_TOL pixels and
    other floats within 1e-4 (`exact`: every float exactly). Returns the
    first difference, or None."""
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return f"{path}: keys {sorted(a)} vs {sorted(b)}"
        for k in a:
            d = same_result(a[k], b[k], f"{path}.{k}", exact)
            if d:
                return d
        return None
    if isinstance(a, list) and isinstance(b, list):
        if len(a) != len(b):
            return f"{path}: {len(a)} vs {len(b)} items"
        for i, (x, y) in enumerate(zip(a, b)):
            d = same_result(x, y, f"{path}[{i}]", exact)
            if d:
                return d
        return None
    if isinstance(a, float) or isinstance(b, float):
        tol = 0.0 if exact else DOC_POLY_TOL if "poly" in path else 1e-4
        return None if abs(a - b) <= tol else f"{path}: {a} vs {b}"
    return None if a == b else f"{path}: {a!r} vs {b!r}"


def rel_rms(a, b):
    return ((a.float() - b.float()).pow(2).mean().sqrt()
            / b.float().pow(2).mean().sqrt().clamp(min=1e-12)).item()


def heat_flips(l16, l32, thr, strict):
    """Where a heat map's keep decisions (a 3x3 peak whose score passes
    `thr`) differ between bf16 and f32 logits [h, w]: for each, the f32
    margin in logits (clamped as the scores are) to the threshold or to
    the largest neighbour, whichever is nearer, over the RMS of the bf16
    error of the map's logits. A flip's margin lies within the errors of
    two positions, so over the local error the ratio stays below 2
    whatever the error is; over the map's RMS error a fault that moves a
    few positions far past bf16's error shows."""
    k16, _ = heat_keep(l16[None], thr, strict)
    k32, _ = heat_keep(l32[None], thr, strict)
    margin = keep_margins(l32, thr)
    rms = (l16.float() - l32.float()).pow(2).mean().sqrt().item()
    differ = (k16 != k32)[0]
    ratios = (margin[differ] / max(rms, 1e-12)).tolist()
    return {"differ": int(differ.sum()), "kept_f32": int(k32.sum()),
            "err_rms": rms, "worst_margin_over_rms": max(ratios, default=0.0)
            }, k16[0] & k32[0]


def keep_margins(logits, thr):
    """Heat logits [h, w] → each position's distance in logits (clamped
    as `sigmoid_clamped` clamps the scores) to the threshold's logit or
    to its largest neighbour, whichever is nearer: how far its keep
    decision is from turning."""
    lo = float(np.log(1e-4 / (1.0 - 1e-4)))
    lc = logits.float().clamp(lo, -lo)
    t = float(np.log(thr / (1.0 - thr)))
    pad = torch.nn.functional.pad(lc, (1, 1, 1, 1), value=lo - 1.0)
    H, W = lc.shape
    nb = torch.stack([pad[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
                      for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                      if dy or dx]).amax(0)
    return torch.minimum((lc - t).abs(), (lc - nb).abs())


def argmax_flips(l16, l32, mask=None):
    """Where argmax over the last axis differs between bf16 and f32
    logits (optionally only where `mask`): the f32 gap between the two
    picks over the RMS of the bf16 error of the logits compared."""
    a16, a32 = l16.argmax(-1), l32.argmax(-1)
    differ = a16 != a32
    err = (l16.float() - l32.float())
    if mask is not None:
        differ &= mask
        err = err[mask]
    rms = err.pow(2).mean().sqrt().item() if err.numel() else 0.0
    g = torch.gather
    gap = (g(l32, -1, a32[..., None]) - g(l32, -1, a16[..., None]))[..., 0]
    ratios = (gap[differ] / max(rms, 1e-12)).tolist()
    return {"differ": int(differ.sum()),
            "decisions": int(mask.sum()) if mask is not None
            else int(a32.numel()),
            "err_rms": rms, "worst_gap_over_rms": max(ratios, default=0.0)}


DOCX_TO_REFERENCE = DLA_TO_REFERENCE[:8] + (
    (r"\.((?:proj|node)_\d+)\.conv\.", r".\1.0."),
    (r"\.((?:proj|node)_\d+)\.bn\.", r".\1.1."),
    (r"\.(up_\d+)\.kernel$", r".\1.weight"),
    (r"^(\w+)_conv1\.", r"\1.0."),
    (r"^(\w+)_out\.", r"\1.2."))


def reference_docxlayout_state(model):
    """A port DocXLayout's weights in the released checkpoint's layout
    (dlav0_subfield.py DLASeg): Sequential indices for the neck's conv and
    BatchNorm, the up kernels [C, 1, 2f, 2f]."""
    out = {}
    for k, v in model.backbone.state_dict().items():
        for pattern, repl in DOCX_TO_REFERENCE:
            k = re.sub(pattern, repl, k)
        v = v.detach().cpu()
        if re.search(r"\.up_\d+\.weight$", k):
            v = v.permute(2, 0, 1)[:, None].contiguous()
        out[k] = v
    return out


def docxlayout_reference_file(model):
    """The released-layout DocXLayout file written, dropped from the page
    cache, loaded and imported into a fresh `DocXLayoutConfig()` model;
    the imported weights must equal the source's, with no tensor left
    unused."""
    rec = {}
    with tempfile.TemporaryDirectory() as tmp, \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        path = os.path.join(tmp, "DocXLayout_231012.pth")
        torch.save({"state_dict": {f"module.{k}": v for k, v in
                                   reference_docxlayout_state(model).items()}},
                   path)
        rec["cached_share_after_evict"] = evict_from_page_cache(path)
        t0 = time.perf_counter()
        sd = load_torch_state_dict(path)
        t1 = time.perf_counter()
        fresh = DocXLayout(DocXLayoutConfig(), seed=9)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        import_docxlayout(sd, fresh)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        rec["seconds"] = {"load_after_evict": t1 - t0,
                          "load_cached": timed_load(path),
                          "build": t2 - t1, "import": t3 - t2}
        rec["file_mb"] = os.path.getsize(path) / 1e6
    want = model.state_dict()
    got = fresh.state_dict()
    rec["tensors"] = len(got)
    rec["equal"] = all(torch.equal(got[k], want[k].to(got[k].device))
                       for k in want if not k.endswith("num_batches_tracked"))
    rec["unused_warnings"] = [str(w.message) for w in caught
                              if "not mapped" in str(w.message)]
    require(rec["equal"] and not rec["unused_warnings"],
            f"DocXLayout reference file did not import as written: {rec}")
    return rec


def png_bytes(image, filters=(0,)):
    """An 8-bit RGB PNG (zlib level 1) of a uint8 [H, W, 3] array, row y
    written with PNG filter filters[y % len(filters)] (0 None, 1 Sub,
    2 Up, 3 Average, 4 Paeth)."""
    import struct
    import zlib
    h, w = image.shape[:2]
    cur = np.ascontiguousarray(image).reshape(h, -1).astype(np.int16)
    up = np.concatenate([np.zeros_like(cur[:1]), cur[:-1]])
    left = np.concatenate([np.zeros_like(cur[:, :3]), cur[:, :-3]], 1)
    ul = np.concatenate([np.zeros_like(up[:, :3]), up[:, :-3]], 1)
    pa, pb, pc = abs(up - ul), abs(left - ul), abs(left + up - 2 * ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, ul))
    preds = np.stack([0 * cur, left, up, (left + up) >> 1, paeth])
    kinds = np.resize(np.asarray(filters), h)
    rows = ((cur - preds[kinds, np.arange(h)]) & 255).astype(np.uint8)
    raw = np.concatenate([kinds[:, None].astype(np.uint8), rows], 1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + chunk(b"IEND", b""))


def pages_from_files(docs, tables, tmp):
    """The pages as a user's files through `load_image`: every page as a
    PNG with Paeth and Average rows (each must decode to the seeded page)
    and page 0 of each kind as its committed baseline JPEG (each must
    decode to PIL's recorded hash). → ({"png": [pages], "jpeg": {kind:
    page}}, the record with host decode ms a page for each format)."""
    from advancedliteratemachinery_tpu_torch.pipelines.file_loading import (
        load_image)
    rec = {"png_filters": list(PAGE_PNG_FILTERS)}
    pngs, ms = [], []
    for i, page in enumerate(np.concatenate([docs, tables])):
        path = os.path.join(tmp, f"page{i}.png")
        with open(path, "wb") as f:
            f.write(png_bytes(page, PAGE_PNG_FILTERS))
        t0 = time.perf_counter()
        pngs.append(load_image(path))
        ms.append((time.perf_counter() - t0) * 1e3)
        require(np.array_equal(pngs[-1], page),
                f"PNG page {i} does not decode to the seeded page")
    rec["png_ms_per_page"] = ms
    with open(os.path.join(PAGE_JPEGS, "smoke_pages_jpeg.json")) as f:
        hashes = json.load(f)
    jpegs, ms, equal = {}, [], {}
    for kind, name in (("doc", "smoke_doc_page0_q90.jpg"),
                       ("table", "smoke_table_page0_q90.jpg")):
        path = os.path.join(PAGE_JPEGS, name)
        t0 = time.perf_counter()
        jpegs[kind] = load_image(path)
        ms.append((time.perf_counter() - t0) * 1e3)
        equal[kind] = (hashlib.sha256(jpegs[kind].tobytes()).hexdigest()
                       == hashes[name]["sha256"])
        seeded = (docs if kind == "doc" else tables)[0]
        rec[f"jpeg_{kind}_vs_seeded_mean_abs"] = float(np.abs(
            jpegs[kind].astype(np.int16) - seeded).mean())
    rec.update({"jpeg_ms_per_page": ms, "jpeg_equals_pil": equal,
                "jpeg_bytes": [os.path.getsize(os.path.join(PAGE_JPEGS, n))
                               for n in ("smoke_doc_page0_q90.jpg",
                                         "smoke_table_page0_q90.jpg")]})
    require(all(equal.values()),
            f"JPEG pages do not decode to PIL's decode: {rec}")
    return {"png": pngs, "jpeg": jpegs}, rec


def mixed_size_page(hw=MIXED_HW, seed=4):
    """A seeded page with one 1200x40 line and one 40x600 column among
    two blocks of small words: the crops of one page differ in size by
    far, the case one canvas of the largest crop's size multiplied."""
    rng = np.random.default_rng(seed)
    H, W = hw
    page = rng.integers(228, 256, (H, W, 3), dtype=np.uint8)
    _word(page, rng, 60, 20, 40, 1200)                      # the line
    _word(page, rng, 160, W - 80, 600, 40)                  # the column
    for x0, x1, y0, y1 in ((40, W - 140, 160, 760),
                           (40, W - 40, 800, H - 60)):
        for y in range(y0, y1, 44):
            x = x0 + int(rng.integers(0, 30))
            while True:
                w = int(rng.integers(60, 160))
                if x + w > x1:
                    break
                _word(page, rng, y, x, 26, w)
                x += w + int(rng.integers(40, 70))
    return page


def mixed_crops_phase(engine, det_fn):
    """The mixed page's crops on the card: the peak memory
    `crop_quads_u8` takes must stay under CROP_BYTES_PER_PIXEL bytes a
    pixel of Σ wᵢ·hᵢ (the rectified crops), with the line and the column
    among them; the crops equal the CPU's within one uint8 level and go
    through the recognizer."""
    from advancedliteratemachinery_tpu_torch.ops.image import (
        crop_quads_u8, perspective_maps)
    page = mixed_size_page()
    quads = np.asarray([order_point(q) for q in det_fn(page)[0]],
                       np.float32).reshape(-1, 4, 2)
    sizes, _ = perspective_maps(quads)
    pixels = int((sizes[:, 0] * sizes[:, 1]).sum())
    gpu_page = torch.from_numpy(page).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    crops = crop_quads_u8(gpu_page, quads)
    torch.cuda.synchronize()
    crop_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    cpu = crop_quads_u8(torch.from_numpy(page), quads)
    results = recognize_in_batches(engine, crops, 64)
    rec = {"page_hw": MIXED_HW, "crops": len(quads),
           "largest_crop_wh": [int(sizes[:, 0].max()),
                               int(sizes[:, 1].max())],
           "crop_pixels": pixels, "peak_bytes": peak,
           "bound_bytes": CROP_BYTES_PER_PIXEL * pixels,
           "one_canvas_pixels": len(quads) * int(sizes[:, 0].max())
           * int(sizes[:, 1].max()),
           "crop_ms": crop_ms,
           "max_diff_vs_cpu": int((crops.cpu().int() - cpu.int()).abs()
                                  .max()),
           "recognized": len(results)}
    require(MIXED_WORDS[0] <= len(quads) <= MIXED_WORDS[1]
            and rec["largest_crop_wh"][0] >= 1000
            and rec["largest_crop_wh"][1] >= 500
            and peak < rec["bound_bytes"] and rec["max_diff_vs_cpu"] <= 1
            and len(results) == len(quads),
            f"mixed page crops out of bounds: {rec}")
    return rec


def readable_cli_main(argv):
    """`cli.main(argv[1:])` with the smoke's readable weights: the
    `DBDetector` the CLI builds gets `readable_db`, and its `LORE`
    `readable_dla`, the offsets of `reseed_offsets(seed=7)`,
    `readable_boxes` and the heat head (fitted and lifted in the smoke's
    process) from the file argv[0]. The CLI's own model functions and
    pipeline run as they are."""
    from advancedliteratemachinery_tpu_torch import cli
    from advancedliteratemachinery_tpu_torch.models import db, lore
    heat = torch.load(argv[0])

    class ReadableDB(db.DBDetector):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            readable_db(self)

    class ReadableLORE(lore.LORE):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            readable_dla(self)
            reseed_offsets(self, seed=7)
            readable_boxes(self.backbone.wh_out, LORE_CELL_HALF)
            self.backbone.hm_out.load_state_dict(heat)

    db.DBDetector, lore.LORE = ReadableDB, ReadableLORE
    return cli.main(argv[1:])


def cli_table_subprocess(page, heat, want):
    """`cli table` on one PNG page at the smoke's widths (MGP-STR-base,
    `LoreConfig()`, `DBConfig()`, on the card) in a fresh process, through
    `readable_cli_main` so that its models are the smoke's (`heat`, LORE's
    readable heat head): its JSON must equal `want`, the in-process
    pipeline's on the same page, with words in some cells. The wall time
    from launch to exit is a user's cold start (imports, model builds,
    the kernels' load from the build directory)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "table.png")
        with open(path, "wb") as f:
            f.write(png_bytes(page))
        heat_path = os.path.join(tmp, "heat.pt")
        torch.save({k: v.cpu() for k, v in heat.items()}, heat_path)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke; sys.exit("
             "chip_smoke.readable_cli_main(sys.argv[1:]))",
             heat_path, "table", path, "--variant", "base"],
            capture_output=True, text=True, timeout=300,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        cold_s = time.perf_counter() - t0
    require(proc.returncode == 0, f"cli table failed: {proc.stderr[-2000:]}")
    got = json.loads(proc.stdout)
    rec = {"cold_start_s": cold_s, "equal": got == want,
           "first_difference": same_result(got, want, exact=True),
           "cells": len(want["cells"]),
           "cells_with_words": sum(bool(c["content"]) for c in want["cells"])}
    require(rec["equal"] and rec["cells"] and rec["cells_with_words"],
            f"cli table JSON differs from the in-process pipeline: {rec}")
    return rec


def recognize_in_batches(engine, u8, batch_size):
    """`engine.recognize` over uint8 crops [N, 32, 128, 3] (NumPy or a
    tensor) in zero-padded batches of `batch_size`, as `TextRecognition`
    and the HTTP server's batcher form them → [(text, conf, head)] for
    the N crops."""
    u8 = torch.as_tensor(u8)
    out = []
    for i in range(0, len(u8), batch_size):
        chunk = u8[i:i + batch_size]
        batch = torch.zeros((batch_size, *u8.shape[1:]), dtype=torch.uint8,
                            device=u8.device)
        batch[:len(chunk)] = chunk
        out += engine.recognize(batch)[:len(chunk)]
    return out


def http_phase(engine, det_fn, pages, reads, batch_size=32):
    """`RecognitionHTTPServer` on 127.0.0.1 with the engine: 64 concurrent
    /v1/recognize requests (PNG word crops cut from `pages`) and a
    /v1/read request for each of `reads` (whole pages: (file bytes, the
    page they decode to)), each result equal to the engine's own
    `recognize` on the same crops in batches of the server's shape."""
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor
    from advancedliteratemachinery_tpu_torch.engine.http_serving import (
        RecognitionHTTPServer)
    from advancedliteratemachinery_tpu_torch.ops.image import (
        crop_quads_u8, resize_linear_u8)
    rng = np.random.default_rng(21)
    crops = []
    for i in range(64):
        page = pages[i % len(pages)]
        h, w = int(rng.integers(24, 48)), int(rng.integers(60, 200))
        y = int(rng.integers(0, page.shape[0] - h))
        x = int(rng.integers(0, page.shape[1] - w))
        crops.append(np.ascontiguousarray(page[y:y + h, x:x + w]))
    bodies = [png_bytes(c) for c in crops]

    def post(path, body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}{path}", data=body,
            headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    def direct(u8):
        return [{"text": t, "confidence": round(float(c), 4), "head": h}
                for t, c, h in recognize_in_batches(engine, u8, batch_size)]

    srv = RecognitionHTTPServer(engine, batch_size=batch_size,
                                max_wait_ms=5.0, port=0,
                                detect_fn=det_fn).start()
    try:
        post("/v1/recognize", bodies[0])                        # warm up
        srv.batcher.stats = {k: 0 for k in srv.batcher.stats}
        with ThreadPoolExecutor(64) as ex:
            t0 = time.perf_counter()
            got = list(ex.map(lambda b: post("/v1/recognize", b), bodies))
            seconds = time.perf_counter() - t0
        stats = dict(srv.batcher.stats)
        t0 = time.perf_counter()
        answers = [post("/v1/read", body) for body, _ in reads]
        read_s = (time.perf_counter() - t0) / len(reads)
    finally:
        srv.stop()
    resized = np.stack([resize_linear_u8(torch.from_numpy(c)[None],
                                         (32, 128))[0].numpy()
                        for c in crops])
    want = direct(resized)
    read_equal = []
    for (_, page), res in zip(reads, answers):
        quads, scores = det_fn(page)
        u8 = crop_quads_u8(torch.from_numpy(page).cuda(),
                           np.asarray(quads).reshape(-1, 4, 2)).cpu().numpy()
        ref = direct(u8)
        read_equal.append(
            [(w["text"], w["confidence"]) for w in res["words"]]
            == [(r["text"], r["confidence"]) for r in ref])
    rec = {"recognize_requests": 64, "requests_per_s": 64 / seconds,
           "batches": stats["batches"], "items": stats["items"],
           "padded_slots": stats["padded_slots"],
           "recognize_equal": got == want,
           "read_words": [len(r["words"]) for r in answers],
           "read_equal": read_equal, "read_s_per_page": read_s}
    require(rec["recognize_equal"] and all(read_equal)
            and stats["items"] == 64,
            f"HTTP results differ from direct recognize: {rec}")
    return rec


def docxchain_phase(card):
    """The document pipelines, the seventh path: DocXLayout
    (`DocXLayoutConfig()`), LORE (`LoreConfig()` on 512² resizes), DB
    (`DBConfig()` at 640²) and MGP-STR-base, in bf16, on 8 seeded
    1024x768 document pages and 8 table pages, through
    `GeneralTextReading`, `TableParsing` and `DocumentStructurization`.
    `card` (nvidia-smi's name and power limit) goes beside its numbers."""
    from advancedliteratemachinery_tpu_torch.models.db import (
        make_db_detect_fn)
    from advancedliteratemachinery_tpu_torch.models.lore import (
        make_table_predict_fn)
    from advancedliteratemachinery_tpu_torch.ops.image import (
        crop_quads_u8, resize_linear_u8)
    from advancedliteratemachinery_tpu_torch.models import db as db_module
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        files, decode_rec = pages_from_files(document_pages(DOC_PAGES),
                                             table_pages(DOC_PAGES), tmp)
    emit({"phase": "docxchain_decode", "card": card, **decode_rec})
    docs = np.stack(files["png"][:DOC_PAGES])
    tables = np.stack(files["png"][DOC_PAGES:])
    cfg = MGPSTRConfig(variant="base")

    def build(policy, device):
        db = DBDetector(DBConfig(), policy=policy, device=device, seed=1)
        readable_db(db)
        lore = LORE(LoreConfig(), policy=policy, device=device, seed=0)
        docx = DocXLayout(DocXLayoutConfig(), policy=policy, device=device,
                          seed=0)
        mgp = MGPSTR(cfg, policy=policy, device=device, seed=0)
        return db, lore, docx, mgp

    db, lore, docx, mgp = build(DEFAULT_POLICY, None)
    readable_dla(lore)
    readable_dla(docx)
    reseed_offsets(lore, seed=7)
    readable_boxes(lore.backbone.wh_out, LORE_CELL_HALF)
    readable_boxes(docx.backbone.wh_out, LAYOUT_REGION_HALF)
    engine = MGPSTRInference(mgp, CharCodec())

    def lore_input(page):           # what make_table_predict_fn feeds
        return resize_linear_u8(torch.from_numpy(page).cuda()[None],
                                (TABLE_INPUT,) * 2).float() / 255.0

    def docx_input(page):           # what make_layout_predict_fn feeds
        return torch.from_numpy(page).cuda()[None].float() / 255.0

    @torch.inference_mode()
    def lore_heat(page):
        return lore(lore_input(page))["hm"][..., 0]

    @torch.inference_mode()
    def docx_heat(page):
        return docx(docx_input(page))["hm"][..., 0]

    t0 = time.perf_counter()
    readable = {
        "table_fit_r2": fit_heat_readout(
            lore.backbone, [lore_input(p) for p in tables], tables, blur=3),
        "layout_fit_r2": fit_heat_readout(
            docx.backbone, [docx_input(p) for p in docs], docs, blur=9)}
    readable.update({
        "table_cells": lift_heat_bias(
            lore.backbone.hm_out, 0, lore_heat, tables, TABLE_CELLS, 0.3,
            True, lore.config.top_k),
        "layout_regions": lift_heat_bias(
            docx.backbone.hm_out, 0, docx_heat, docs, LAYOUT_REGIONS,
            docx.config.score_threshold, False, docx.config.top_k)})
    det_fn = make_db_detect_fn(db)
    table_fn = make_table_predict_fn(lore, input_size=TABLE_INPUT)
    layout_fn = make_layout_predict_fn(docx)
    words = [len(det_fn(p)[0]) for p in np.concatenate([docs, tables])]
    cells = [len(table_fn(p)["polygons"]) for p in tables]
    regions = [len(layout_fn(p)[0]) for p in docs]
    dense = dense_page()
    dense_words = len(det_fn(dense)[0])
    readable.update({"words_per_page": words, "cells_per_table": cells,
                     "regions_per_page": regions,
                     "dense_page_words": dense_words,
                     "seconds": time.perf_counter() - t0})
    emit({"phase": "docxchain_readable", **readable})
    require(all(DOC_WORDS[0] <= n <= DOC_WORDS[1] for n in words)
            and DENSE_WORDS[0] <= dense_words <= DENSE_WORDS[1]
            and all(TABLE_CELLS[0] <= n <= TABLE_CELLS[1] for n in cells)
            and all(LAYOUT_REGIONS[0] <= n <= LAYOUT_REGIONS[1]
                    for n in regions),
            f"pages not readable as required: {readable}")

    pipes = doc_pipelines(engine, det_fn, table_fn, layout_fn)
    inputs = {"reading": docs, "table": tables, "structurization": docs}

    # launch counts per path, each read just after its one page; the
    # dense page takes several recognizer forwards
    launches = {}
    for key, name, page in (
            ("reading", "reading", docs[0]),
            ("reading_dense", "reading", dense),
            ("table", "table", tables[0]),
            ("structurization", "structurization", docs[0]),
            ("structurization_dense", "structurization", dense)):
        fwd = -(-len(det_fn(page)[0]) // 64)
        _, counts = counted(lambda: pipes[name](page))
        want = {"fused_qkv_attention": 12 * fwd,
                "vocab_greedy_decode": 2 * fwd}
        if name == "table":
            want["deform_conv"] = 16
        launches[key] = {**counts, "forwards": fwd}
        require(counts == want,
                f"{key}: launches {counts}, expected {want}")

    # the dense page's strings, batch by batch, are the engine's own on the
    # same crops in the same zero-padded batches of 64
    quads = np.asarray([order_point(q) for q in det_fn(dense)[0]],
                       np.float32)
    want = recognize_in_batches(engine, crop_quads_u8(
        torch.from_numpy(dense).cuda(), quads), 64)
    lats = []
    for _ in range(3):
        t1 = time.perf_counter()
        got = pipes["reading"](dense)["instances"]
        lats.append((time.perf_counter() - t1) * 1e3)
    dense_rec = {"words": len(got), "forwards": -(-len(got) // 64),
                 "p50_ms": float(np.median(lats)),
                 "equal": [(w["text"], w["confidence"]) for w in got]
                 == [(t, c) for t, c, _ in want]}
    require(dense_rec["equal"] and len(got) == dense_words,
            f"dense page: strings differ from the engine's: {dense_rec}")

    # the pages that entered as JPEG files through the same pipelines
    jpeg_rec = {"reading_words": len(pipes["reading"](
        files["jpeg"]["doc"])["instances"]),
        "table_cells": len(pipes["table"](files["jpeg"]["table"])["cells"])}
    require(jpeg_rec["reading_words"] and jpeg_rec["table_cells"],
            f"the JPEG pages gave no words or no cells: {jpeg_rec}")
    mixed = mixed_crops_phase(engine, det_fn)
    emit({"phase": "docxchain_mixed_crops", "card": card, **mixed})

    # the host box extraction timed a call (and, under the stage clock,
    # its start marked as the end of the detect function's model stage)
    real_extract, extract_ms, stage_clock = db_module.extract_boxes, [], []

    def timed_extract(*a, **k):
        if stage_clock:
            stage_clock[0].mark("det_model")
        t0 = time.perf_counter()
        out = real_extract(*a, **k)
        extract_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    db_module.extract_boxes = timed_extract
    try:
        # throughput and latency, 2 rounds over the 8 pages
        speed = {}
        for name, pipe in pipes.items():
            pipe(inputs[name][0])                           # warm up
            lats = []
            extract_ms.clear()
            t0 = time.perf_counter()
            for _ in range(2):
                for page in inputs[name]:
                    t1 = time.perf_counter()
                    pipe(page)
                    lats.append((time.perf_counter() - t1) * 1e3)
            speed[name] = {
                "pages_per_s": len(lats) / (time.perf_counter() - t0),
                "p50_ms": float(np.percentile(lats, 50)),
                "p99_ms": float(np.percentile(lats, 99)),
                "host_extract_ms_per_page": float(np.mean(extract_ms))}

        # stage times by CUDA events over 3 pages a path
        clock = StageClock()
        stage_clock.append(clock)
        timed = doc_pipelines(engine, det_fn, table_fn, layout_fn,
                              clock=clock)
        stages = {}
        for name, pipe in timed.items():
            clock.calls = []
            for page in inputs[name][:3]:
                clock.start()
                pipe(page)
                clock.mark("assembly")
            stages[name] = clock.stage_ms()
    finally:
        db_module.extract_boxes = real_extract
    emit({"phase": "docxchain", "card": card, "pages": DOC_PAGES,
          "page_hw": DOC_HW,
          "table_input": TABLE_INPUT, "speed": speed, "stage_ms": stages,
          "launches": launches, "dense_page": dense_rec,
          "jpeg_pages": jpeg_rec,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})

    # f32 on the card against the port on the CPU, doc page 0 and table
    # page 0: equal results, no launch
    f32 = {}
    for device in ("cuda", "cpu"):
        db32, lore32, docx32, mgp32 = build(FP32_POLICY, device)
        lore32.load_state_dict(lore.state_dict())
        docx32.load_state_dict(docx.state_dict())
        eng32 = MGPSTRInference(mgp32, CharCodec(),
                                input_dtype=torch.float32, device=device)
        fns = (make_db_detect_fn(db32),
               make_table_predict_fn(lore32, input_size=TABLE_INPUT),
               make_layout_predict_fn(docx32))
        p32 = doc_pipelines(eng32 if device == "cuda" else
                            MemoRecognizer(eng32), *fns, device=device)
        t0 = time.perf_counter()
        res, counts = counted(lambda: {
            name: json_form(pipe(inputs[name][0]))
            for name, pipe in p32.items()})
        f32[device] = {"results": res, "launches": counts,
                       "seconds": time.perf_counter() - t0,
                       "models": (db32, lore32, docx32, eng32, fns)}
    diffs = {name: same_result(f32["cuda"]["results"][name],
                               f32["cpu"]["results"][name])
             for name in pipes}
    # the f32 detect function (the JAX CLI's: host extraction) on page 0
    (q_gpu, s_gpu), (q_cpu, s_cpu) = (f32[d]["models"][4][0](docs[0])
                                      for d in ("cuda", "cpu"))
    same_shape = q_gpu.shape == q_cpu.shape
    det_rec = {"boxes": [len(q_gpu), len(q_cpu)],
               "max_quad_diff": float(np.abs(q_gpu - q_cpu).max(initial=0))
               if same_shape else None,
               "max_score_diff": float(np.abs(s_gpu - s_cpu).max(initial=0))
               if same_shape else None}
    res = f32["cuda"]["results"]
    f32_rec = {"diffs": diffs, "launches": f32["cuda"]["launches"],
               "detect_page0": det_rec,
               "seconds": {d: f32[d]["seconds"] for d in f32},
               "words": len(res["reading"]["instances"]),
               "cells": len(res["table"]["cells"]),
               "cells_with_words": sum(bool(c["content"])
                                       for c in res["table"]["cells"]),
               "regions": len(res["structurization"]),
               "regions_with_words": sum(bool(r["text_list"])
                                         for r in res["structurization"])}
    emit({"phase": "docxchain_f32_vs_cpu", **f32_rec})
    require(not any(diffs.values()) and f32_rec["launches"] == {}
            and same_shape and len(q_cpu)
            and det_rec["max_quad_diff"] <= DOC_POLY_TOL
            and det_rec["max_score_diff"] <= 1e-5,
            f"f32 pipelines on the card differ from the CPU: {f32_rec}")

    # bf16 decisions against f32 on the card: every place they part must
    # be a rounding flip, and the bf16 maps and logits near f32's
    db32, lore32, docx32, eng32, (det32, _, _) = f32["cuda"]["models"]
    del f32
    # the bound holds the features the heads read (the trunk and neck, K3
    # in LORE's) and the recognizer's logits; the readable heat maps
    # amplify their features' small variation and are reported only
    bf = {"rel_rms": {}, "maps_rel_rms": {}, "flips": {}}

    def worst(table, key, value):
        table[key] = max(table.get(key, 0.0), value)

    with torch.inference_mode():
        for i, page in enumerate(docs):
            x = docx_input(page)
            m16, m32 = docx(x), docx32(x)
            worst(bf["rel_rms"], "layout_features", rel_rms(
                head_features(docx.backbone, x, "hm"),
                head_features(docx32.backbone, x, "hm")))
            for head in ("hm", "cls"):
                worst(bf["maps_rel_rms"], f"layout_{head}",
                      rel_rms(m16[head], m32[head]))
            l16, l32 = m16["hm"][0, ..., 0], m32["hm"][0, ..., 0]
            thr = docx.config.score_threshold
            flips, both_kept = heat_flips(l16, l32, thr, False)
            bf["flips"][f"layout_keep_{i}"] = flips
            bf["flips"][f"layout_class_{i}"] = argmax_flips(
                m16["cls"][0], m32["cls"][0], both_kept)
            if i == 0:
                # control: the bf16 map with its firmest f32 keep decision
                # dropped below the threshold, a fault the gate must see
                firm = torch.where(heat_keep(l32[None], thr, False)[0][0],
                                   keep_margins(l32, thr), -1.0)
                pos = divmod(int(firm.argmax()), firm.shape[1])
                faulty = l16.clone()
                faulty[pos] = float(np.log(thr / (1.0 - thr))) - 1.0
                control_flip = heat_flips(faulty, l32, thr, False)[0][
                    "worst_margin_over_rms"]
        for i, page in enumerate(tables):
            x = lore_input(page)
            m16, m32 = lore(x), lore32(x)
            f32_feat = head_features(lore32.backbone, x, "hm")
            worst(bf["rel_rms"], "table_features", rel_rms(
                head_features(lore.backbone, x, "hm"), f32_feat))
            # the same bf16 model with its DCNs on the plain version, which
            # has K3's rounding points: bf16's own error here
            dcn_module.supports_deform_conv = lambda *a: False
            try:
                worst(bf["rel_rms"], "table_features_plain_dcn", rel_rms(
                    head_features(lore.backbone, x, "hm"), f32_feat))
            finally:
                dcn_module.supports_deform_conv = supports_deform_conv
            # controls: K3 fed offsets shifted by a fraction of a pixel
            for shift in K3_CONTROL_SHIFTS:
                dcn_module.deform_conv2d = (
                    lambda x_, off, *a, d=shift: deform_conv2d(
                        x_, off + d, *a))
                try:
                    worst(bf["rel_rms"], f"table_features_k3_shift_{shift}",
                          rel_rms(head_features(lore.backbone, x, "hm"),
                                  f32_feat))
                finally:
                    dcn_module.deform_conv2d = deform_conv2d
            worst(bf["maps_rel_rms"], "table_hm",
                  rel_rms(m16["hm"], m32["hm"]))
            bf["flips"][f"table_keep_{i}"] = heat_flips(
                m16["hm"][0, ..., 0], m32["hm"][0, ..., 0], 0.3, True)[0]
        boxes = []      # [bf16 boxes, f32 boxes, the farthest bf16 box
        for page in np.concatenate([docs, tables]):  # from its nearest f32
            q16, _ = det_fn(page)                    # box, pixels]
            q32, _ = det32(page)
            far = (np.abs(q16[:, None] - q32[None]).max(-1).min(1).max()
                   if len(q16) and len(q32) else 0.0)
            boxes.append([len(q16), len(q32), float(far)])
        # strings: the recognizer's char decisions on the f32 crops
        page = docs[0]
        quads = np.asarray([order_point(q) for q in det32(page)[0]],
                           np.float32)
        u8 = crop_quads_u8(torch.from_numpy(page).cuda(), quads)
        l16 = engine.model(normalize_crops(u8))["char"][:, 1:].float()
        l32 = eng32.model(normalize_crops(u8, torch.float32))["char"][:, 1:]
        V = engine.true_vocab["char"]
        bf["rel_rms"]["rec_char"] = rel_rms(l16[..., :V], l32[..., :V])
        bf["flips"]["rec_char"] = argmax_flips(l16[..., :V], l32[..., :V])
        s16 = [t for t, _, _ in engine.recognize(u8)]
        s32 = [t for t, _, _ in eng32.recognize(u8)]
        bf["strings_equal"] = [sum(a == b for a, b in zip(s16, s32)),
                               len(s32)]
    bf["boxes_bf16_f32_maxdiff"] = boxes
    worst = max([f.get("worst_margin_over_rms", f.get("worst_gap_over_rms",
                                                      0.0))
                 for f in bf["flips"].values()])
    bf["worst_flip_ratio"] = worst
    r = bf["rel_rms"]
    plain = max(r["table_features_plain_dcn"], 1e-3)
    bf["k3_over_plain"] = r["table_features"] / plain
    bf["controls"] = {
        "layout_firmest_keep_dropped": control_flip,
        **{f"k3_shift_{d}_over_plain": r[f"table_features_k3_shift_{d}"]
           / plain for d in K3_CONTROL_SHIFTS}}
    emit({"phase": "docxchain_bf16_vs_f32", "tol_rel_rms": DOC_BF16_RTOL,
          "tol_k3_over_plain": DOC_K3_RATIO,
          "tol_flip_over_rms": FLIP_RMS_BOUND, **bf})
    require(worst <= FLIP_RMS_BOUND and all(b[0] == b[1] for b in boxes)
            and max(r["layout_features"], r["rec_char"]) <= DOC_BF16_RTOL
            and bf["k3_over_plain"] <= DOC_K3_RATIO,
            f"bf16 pipelines part from f32 beyond rounding: {bf}")
    require(bf["controls"][f"k3_shift_{K3_CONTROL_SHIFTS[0]}_over_plain"]
            > DOC_K3_RATIO,
            f"the K3 gate passes a half-pixel sampling fault: {bf}")
    del db32, lore32, docx32, eng32, det32
    torch.cuda.empty_cache()

    ref = docxlayout_reference_file(docx)
    emit({"phase": "docxchain_reference_file", **ref})
    cli_rec = cli_table_subprocess(
        tables[0], lore.backbone.hm_out.state_dict(),
        json_form(pipes["table"](tables[0])))
    emit({"phase": "docxchain_cli", "card": card, **cli_rec})
    with open(os.path.join(PAGE_JPEGS, "smoke_doc_page0_q90.jpg"),
              "rb") as f:
        jpeg_body = f.read()
    http = http_phase(engine, det_fn, docs, [
        (png_bytes(docs[0]), docs[0]), (png_bytes(docs[1]), docs[1]),
        (png_bytes(dense), dense), (jpeg_body, files["jpeg"]["doc"])])
    emit({"phase": "docxchain_http", "card": card, **http})
    emit({"phase": "docxchain_seconds", "card": card,
          "seconds": time.perf_counter() - t_phase})
    table = pipes["table"]          # the evaluation phase's doc_parsing set
    del engine, db, lore, docx, mgp, pipes
    torch.cuda.empty_cache()
    return table


# the evaluation phase: the standard STR eval sets' names and sizes
EVAL_SETS = (("IIIT5k_3000", 3000), ("SVT", 647), ("IC13_857", 857),
             ("IC15_1811", 1811), ("SVTP", 645), ("CUTE80", 288))
EVAL_CROP_H, EVAL_CROP_W = (16, 96), (32, 384)    # crop size ranges, px
EVAL_PNG_FILTERS = (1, 2)     # the crops' PNG rows: Sub and Up
EVAL_ALTERED = 5              # labels altered a set on the self-labelled sets
# random weights never end a word, so the recognizer would fill all 26
# character slots of batch_max_length 25, one past the label filter's 25:
# it runs at 24 (25 slots; `--config-json`), the width (D=768, 12 layers,
# S=257) MGP-STR-base's own
EVAL_RECOGNIZER_LENGTH = 24
EVAL_BATCHES = (64, 256)
CCOCR_WORKERS = (1, 4)
# the macro F1 of CC-OCR's OCR evaluator divides by counts + 1e-9, so a
# page read exactly scores 1 - ~1e-9
CCOCR_EXACT = 1e-6


def readable_mgp_str(model):
    """Hold the char head's [GO] (id 0, the start token a trained head
    never predicts) down, so that no random string spells out "[GO]"."""
    with torch.no_grad():
        model.char_head.bias[0] = -1e4


class PatchedCLI:
    """Within the block, the port CLI's `_rec_engine` gives engines made
    readable by `readable_mgp_str` whose recognize() records its strings
    (`strings`), and its `DBDetector` is `readable_db`'s ink detector."""

    def __init__(self):
        from advancedliteratemachinery_tpu_torch import cli
        from advancedliteratemachinery_tpu_torch.models import db
        self.cli, self.db, self.strings = cli, db, []

    def __enter__(self):
        make, strings = self.cli._rec_engine, self.strings
        self.saved = make, self.db.DBDetector

        def rec_engine(args):
            engine = make(args)
            readable_mgp_str(engine.model)
            recognize = engine.recognize

            def record(batch):
                out = recognize(batch)
                strings.extend(t for t, _, _ in out)
                return out
            engine.recognize = record
            return engine

        class ReadableDB(self.db.DBDetector):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                readable_db(self)

        self.cli._rec_engine, self.db.DBDetector = rec_engine, ReadableDB
        return self

    def __exit__(self, *exc):
        self.cli._rec_engine, self.db.DBDetector = self.saved

    def run(self, argv):
        """`cli.main(argv)` → its stdout; fails the run on a non-zero exit."""
        import contextlib
        import io
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = self.cli.main(argv)
        require(rc == 0, f"cli {argv[0]} exited {rc}")
        return buf.getvalue()


def eval_crop_files(tmp):
    """The six eval sets' crops as files: two of every three a seeded
    `word_crop` of 16-96 x 32-384 px written as PNG with `zlib`, the third
    a committed JPEG crop, cycled (decoded to PIL's recorded hash on
    read-back) → {set: [paths]}, the record."""
    with open(os.path.join(PAGE_JPEGS, "smoke_crops_jpeg.json")) as f:
        jpegs = sorted(json.load(f))
    rng = np.random.default_rng(30)
    files, n_png, t0 = {}, 0, time.perf_counter()
    for name, n in EVAL_SETS:
        os.makedirs(os.path.join(tmp, "crops", name))
        paths = []
        for i in range(n):
            if i % 3 == 2:
                paths.append(os.path.join(PAGE_JPEGS,
                                          jpegs[(i // 3) % len(jpegs)]))
                continue
            h = int(rng.integers(EVAL_CROP_H[0], EVAL_CROP_H[1] + 1))
            w = int(rng.integers(EVAL_CROP_W[0], EVAL_CROP_W[1] + 1))
            paths.append(os.path.join(tmp, "crops", name, f"{i}.png"))
            with open(paths[-1], "wb") as f:
                f.write(png_bytes(word_crop(rng, h, w), EVAL_PNG_FILTERS))
            n_png += 1
        files[name] = paths
    return files, {"crops": sum(len(v) for v in files.values()),
                   "png": n_png, "jpeg_files": len(jpegs),
                   "write_s": time.perf_counter() - t0}


def write_eval_sets(patched, files, labels, out):
    """`create-lmdb` through the CLI for each set with `labels` → the LMDB
    directories (named as the sets), each holding every crop."""
    dirs = []
    os.makedirs(out)
    for name, paths in files.items():
        gt = os.path.join(out, f"{name}.txt")
        with open(gt, "w", encoding="utf-8") as f:
            f.writelines(f"{p}\t{lb}\n" for p, lb in zip(paths,
                                                          labels[name]))
        dirs.append(os.path.join(out, name))
        n = json.loads(patched.run(["create-lmdb", gt, dirs[-1]])
                       .splitlines()[-1])["num_samples"]
        require(n == len(paths), f"create-lmdb kept {n} of {len(paths)} "
                                 f"crops of {name}")
    return dirs


def split_strings(strings, files):
    """Recorded strings in the order the runner read the sets → per set."""
    out, at = {}, 0
    for name, paths in files.items():
        out[name] = strings[at:at + len(paths)]
        at += len(paths)
    require(at == len(strings), f"{len(strings)} strings for {at} crops")
    return out


def altered(s):
    """A label the recognizer's string `s` does not match."""
    return ("q" if s[:1] != "q" else "z") + s[1:]


def timed_eval(engine, dirs, batch, patched):
    """`benchmark_all_eval` on the card at `batch` with its stage split,
    host clock after a synchronize, card peak memory."""
    from advancedliteratemachinery_tpu_torch.eval.str_eval import (
        benchmark_all_eval)
    patched.strings.clear()

    def record(b):
        out = engine.recognize(b)
        patched.strings.extend(t for t, _, _ in out)
        return out
    timings = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (out, counts) = counted(lambda: benchmark_all_eval(
        record, dirs, max_length=25, batch_size=batch, device=engine.device,
        timings=timings))
    wall = time.perf_counter() - t0
    n = out["total_samples"]
    return out, {"batch": batch, "seconds": wall, "crops_per_s": n / wall,
                 "stage_s": timings, "launches": counts,
                 "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def ccocr_pages(kind):
    """The docxchain phase's page files of `kind` ("doc" or "table"): page
    0 as its committed JPEG, pages 1-7 as PNGs with Paeth and Average
    rows → [(file name, bytes)]."""
    pages = (document_pages if kind == "doc" else table_pages)(DOC_PAGES)
    with open(os.path.join(PAGE_JPEGS, f"smoke_{kind}_page0_q90.jpg"),
              "rb") as f:
        out = [(f"{kind}0.jpg", f.read())]
    return out + [(f"{kind}{i}.png", png_bytes(page, PAGE_PNG_FILTERS))
                  for i, page in enumerate(pages[1:], 1)]


# the TableParsing pipeline `table_html` runs, set by the evaluation phase
TABLE_PIPE = None


def table_html(image_path, question):
    """A CC-OCR `import:` model (`import:chip_smoke:table_html`): the
    docxchain phase's bf16 TableParsing (readable LORE, K3) on the page
    file → its HTML."""
    from advancedliteratemachinery_tpu_torch.pipelines.file_loading import (
        load_image)
    return TABLE_PIPE(load_image(image_path))["html"]


def ccocr_tree(tmp, name, group, pages):
    """A CC-OCR-format tree of one dataset (index JSON, `qa.jsonl`,
    images) of `pages` ((file name, bytes) pairs) → the index path."""
    root = os.path.join(tmp, "ccocr")
    data = os.path.join(root, "data", name)
    os.makedirs(os.path.join(data, "images"))
    with open(os.path.join(data, "qa.jsonl"), "w") as f:
        for fname, body in pages:
            with open(os.path.join(data, "images", fname), "wb") as img:
                img.write(body)
            f.write(json.dumps({"url": f"images/{fname}", "prompt":
                                "Read all the text in the image."}) + "\n")
    os.makedirs(os.path.join(root, "index"), exist_ok=True)
    index = os.path.join(root, "index", f"{name}.json")
    with open(index, "w") as f:
        json.dump([{"dataset": name, "group": group,
                    "base_dir": f"data/{name}"}], f)
    return index


def ccocr_responses(path):
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), encoding="utf-8") as f:
            out[name] = json.load(f)["response"]
    return out


def ccocr_collect(patched, index, name, model, tmp):
    """`ccocr-collect` at each of CCOCR_WORKERS (threads sharing the card):
    every page read, the responses and the launches of every worker count
    equal → (responses of the first, the record)."""
    from advancedliteratemachinery_tpu_torch.eval import ccocr_harness
    collect, spans = ccocr_harness.collect_predictions, []

    def timed_collect(*a, **k):                 # pages/s past the builds
        t0 = time.perf_counter()
        out = collect(*a, **k)
        spans.append(time.perf_counter() - t0)
        return out

    ccocr_harness.collect_predictions = timed_collect
    rec, resp, launches = {}, {}, {}
    try:
        for w in CCOCR_WORKERS:
            out = os.path.join(tmp, "ccocr", "preds")
            stats, launches[w] = counted(lambda: json.loads(patched.run(
                ["ccocr-collect", index, out, "--model", model,
                 "--workers", str(w), "--model-name", f"w{w}"])))
            stats = stats[name]
            resp[w] = ccocr_responses(os.path.join(out, f"w{w}", name))
            rec[f"workers_{w}"] = {**stats, "collect_s": spans[-1],
                                   "pages_per_s": stats["ok"] / spans[-1],
                                   "launches": launches[w]}
            require(stats["ok"] == stats["total"] == len(resp[w]) > 0,
                    f"ccocr-collect lost pages of {name}: {stats}")
    finally:
        ccocr_harness.collect_predictions = collect
    last = CCOCR_WORKERS[-1]
    rec.update({"equal_1_4": resp[1] == resp[last],
                "launches_equal": launches[1] == launches[last]})
    require(rec["equal_1_4"] and rec["launches_equal"],
            f"ccocr-collect of {name} at 1 and {last} workers differ: {rec}")
    return resp[1], rec


def ccocr_score(patched, index, name, truth, tmp, case):
    """`ccocr-eval` of the first collect run against `truth` (a response a
    page) → the dataset's evaluation summary."""
    gt = os.path.join(tmp, "ccocr", f"gt_{case}", name)
    os.makedirs(gt)
    for fname, text in truth.items():
        with open(os.path.join(gt, fname), "w", encoding="utf-8") as f:
            json.dump({"text": text}, f)
    out = json.loads(patched.run(["ccocr-eval", index, os.path.join(
        tmp, "ccocr", "preds", "w1"), os.path.dirname(gt)]))
    return out[name]["evaluation"]["summary"]


def first_cell_altered(html):
    """The HTML with the text of its first non-empty cell changed."""
    return re.sub(r"(<td[^>]*>)([^<]+)(</td>)", r"\1\2#\3", html, count=1)


def ccocr_phase(patched, tmp, table_pipe):
    """The CC-OCR harness on the card: `ccocr-collect --model pipeline`
    (the port's GeneralTextReading at MGP-STR-base, the readable DB) over
    the docxchain phase's 16 page files in a `multi_scene_ocr` dataset,
    and `--model import:chip_smoke:table_html` (the docxchain phase's
    TableParsing, K3) over its 8 table pages in a `doc_parsing` dataset,
    each at 1 and 4 workers on one card; `ccocr-eval` against ground truth
    from the first run (1 within CCOCR_EXACT; TEDS 1) and against a control
    (one word dropped a page; one cell's text changed a page: below 1)."""
    global TABLE_PIPE
    # `import:chip_smoke:...` must find this module run as a script
    sys.modules.setdefault("chip_smoke", sys.modules[__name__])
    TABLE_PIPE = table_pipe
    rec = {}
    try:
        pages = ccocr_pages("doc") + ccocr_pages("table")
        index = ccocr_tree(tmp, "smoke_pages", "multi_scene_ocr", pages)
        resp, rec["ocr"] = ccocr_collect(patched, index, "smoke_pages",
                                         "pipeline", tmp)
        words = [len(r.split("\n")) if r else 0 for r in resp.values()]
        rec["ocr"].update({"pages": len(pages), "words_per_page": words})
        require(min(words) > 0, f"a page read no word: {words}")
        rec["ocr"]["score_own"] = ccocr_score(
            patched, index, "smoke_pages", resp, tmp, "own")
        rec["ocr"]["score_control"] = ccocr_score(
            patched, index, "smoke_pages",
            {k: "\n".join(v.split("\n")[1:]) for k, v in resp.items()},
            tmp, "control")
        index = ccocr_tree(tmp, "smoke_tables", "doc_parsing",
                           ccocr_pages("table"))
        html, rec["tables"] = ccocr_collect(
            patched, index, "smoke_tables", "import:chip_smoke:table_html",
            tmp)
        control = {k: first_cell_altered(v) for k, v in html.items()}
        rec["tables"].update({
            "cells_per_page": [v.count("<td") for v in html.values()],
            "score_own": ccocr_score(patched, index, "smoke_tables", html,
                                     tmp, "own_tables"),
            "score_control": ccocr_score(patched, index, "smoke_tables",
                                         control, tmp, "control_tables"),
            "control_changed": sum(control[k] != html[k] for k in html)})
    finally:
        TABLE_PIPE = None
    ocr, tab = rec["ocr"], rec["tables"]
    require(abs(ocr["score_own"]["macro_f1_score"] - 1.0) < CCOCR_EXACT
            and ocr["score_control"]["macro_f1_score"] < 1.0 - 1e-3
            and tab["score_own"]["teds"] == 1.0
            and tab["control_changed"] == len(html)
            and tab["score_control"]["teds"] < 1.0,
            f"ccocr-eval scores wrong: {rec}")
    return rec


def evaluation_phase(card, table_pipe):
    """The evaluation surface (`evaluation`): six LMDB STR eval sets of the
    standard names and sizes (7,248 seeded crops, a third JPEG) through
    `create-lmdb` and `eval` (MGP-STR-base in bf16, K1 + K2), labels from
    the first pass with EVAL_ALTERED altered a set (accuracy exactly
    (n - k)/n) and a control with every label altered (0), timed at
    batch 64 and 256 with the stage split; then the CC-OCR harness
    (`ccocr_phase`; `table_pipe`, the docxchain phase's TableParsing,
    reads its doc_parsing set)."""
    from advancedliteratemachinery_tpu_torch.engine.infer import (
        MGPSTRInference)
    t_phase = time.perf_counter()
    cfg = MGPSTRConfig(variant="base",
                       batch_max_length=EVAL_RECOGNIZER_LENGTH)
    rec = {"card": card, "sets": dict(EVAL_SETS)}
    with tempfile.TemporaryDirectory() as tmp, PatchedCLI() as patched:
        files, rec["files"] = eval_crop_files(tmp)
        first = {name: ["x"] * len(p) for name, p in files.items()}
        dirs = write_eval_sets(patched, files, first,
                               os.path.join(tmp, "first"))
        argv = ["eval", "--data", *dirs, "--variant", "base",
                "--batch-size", str(EVAL_BATCHES[0]),
                "--batch-max-length", "25", "--config-json",
                json.dumps({"batch_max_length": EVAL_RECOGNIZER_LENGTH})]
        t0 = time.perf_counter()
        _, counts = counted(lambda: patched.run(argv))
        forwards = sum(-(-n // EVAL_BATCHES[0]) for _, n in EVAL_SETS)
        rec["cli_pass"] = {"seconds": time.perf_counter() - t0,
                           "launches": counts, "forwards": forwards}
        require_counts(counts, forwards, "eval --batch-size 64")
        strings = split_strings(list(patched.strings), files)
        rng = np.random.default_rng(31)
        labels, control = {}, {}
        for name, got in strings.items():
            labels[name] = list(got)
            for i in rng.choice(len(got), EVAL_ALTERED, replace=False):
                labels[name][i] = altered(got[i])
            control[name] = [altered(s) for s in got]
        require(all(len(s) <= 25 for v in strings.values() for s in v),
                "a string past the label filter's 25 characters")
        self_dirs = write_eval_sets(patched, files, labels,
                                    os.path.join(tmp, "self"))
        control_dirs = write_eval_sets(patched, files, control,
                                       os.path.join(tmp, "control"))
        engine = MGPSTRInference(MGPSTR(cfg, seed=0), CharCodec())
        readable_mgp_str(engine.model)
        out, rec["batch_64"] = timed_eval(engine, self_dirs,
                                          EVAL_BATCHES[0], patched)
        same_64 = split_strings(list(patched.strings), files) == strings
        want = {name: (n - EVAL_ALTERED) / n for name, n in EVAL_SETS}
        n_all = sum(n for _, n in EVAL_SETS)
        want["total_accuracy"] = (n_all - EVAL_ALTERED * len(EVAL_SETS)
                                  ) / n_all
        rec["self_labelled"] = out
        rec["self_labelled_exact"] = all(out[k] == v for k, v in
                                         want.items())
        out, rec["batch_256"] = timed_eval(engine, control_dirs,
                                           EVAL_BATCHES[1], patched)
        same_256 = split_strings(list(patched.strings), files) == strings
        rec["control"] = out
        rec["strings_equal"] = {"cli_vs_64": same_64,
                                "cli_vs_256": same_256}
        require(rec["self_labelled_exact"] and out["total_samples"] == n_all
                and all(v == 0 for k, v in out.items()
                        if k != "total_samples")
                and same_64 and same_256
                and rec["batch_64"]["launches"] == counts,
                f"evaluation: accuracies or strings wrong: {rec}")
        del engine
        torch.cuda.empty_cache()
        emit({"phase": "evaluation", **rec})
        ccocr = ccocr_phase(patched, tmp, table_pipe)
    emit({"phase": "evaluation_ccocr", "card": card, **ccocr,
          "phase_seconds": time.perf_counter() - t_phase})
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"card": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t_start = time.perf_counter()
    timeline = {}

    def mark(name):
        timeline[name] = time.perf_counter() - t_start

    t0 = time.perf_counter()
    seconds = _kernels.build()
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "wgmma" in ln]
             for n, log in _kernels.BUILD_LOG.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_s": seconds, "ptxas": ptxas})

    mark("build")
    golden_replay()
    mark("golden_replay")

    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, S, H in ((3, 17, 2), (2, 64, 1), (4, 100, 3), (2, 700, 2)):
        check_attention(B, S, H, True, gen, time_it=False)
    # both sides of the 64-row tiles, a 16-key short last chunk, S=768
    for S in (1, 63, 64, 65, 129, 257, 320, 768):
        for safe in (True, False):
            check_attention(3, S, 5, safe, gen, time_it=False)
    check_attention(256, 257, 12, True, gen)
    check_attention(256, 257, 12, False, gen)
    k1 = check_attention(512, 257, 12, False, gen)      # e2e: 8 x 64 crops
    k1_err = k1["max_abs_err"]
    short_tail_probe(gen)
    # rows and columns off the 128 x 256 tiles and 2048-column chunks, a
    # single row, true_vocab inside the last tile, ties across tiles and
    # across a chunk boundary
    k2_err = 0.0
    for M, V, true_v, extra in ((300, 1200, 1190, ()),
                                (127, 4100, 4097, ((255, 256), (2047, 2048))),
                                (129, 2304, 2200, ((2047, 2048),)),
                                (1, 30592, 30522, ())):
        k2_err = max(k2_err, check_decode(M, V, true_v, gen, time_it=False,
                                          extra_pairs=extra)["max_abs_err"])
    k2 = None
    for M in (6656, 13312):                               # 256 / 512 crops
        for V, true_v in ((50304, 50257), (30592, 30522)):
            rec = check_decode(M, V, true_v, gen)
            k2_err = max(k2_err, rec["max_abs_err"])
            if M == 13312 and V == 50304:
                k2 = rec
    torch.cuda.empty_cache()

    cfg = MGPSTRConfig(variant="base")
    vit = cfg.vit_config()
    require(vit.embed_dim == 768 and vit.depth == 12, "not MGP-STR-base")
    engine = MGPSTRInference(MGPSTR(cfg, seed=0), CharCodec())
    images = np.random.default_rng(0).integers(0, 256, (256, 32, 128, 3),
                                               dtype=np.uint8)
    check_encoder(engine, cfg, images)
    rec_only(engine, images)
    texts = engine.recognize(images[:4])
    emit({"phase": "recognize", "results": texts})
    require(len(texts) == 4 and all(0.0 <= c <= 1.0 for _, c, _ in texts),
            "recognize() output malformed")

    mark("k1_k2_checks_rec_only")
    _, counts = e2e_spotting(engine)
    mark("e2e_spotting")
    del engine
    torch.cuda.empty_cache()

    k3_err = 0.0
    # pixels off the 8 x 16 tiles, Cin off the 64-channel stages and the
    # 8-channel vectors, Cout at N = 64, 128, 256 and two column blocks
    for B, H, Cin, Cout, case in ((3, 13, 40, 72, "normal"),
                                  (2, 37, 200, 100, "normal"),
                                  (1, 24, 5, 7, "normal"),
                                  (1, 9, 200, 200, "normal"),
                                  (2, 24, 512, 256, "normal"),
                                  (1, 11, 64, 300, "normal"),
                                  (3, 5, 8, 128, "normal"),
                                  (2, 48, 64, 64, "far"),
                                  (2, 48, 64, 64, "beyond3"),
                                  (2, 48, 64, 64, "outside"),
                                  (1, 10, 5, 7, "outside"),
                                  (1, 10, 512, 256, "outside"),
                                  (2, 48, 64, 64, "zero_mask")):
        k3_err = max(k3_err, check_deform_conv(B, H, H + 3, Cin, Cout, gen,
                                               case)["max_abs_err"])
    path = []
    for B, H, Cin, Cout, n in DCN_PATH_SHAPES:
        rec = check_deform_conv(B, H, H, Cin, Cout, gen, time_it=True,
                                time_plain=H == 192)
        k3_err = max(k3_err, rec["max_abs_err"])
        path.append((n, rec))
    k3 = path[-1][1]                                    # 64 -> 64 at 192²
    emit({"phase": "deform_conv_per_forward", "layers": 16,
          **{key: sum(n * r[key] for n, r in path)
             for key in ("ms", "library_ms", "bound_ms")}})
    torch.cuda.empty_cache()

    lore = LORE(LoreConfig(), seed=0)
    require(lore.config.backbone.dla.channels[-1] == 512
            and lore.config.backbone.head_conv == 256
            and lore.config.hidden_size == 256, "not the full LoreConfig")
    reseed_offsets(lore, seed=7)
    check_lore_vs_cpu(lore)
    _, lore_counts = lore_tsr(lore)
    mark("k3_checks_lore")
    del lore
    torch.cuda.empty_cache()
    f32_models_phase()
    mark("f32_models")
    reference_checkpoints()
    mark("reference_checkpoints")
    lister_phase()
    mark("lister")
    levocr_phase()
    mark("levocr")
    spot_bf16, spot_f32, omni_pages = omniparser_phase()
    mark("omniparser")
    omniparser_tasks_phase(smi, spot_bf16, spot_f32, omni_pages)
    del spot_bf16, spot_f32, omni_pages
    mark("omniparser_tasks")
    table_pipe = docxchain_phase(smi)
    mark("docxchain")
    evaluation_phase(smi, table_pipe)
    del table_pipe
    torch.cuda.empty_cache()
    mark("evaluation")

    bwd_err = 0.0
    # both sides of the 64-row tiles and of a 16-row short last chunk, one
    # and two heads a block (an odd number of heads: B=3, H=1), and a scale
    # that is no power of two
    for S in K4_SEQS:
        for B, H in ((3, 1), (2, 3), (1, 12)):
            bwd_err = max(bwd_err,
                          check_attention_bwd(B, S, H, gen)["max_abs_err"])
    for B, S, H, scale in ((2, 257, 3, 0.1), (1, 768, 2, 0.3)):
        bwd_err = max(bwd_err, check_attention_bwd(
            B, S, H, gen, scale=scale)["max_abs_err"])
    k4 = check_attention_bwd(128, 257, 12, gen, time_it=True)
    k4_long = check_attention_bwd(16, 768, 12, gen, time_it=True)
    bwd_err = max(bwd_err, k4["max_abs_err"], k4_long["max_abs_err"])
    torch.cuda.empty_cache()
    mark("k4_checks")
    k4_repeats_phase(gen)
    mark("k4_repeats")
    mha_err = 0.0
    for B, S, H in ((3, 17, 2), (2, 300, 3), (1, 1000, 2)):
        mha_err = max(mha_err, check_mha(B, S, H, gen)["max_abs_err"])
    # resident (S <= 320) and streamed, in each layout K5 reads in place
    for S in (1, 64, 65, 257, 513, 640, 1024):
        for layout in ("qkv", "q+kv", "bhsd"):
            mha_err = max(mha_err, check_mha(2, S, 3, gen, layout=layout)[
                "max_abs_err"])
    k5 = check_mha(128, 257, 12, gen, time_it=True)
    k5_long = check_mha(16, 1024, 12, gen, time_it=True)
    mha_err = max(mha_err, k5["max_abs_err"], k5_long["max_abs_err"])
    torch.cuda.empty_cache()

    mark("k5_checks")
    _, train_counts, host = train_step_phase()
    fit_phase(host)
    mark("train_fit")
    emit({"phase": "timeline", "seconds_since_start": timeline})
    torch.cuda.empty_cache()
    print(smi, flush=True)      # again beside the summary, for short tails
    emit({"kernels": [
        {"name": "fused_qkv_attention", "route": "cuda", "source": ATTN_SRC,
         "replaces": "advancedliteratemachinery_tpu/ops/attention.py:51",
         "launches": counts["fused_qkv_attention"], "max_abs_err": k1_err,
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": k1["library_ms"],
         "library_strided_ms": k1["library_strided_ms"],
         "library": "scaled_dot_product_attention on contiguous BHSD "
                    "copies (library_ms) and on strided views of qkv "
                    "(library_strided_ms)",
         "shape": "B=512 S=257 D=768 H=12"},
        {"name": "vocab_greedy_decode", "route": "cuda", "source": DECODE_SRC,
         "replaces": "advancedliteratemachinery_tpu/ops/vocab_decode.py:39",
         "launches": counts["vocab_greedy_decode"], "max_abs_err": k2_err,
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": k2["library_ms"],
         "shape": "M=13312 D=768 V=50304 (true 50257)"},
        {"name": "deform_conv", "route": "cuda", "source": DCN_SRC,
         "replaces":
             "advancedliteratemachinery_tpu/ops/deform_conv_pallas.py:36",
         "launches": lore_counts["deform_conv"], "max_abs_err": k3_err,
         "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
         "library_ms": k3["library_ms"],
         "library": "F.conv2d: the same layer at zero offsets, unit mask",
         "shape": "B=8 H=W=192 Cin=64 Cout=64"},
        {"name": "fused_qkv_attention_bwd", "route": "cuda",
         "source": BWD_SRC,
         "replaces": "advancedliteratemachinery_tpu/ops/attention.py:165",
         "launches": train_counts["fused_qkv_attention_bwd"],
         "max_abs_err": bwd_err, "ms": k4["ms"], "plain_ms": k4["plain_ms"],
         "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"],
         "library_ms": k4["library_ms"],
         "library": "backward of scaled_dot_product_attention on strided "
                    "views of the same q/k/v",
         "shape": "B=128 S=257 D=768 H=12",
         "s768": {key: k4_long[key] for key in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}},
        {"name": "mha_short_seq", "route": "cuda", "source": MHA_SRC,
         "replaces": "advancedliteratemachinery_tpu/ops/attention.py:276",
         "launches": train_counts.get("mha_short_seq", 0),
         "main_path": "none: no path of the JAX package reaches it",
         "max_abs_err": mha_err, "ms": k5["ms"], "plain_ms": k5["plain_ms"],
         "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
         "library_ms": k5["library_ms"],
         "library": "scaled_dot_product_attention on the same views",
         "shape": "B=128 S=257 H=12 hd=64, strided views of one projection",
         "s1024": {key: k5_long[key] for key in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
