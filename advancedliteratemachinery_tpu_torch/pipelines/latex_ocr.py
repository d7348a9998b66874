"""LaTeX-OCR ONNX backend for formula recognition (port of
`advancedliteratemachinery_tpu/pipelines/latex_ocr.py`, which imports no
JAX; reference Applications/DocXChain/modules/formula_recognition.py:11,
upstream RapidAI/RapidLatexOCR, the ONNX export of lukas-blecher/LaTeX-OCR
pix2tex). Host NumPy around three ONNX sessions, with the JAX module's
arithmetic, so the same sessions give the same arrays and strings:

- image → grayscale, pad to the model's multiple-of-32 box within
  (min_dims, max_dims), normalize (x/255 − 0.7931)/0.1738;
- iterative width-bucket search with the resizer network (pix2tex
  resizer loop: predict argmax bucket, resize, repeat until fixed
  point);
- encoder → cross-attention context;
- greedy autoregressive decode (bos=1, eos=2, max 512) through the
  decoder network;
- HF-tokenizer-json detokenization + pix2tex post_process cleanup.

The sessions are injectable callables (`__init__` takes them).
`from_paths` imports `onnxruntime` only when it is called and raises the
JAX module's ImportError where it is missing.
"""

from __future__ import annotations

import json
import os
import re
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

_MEAN, _STD = 0.7931, 0.1738


def _load_tokenizer_vocab(tokenizer_json: str) -> Dict[int, str]:
    """HF `tokenizers` json → {id: token}. Only the vocab table is needed
    for greedy detokenization (pix2tex token2str)."""
    with open(tokenizer_json, encoding="utf-8") as f:
        tok = json.load(f)
    vocab = tok.get("model", {}).get("vocab")
    if vocab is None:
        raise ValueError(f"{tokenizer_json}: no model.vocab table — not a "
                         f"LaTeX-OCR tokenizer json")
    id2tok = {int(i): t for t, i in vocab.items()}
    for added in tok.get("added_tokens", []):
        id2tok[int(added["id"])] = added["content"]
    return id2tok


def post_process(s: str) -> str:
    """pix2tex utils.post_process: normalize whitespace in the decoded
    LaTeX (remove spaces except between letter tokens)."""
    text_reg = r"(\\(operatorname|mathrm|text|mathbf)\s?\*? {.*?})"
    letter = "[a-zA-Z]"
    noletter = r"[\W_^\d]"
    names = [x[0].replace(" ", "") for x in re.findall(text_reg, s)]
    s = re.sub(text_reg, lambda _m: str(names.pop(0)), s)
    news = s
    while True:
        s = news
        news = re.sub(rf"(?!\\ )({noletter})\s+?({noletter})", r"\1\2", s)
        news = re.sub(rf"(?!\\ )({noletter})\s+?({letter})", r"\1\2", news)
        news = re.sub(rf"({letter})\s+?({noletter})", r"\1\2", news)
        if news == s:
            break
    return s


class LatexOcrOnnx:
    """Formula image → LaTeX through LaTeX-OCR-format ONNX models.

    resizer/encoder/decoder: callables mapping a dict of input arrays to
    a list of output arrays (the onnxruntime `session.run(None, feeds)`
    shape) — `from_dir` builds them from .onnx files."""

    def __init__(self, encoder: Callable, decoder: Callable,
                 tokenizer: Dict[int, str],
                 resizer: Optional[Callable] = None,
                 max_dims: Tuple[int, int] = (192, 672),
                 min_dims: Tuple[int, int] = (32, 32),
                 max_len: int = 512, bos_id: int = 1, eos_id: int = 2):
        self.encoder = encoder
        self.decoder = decoder
        self.resizer = resizer
        self.id2tok = tokenizer
        self.max_dims = max_dims           # (H, W)
        self.min_dims = min_dims
        self.max_len = max_len
        self.bos_id = bos_id
        self.eos_id = eos_id

    # ---- construction ----

    @classmethod
    def from_dir(cls, model_dir: str, **kw) -> "LatexOcrOnnx":
        """Directory holding encoder_model.onnx / decoder_model.onnx /
        image_resizer.onnx (optional) / tokenizer.json — the
        RapidLatexOCR artifact layout."""
        def find(*names):
            for n in names:
                p = os.path.join(model_dir, n)
                if os.path.exists(p):
                    return p
            return None

        enc = find("encoder_model.onnx", "encoder.onnx")
        dec = find("decoder_model.onnx", "decoder.onnx")
        tok = find("tokenizer.json")
        if not (enc and dec and tok):
            raise FileNotFoundError(
                f"{model_dir}: need encoder_model.onnx, decoder_model.onnx "
                f"and tokenizer.json (RapidLatexOCR layout); found "
                f"{sorted(os.listdir(model_dir))}")
        rsz = find("image_resizer.onnx", "resizer.onnx")
        return cls.from_paths(enc, dec, tok, rsz, **kw)

    @classmethod
    def from_paths(cls, encoder_path: str, decoder_path: str,
                   tokenizer_json: str,
                   resizer_path: Optional[str] = None,
                   **kw) -> "LatexOcrOnnx":
        try:
            import onnxruntime as ort
        except ImportError as e:
            raise ImportError(
                "formula recognition's ONNX backend needs onnxruntime, "
                "which is not installed in this environment — install it "
                "or inject a callable via FormulaRecognition(latex_fn=...)"
            ) from e

        def session(path):
            if path is None:
                return None
            s = ort.InferenceSession(path,
                                     providers=["CPUExecutionProvider"])
            names = [i.name for i in s.get_inputs()]

            def run(feeds):
                return s.run(None, {n: feeds[n] for n in names})

            return run

        return cls(session(encoder_path), session(decoder_path),
                   _load_tokenizer_vocab(tokenizer_json),
                   resizer=session(resizer_path), **kw)

    # ---- preprocessing ----

    def _pad_gray(self, image: np.ndarray) -> np.ndarray:
        """uint8 [H,W,3] / [H,W] → grayscale, cropped to content and
        padded to multiples of 32 within (min_dims, max_dims)."""
        img = np.asarray(image)
        if img.ndim == 3:
            img = img.mean(axis=-1)
        img = img.astype(np.float32)
        Hmax, Wmax = self.max_dims
        h = int(np.clip(32 * int(np.ceil(img.shape[0] / 32)),
                        self.min_dims[0], Hmax))
        w = int(np.clip(32 * int(np.ceil(img.shape[1] / 32)),
                        self.min_dims[1], Wmax))
        out = np.full((h, w), 255.0, np.float32)
        ih, iw = min(img.shape[0], h), min(img.shape[1], w)
        out[:ih, :iw] = img[:ih, :iw]
        return out

    @staticmethod
    def _resize(img: np.ndarray, wh: Tuple[int, int]) -> np.ndarray:
        """Bilinear resize [H,W] → (w, h) without cv2 (separable)."""
        w, h = wh
        H, W = img.shape
        ys = np.clip((np.arange(h) + 0.5) * H / h - 0.5, 0, H - 1)
        xs = np.clip((np.arange(w) + 0.5) * W / w - 0.5, 0, W - 1)
        y0 = np.floor(ys).astype(int)
        x0 = np.floor(xs).astype(int)
        y1 = np.minimum(y0 + 1, H - 1)
        x1 = np.minimum(x0 + 1, W - 1)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        a = img[y0][:, x0] * (1 - fy) * (1 - fx)
        b = img[y0][:, x1] * (1 - fy) * fx
        c = img[y1][:, x0] * fy * (1 - fx)
        d = img[y1][:, x1] * fy * fx
        return (a + b + c + d).astype(np.float32)

    def _resizer_loop(self, gray: np.ndarray, iters: int = 10) -> np.ndarray:
        """pix2tex resizer fixed point: the resizer CNN classifies the
        best width bucket (argmax·32) for the current rendering; resize
        and repeat until the prediction stops changing."""
        if self.resizer is None:
            return gray
        img = gray
        for _ in range(iters):
            feed = ((255.0 - img[None, None]) / 255.0).astype(np.float32)
            out = self.resizer({"input": feed})[0]
            w_pred = int((np.argmax(np.asarray(out).reshape(-1)) + 1) * 32)
            w_pred = min(w_pred, self.max_dims[1])
            if w_pred == img.shape[1]:
                break
            h_pred = max(32, min(
                self.max_dims[0],
                32 * int(np.ceil(img.shape[0] * w_pred
                                 / max(img.shape[1], 1) / 32))))
            img = self._resize(img, (w_pred, h_pred))
        return img

    # ---- decode ----

    def __call__(self, image: np.ndarray) -> str:
        gray = self._resizer_loop(self._pad_gray(image))
        x = ((gray / 255.0 - _MEAN) / _STD).astype(np.float32)[None, None]
        context = np.asarray(self.encoder({"input": x})[0])

        ids: List[int] = [self.bos_id]
        for _ in range(self.max_len - 1):
            logits = np.asarray(self.decoder({
                "x": np.asarray([ids], np.int64),
                "context": context,
            })[0])
            nxt = int(np.argmax(logits[0, -1]))
            if nxt == self.eos_id:
                break
            ids.append(nxt)
        return self.detokenize(ids[1:])

    def detokenize(self, ids) -> str:
        toks = [self.id2tok.get(int(i), "") for i in ids]
        s = "".join(toks).replace("Ġ", " ").strip()
        s = re.sub(r"\[(PAD|BOS|EOS)\]", "", s)
        return post_process(s)
