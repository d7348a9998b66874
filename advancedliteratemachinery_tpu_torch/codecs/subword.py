r"""Subword codecs: GPT-2 byte-level BPE and BERT WordPiece (the port's own
copy of `advancedliteratemachinery_tpu/codecs/subword.py`).

MGP-STR `TokenLabelConverter` (reference OCR/MGP-STR/utils.py:60-88): BPE
targets are [1] + gpt2_ids + [2], GO(0)-padded to max_tokens; WordPiece
targets are `[CLS] ... [SEP]`, padded or truncated to max_tokens. The BPE
eval decode prunes at '#' (the text of GPT-2 id 2); the WordPiece decode
glues '##' pieces and joins on nothing.

The GPT-2 pre-tokenizer is the pattern

    's|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+

which needs the `regex` package for `\p{L}` and `\p{N}`. Here it is a
scanner over `unicodedata` categories: L* for letters, Nd/Nl/No for
numbers, and `regex`'s `\s` (str.isspace less the four separators
U+001C-U+001F). The categories are those of Python's own Unicode tables;
`regex` may carry a newer Unicode version, which differs only on code
points that Python's tables leave unassigned.

Point the codecs at standard `vocab.json`/`merges.txt` or `vocab.txt`
files; nothing is downloaded.
"""

from __future__ import annotations

import functools
import json
import os
import unicodedata
from typing import Dict, List, Sequence, Tuple

import numpy as np

from advancedliteratemachinery_tpu_torch.core.registry import CODECS

ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")

_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
_NOT_REGEX_SPACE = frozenset("\x1c\x1d\x1e\x1f")


def _kind(ch: str) -> str:
    """'L' letter, 'N' number, 'S' whitespace, 'O' anything else."""
    cat = unicodedata.category(ch)
    if cat[0] == "L":
        return "L"
    if cat in ("Nd", "Nl", "No"):
        return "N"
    if ch.isspace() and ch not in _NOT_REGEX_SPACE:
        return "S"
    return "O"


def gpt2_pretokenize(text: str) -> List[str]:
    """The GPT-2 pattern's `findall`, alternative by alternative: a
    contraction; else an optional single space and a run of one kind
    (letters, numbers or other); else whitespace, of which a run followed
    by a non-space gives up its last character to prefix the next token."""
    kinds = [_kind(c) for c in text]
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        c = next((c for c in _CONTRACTIONS if text.startswith(c, i)), None)
        if c is not None:
            out.append(c)
            i += len(c)
            continue
        j = i + 1 if (text[i] == " " and i + 1 < n
                      and kinds[i + 1] != "S") else i
        kind = kinds[j]
        end = j + 1
        while end < n and kinds[end] == kind:
            end += 1
        if kind == "S" and end < n and end - i > 1:
            end -= 1                          # \s+(?!\S)
        out.append(text[i:end])
        i = end
    return out


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte→unicode map."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


@CODECS.register("bpe")
class BpeCodec:
    """Byte-level BPE (the GPT-2 algorithm)."""

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]],
                 batch_max_length: int = 25, sos_id: int = 1,
                 eos_id: int = 2, pad_id: int = 0):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in vocab.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.max_tokens = batch_max_length + 2
        self.sos_id, self.eos_id, self.pad_id = sos_id, eos_id, pad_id
        self._cache: Dict[str, str] = {}

    @classmethod
    def default(cls, **kw) -> "BpeCodec":
        """The standard GPT-2 vocabulary from the port's `assets/`
        (`gpt2_vocab.json`, `gpt2_merges.txt`); raises FileNotFoundError
        when they are missing."""
        vocab = os.path.join(ASSETS, "gpt2_vocab.json")
        merges = os.path.join(ASSETS, "gpt2_merges.txt")
        if not (os.path.exists(vocab) and os.path.exists(merges)):
            raise FileNotFoundError(
                f"GPT-2 vocab assets missing: place gpt2_vocab.json and "
                f"gpt2_merges.txt in {ASSETS} (scripts/fetch_vocabs.py "
                f"fetches them where there is network)")
        return cls.from_files(vocab, merges, **kw)

    @classmethod
    def from_files(cls, vocab_json: str, merges_txt: str, **kw) -> "BpeCodec":
        with open(vocab_json, encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(merges_txt, encoding="utf-8") as f:
            for line in f.read().split("\n"):
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split()
                merges.append((a, b))
        return cls(vocab, merges, **kw)

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word: Tuple[str, ...] = tuple(token)
        pairs = _get_pairs(word)
        if not pairs:
            return token
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode_text(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in gpt2_pretokenize(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
        return ids

    def decode_ids(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        data = bytearray(self.byte_decoder[c] for c in text
                         if c in self.byte_decoder)
        return data.decode("utf-8", errors="replace")

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        """→ [B, max_tokens] int32: [sos] + ids + [eos], pad-id padded."""
        out = np.full((len(texts), self.max_tokens), self.pad_id,
                      dtype=np.int32)
        for i, t in enumerate(texts):
            seq = [self.sos_id] + self.encode_text(t) + [self.eos_id]
            seq = seq[: self.max_tokens]
            out[i, : len(seq)] = seq
        return out

    def decode(self, ids: np.ndarray) -> List[str]:
        """The reference's BPE eval decode: raw decode, pruned at '#'."""
        texts = []
        for row in np.asarray(ids):
            s = self.decode_ids(row)
            cut = s.find("#")
            texts.append(s[:cut] if cut >= 0 else s)
        return texts


def _wordpiece_tokenize(word: str, vocab: Dict[str, int], unk: str = "[UNK]",
                        max_chars: int = 100) -> List[str]:
    """Greedy longest-match-first split of one word."""
    if len(word) > max_chars:
        return [unk]
    tokens: List[str] = []
    start = 0
    while start < len(word):
        end = len(word)
        cur = None
        while start < end:
            sub = word[start:end]
            if start > 0:
                sub = "##" + sub
            if sub in vocab:
                cur = sub
                break
            end -= 1
        if cur is None:
            return [unk]
        tokens.append(cur)
        start = end
    return tokens


@CODECS.register("wordpiece")
class WordpieceCodec:
    """BERT-uncased WordPiece: basic tokenization (lowercase, punctuation
    split), greedy longest-match subwords, [CLS]/[SEP] around, padded to
    max_tokens (utils.py:77)."""

    def __init__(self, vocab: Dict[str, int], batch_max_length: int = 25,
                 lowercase: bool = True):
        self.vocab = dict(vocab)
        self.inv = {v: k for k, v in vocab.items()}
        self.max_tokens = batch_max_length + 2
        self.lowercase = lowercase
        self.cls_id = vocab.get("[CLS]", 101)
        self.sep_id = vocab.get("[SEP]", 102)
        self.pad_id = vocab.get("[PAD]", 0)
        self.unk = "[UNK]"

    @classmethod
    def default(cls, **kw) -> "WordpieceCodec":
        """BERT-base-uncased vocab from the port's `assets/`
        (`bert_base_uncased_vocab.txt`); raises FileNotFoundError when it
        is missing."""
        vocab = os.path.join(ASSETS, "bert_base_uncased_vocab.txt")
        if not os.path.exists(vocab):
            raise FileNotFoundError(
                f"BERT vocab asset missing: place bert_base_uncased_vocab.txt "
                f"in {ASSETS} (scripts/fetch_vocabs.py fetches it where there "
                f"is network)")
        return cls.from_file(vocab, **kw)

    @classmethod
    def from_file(cls, vocab_txt: str, **kw) -> "WordpieceCodec":
        vocab: Dict[str, int] = {}
        with open(vocab_txt, encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = i
        return cls(vocab, **kw)

    def _basic_tokenize(self, text: str) -> List[str]:
        if self.lowercase:
            text = text.lower()
        out: List[str] = []
        buf: List[str] = []
        for ch in text:
            if ch.isspace():
                if buf:
                    out.append("".join(buf))
                    buf = []
            elif not (ch.isalnum() or ch == "'"):
                # BERT makes every punctuation mark a token of its own
                if buf:
                    out.append("".join(buf))
                    buf = []
                out.append(ch)
            else:
                buf.append(ch)
        if buf:
            out.append("".join(buf))
        return out

    def encode_text(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in self._basic_tokenize(text):
            for sub in _wordpiece_tokenize(word, self.vocab, self.unk):
                ids.append(self.vocab.get(sub, self.vocab.get(self.unk, 100)))
        return ids

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        out = np.full((len(texts), self.max_tokens), self.pad_id,
                      dtype=np.int32)
        for i, t in enumerate(texts):
            seq = [self.cls_id] + self.encode_text(t) + [self.sep_id]
            seq = seq[: self.max_tokens]
            if len(seq) == self.max_tokens:
                seq[-1] = self.sep_id   # truncation keeps [SEP] (as HF)
            out[i, : len(seq)] = seq
        return out

    def decode(self, ids: np.ndarray) -> List[str]:
        """The reference's wp eval decode (utils.py:81-88): detokenize, then
        join the whitespace-separated pieces with ''. '[SEP]', '[CLS]' and
        '[PAD]' render as literal tokens, so that the caller can prune at
        '[SEP]'."""
        texts = []
        for row in np.asarray(ids):
            pieces: List[str] = []
            for i in row:
                tok = self.inv.get(int(i), "")
                if tok.startswith("##"):
                    if pieces:
                        pieces[-1] += tok[2:]
                    else:
                        pieces.append(tok[2:])
                else:
                    pieces.append(tok)
            texts.append("".join("".join(pieces).split()))
        return texts
