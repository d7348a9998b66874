"""CC-OCR token-level OCR metrics (macro/micro P/R/F1).

Parity target: Benchmarks/CC-OCR/evaluation/evaluator/ocr_evaluator.py
(token_normalize :11, text_normalize_and_tokenize :21,
evaluate_single_sample :32 [multiset intersection],
calculate_metrics :42).

The port's copy of `advancedliteratemachinery_tpu/eval/ocr_metrics.py`.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Dict, List, Sequence


def normalize_and_tokenize(text: str, word_level: bool = True,
                           lowercase: bool = True,
                           alphanum_only: bool = False) -> List[str]:
    text = (text.replace("\t", " ").replace("\n", " ")
            .replace("###", "").replace("***", ""))
    text = re.sub(r"\s+", " ", text)
    if not word_level:
        text = text.replace(" ", "")
    tokens = text.split(" ") if word_level else list(text)
    if lowercase:
        tokens = [t.lower() for t in tokens]
    if alphanum_only:
        tokens = [re.sub("[^A-Za-z0-9]+", "", t) for t in tokens]
    return [t for t in tokens if t]


def _sample_hits(gts: Sequence[str], preds: Sequence[str]) -> int:
    gt_c = Counter(gts)
    pd_c = Counter(preds)
    return sum(min(c, pd_c.get(tok, 0)) for tok, c in gt_c.items())


def token_metrics(preds: Dict[str, str], gts: Dict[str, str],
                  word_level: bool = True, lowercase: bool = True,
                  alphanum_only: bool = False) -> Dict[str, float]:
    """→ macro/micro recall/precision/F1 over the image set."""
    macro_r, macro_p, macro_f = [], [], []
    tot_gt = tot_pd = tot_hit = 0
    for name, gt_text in gts.items():
        g = normalize_and_tokenize(str(gt_text).strip(), word_level, lowercase,
                                   alphanum_only)
        p = normalize_and_tokenize(str(preds.get(name, "")).strip(), word_level,
                                   lowercase, alphanum_only)
        hit = _sample_hits(g, p)
        tot_hit += hit
        tot_gt += len(g)
        tot_pd += len(p)
        r = hit / (len(g) + 1e-9)
        pr = hit / (len(p) + 1e-9)
        macro_r.append(r)
        macro_p.append(pr)
        macro_f.append(2 * r * pr / (r + pr + 1e-9))
    n = len(macro_r) + 1e-9
    micro_r = tot_hit / (tot_gt + 1e-9)
    micro_p = tot_hit / (tot_pd + 1e-9)
    return {
        "macro_recall": sum(macro_r) / n,
        "macro_precision": sum(macro_p) / n,
        "macro_f1_score": sum(macro_f) / n,
        "micro_recall": micro_r,
        "micro_precision": micro_p,
        "micro_f1_score": 2 * micro_r * micro_p / (micro_r + micro_p + 1e-9),
    }
