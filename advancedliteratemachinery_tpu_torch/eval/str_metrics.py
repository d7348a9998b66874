"""Scene-text recognition accuracy harness (port of
`advancedliteratemachinery_tpu/eval/str_metrics.py`).

Parity targets:
- MGP-STR benchmark_all_eval (test_final.py:29): per-set word accuracy over
  the 6-11 standard LMDB eval sets + sample-weighted total, per-head
  accuracies and confidence-fused accuracy (:176-200).
- LISTER AR_counter (utils.py:302) incl. case-insensitive comparison and
  length-bucket accuracy (eval_len_bias.py).

The JAX counter fills `norm_ed` only where the `Levenshtein` package
imports; the card's machine has none, so the port computes the edit
distance itself (`edit_distance`, equal to `Levenshtein.distance`) and
`norm_ed` is the same on every machine.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence


def edit_distance(a: str, b: str) -> int:
    """Levenshtein distance (unit insert, delete and substitute) between two
    strings, by code point, as `Levenshtein.distance`."""
    if a == b:
        return 0
    # a common prefix and suffix change nothing
    lo = 0
    while lo < min(len(a), len(b)) and a[lo] == b[lo]:
        lo += 1
    a, b = a[lo:], b[lo:]
    hi = 0
    while hi < min(len(a), len(b)) and a[-1 - hi] == b[-1 - hi]:
        hi += 1
    a, b = a[:len(a) - hi], b[:len(b) - hi]
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


@dataclasses.dataclass
class STRAccuracyCounter:
    case_sensitive: bool = False
    total: int = 0
    correct: int = 0
    norm_ed_sum: float = 0.0
    by_length: Dict[int, List[int]] = dataclasses.field(default_factory=dict)

    def _norm(self, s: str) -> str:
        return s if self.case_sensitive else s.lower()

    def add(self, pred: str, gt: str) -> bool:
        ok = self._norm(pred) == self._norm(gt)
        self.total += 1
        self.correct += int(ok)
        n = self.by_length.setdefault(len(gt), [0, 0])
        n[0] += 1
        n[1] += int(ok)
        d = edit_distance(self._norm(pred), self._norm(gt))
        self.norm_ed_sum += 1 - d / max(len(gt), len(pred), 1)
        return ok

    @property
    def accuracy(self) -> float:
        return self.correct / max(self.total, 1)

    @property
    def norm_ed(self) -> float:
        return self.norm_ed_sum / max(self.total, 1)

    def length_bias(self) -> Dict[int, float]:
        """Per-length accuracy (LISTER eval_len_bias.py)."""
        return {l: c / max(n, 1) for l, (n, c) in sorted(self.by_length.items())}

    def length_uniform_accuracy(self) -> float:
        """TUL-style: mean of per-length accuracies (LISTER README TUL)."""
        accs = self.length_bias()
        return sum(accs.values()) / max(len(accs), 1)


def benchmark_summary(per_set: Dict[str, STRAccuracyCounter]) -> Dict[str, float]:
    """Weighted total over eval sets (test_final.py:29 benchmark_all_eval)."""
    out = {name: c.accuracy for name, c in per_set.items()}
    total = sum(c.total for c in per_set.values())
    correct = sum(c.correct for c in per_set.values())
    out["total_accuracy"] = correct / max(total, 1)
    out["total_samples"] = total
    return out


def fuse_predictions(candidates: Sequence[Sequence], gts: Sequence[str],
                     case_sensitive: bool = False) -> Dict[str, float]:
    """Multi-head confidence fusion accuracy (test_final.py:176-200).

    candidates: per-sample list of (text, confidence, head_name). Returns
    accuracy per head + fused."""
    counters: Dict[str, STRAccuracyCounter] = {}
    fused = STRAccuracyCounter(case_sensitive)
    for cands, gt in zip(candidates, gts):
        best_text, best_conf = None, 0.0
        for text, conf, head in cands:
            counters.setdefault(head, STRAccuracyCounter(case_sensitive)).add(text, gt)
            if conf > best_conf:
                best_conf, best_text = conf, text
        fused.add(best_text if best_text is not None else "", gt)
    out = {h: c.accuracy for h, c in counters.items()}
    out["fused"] = fused.accuracy
    return out
