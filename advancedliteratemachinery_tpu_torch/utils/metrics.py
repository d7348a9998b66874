"""Training metrics logging (the port's own copy of
`advancedliteratemachinery_tpu/utils/metrics.py`: `SmoothedValue`,
`MetricLogger` and `nan_guard`, as `engine/fit.py` uses them).

A host-side window over the scalars each logged train step returns, in
place of the reference's DETR-style logger and its all-reduce.
"""

from __future__ import annotations

import math
from collections import defaultdict, deque
from typing import Dict


class SmoothedValue:
    def __init__(self, window_size: int = 20,
                 fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1) -> None:
        self.deque.append(float(value))
        self.count += n
        self.total += float(value) * n

    @property
    def median(self) -> float:
        s = sorted(self.deque)
        return s[len(s) // 2] if s else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, value=self.value)


class MetricLogger:
    def __init__(self, delimiter: str = "  ", print_fn=print):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.print_fn = print_fn

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __str__(self) -> str:
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())


def nan_guard(loss: float, step: int) -> None:
    """Abort on a non-finite loss (reference: OmniParser engine/train.py:46-49
    exits the job on inf/nan)."""
    if not math.isfinite(loss):
        raise FloatingPointError(
            f"Loss is {loss} at step {step}; stopping training "
            "(non-finite loss guard)")
