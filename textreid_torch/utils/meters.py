"""Windowed training meters (counterpart of ``textreid_tpu/utils/meters.py``:
window-20 median and global average per metric)."""

from __future__ import annotations

from collections import defaultdict, deque


class SmoothedValue:
    def __init__(self, window_size: int = 20):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value: float) -> None:
        self.deque.append(float(value))
        self.count += 1
        self.total += float(value)

    @property
    def median(self) -> float:
        vals = sorted(self.deque)
        n = len(vals)
        if n == 0:
            return 0.0
        mid = n // 2
        return vals[mid] if n % 2 else 0.5 * (vals[mid - 1] + vals[mid])

    @property
    def global_avg(self) -> float:
        return self.total / self.count if self.count else 0.0


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(v)

    def __getattr__(self, attr: str):
        meters = self.__dict__.get("meters")
        if meters is not None and attr in meters:
            return meters[attr]
        raise AttributeError(attr)

    def __str__(self) -> str:
        return self.delimiter.join(
            f"{name}: {m.median:.4f} ({m.global_avg:.4f})"
            for name, m in self.meters.items())
