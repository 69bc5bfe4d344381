"""Multi-item running averages (the port's copy of
``imgadapointr_tpu/utils/average_meter.py``)."""

from __future__ import annotations


class AverageMeter:
    def __init__(self, items=None):
        self.items = items
        self.n_items = 1 if items is None else len(items)
        self.reset()

    def reset(self):
        self._val = [0.0] * self.n_items
        self._sum = [0.0] * self.n_items
        self._count = [0] * self.n_items

    def update(self, values):
        if not isinstance(values, (list, tuple)):
            values = [values]
        for i, v in enumerate(values):
            self._val[i] = float(v)
            self._sum[i] += float(v)
            self._count[i] += 1

    def _pick(self, seq, idx):
        if idx is None:
            return seq[0] if self.n_items == 1 else seq
        return seq[idx]

    def count(self, idx=None):
        return self._pick(self._count, idx)

    def val(self, idx=None):
        return self._pick(self._val, idx)

    def avg(self, idx=None):
        return self._pick([s / max(c, 1) for s, c in zip(self._sum, self._count)], idx)
