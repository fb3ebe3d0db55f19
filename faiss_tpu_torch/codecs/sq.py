"""ScalarQuantizer, the QT_8bit codec with RS_minmax ranges (counterpart of
the parts of faiss_tpu/codecs/sq.py:161-340 that QT_8bit takes).

Per-dimension linear 8-bit codes (ScalarQuantizer.h:27): training keeps each
dimension's minimum and range, ``trained = [vmin, vdiff]`` float32 [2, d] as
faiss_tpu keeps them; a value encodes to floor((x - vmin) / vdiff * 256),
clipped to [0, 255], and decodes to the centre of its bin. Host numpy, as in
faiss_tpu: IndexFlatSQ8 moves the codes to its device and dequantizes there.
Every other quantizer type and range statistic raises, naming ROADMAP queue
1 item 10."""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np


class QuantizerType(enum.IntEnum):
    """reference: ScalarQuantizer.h:27 (the values of faiss_tpu's enum)."""

    QT_8bit = 0
    QT_4bit = 1
    QT_8bit_uniform = 2
    QT_4bit_uniform = 3
    QT_fp16 = 4
    QT_8bit_direct = 5
    QT_6bit = 6
    QT_bf16 = 7
    QT_8bit_direct_signed = 8


class RangeStat(enum.IntEnum):
    """reference: ScalarQuantizer.h:54."""

    RS_minmax = 0
    RS_meanstd = 1
    RS_quantiles = 2
    RS_optim = 3


def _unported(what: str):
    raise NotImplementedError(
        f"ScalarQuantizer: {what} is ROADMAP queue 1 item 10 (only QT_8bit "
        "with RS_minmax is ported)"
    )


class ScalarQuantizer:
    """reference: impl/ScalarQuantizer.h:20; QT_8bit and RS_minmax only."""

    QT_8bit = QuantizerType.QT_8bit
    RS_minmax = RangeStat.RS_minmax

    def __init__(self, d: int, qtype: QuantizerType = QuantizerType.QT_8bit):
        self.qtype = QuantizerType(qtype)
        if self.qtype != QuantizerType.QT_8bit:
            _unported(f"quantizer type {self.qtype.name}")
        self.d = int(d)
        self.rangestat = RangeStat.RS_minmax
        self.rangestat_arg = 0.0
        self.bits = 8
        self.code_size = self.d
        self.trained: Optional[np.ndarray] = None  # [2, d]: vmin, vdiff

    @property
    def is_trained(self) -> bool:
        return self.trained is not None

    def train(self, x) -> None:
        """Per-dimension minimum and range of ``x`` (RS_minmax; the range is
        at least 1e-20)."""
        if self.rangestat != RangeStat.RS_minmax:
            _unported(f"range statistic {RangeStat(self.rangestat).name}")
        x = np.ascontiguousarray(x, np.float32)
        vmin, vmax = x.min(axis=0), x.max(axis=0)
        vdiff = np.maximum(vmax - vmin, 1e-20)
        self.trained = np.stack(
            [vmin.astype(np.float32), vdiff.astype(np.float32)]
        ).astype(np.float32)

    def compute_codes(self, x) -> np.ndarray:
        """uint8 codes [n, d]."""
        x = np.ascontiguousarray(x, np.float32)
        vmin, vdiff = self.trained[0], self.trained[1]
        q = np.floor((x - vmin) / vdiff * 256)
        return np.clip(q, 0, 255).astype(np.uint8)

    def decode(self, codes) -> np.ndarray:
        """float32 [n, d]: the centre of each code's bin."""
        q = np.ascontiguousarray(codes, np.uint8).reshape(-1, self.d)
        vmin, vdiff = self.trained[0], self.trained[1]
        return ((q.astype(np.float32) + 0.5) / 256 * vdiff + vmin).astype(
            np.float32
        )
