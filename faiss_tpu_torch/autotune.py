"""Auto-tuning (counterpart of faiss_tpu/autotune.py; reference:
faiss/AutoTune.{h,cpp}).

AutoTuneCriterion (1-recall@R / rank intersection), the OperatingPoints
Pareto frontier, and ParameterSpace: string-addressable runtime parameters
applied through wrapper indexes (nprobe, efSearch, k_factor), with
``explore()`` sweeping combinations (AutoTune.h:56-219). ``explore`` times
each search by the host clock: the port's ``search`` returns host arrays,
so the time includes the device's work.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np


class AutoTuneCriterion:
    """reference: AutoTune.h:31."""

    def __init__(self, nq: int, nnn: int):
        self.nq = nq
        self.nnn = nnn
        self.gt_D: Optional[np.ndarray] = None
        self.gt_I: Optional[np.ndarray] = None

    def set_groundtruth(self, gt_D, gt_I) -> None:
        self.gt_D = gt_D
        self.gt_I = np.asarray(gt_I, np.int64)

    def evaluate(self, D, I) -> float:
        raise NotImplementedError


class OneRecallAtRCriterion(AutoTuneCriterion):
    """Fraction of queries where gt[0] is in the first R results
    (AutoTune.h:56)."""

    def __init__(self, nq: int, R: int):
        super().__init__(nq, R)
        self.R = R

    def evaluate(self, D, I) -> float:
        del D
        found = 0
        for q in range(self.nq):
            found += self.gt_I[q, 0] in I[q, : self.R]
        return found / self.nq


class IntersectionCriterion(AutoTuneCriterion):
    """Average intersection of the first R results with gt (AutoTune.h:66)."""

    def __init__(self, nq: int, R: int):
        super().__init__(nq, R)
        self.R = R

    def evaluate(self, D, I) -> float:
        del D
        ninter = 0
        for q in range(self.nq):
            ninter += len(
                np.intersect1d(self.gt_I[q, : self.R], I[q, : self.R])
            )
        return ninter / (self.nq * self.R)


class OperatingPoint:
    def __init__(self, perf: float, t: float, key: str, cno: int = -1):
        self.perf = perf
        self.t = t
        self.key = key
        self.cno = cno

    def __repr__(self):
        return f"OP(perf={self.perf:.4f}, t={self.t*1000:.3f}ms, {self.key!r})"


class OperatingPoints:
    """Pareto-optimal (perf, time) frontier (reference: AutoTune.h:92)."""

    def __init__(self):
        self.all_pts: List[OperatingPoint] = []
        self.optimal_pts: List[OperatingPoint] = []

    def add(self, perf: float, t: float, key: str, cno: int = -1) -> bool:
        op = OperatingPoint(perf, t, key, cno)
        self.all_pts.append(op)
        # optimal iff no point is both faster and at least as accurate
        for o in self.optimal_pts:
            if o.t <= op.t and o.perf >= op.perf:
                return False
        self.optimal_pts = [
            o for o in self.optimal_pts if not (op.t <= o.t and op.perf >= o.perf)
        ]
        self.optimal_pts.append(op)
        self.optimal_pts.sort(key=lambda o: o.t)
        return True

    def t_for_perf(self, perf: float) -> float:
        for o in self.optimal_pts:
            if o.perf >= perf:
                return o.t
        return float("inf")

    def display(self) -> None:
        for o in self.optimal_pts:
            print(o)


def _combinations(ranges) -> List[dict]:
    """Every {name: value} of the product of ``ranges`` ((name, values)
    pairs), the first name varying slowest."""
    combos = [{}]
    for name, values in ranges:
        combos = [dict(c, **{name: v}) for c in combos for v in values]
    return combos


class ParameterRange:
    """reference: AutoTune.h:124."""

    def __init__(self, name: str, values):
        self.name = name
        self.values = list(values)


class ParameterSpace:
    """String-addressable runtime parameters + exploration (AutoTune.h:131).

    Knows how to reach nprobe/efSearch/k_factor/max_codes/ht through
    PreTransform/IDMap/Refine wrappers, like the reference's
    set_index_parameter (AutoTune.cpp).
    """

    def __init__(self):
        self.parameter_ranges: List[ParameterRange] = []
        self.verbose = False

    # -- parameter plumbing ---------------------------------------------------
    @staticmethod
    def _unwrap(index):
        from .models.meta import IndexIDMap, IndexPreTransform

        while True:
            if isinstance(index, IndexPreTransform):
                index = index.index
            elif isinstance(index, IndexIDMap):
                index = index.index
            else:
                return index

    def set_index_parameter(self, index, name: str, value) -> None:
        """Set ``name`` where it lives: through IndexPreTransform and the id
        maps first (AutoTune.cpp recurses into them), then ``k_factor_rf``
        on a refinement and anything else on its base, ``quantizer_``
        names on an IVF's coarse quantizer. faiss_tpu looks for the
        refinement at the top only, so a wrapped one refuses every name.
        ``ht`` is the polysemous threshold of a PQ or IVF-PQ index, off at
        or above the code's bits (AutoTune.cpp); faiss_tpu ignores it."""
        from .models.hnsw import IndexHNSW
        from .models.ivf import IndexIVF
        from .models.ivf_pq import IndexIVFPQ
        from .models.meta import IndexRefine
        from .models.pq import IndexPQ

        index = self._unwrap(index)
        if name.startswith("quantizer_") and isinstance(index, IndexIVF):
            self.set_index_parameter(index.quantizer, name[len("quantizer_"):], value)
            return
        if isinstance(index, IndexRefine):
            if name == "k_factor_rf":
                index.k_factor = float(value)
            else:  # anything else to the base index
                self.set_index_parameter(index.base_index, name, value)
            return
        if name == "nprobe" and isinstance(index, IndexIVF):
            index.nprobe = int(value)
        elif name == "max_codes" and isinstance(index, IndexIVF):
            index.max_codes = int(value)
        elif name == "efSearch" and isinstance(index, IndexHNSW):
            index.hnsw.efSearch = int(value)
        elif name == "ht" and isinstance(index, IndexPQ):
            if value >= index.pq.code_size * 8:
                index.search_type = IndexPQ.ST_PQ
            else:
                index.search_type = IndexPQ.ST_polysemous
                index.polysemous_ht = int(value)
        elif name == "ht" and isinstance(index, IndexIVFPQ):
            off = value >= index.pq.code_size * 8
            index.polysemous_ht = 0 if off else int(value)
        elif name == "k_factor" and hasattr(index, "k_factor"):
            index.k_factor = float(value)
        else:
            raise ValueError(f"cannot set parameter {name!r} on {type(index)}")

    def initialize(self, index) -> None:
        """Default ranges from the index type (AutoTune.cpp initialize),
        looking through the wrappers and a refinement's base (faiss_tpu
        looks at the top and through the wrappers only: under a refinement
        it gives no ``nprobe`` range)."""
        from .models.hnsw import IndexHNSW
        from .models.ivf import IndexIVF
        from .models.meta import IndexRefine

        self.parameter_ranges = []
        inner = self._unwrap(index)
        refined = isinstance(inner, IndexRefine)
        if refined:
            inner = self._unwrap(inner.base_index)
        if isinstance(inner, IndexIVF):
            maxp = min(inner.nlist, 4096)
            vals, v = [], 1
            while v <= maxp:
                vals.append(v)
                v *= 2
            self.parameter_ranges.append(ParameterRange("nprobe", vals))
        if isinstance(inner, IndexHNSW):
            self.parameter_ranges.append(
                ParameterRange("efSearch", [4, 8, 16, 32, 64, 128, 256])
            )
        if refined:
            self.parameter_ranges.append(
                ParameterRange("k_factor_rf", [1, 2, 4, 16, 64])
            )

    def set_index_parameters(self, index, param_string: str) -> None:
        """Apply "nprobe=32,k_factor=4"-style strings (AutoTune.cpp)."""
        for tok in param_string.split(","):
            if not tok.strip():
                continue
            name, value = tok.split("=")
            self.set_index_parameter(index, name.strip(), float(value))

    # -- exploration (AutoTune.h explore) --------------------------------------
    def explore(self, index, xq, crit: AutoTuneCriterion) -> OperatingPoints:
        ops = OperatingPoints()
        combos = _combinations(
            [(pr.name, pr.values) for pr in self.parameter_ranges])
        for cno, combo in enumerate(combos):
            for name, value in combo.items():
                self.set_index_parameter(index, name, value)
            # could skip provably-suboptimal combos; evaluate all for now
            t0 = time.time()
            D, I = index.search(xq, crit.nnn)
            t = time.time() - t0
            perf = crit.evaluate(D, I)
            key = ",".join(f"{k}={v}" for k, v in combo.items())
            added = ops.add(perf, t, key, cno)
            if self.verbose:
                print(f"cno={cno} {key}: perf={perf:.4f} t={t:.3f}s "
                      f"{'*' if added else ''}")
        return ops
