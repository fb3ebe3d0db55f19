"""MatrixStats — data diagnostics (counterpart of faiss_tpu/stats.py;
reference: faiss/MatrixStats.{h,cpp}). numpy on the host, as there."""

from __future__ import annotations

import numpy as np


class MatrixStats:
    """Compute input-data health statistics (NaN/inf counts, collapsed
    dimensions, duplicate rows) and a human-readable summary."""

    def __init__(self, x: np.ndarray):
        x = np.asarray(x, np.float32)
        self.n, self.d = x.shape
        self.n_nan = int(np.isnan(x).sum())
        self.n_inf = int(np.isinf(x).sum())
        finite = np.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
        self.n0 = int((finite == 0).all(axis=0).sum())  # all-zero dims
        per_dim_std = finite.std(axis=0)
        self.n_collapsed = int((per_dim_std == 0).sum())
        norms = np.linalg.norm(finite, axis=1)
        self.min_norm = float(norms.min()) if self.n else 0.0
        self.max_norm = float(norms.max()) if self.n else 0.0
        # duplicate rows: equal bytes, each row one opaque item (faiss_tpu
        # compares them as d * 4 uint8 fields, 12x slower for the same groups)
        rows = np.ascontiguousarray(finite).view(np.dtype((np.void, 4 * self.d)))
        _, counts = np.unique(rows.ravel(), return_counts=True)
        self.n_dup = int((counts > 1).sum())
        self.comments = self._comments()

    def _comments(self) -> str:
        out = [f"analyzing {self.n} vectors of size {self.d}"]
        if self.n_nan:
            out.append(f"WARN {self.n_nan} NaN values")
        if self.n_inf:
            out.append(f"WARN {self.n_inf} inf values")
        if self.n_collapsed:
            out.append(f"WARN {self.n_collapsed} dimensions are constant")
        if self.n_dup:
            out.append(f"WARN {self.n_dup} duplicate vector groups")
        out.append(f"vector norms in [{self.min_norm:.4g}, {self.max_norm:.4g}]")
        return "\n".join(out)
