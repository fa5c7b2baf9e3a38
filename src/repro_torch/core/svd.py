"""SVD dimensionality reduction (PilotANN §4.1) — numpy copy of
``repro.core.svd`` (the port imports nothing of the JAX package).

X = U Σ Vᵀ with orthogonal V: rotating by V preserves Euclidean distances
exactly, and the rotated coordinates are ordered by singular value, so the
first ``d_primary`` dims capture the most distance mass.  Every vector splits
as  x̂ = {x_primary, x_residual}  with
    ‖x − q‖² = ‖xp − qp‖² + ‖xr − qr‖²   (exact, no approximation)
which is what makes stage-② *refinement* (not re-computation) possible.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class SVDReducer:
    V: np.ndarray          # (d, d) rotation (right singular vectors)
    d_primary: int
    explained: np.ndarray  # (d,) fraction of variance per rotated dim

    @property
    def d(self) -> int:
        return self.V.shape[0]

    def rotate(self, x: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(x.astype(np.float32) @ self.V)

    def split(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(primary, residual): the rotated rows' first ``d_primary`` dims
        and the rest."""
        xr = self.rotate(x)
        return (np.ascontiguousarray(xr[..., : self.d_primary]),
                np.ascontiguousarray(xr[..., self.d_primary:]))


def svd_fit(x: np.ndarray, svd_ratio: float, *, sample: int = 131072,
            seed: int = 0) -> SVDReducer:
    """Fit the rotation on a sample; d_primary = round(svd_ratio * d)."""
    rng = np.random.default_rng(seed)
    n, d = x.shape
    xs = x[rng.choice(n, size=min(sample, n), replace=False)].astype(np.float32)
    # economy SVD of the (sample, d) matrix; V spans the row space.  With
    # fewer rows than dims the economy V is (d, rows) and would drop dims
    # (a 64-row semantic cache at d 96 rotates to 64 dims, and its inserts
    # then fail in the reference); the full SVD completes it to a (d, d)
    # rotation there, and is not taken where the economy V is already
    # square, so those rotations stay the reference's bit for bit
    _, s, vt = np.linalg.svd(xs, full_matrices=len(xs) < d)
    V = vt.T  # (d, d)
    var = np.pad(s ** 2, (0, d - len(s)))
    explained = var / var.sum()
    d_primary = int(round(svd_ratio * d))
    d_primary = max(1, min(d, d_primary))
    return SVDReducer(V=np.ascontiguousarray(V, np.float32),
                      d_primary=d_primary, explained=explained)
