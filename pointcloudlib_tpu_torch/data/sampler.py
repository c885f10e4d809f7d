"""KPConv's epoch sampling and augmentation (counterpart of
``pointcloudlib_tpu/data/sampler.py``; numpy, the same code, so the
draws are bit-identical).

``PotentialSampler``: each item carries a potential; an epoch takes the
lowest-potential items and raises theirs by ``1/(1 + noise)``, so that
epochs of a subset still cover the set evenly. ``kpconv_augment``: an
optional rotation, an anisotropic scale in [0.8, 1.2] with random axis
flips, and Gaussian noise of 0.001.
"""

from __future__ import annotations

import numpy as np


class PotentialSampler:
    def __init__(self, n_items: int, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        # tiny init noise: random first-epoch order (kpconv_loader.py:713)
        self.potentials = self._rng.random(n_items) * 0.1 + 0.1

    def sample(self, n: int) -> np.ndarray:
        """Pick the n lowest-potential items, bump their potentials."""
        n = min(n, len(self.potentials))
        picked = np.argpartition(self.potentials, n - 1)[:n]
        # shuffle within the epoch (argpartition order is arbitrary but
        # deterministic; training wants a random visit order)
        self._rng.shuffle(picked)
        bump = 1.0 / (1.0 + 0.1 * self._rng.random(n))
        self.potentials[picked] += bump
        # remember each item's bump so refund() can undo it exactly
        self._last_bump = dict(zip(picked.tolist(), bump.tolist()))
        return picked

    def refund(self, indices) -> None:
        """Undo the last ``sample()`` bump for items that were sampled
        but never trained on (e.g. bucketed batching dropped a partial
        tail batch) so they stay lowest-potential for the next epoch."""
        last = getattr(self, "_last_bump", {})
        for i in np.asarray(indices, np.int64).ravel():
            b = last.pop(int(i), None)
            if b is not None:
                self.potentials[int(i)] -= b


def kpconv_augment(
    pts: np.ndarray,
    rng: np.random.Generator,
    rotation: str = "none",
    scale_min: float = 0.8,
    scale_max: float = 1.2,
    symmetries=(True, True, True),
    noise: float = 0.001,
) -> np.ndarray:
    """KPConv per-cloud augmentation (augmentation_transform,
    data_utils/kpconv_loader.py:415-491): optional rotation, anisotropic
    scale with random axis symmetries, gaussian noise."""
    if rotation == "vertical":
        theta = rng.uniform(0, 2 * np.pi)
        c, s = np.cos(theta), np.sin(theta)
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], pts.dtype)
        pts = pts @ rot.T
    elif rotation == "all":
        q, r = np.linalg.qr(rng.standard_normal((3, 3)))
        q *= np.sign(np.diag(r))
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        pts = pts @ q.T.astype(pts.dtype)
    scale = rng.uniform(scale_min, scale_max, 3)
    flips = np.where(
        np.array(symmetries) & (rng.random(3) > 0.5), -1.0, 1.0
    )
    pts = pts * (scale * flips).astype(pts.dtype)
    return pts + rng.normal(0, noise, pts.shape).astype(pts.dtype)
