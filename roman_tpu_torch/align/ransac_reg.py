"""RansacReg (port of roman_tpu/align/ransac_reg.py; reference
roman/align/ransac_reg.py).

The reference wraps open3d's correspondence RANSAC over object centers
(ransac_reg.py:9-54); here ``registration.register_ransac`` scores the
hypotheses of one pair at once. Its triplets come from ``ransac_draws``
(host draws from a torch.Generator), not from JAX's PRNG, so the two
packages agree on outcomes, not on triplets. No kernel lies on this path.
"""

from __future__ import annotations

from typing import List

import numpy as np

from roman_tpu_torch.align.object_registration import (  # noqa: F401 (roman_tpu's names)
    ObjectRegistration, _host, segments_to_features)
from roman_tpu_torch.align.registration import (RegistrationConfig,
                                                ransac_draws, register_ransac)


class RansacReg(ObjectRegistration):
    def __init__(self, max_correspondence_distance: float = 0.5,
                 num_iterations: int = 4096, dim: int = 3, device=None):
        cfg = RegistrationConfig(method="ransac", dim=dim,
                                 epsilon=max_correspondence_distance,
                                 ransac_iter=num_iterations)
        super().__init__(cfg, device=device)

    def register(self, map1: List, map2: List, seed: int = 0) -> np.ndarray:
        if self._size(map1) == 0 or self._size(map2) == 0:
            return np.array([[]])
        f1, f2 = self._features(map1, map2)
        draws = ransac_draws(seed, 1, self.cfg.ransac_iter)[0]
        res = register_ransac(f1, f2, self.cfg, draws,
                              max_corr_dist=self.cfg.epsilon)
        return np.argwhere(_host(res.sel))
