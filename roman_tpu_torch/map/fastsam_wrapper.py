"""The reference's import path for the front end
(``from roman_tpu_torch.map.fastsam_wrapper import FastSAMWrapper``): a
port of roman_tpu/map/fastsam_wrapper.py.

The front end batches frames (reference FastSAMWrapper.run is one frame at
a time, fastsam_wrapper.py:254-418); `FastSAMWrapper.from_params` builds a
PerceptionFrontend and `.run(t, pose, img, depth)` adapts the one-frame
call onto `run_batch`.
"""

from __future__ import annotations

import numpy as np

from roman_tpu_torch.perception.wrapper import PerceptionFrontend


class FastSAMWrapper(PerceptionFrontend):
    """PerceptionFrontend with the reference's one-frame surface."""

    @classmethod
    def from_params(cls, params, camera, **kw):
        """Reference factory (fastsam_wrapper.py:98-134); `device` and the
        weights pass through to PerceptionFrontend."""
        return cls(params, camera, **kw)

    def run(self, t, pose, img, depth_data=None):
        """One frame with the reference's return contract
        (fastsam_wrapper.py:254-265): (list of Observations, frame
        descriptor). For throughput use run_batch: one program a batch."""
        img = np.asarray(img)
        depth = (np.asarray(depth_data) if depth_data is not None
                 else np.zeros(img.shape[:2], np.float32))
        out = self.run_batch(img[None], depth[None])
        obs = self.observations(out, [t], [np.asarray(pose)])[0]
        return obs, np.asarray(out.frame_descriptors[0])
