"""roman_tpu_torch: the PyTorch/CUDA port of roman_tpu, for NVIDIA Hopper.

The JAX package ``roman_tpu`` stays the reference; this package is held
against it module by module and imports nothing from it (nor ``jax``).
Layout and names follow ``roman_tpu`` so each module's counterpart is easy
to find:

- ``roman_tpu_torch.align``   — ROMAN invariant, CLIPPER solve, the fused
                                registration path and the all-pairs
                                ``submap_align`` entry point.
- ``roman_tpu_torch.csrc``    — hand-written CUDA C++ kernels (sm_90a),
                                built on first use by ``kernels.build``.
- ``roman_tpu_torch.ops``     — SE(3) helpers and batched Arun.
- ``roman_tpu_torch.map``       — the host and device mappers and the
                                mapping runner.
- ``roman_tpu_torch.perception`` — FastSAM-x, DINOv2/CLIP and the batched
                                front end.
- ``roman_tpu_torch.rpgo``      — the robust pose-graph back half.
- ``roman_tpu_torch.data``, ``params``, ``sim`` — host copies: ROS1/ROS2
                                bags, image archives, poses, cameras, the
                                params schema, synthetic worlds.
- ``roman_tpu_torch.demo``      — ``python -m roman_tpu_torch.demo``, the
                                whole chain from a params directory.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``roman_tpu_torch.device.resolve_device``). Each kernel wrapper launches
its kernel for CUDA tensors and runs its plain PyTorch twin only for CPU
tensors.
"""

from roman_tpu_torch import device  # noqa: F401  (turns TF32 off)

__version__ = "0.1.0"
