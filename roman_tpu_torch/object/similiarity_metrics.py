"""Alias for reference roman/object/similiarity_metrics.py (reference
filename typo preserved). The reference exposes Wasserstein /
ChamferDistance callables; here the batched functional forms."""
from roman_tpu_torch.ops.metrics import (chamfer_distance,  # noqa: F401
                                   cosine_similarity,
                                   norm_chamfer_similarity,
                                   wasserstein_metric)

Wasserstein = wasserstein_metric
ChamferDistance = chamfer_distance
