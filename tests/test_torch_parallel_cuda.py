"""The pair grid split over a mesh, on the card.

Needs a CUDA card and nvcc; without a card every test skips. These tests
import nothing of JAX, so they run on a machine that has only PyTorch:

    python -m pytest --noconftest -o "markers=cuda: needs a CUDA card" \
        -m cuda tests/test_torch_parallel_cuda.py

Four virtual shards on cuda:0 (get_mesh(4, device="cuda:0")) stand in for
four cards. The card's result for a pair depends on its launch's pair
count (the kernels' cluster size, and the batched products and SVD of
the torch code around them), so the byte-for-byte test gives every
launch of both runs the same pair count; other layouts are held to equal
selections and T_align within 1e-4.
"""

import numpy as np
import pytest
import torch

from roman_tpu_torch.align.submap_align import PairGridRegistrar
from roman_tpu_torch.parallel import multichip
from roman_tpu_torch.parallel.mesh import get_mesh

pytestmark = pytest.mark.cuda

FIELDS = ("sel", "count", "T_align", "ok", "score", "converged")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def test_four_virtual_shards_equal_the_unsharded_grid(dev):
    """32 pairs of related views: four unsharded launches of 8 against
    one chunk of four shards of 8. The rescue launches its pairs at once
    in both runs while there are at most 8 of them."""
    stack = multichip.make_pair_batch(P=32, cap=40, desc_dim=768, seed=3)
    f1, f2 = (multichip.batch_features(stack, s, dev) for s in (1, 2))
    ids = np.arange(32 * 40).reshape(32, 40)
    idx = np.arange(32)
    plain = PairGridRegistrar(multichip.GRID_CFG, chunk_size=8, device=dev)
    ref = plain(f1, f2, ids, ids + 10**6, idx, idx)
    assert plain.rescued <= 8
    res = PairGridRegistrar(multichip.GRID_CFG, chunk_size=32,
                            mesh=get_mesh(4, device="cuda:0"))(f1, f2, ids, ids + 10**6,
                                                               idx, idx)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(res, f), getattr(ref, f), err_msg=f)
    assert (res.count >= 3).all()


@pytest.mark.parametrize("n,device", [(1, None), (4, "cuda:0")])
def test_dryrun_multichip(dev, n, device):
    out = multichip.dryrun_multichip(n, device=device)
    # one shard is the unsharded run; four shards launch 2 and 1 pairs
    # where it launches 8 and 4
    assert out["grid"]["pairs"] == 36 and (out["grid"]["same_bytes"] or n > 1)
    assert out["grid"]["T_err"] <= 1e-4
    assert len(out["mapping"]["segments"]) == n
    assert out["pgo"]["max_abs_err"] <= 1e-5
