"""The port's plain ROMAN affinity against roman_tpu.align.invariants.

The same pair problems, made from a numpy seed, go through both packages;
the f32 affinities must agree within 1e-6 (a few f32 ulps at 1.0: the two
frameworks sum norms and dot products in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roman_tpu.align import invariants as jinv
from roman_tpu.align import registration as jreg
from roman_tpu.sim import world

from roman_tpu_torch import convert
from roman_tpu_torch.align import invariants as tinv
from roman_tpu_torch.align import registration as treg

torch.set_num_threads(1)


def _features(seed, P=3, cap=12, desc_dim=16):
    """Both packages' features of the same padded sim pair problems."""
    rng = np.random.default_rng(seed)
    pads = [world.pad_problem(world.make_pair_problem(
        rng, n_common=6, n_only1=3, n_only2=3, desc_dim=desc_dim), cap)
        for _ in range(P)]
    cfg = jreg.RegistrationConfig(method="roman")

    def st(key):
        return jnp.asarray(np.stack([p[key] for p in pads]))

    jf = [jreg.build_features(
        st(f"centers{k}"), st(f"valid{k}"), cfg, pca_attrs=st(f"pca{k}"),
        volume=st(f"volume{k}"), extent=st(f"extent{k}"),
        descriptors=st(f"desc{k}")) for k in (1, 2)]
    tf = [convert.features_from_numpy(
        *jax.tree.map(np.asarray, (f.centers, f.ratio_feats, f.descriptors,
                                   f.valid)), device="cpu") for f in jf]
    return jf, tf


@pytest.mark.parametrize("gravity", [True, False])
@pytest.mark.parametrize("fusion", ["geometric_mean", "arithmetic_mean",
                                    "product"])
def test_affinity_matches_jax(fusion, gravity):
    (j1, j2), (t1, t2) = _features(0)
    kw = dict(cos_min=0.5, cos_max=0.9, gravity=gravity, fusion=fusion)
    M_j, single_j = jinv.affinity(
        j1, j2, jinv.ROMANInvariantParams(ratio_epsilon=jnp.zeros(4), **kw))
    M_t, single_t = tinv.affinity(
        t1, t2, tinv.ROMANInvariantParams(ratio_epsilon=torch.zeros(4), **kw))
    assert M_t.shape == M_j.shape and M_t.dtype == torch.float32
    np.testing.assert_allclose(M_t.numpy(), np.asarray(M_j), atol=1e-6)
    np.testing.assert_allclose(single_t.numpy(), np.asarray(single_j), atol=1e-6)


def test_build_features_matches_jax():
    rng = np.random.default_rng(1)
    c = rng.normal(size=(2, 5, 3)).astype(np.float32)
    pca = rng.uniform(size=(2, 5, 3)).astype(np.float32)
    vol = rng.uniform(size=(2, 5)).astype(np.float32)
    ext = rng.uniform(size=(2, 5, 3)).astype(np.float32)
    desc = rng.normal(size=(2, 5, 8)).astype(np.float32)
    valid = rng.uniform(size=(2, 5)) > 0.3
    for method in ("roman", "sevg", "clipper"):
        jf = jreg.build_features(
            jnp.asarray(c), jnp.asarray(valid), jreg.RegistrationConfig(method=method),
            pca_attrs=jnp.asarray(pca), volume=jnp.asarray(vol),
            extent=jnp.asarray(ext), descriptors=jnp.asarray(desc))
        tf = treg.build_features(
            torch.tensor(c), torch.tensor(valid), treg.RegistrationConfig(method=method),
            pca_attrs=torch.tensor(pca), volume=torch.tensor(vol),
            extent=torch.tensor(ext), descriptors=torch.tensor(desc))
        for name in ("centers", "ratio_feats", "descriptors", "valid"):
            np.testing.assert_array_equal(getattr(tf, name).numpy(),
                                          np.asarray(getattr(jf, name)))
