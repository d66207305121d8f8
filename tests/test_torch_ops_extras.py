"""Small public functions of the port against roman_tpu's, on the CPU:
the yaw helpers and rotation magnitude of ops/se3.py, umeyama_alignment
of ops/arun.py (float32, no TF32) and interop.is_reference_map."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from roman_tpu import interop as jax_interop
from roman_tpu.ops import arun as jax_arun
from roman_tpu.ops import se3 as jax_se3
from roman_tpu.sim import world as jax_world

from roman_tpu_torch import interop
from roman_tpu_torch.map.roman_map import RomanMap
from roman_tpu_torch.ops import arun, se3

torch.set_num_threads(1)


def _rotations(seed, n=64):
    """Seeded rotations (n, 3, 3) f32, with the identity, a half turn about
    z and one about x among them."""
    R = Rotation.random(n, random_state=seed).as_matrix()
    R[0] = np.eye(3)
    R[1] = Rotation.from_euler("z", np.pi).as_matrix()
    R[2] = Rotation.from_euler("x", np.pi).as_matrix()
    return R.astype(np.float32)


def _transforms(seed, n=64):
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, :3] = _rotations(seed, n)
    T[:, :3, 3] = np.random.default_rng(seed).normal(size=(n, 3)) * 5
    return T


def test_yaw_of_rot_and_rot_z_match_roman_tpu():
    R = _rotations(0)
    yaw = se3.yaw_of_rot(torch.as_tensor(R))
    np.testing.assert_allclose(yaw.numpy(), np.asarray(jax_se3.yaw_of_rot(jnp.asarray(R))),
                               atol=1e-6)
    angles = np.random.default_rng(1).uniform(-4, 4, (5, 7)).astype(np.float32)
    np.testing.assert_allclose(se3.rot_z(torch.as_tensor(angles)).numpy(),
                               np.asarray(jax_se3.rot_z(jnp.asarray(angles))), atol=1e-6)


def test_roll_pitch_removal_matches_roman_tpu():
    R, T = _rotations(2), _transforms(3)
    got = se3.rotation_rm_roll_pitch(torch.as_tensor(R)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_se3.rotation_rm_roll_pitch(jnp.asarray(R))), atol=1e-6)
    np.testing.assert_allclose(got[..., 2, :], np.tile([0, 0, 1], (len(R), 1)))
    gotT = se3.transform_rm_roll_pitch(torch.as_tensor(T)).numpy()
    np.testing.assert_allclose(
        gotT, np.asarray(jax_se3.transform_rm_roll_pitch(jnp.asarray(T))), atol=1e-6)
    np.testing.assert_array_equal(gotT[:, :3, 3], T[:, :3, 3])


def test_rotation_magnitude_matches_roman_tpu_and_scipy():
    R = _rotations(4)
    got = se3.rotation_magnitude(torch.as_tensor(R)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_se3.rotation_magnitude(jnp.asarray(R))), atol=1e-6)
    np.testing.assert_allclose(got, Rotation.from_matrix(R.astype(np.float64)).magnitude(),
                               atol=2e-3)


@pytest.mark.parametrize("with_scale", [False, True])
def test_umeyama_alignment_matches_roman_tpu_in_f32(with_scale):
    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(5)
    ref = np.cumsum(rng.normal(size=(200, 3)), axis=0).astype(np.float32)
    Rt = Rotation.random(random_state=6).as_matrix()
    est = (1.3 * ref @ Rt.T + [4.0, -2.0, 0.5]
           + rng.normal(scale=0.05, size=ref.shape)).astype(np.float32)
    R, t, s = arun.umeyama_alignment(torch.as_tensor(est), torch.as_tensor(ref),
                                     with_scale=with_scale)
    assert R.dtype == t.dtype == s.dtype == torch.float32
    Rj, tj, sj = jax_arun.umeyama_alignment(jnp.asarray(est), jnp.asarray(ref),
                                            with_scale=with_scale)
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(float(s), float(sj), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), atol=1e-5 * np.abs(tj).max())
    fit = (float(s) * est @ R.numpy().T + t.numpy())
    assert np.sqrt(np.mean(np.sum((fit - ref) ** 2, axis=1))) < (0.1 if with_scale else 20.0)


def test_is_reference_map_on_reference_objects_and_roman_maps():
    rng = np.random.default_rng(7)
    _, runs = jax_world.make_multi_robot_world(
        rng, n_robots=1, n_objects=40, area=(30.0, 30.0, 4.0), traj_len=20.0,
        desc_dim=4)
    jmap = jax_world.roman_map_from_run(runs[0])
    ref_obj = jax_interop.reference_map_object(jmap)
    port_map = RomanMap(segments=[], trajectory=np.zeros((0, 4, 4)), times=np.zeros(0))
    port_ref = interop.reference_map_object(port_map)
    for obj, expect in ((ref_obj, True), (port_ref, True), (jmap, False),
                        (port_map, False), (object(), False)):
        assert interop.is_reference_map(obj) is expect
        assert jax_interop.is_reference_map(obj) is expect
