"""The align cells' float64 reference: a tiny case with a known answer, its
agreement with the port's plain path on the CPU, and the control (the
reference at the configuration's narrower precisions) failing the limits
at a size this sandbox holds; on a card, the control at the cells' own
size on three seeds."""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.entries import align_common as common
from benchmark.reference import clipper_f64, compare


def _yaw_T(yaw, t):
    T = np.eye(4)
    c, s = np.cos(yaw), np.sin(yaw)
    T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    T[:3, 3] = t
    return T


def test_a_shared_scene_is_registered_exactly():
    """Eight objects seen from two frames related by a yaw and a shift,
    side 2 permuted: every true association is selected and Arun's
    transform is the one that relates the frames."""
    rng = np.random.default_rng(0)
    n, D = 8, 16
    c1 = rng.uniform(0, 10, size=(n, 3))
    T = _yaw_T(0.7, [3.0, -2.0, 0.5])
    perm = rng.permutation(n)
    c2 = ((c1 - T[:3, 3]) @ T[:3, :3])[perm]       # T @ c2 = c1[perm]
    ratio = rng.uniform(0.2, 1.0, size=(n, 4))
    desc = rng.normal(size=(n, D))
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    t = lambda x: torch.as_tensor(x)[None]  # noqa: E731
    v = torch.ones((1, n), dtype=torch.bool)
    res = clipper_f64.register(t(c1), t(ratio), t(desc), v,
                               t(c2), t(ratio[perm]), t(desc[perm]), v,
                               clipper_f64.Params(), rescue=True)
    truth = np.zeros((n, n), bool)
    truth[perm, np.arange(n)] = True
    assert (res["sel"][0].numpy() == truth).all() and int(res["count"][0]) == n
    assert np.abs(res["T"][0].numpy() - T).max() < 1e-9


@pytest.mark.parametrize("name", ["align_grid", "align_register"])
def test_the_port_agrees_with_the_reference_on_the_cpu(bench, tiny_cell, name):
    """The port's plain path (bf16 M, f32) on a tiny scene selects what the
    reference selects, within the cell's limits."""
    wl, config, traffic = tiny_cell(name)
    cell = harness.entry_module(traffic).Cell(config, traffic, 7, torch.device("cpu"))
    outs = [cell.op(k)[0] for k in range(len(cell.pair_i))]
    numbers = cell.check(outs)
    limits = harness.load_json(harness.HERE, "limits", name + ".json")
    assert all(ok for *_, ok in compare.judge(numbers, limits)), numbers


def test_the_grid_control_fails_on_the_cpu(bench, tiny_cell):
    """At this size the control's selections may all agree; its Arun in
    bfloat16 does not (the register cell's control is held on the card)."""
    wl, config, traffic = tiny_cell("align_grid")
    limits = harness.load_json(harness.HERE, "limits", "align_grid.json")
    for seed in (1, 2, 3):
        cell = harness.entry_module(traffic).Cell(config, traffic, seed,
                                                  torch.device("cpu"))
        numbers = cell.control()
        assert not all(ok for *_, ok in compare.judge(numbers, limits)), (seed, numbers)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["align_grid", "align_register"])
def test_the_control_fails_at_the_cells_size(bench, card, name):
    """The control in the program's place, at the cell's own size, on three
    seeds, each also the scene's: `correct` comes out false on each."""
    wl, config, traffic = harness.find_cell(bench, name)
    limits = harness.load_json(harness.HERE, "limits", name + ".json")
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        scene = dict(config, scene=dict(config["scene"], seed=seed))
        cell = harness.entry_module(traffic).Cell(scene, traffic, seed, card)
        cell.release()
        numbers = cell.control()
        assert not all(ok for *_, ok in compare.judge(numbers, limits)), (seed, numbers)


def test_padding_does_not_change_a_pair(bench, tiny_cell):
    """A pair registered at the capacity's padding, with its rounding
    capped at its own sizes, is the pair registered unpadded."""
    wl, config, traffic = tiny_cell("align_register")
    from benchmark import world

    subs = world.make_scene(dict(config, scene=dict(config["scene"], seed=5)))
    pi, pj = world.full_grid(subs)
    padded = common.reference(config, subs, pi, pj, "cpu", rescue=False, unpadded=True)
    p = clipper_f64.Params.from_config(config)
    for q in range(0, len(pi), 7):
        a, b = pi[q], pj[q]
        n, m = int(subs[0].sizes[a]), int(subs[1].sizes[b])
        side = lambda s, k, size: [torch.as_tensor(x[k:k + 1, :size])  # noqa: E731
                                   for x in (s.centers, s.ratio, s.desc, s.valid)]
        one = clipper_f64.register(*side(subs[0], a, n), *side(subs[1], b, m), p,
                                   rescue=False)
        assert (one["sel"][0].numpy() == padded["sel"][q][:n, :m]).all()
        assert not padded["sel"][q][n:].any() and not padded["sel"][q][:, m:].any()


def test_the_scene_is_the_ports(bench, tiny_cell):
    """benchmark/world.py makes, draw for draw, the arrays that the port's
    sim world, submap cut and packing make from the same seed."""
    from benchmark import world
    from roman_tpu_torch.align.registration import RegistrationConfig
    from roman_tpu_torch.map.roman_map import (SubmapParams, submaps_from_roman_map,
                                               submaps_to_features)
    from roman_tpu_torch.sim import world as sim

    _, config, _ = tiny_cell("align_grid")
    sc, al = config["scene"], config["align"]
    subs = world.make_scene(config)
    _, runs = sim.make_multi_robot_world(
        np.random.default_rng(sc["seed"]), n_robots=sc["n_robots"],
        n_objects=sc["n_objects"], area=tuple(sc["area_m"]), traj_len=sc["traj_len_m"],
        speed=sc["speed_m_s"], dt=sc["dt_s"], view_radius=sc["view_radius_m"],
        p_detect=sc["p_detect"], center_noise=sc["center_noise_m"],
        desc_noise=sc["desc_noise"], shape_noise=sc["shape_noise"],
        odom_drift_per_m=sc["odom_drift_per_m"], desc_dim=sc["desc_dim"],
        n_classes=sc["n_classes"], instance_noise=sc["instance_noise"])
    params = SubmapParams(max_size=al["submap_max_size"], radius=al["submap_radius"],
                          distance=al["submap_center_dist"])
    cfg = RegistrationConfig(method="roman")
    for mine, run in zip(subs, runs):
        f, aux = submaps_to_features(submaps_from_roman_map(sim.roman_map_from_run(run),
                                                            params),
                                     cfg, capacity=al["submap_max_size"],
                                     desc_dim=sc["desc_dim"], device="cpu")
        assert (f.centers.numpy() == mine.centers).all()
        assert (f.ratio_feats.numpy() == mine.ratio).all()
        assert (f.descriptors.numpy() == mine.desc).all()
        assert (f.valid.numpy() == mine.valid).all() and (aux["seg_ids"] == mine.ids).all()
