"""The 3-robot demo pinned against roman_tpu on the CPU: ``python -m
roman_tpu_torch.demo --cpu`` and ``demo/demo.py --cpu``, both in-process
with --skip-self-lc, on one small three-robot sim world.

The world is tests/test_e2e_demo3.py's (seed 11, three robots, dt 0.25,
32-d descriptors, the same submap_align.yaml and mapper.yaml) cut to fit
the test budget: 25 objects where it has 400, 12 m trajectories where it
has 70, and so a 25 m square where it has 70 m, so that the three robots
still see each other's objects and every robot pair has a loop closure.

- the three map pickles are equal byte for byte;
- the three cross-robot align.g2o files have the same EDGE lines: vertex
  ids equal, numbers within 1e-4, and the same ``# LC:`` counts;
- RPGO reports the same counts of vertices, edges, loop closures and PCM
  and GNC rejections;
- the ATE agrees within 1e-3 m.
"""

import contextlib
import io
import os
import re
import runpy
import sys

import numpy as np
import pytest
import torch
import yaml

from roman_tpu_torch import demo

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = ["robot0", "robot1", "robot2"]
PAIRS = ["robot0_robot1", "robot0_robot2", "robot1_robot2"]


def _rpgo_line(stdout: str) -> str:
    lines = [ln for ln in stdout.splitlines() if ln.startswith("rpgo: ")]
    assert len(lines) == 1, stdout[-2000:]
    return lines[0]


@pytest.fixture(scope="module")
def demo3(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_demo3")
    params = tmp / "params"
    params.mkdir()
    with open(params / "data.yaml", "w") as f:
        yaml.dump({"runs": RUNS, "dt": 0.25, "img_data_params": {
            "type": "sim", "seed": 11, "n_robots": 3, "n_objects": 25,
            "area": [25.0, 25.0, 4.0], "traj_len": 12.0, "desc_dim": 32}}, f)
    with open(params / "submap_align.yaml", "w") as f:
        yaml.dump({"method": "roman", "semantics_dim": 32, "submap_max_size": 25,
                   "cosine_min": 0.5, "cosine_max": 0.9}, f)
    with open(params / "mapper.yaml", "w") as f:
        yaml.dump({"min_2d_iou": None, "min_sightings": 2, "max_t_no_sightings": 0.6,
                   "geometric_score_range": [0.15, 1.0], "min_max_extent": 0.05}, f)
    flags = ["-p", str(params), "--cpu", "--skip-self-lc"]

    port_out = io.StringIO()
    with contextlib.redirect_stdout(port_out):
        demo.main(flags + ["-o", str(tmp / "port")])

    # demo/demo.py as `python demo/demo.py ...` runs it: its directory on
    # sys.path for its `import mapping`, that module dropped afterwards
    jax_out = io.StringIO()
    saved = sys.modules.pop("mapping", None)
    try:
        with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(jax_out):
            mp.setattr(sys, "argv", ["demo.py"] + flags + ["-o", str(tmp / "jax")])
            mp.syspath_prepend(os.path.join(ROOT, "demo"))
            try:
                runpy.run_path(os.path.join(ROOT, "demo", "demo.py"), run_name="__main__")
            except SystemExit as e:
                assert not e.code
    finally:
        sys.modules.pop("mapping", None)
        if saved is not None:
            sys.modules["mapping"] = saved
        import matplotlib.pyplot as plt

        plt.close("all")
    return tmp / "port", tmp / "jax", port_out.getvalue(), jax_out.getvalue()


def test_map_pickles_are_equal_byte_for_byte(demo3):
    port, jax_dir, _, _ = demo3
    for run in RUNS:
        got = (port / "map" / f"{run}.pkl").read_bytes()
        assert got == (jax_dir / "map" / f"{run}.pkl").read_bytes(), run
        assert len(got) > 1000


def _align(path):
    """(EDGE rows: (kind, id1, id2) and their numbers, # LC: comments)."""
    heads, numbers, lc = [], [], []
    for ln in path.read_text().splitlines():
        if ln.startswith("EDGE"):
            tok = ln.split()
            heads.append(tuple(tok[:3]))
            numbers.append([float(x) for x in tok[3:]])
        elif ln.startswith("# LC:"):
            lc.append(ln)
    return heads, np.array(numbers), lc


def test_align_g2o_edges_match(demo3):
    port, jax_dir, _, _ = demo3
    assert sorted(p.name for p in (port / "align").iterdir()) == PAIRS
    for pair in PAIRS:
        got, want = (_align(d / "align" / pair / "align.g2o") for d in (port, jax_dir))
        assert got[0] == want[0], pair
        assert got[2] == want[2], pair
        assert len(want[0]) >= 1, f"{pair}: no loop closure in this world"
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-4, err_msg=pair)


def test_rpgo_counts_match(demo3):
    _, _, port_out, jax_out = demo3
    got, want = _rpgo_line(port_out), _rpgo_line(jax_out)
    assert got == want
    n = {k: int(v) for k, v in re.findall(r"'(n_lc\w*)': (\d+)", want)}
    assert n["n_lc"] >= 4 and n["n_lc"] > n["n_lc_pcm_rejected"], want


def test_ate_matches(demo3):
    port, jax_dir, _, _ = demo3
    got, want = (float((d / "offline_rpgo" / "ate_rmse.txt").read_text())
                 for d in (port, jax_dir))
    assert np.isfinite(got) and abs(got - want) <= 1e-3, (got, want)
