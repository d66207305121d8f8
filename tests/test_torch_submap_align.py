"""The port's alignment stage as a whole against roman_tpu's, on the CPU.

A small two-robot sim world goes through both packages' submap_align from
the same map pickles, written by roman_tpu. The loop-closure set, every
pair's association set and the loop-closure transforms must agree. Both
packages' writers, fed the same results, must write the same bytes.
"""

import dataclasses
import os
import struct
import zlib

import numpy as np
import pytest
import torch
import yaml

from roman_tpu.align import results as jax_results
from roman_tpu.align.submap_align import submap_align as jax_submap_align
from roman_tpu.params.submap_align_params import (
    SubmapAlignInputOutput as JaxIO,
    SubmapAlignParams as JaxParams,
)
from roman_tpu.sim import world

from roman_tpu_torch.align import results as port_results
from roman_tpu_torch.align.submap_align import submap_align
from roman_tpu_torch.params.submap_align_params import (
    SubmapAlignInputOutput,
    SubmapAlignParams,
)

torch.set_num_threads(1)

PARAMS = dict(method="roman", semantics_dim=32, submap_max_size=20,
              cosine_min=0.5, cosine_max=0.9)


@pytest.fixture(scope="module")
def aligned(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_align")
    rng = np.random.default_rng(7)
    _, runs = world.make_multi_robot_world(
        rng, n_robots=2, n_objects=300, area=(60.0, 60.0, 4.0),
        traj_len=100.0, desc_dim=32, odom_drift_per_m=0.005)
    inputs, gt = [], []
    for k, run in enumerate(runs):
        world.roman_map_from_run(run).save(str(tmp / f"robot{k}.pkl"))
        world.write_gt_csv(run, str(tmp / f"gt{k}.csv"))
        with open(tmp / f"gt{k}.yaml", "w") as f:
            yaml.dump({"type": "csv", "path": str(tmp / f"gt{k}.csv")}, f)
        inputs.append(str(tmp / f"robot{k}.pkl"))
        gt.append(str(tmp / f"gt{k}.yaml"))
    io = dict(inputs=inputs, run_name="align", input_gt_pose_yaml=gt,
              robot_names=["robot0", "robot1"])
    ref = jax_submap_align(JaxParams(**PARAMS),
                           JaxIO(output_dir=str(tmp / "jax"), **io),
                           chunk_size=32)
    port = submap_align(SubmapAlignParams(**PARAMS),
                        SubmapAlignInputOutput(output_dir=str(tmp / "port"), **io),
                        chunk_size=32, device="cpu")
    return tmp, ref, port


def _lc_pairs(res, thresh=4):
    acc = res.clipper_num_associations >= thresh
    finite = ~np.isnan(res.T_ij_hat_mat).any(axis=(-2, -1))
    return {(int(i), int(j)) for i, j in zip(*np.nonzero(acc & finite))}


def _edges(path):
    with open(path) as f:
        return sorted(ln.split()[1:3] for ln in f if ln.startswith("EDGE_SE3:QUAT"))


def test_same_loop_closures_associations_and_transforms(aligned):
    tmp, ref, port = aligned
    lcs = _lc_pairs(ref)
    assert len(lcs) >= 3, "the sim world must produce loop closures"
    assert _lc_pairs(port) == lcs
    assert _edges(tmp / "port" / "align.g2o") == _edges(tmp / "jax" / "align.g2o")
    n0, n1 = ref.clipper_num_associations.shape
    for i in range(n0):
        for j in range(n1):
            a = {tuple(x) for x in np.asarray(ref.associated_objs_mat[i][j])}
            b = {tuple(x) for x in np.asarray(port.associated_objs_mat[i][j])}
            assert a == b, (i, j)
    for i, j in lcs:
        np.testing.assert_allclose(port.T_ij_hat_mat[i, j],
                                   ref.T_ij_hat_mat[i, j], atol=1e-4)
    np.testing.assert_array_equal(port.clipper_num_associations,
                                  ref.clipper_num_associations)


def test_heatmap_png_is_well_formed(aligned):
    """align.png is drawn without matplotlib: a valid 8-bit RGB png whose
    pixel rows decompress to the size its header states."""
    tmp, _, port = aligned
    with open(tmp / "port" / "align.png", "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and data[12:16] == b"IHDR"
    w, h, depth, color = struct.unpack(">IIBB", data[16:26])
    assert (depth, color) == (8, 2) and w > 0 and h > 0
    start = data.index(b"IDAT")
    (n,) = struct.unpack(">I", data[start - 4:start])
    rows = zlib.decompress(data[start + 4:start + 4 + n])
    assert len(rows) == h * (1 + 3 * w)
    assert data.endswith(b"IEND\xaeB`\x82")


def test_writers_write_the_same_bytes(aligned):
    tmp, _, port = aligned
    from roman_tpu_torch.map.roman_map import (SubmapParams, load_roman_map,
                                               submaps_from_roman_map)

    maps = [load_roman_map(p) for p in port.submap_io.inputs]
    sp = SubmapParams.from_submap_align_params(port.submap_align_params)
    submaps = [submaps_from_roman_map(m, sp) for m in maps]
    files = {}
    for name, writer in (("w_jax", jax_results), ("w_port", port_results)):
        io = dataclasses.replace(port.submap_io, output_dir=str(tmp / name))
        writer.save_submap_align_results(
            dataclasses.replace(port, submap_io=io), submaps, maps)
        files[name] = io
    a, b = files["w_jax"], files["w_port"]
    paths = [(a.output_g2o, b.output_g2o), (a.output_lc_json, b.output_lc_json),
             (a.output_timing, b.output_timing), (a.output_params, b.output_params),
             (a.output_matrix, b.output_matrix),
             *zip(a.output_submaps, b.output_submaps)]
    for pa, pb in paths:
        assert os.path.exists(pa) and os.path.exists(pb)
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            assert fa.read() == fb.read(), os.path.basename(pa)
