"""The port's host C++ runtime (roman_tpu_torch.native) on the CPU: the
g2o parser against the port's python parser, the assignment against
scipy, the serial CLIPPER referee against roman_tpu's on seeded sim pair
problems, and where the library is built (under build/, never in a
package, and never over roman_tpu/native/libroman_native.so)."""

from pathlib import Path

import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment

import roman_tpu.native as jax_native

from roman_tpu_torch import native
from roman_tpu_torch.align.registration import RegistrationConfig
from roman_tpu_torch.rpgo import g2o_io
from roman_tpu_torch.rpgo.g2o_io import G2OEdge, G2OGraph, symbol
from roman_tpu_torch.sim import world

ROOT = Path(__file__).resolve().parent.parent
TRACKED = ROOT / "roman_tpu" / "native" / "libroman_native.so"


def _listing():
    return {p: sorted(x.name for x in (ROOT / p).iterdir() if x.name != "__pycache__")
            for p in ("roman_tpu/native", "roman_tpu_torch/native")}


def test_library_builds_under_build_and_leaves_roman_tpu_alone(monkeypatch, tmp_path):
    before = (TRACKED.stat().st_mtime_ns, _listing())
    assert native.BUILD_DIR == ROOT / "build" / "roman_tpu_torch" / "native"
    native.get_lib()
    assert native.library_path().parent == native.BUILD_DIR
    assert native.library_path().exists()
    # a fresh build, into another build directory
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)
    native.get_lib()
    assert [p.name for p in (tmp_path / "native").iterdir()] == [native.library_path().name]
    assert (TRACKED.stat().st_mtime_ns, _listing()) == before


def test_a_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( {\n")
    monkeypatch.setattr(native, "SOURCES", (bad,))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error: expected"):
        native.get_lib()
    assert not (tmp_path / "native").exists() or not any((tmp_path / "native").glob("*.so"))


def test_parse_g2o_native_matches_the_python_parser(tmp_path):
    rng = np.random.default_rng(0)
    vertices = {symbol("a", i): rng.normal(size=7) for i in range(5)}
    vertices.update({symbol("b", i): rng.normal(size=7) for i in range(3)})
    edges = [G2OEdge(symbol("a", i), symbol("a", i + 1), rng.normal(size=7),
                     rng.normal(size=21), lc_count=(7 if i == 2 else None))
             for i in range(4)]
    edges.append(G2OEdge(symbol("a", 1), symbol("b", 2), rng.normal(size=7),
                         rng.normal(size=21), lc_count=12))
    path = str(tmp_path / "x.g2o")
    g2o_io.write_g2o(G2OGraph(vertices=vertices, edges=edges), path)

    keys, vx, v1, v2, ex, info, lc = native.parse_g2o_native(path)
    ref = g2o_io.parse_g2o(path)
    assert keys.tolist() == list(ref.vertices.keys())
    for k, key in enumerate(keys.tolist()):
        np.testing.assert_allclose(vx[k], ref.vertices[key])
    assert len(v1) == len(ref.edges)
    for i, e in enumerate(ref.edges):
        assert (v1[i], v2[i]) == (e.v1, e.v2)
        np.testing.assert_allclose(ex[i], e.xyz_quat)
        np.testing.assert_allclose(info[i], e.info_upper)
        assert lc[i] == (e.lc_count if e.lc_count is not None else -1)
    with pytest.raises(FileNotFoundError):
        native.parse_g2o_native(str(tmp_path / "missing.g2o"))


def test_hungarian_native_matches_scipy():
    rng = np.random.default_rng(1)
    for _ in range(12):
        n, m = rng.integers(1, 12, 2)
        cost = rng.uniform(size=(n, m))
        match = native.hungarian_native(cost)
        rows, cols = linear_sum_assignment(cost)
        assert (match >= 0).sum() == min(n, m)
        assert len(set(match[match >= 0].tolist())) == min(n, m)
        got = sum(cost[i, match[i]] for i in range(n) if match[i] >= 0)
        assert abs(got - cost[rows, cols].sum()) < 1e-9


def test_clipper_ref_solve_native_equals_roman_tpu(monkeypatch, tmp_path):
    # roman_tpu's library is built from its own sources into tmp_path, so
    # the tracked roman_tpu/native/libroman_native.so is neither rebuilt
    # nor raced by another test process
    monkeypatch.setattr(jax_native, "_LIB", str(tmp_path / "libroman_native.so"))
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", False)
    cfg = RegistrationConfig(method="roman", cos_min=0.5, cos_max=0.9)
    knobs = (cfg.sigma, cfg.epsilon, cfg.mindist, cfg.cos_min, cfg.cos_max)
    rng = np.random.default_rng(3)
    n_assoc = []
    for _ in range(4):
        p = world.make_pair_problem(rng, n_common=10, n_only1=4, n_only2=6,
                                    desc_dim=16)
        args = (p.centers1, np.concatenate([p.pca1, p.volume1[:, None]], 1), p.desc1,
                p.centers2, np.concatenate([p.pca2, p.volume2[:, None]], 1), p.desc2)
        got = native.clipper_ref_solve_native(*args, *knobs)
        ref = jax_native.clipper_ref_solve_native(*args, *knobs)
        assert ref is not None
        assert got == ref
        n_assoc.append(len(got))
    assert min(n_assoc) >= 3
