"""Package rules of the PyTorch port, on the CPU.

- roman_tpu_torch imports neither jax (nor flax) nor anything of
  roman_tpu, nor scikit-learn, OpenCV, orbax, transformers or ultralytics:
  checked by importing every module in a fresh interpreter
  where they are blocked, and by a scan of every import statement of the
  package and of chip_smoke.py;
- entry points run on cuda unless asked for the CPU, and raise on a host
  without a card;
- a kernel wrapper runs its plain twin only for CPU tensors: for any other
  device it checks its inputs and launches its kernel, and raises when the
  launch fails, without counting it.
"""

import ast
import contextlib
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from roman_tpu_torch import convert, device
from roman_tpu_torch.align import fused_register as tfr
from roman_tpu_torch.align.clipper import ClipperSolveParams
from roman_tpu_torch.align.clipper_solve import clipper_solve
from roman_tpu_torch.align.registration import RegistrationConfig
from roman_tpu_torch.align.submap_align import PairGridRegistrar, submap_align
from roman_tpu_torch.kernels import build
from roman_tpu_torch.params.submap_align_params import (SubmapAlignInputOutput,
                                                        SubmapAlignParams)
from roman_tpu_torch.rpgo import solver
from roman_tpu_torch.rpgo.g2o_io import G2OGraph

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "roman_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "roman_tpu", "sklearn", "cv2", "orbax",
           "transformers", "ultralytics")


def _blocked(module: str) -> bool:
    return module.split(".")[0] in BLOCKED


def test_every_module_imports_with_jax_and_roman_tpu_blocked():
    modules = sorted(
        "roman_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py")
    code = (
        "import sys\n"
        f"blocked = {BLOCKED!r}\n"
        "for name in list(sys.modules):\n"
        "    if name.split('.')[0] in blocked:\n"
        "        del sys.modules[name]\n"
        "for name in blocked:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        "import roman_tpu_torch\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "leaked = [m for m in sys.modules if m.split('.')[0] in blocked\n"
        "          and sys.modules[m] is not None]\n"
        "assert not leaked, leaked\n"
        "print('imported', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout


def test_no_file_imports_jax_or_roman_tpu():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert not _blocked(name), f"{path.relative_to(ROOT)} imports {name}"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_device_raise_on_a_host_without_a_card(no_card, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PairGridRegistrar(RegistrationConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.features_from_numpy(np.zeros((2, 3)), np.zeros((2, 4)),
                                    np.zeros((2, 8)), np.ones(2, bool))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PairGridRegistrar(RegistrationConfig(method="ransac"))
    io = SubmapAlignInputOutput(inputs=["a.pkl", "b.pkl"],
                                output_dir=str(tmp_path), run_name="align")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        submap_align(SubmapAlignParams(), io)
    graph = G2OGraph(vertices={0: np.array([0, 0, 0, 0, 0, 0, 1.0])}, edges=[])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solver.solve_pose_graph(graph)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solver.rpgo_solve_g2o(str(tmp_path / "in.g2o"), str(tmp_path))
    assert not any(tmp_path.iterdir())
    assert device.resolve_device("cpu") == torch.device("cpu")


def test_mapping_entry_points_without_device_raise_on_a_host_without_a_card(no_card):
    """The device mapper, the device backend of MapRunner and the range
    sensor's renderer run on cuda unless asked for the CPU; the host
    backend needs no device."""
    from roman_tpu_torch.data.camera import CameraParams
    from roman_tpu_torch.data.pose_data import PoseData
    from roman_tpu_torch.map.align_pointcloud import AlignPointCloud
    from roman_tpu_torch.map.batch_mapper import BatchMapper, init_state
    from roman_tpu_torch.map.run import MapRunner
    from roman_tpu_torch.params.fastsam_params import FastSAMParams
    from roman_tpu_torch.params.mapper_params import MapperParams

    small = dict(max_segments=4, max_points_per_segment=8)
    cam = CameraParams.simple()
    pd = PoseData.from_times_and_poses([0.0, 1.0], np.stack([np.eye(4)] * 2))
    device_params = MapperParams(mapper_backend="device", **small)
    for make in (lambda: BatchMapper(MapperParams(**small), cam),
                 lambda: init_state(4, 8, 2),
                 lambda: MapRunner(device_params, FastSAMParams(), cam, pd),
                 lambda: AlignPointCloud(cam, np.eye(4))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert BatchMapper(MapperParams(**small), cam, device="cpu").state.points.device.type == "cpu"
    assert MapRunner(device_params, FastSAMParams(), cam, pd, device="cpu").device.type == "cpu"
    assert MapRunner(MapperParams(**small), FastSAMParams(), cam, pd).mapper is not None


def test_perception_entry_points_without_device_raise_on_a_host_without_a_card(no_card):
    """The front end, its one-frame wrapper and MapRunner.run (which builds
    the front end on its device) run on cuda unless asked for the CPU."""
    from roman_tpu_torch.data.camera import CameraParams
    from roman_tpu_torch.data.pose_data import PoseData
    from roman_tpu_torch.map.fastsam_wrapper import FastSAMWrapper
    from roman_tpu_torch.map.run import MapRunner
    from roman_tpu_torch.params.fastsam_params import FastSAMParams
    from roman_tpu_torch.params.mapper_params import MapperParams
    from roman_tpu_torch.perception.wrapper import PerceptionFrontend

    tiny = FastSAMParams(seg_arch="tiny", vit_arch="tiny", imgsz=(32, 32))
    cam = CameraParams.simple(width=32, height=32)
    pd = PoseData.from_times_and_poses([0.0, 1.0], np.stack([np.eye(4)] * 2))
    runner = MapRunner(MapperParams(max_segments=4, max_points_per_segment=8), tiny, cam, pd)
    for make in (lambda: PerceptionFrontend(tiny, cam),
                 lambda: PerceptionFrontend(tiny, cam, device="cuda"),
                 lambda: FastSAMWrapper.from_params(tiny, cam),
                 lambda: runner.run(lambda ts: None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert runner.frontend is None
    assert PerceptionFrontend(tiny, cam, device="cpu").device.type == "cpu"


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.fixture
def failing_launch(monkeypatch):
    """Kernel launchers that report a CUDA error, so no compiler or card is
    needed to see what a wrapper does with a non-CPU tensor."""
    calls = []

    def function(lib, name, argtypes):
        def fn(*args):
            calls.append((lib, name, len(args), len(argtypes)))
            return 98  # cudaErrorInvalidDeviceFunction
        return fn

    monkeypatch.setattr(build, "function", function)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(multi_processor_count=132))
    return calls


def test_wrappers_launch_for_non_cpu_tensors_and_raise_on_a_failed_launch(
        failing_launch):
    P, n, m, F, D = 2, 4, 3, 4, 8
    N = n * m
    inv = tfr.FusedInvariantStatics()
    before = [k.launches for k in tfr.KERNELS]
    cases = [
        (tfr.assoc_terms, (_meta(P, n, F), _meta(P, n, D), _meta(P, m, F),
                           _meta(P, m, D), _meta(P, n, m), inv)),
        (tfr.build_affinity, (_meta(P, n, 3), _meta(P, m, 3), _meta(P, 2, N),
                              _meta(P, 2, N), _meta(P, N), _meta(P, N), inv)),
        (clipper_solve, (_meta(P, N, N, dtype=torch.bfloat16), _meta(P, N),
                         n, m, ClipperSolveParams())),
        (tfr.round_refine, (_meta(P, N, N, dtype=torch.bfloat16), _meta(P, N),
                            _meta(P), _meta(P), n, m, inv)),
    ]
    for wrapper, args in cases:
        with pytest.raises(RuntimeError, match=f"{wrapper.__name__}: CUDA launch failed"):
            wrapper(*args)
    assert [c[1] for c in failing_launch] == [
        "assoc_terms_launch", "build_affinity_launch", "clipper_solve_launch",
        "round_refine_launch"]
    assert all(n_args == n_types for _, _, n_args, n_types in failing_launch)
    assert [k.launches for k in tfr.KERNELS] == before


def test_solve_and_round_rounds_through_the_kernel_off_the_cpu(
        failing_launch, monkeypatch):
    """For a tensor that is not on the CPU, solve_and_round's rounding and
    refinement launch the round_refine kernel, looked up at call time;
    the plain twins never run."""
    from roman_tpu_torch.align import clipper
    from roman_tpu_torch.align import clipper_solve as cs_mod

    P, n, m = 2, 4, 3
    N = n * m

    def solve(M, valid, n_, m_, params):
        return _meta(P, N), _meta(P), _meta(P), _meta(P)

    monkeypatch.setattr(cs_mod, "clipper_solve", solve)
    monkeypatch.setattr(clipper, "round_greedy", None)
    monkeypatch.setattr(clipper, "refine_selection_2d", None)
    with pytest.raises(RuntimeError, match="round_refine: CUDA launch failed"):
        clipper.solve_and_round(_meta(P, n, m, n, m), _meta(P, n, m, dtype=torch.bool),
                                max_clique=64)
    assert [c[1] for c in failing_launch] == ["round_refine_launch"]


@pytest.mark.parametrize("entry", ["clipper_prune", "mno_clipper", "clipper_solve"])
def test_registration_methods_launch_kernels_off_the_cpu(failing_launch, entry):
    """clipper+prune, mno_clipper and the 4D solve reach the kernels for a
    tensor that is not on the CPU; the plain twins never run."""
    from roman_tpu_torch.align import clipper, registration
    from roman_tpu_torch.align.invariants import SubmapFeatures

    P, n, m = 2, 4, 3

    def feats():
        return SubmapFeatures(centers=_meta(P, n, 3), ratio_feats=_meta(P, n, 4),
                              descriptors=_meta(P, n, 8),
                              valid=_meta(P, n, dtype=torch.bool))

    cfg = RegistrationConfig(method="clipper+prune")
    if entry == "clipper_prune":
        f1, f2 = feats(), feats()
        call, first = (lambda: registration.register_clipper_prune(
            f1, f2, cfg, descriptors1=f1.descriptors, descriptors2=f2.descriptors)), \
            "assoc_terms"
    elif entry == "mno_clipper":
        call, first = (lambda: registration.mno_clipper(
            feats(), feats(), RegistrationConfig())), "clipper_solve"
    else:
        call, first = (lambda: clipper.solve(
            _meta(P, n, m, n, m), _meta(P, n, m, dtype=torch.bool))), "clipper_solve"
    with pytest.raises(RuntimeError, match=f"{first}: CUDA launch failed"):
        call()
    assert [c[1] for c in failing_launch] == [f"{first}_launch"]


def test_wrappers_check_their_inputs(failing_launch):
    P, n, m = 2, 4, 3
    N = n * m
    M = _meta(P, N, N, dtype=torch.bfloat16)
    bad = [
        (M.float(), _meta(P, N)),                       # wrong dtype
        (M, _meta(P, N + 1)),                           # wrong shape
        (M, _meta(N, P).t()),                           # not contiguous
    ]
    for Mx, valid in bad:
        with pytest.raises(ValueError):
            clipper_solve(Mx, valid, n, m)
    with pytest.raises(ValueError, match="n_restarts"):
        clipper_solve(M, _meta(P, N), n, m, ClipperSolveParams(n_restarts=9))
    assert failing_launch == []
