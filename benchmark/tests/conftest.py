"""Shared fixtures of the benchmark's own tests (run from the root of the
checkout: python -m pytest benchmark/tests). Tests marked `cuda` need a
card and skip without one."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture(scope="session")
def bench():
    from benchmark import harness

    return harness.load_json(harness.ROOT, "BENCHMARK.json")


def tiny(config: dict, scene_seed: int = 0) -> dict:
    """A configuration cut to a size this sandbox's CPU registers in a
    second: 150 objects, 40 m drives, 32-d descriptors, capacity 12."""
    config = copy.deepcopy(config)
    config["scene"].update(seed=scene_seed, n_objects=150, area_m=[40.0, 40.0, 3.0], traj_len_m=40.0,
                           desc_dim=32, n_classes=16)
    config["align"]["submap_max_size"] = 12
    return config


@pytest.fixture
def tiny_cell(bench):
    """(workload entry, tiny configuration, traffic) of a cell by name, with
    a traced stretch short enough for a one-second window."""
    from benchmark import harness

    def make(name):
        wl, config, traffic = harness.find_cell(bench, name)
        traffic = dict(traffic, trace=dict(traffic["trace"], lead_s=0.1, span_ops=3))
        return wl, tiny(config), traffic

    return make


@pytest.fixture
def card():
    """The CUDA device, with the port's kernels built; skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from roman_tpu_torch.kernels import build

    build.build_all()
    return torch.device("cuda:0")
