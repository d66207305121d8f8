"""The port's reference-layout aliases against roman_tpu's, on the CPU: every
public name that roman_tpu's ``offline_rpgo`` and per-pair ``align``
modules define exists in the port's module of the same name, the alias
package's entry points are the port's ``rpgo`` functions, the palette
helpers return roman_tpu's colours, and ``plot_g2o`` draws roman_tpu's
figure pixel for pixel (and names matplotlib where it is missing)."""

import importlib
import sys

import numpy as np
import pytest

from test_torch_demo import _graph_lines

OFFLINE_RPGO = ["combine_loop_closures", "edit_g2o_edge_information", "evaluate",
                "extract_odom_g2o", "g2o_and_time_to_pose_data", "g2o_change_frame",
                "g2o_file_fusion", "plot_g2o", "rm_robots_g2o"]
ALIGN = ["object_registration", "roman_registration", "dist_reg_with_pruning",
         "ransac_reg", "submap", "submap_viz", "align_viz"]


def _defined_names(module):
    """Public names of a roman_tpu module bound to roman_tpu's own classes
    and functions (its imports of numpy, jax and the like excluded)."""
    return {n for n, v in vars(module).items() if not n.startswith("_")
            and getattr(v, "__module__", "").startswith("roman_tpu.")}


@pytest.mark.parametrize("name", [f"offline_rpgo.{m}" for m in OFFLINE_RPGO]
                         + ["offline_rpgo"] + [f"align.{m}" for m in ALIGN])
def test_every_name_of_roman_tpu_exists_in_the_port(name):
    ref = importlib.import_module(f"roman_tpu.{name}")
    port = importlib.import_module(f"roman_tpu_torch.{name}")
    names = _defined_names(ref)
    assert names
    assert not [n for n in names if not hasattr(port, n)]


def test_offline_rpgo_aliases_are_the_port_rpgo_functions():
    from roman_tpu_torch.offline_rpgo import plot_g2o as alias_plot
    from roman_tpu_torch.offline_rpgo.edit_g2o_edge_information import \
        edit_g2o_edge_information
    from roman_tpu_torch.offline_rpgo.extract_odom_g2o import RomanMap, roman_map_pkl_to_g2o
    from roman_tpu_torch.offline_rpgo.g2o_change_frame import g2o_change_frame
    from roman_tpu_torch.offline_rpgo.g2o_file_fusion import g2o_file_fusion
    from roman_tpu_torch.offline_rpgo.rm_robots_g2o import rm_robots, rm_robots_g2o
    from roman_tpu_torch.map import roman_map
    from roman_tpu_torch.rpgo import extract_odom, fusion, g2o_io, g2o_utils, plot_g2o

    assert g2o_file_fusion is fusion.g2o_file_fusion
    assert edit_g2o_edge_information is g2o_io.edit_g2o_edge_information
    assert roman_map_pkl_to_g2o is extract_odom.roman_map_pkl_to_g2o
    assert RomanMap is roman_map.RomanMap
    assert g2o_change_frame is g2o_utils.g2o_change_frame
    assert rm_robots is g2o_utils.rm_robots and rm_robots_g2o is plot_g2o.rm_robots_g2o
    # (a package attribute may be shadowed by its submodule of the same
    # name, depending on import order, as in the reference's package)
    assert getattr(alias_plot, "plot_g2o", alias_plot) is plot_g2o.plot_g2o


def test_palettes_match_roman_tpu():
    from roman_tpu.align import submap_viz as j_sv
    from roman_tpu_torch.align import submap_viz as t_sv

    assert t_sv.generate_bright_color_palette(7) == j_sv.generate_bright_color_palette(7)
    last = t_sv.generate_bright_color_palette(3)
    got = [t_sv.random_bright_color(last, rng=np.random.default_rng(s)) for s in range(5)]
    ref = [j_sv.random_bright_color(last, rng=np.random.default_rng(s)) for s in range(5)]
    assert got == ref


def test_plot_g2o_matches_roman_tpu_pixel_for_pixel(tmp_path, monkeypatch):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from roman_tpu.rpgo import plot_g2o as j_plot
    from roman_tpu_torch.offline_rpgo.plot_g2o import G2OPlotParams, plot_g2o

    path = tmp_path / "fused.g2o"
    path.write_text("\n".join(_graph_lines(4)) + "\n")

    def pixels(fn, params, **kw):
        fig, ax = plt.subplots(figsize=(3, 3), dpi=50)
        fn(str(path), ax=ax, params=params, **kw)
        fig.canvas.draw()
        img = np.asarray(fig.canvas.buffer_rgba()).copy()
        plt.close(fig)
        return img

    for axes, kw in (((0, 1), {}),
                     ((0, 2), dict(g2o_symbol_to_name={"a": "robot0"},
                                   g2o_symbol_to_color={"a": "tab:red", "b": "k"}))):
        got = pixels(plot_g2o, G2OPlotParams(axes=axes), **kw)
        ref = pixels(j_plot.plot_g2o, j_plot.G2OPlotParams(axes=axes), **kw)
        assert (got != 255).any()
        np.testing.assert_array_equal(got, ref)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        plot_g2o(str(path))
