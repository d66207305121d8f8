"""The reference's ``roman.offline_rpgo`` layout over the port's ``rpgo/``
(port of roman_tpu/offline_rpgo): the same names in the same modules."""

from roman_tpu_torch.rpgo.combine_loop_closures import (LoopClosure,  # noqa: F401
                                                        combine_loop_closures)
from roman_tpu_torch.rpgo.evaluate import evaluate  # noqa: F401
from roman_tpu_torch.rpgo.extract_odom import (extract_odom_g2o,  # noqa: F401
                                               roman_map_pkl_to_g2o)
from roman_tpu_torch.rpgo.fusion import create_config, g2o_file_fusion  # noqa: F401
from roman_tpu_torch.rpgo.g2o_io import (edit_g2o_edge_information,  # noqa: F401
                                         g2o_and_time_to_pose_data)
from roman_tpu_torch.rpgo.plot_g2o import plot_g2o  # noqa: F401
