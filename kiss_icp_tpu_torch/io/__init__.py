"""Point-cloud readers, the native scan decoder and odometry checkpoints.

The AOT artifact of the step is `kiss_icp_tpu_torch.io.aot`, imported on its
own: it imports the odometry step and the kernels' operators, which the
readers do not need."""

from kiss_icp_tpu_torch.io.cloud_io import (  # noqa: F401
    natural_sort,
    read_kitti_bin,
    read_pcd,
    read_ply,
    read_point_cloud,
)
from kiss_icp_tpu_torch.io.checkpoint import (  # noqa: F401
    load_checkpoint,
    save_checkpoint,
    save_state,
)
