"""Point-cloud readers, the native scan decoder and odometry checkpoints."""

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
