"""Many sequences, and maps split into shards: the sequence axis
(`batch.py`), the map-sharded engine (`sharded_map.py`,
`sharded_engine.py`), the pod program (`pod.py`), the pts axis
(`sharded_icp.py`) and multi-process runs (`multihost.py`), over the grid
of `grid.py`."""

from kiss_icp_tpu_torch.parallel.batch import (  # noqa: F401
    BatchedOdometry,
    DeviceMesh,
    batched_state_sharding,
    init_batched_state,
    make_batched_chunked_step,
    make_batched_step,
    make_mesh,
)
from kiss_icp_tpu_torch.parallel.pod import PodOdometry, make_pod_mesh  # noqa: F401
from kiss_icp_tpu_torch.parallel.sharded_engine import ShardedKissICP  # noqa: F401
