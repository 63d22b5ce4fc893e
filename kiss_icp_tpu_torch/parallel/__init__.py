"""Many sequences at once. Only the sequence axis on one device is ported
(`batch.py`); the map-sharded engine, the pod program and the multi-host
driver come with ROADMAP item 16b."""

from kiss_icp_tpu_torch.parallel.batch import (  # noqa: F401
    BatchedOdometry,
    DeviceMesh,
    batched_state_sharding,
    init_batched_state,
    make_batched_chunked_step,
    make_batched_step,
    make_mesh,
)
