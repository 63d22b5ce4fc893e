"""PointCloud2 message decoding, pure numpy.

Equivalent of the reference tools/point_cloud2.py:59-180 (itself adapted from
ROS2 sensor_msgs_py): build a structured dtype from the message's field
descriptors, view the raw buffer, select x/y/z plus a sniffed timestamp field,
swap endianness when needed, and drop non-finite rows. Works with any object
exposing the PointCloud2 attributes (rosbags / mcap deserialized messages or
real ROS2 messages).
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np

# sensor_msgs/PointField datatype codes -> numpy dtypes.
_DATATYPES = {
    1: np.dtype(np.int8),
    2: np.dtype(np.uint8),
    3: np.dtype(np.int16),
    4: np.dtype(np.uint16),
    5: np.dtype(np.int32),
    6: np.dtype(np.uint32),
    7: np.dtype(np.float32),
    8: np.dtype(np.float64),
}

# One definition of the stamp-field sniff set (reference sniffs the same
# names in two places too — Utils.hpp:94-106 and generic.py:96-105).
from kiss_icp_tpu_torch.io.cloud_io import TIME_FIELD_NAMES  # noqa: F401,E402


def _fields_to_dtype(fields, point_step: int) -> np.dtype:
    """Structured dtype covering one point record, including pad bytes."""
    offset = 0
    names: List[str] = []
    formats: List[Any] = []
    offsets: List[int] = []
    for f in sorted(fields, key=lambda f: f.offset):
        if f.offset < offset:
            continue  # overlapping field: skip
        dt = _DATATYPES[f.datatype]
        count = getattr(f, "count", 1) or 1
        names.append(f.name)
        formats.append(dt if count == 1 else (dt, (count,)))
        offsets.append(f.offset)
        offset = f.offset + dt.itemsize * count
    return np.dtype({"names": names, "formats": formats, "offsets": offsets,
                     "itemsize": point_step})


def read_point_cloud(msg) -> Tuple[np.ndarray, np.ndarray]:
    """PointCloud2 -> (points (N,3) float64, timestamps (N,) float64 in [0,1]).

    Timestamps are empty when the message carries no recognized stamp field
    (the odometry then skips deskewing, reference Utils.hpp:102-105).
    """
    dtype = _fields_to_dtype(msg.fields, msg.point_step)
    n = msg.width * msg.height
    arr = np.frombuffer(bytes(msg.data), dtype=dtype, count=n)
    if getattr(msg, "is_bigendian", False):
        arr = arr.byteswap()

    pts = np.stack(
        [arr["x"].astype(np.float64), arr["y"].astype(np.float64),
         arr["z"].astype(np.float64)],
        axis=1,
    )

    stamps: Optional[np.ndarray] = None
    for cand in TIME_FIELD_NAMES:
        if cand in (arr.dtype.names or ()):
            stamps = arr[cand].astype(np.float64)
            break

    finite = np.all(np.isfinite(pts), axis=1)
    pts = pts[finite]
    if stamps is None:
        return pts, np.array([])
    stamps = stamps[finite]
    # Normalize to [0, 1] (reference Utils.hpp:109-120).
    span = stamps.max() - stamps.min() if len(stamps) else 0.0
    if span > 0:
        stamps = (stamps - stamps.min()) / span
    else:
        stamps = np.zeros_like(stamps)
    return pts, stamps
