"""ROS1/ROS2 bag loader (reference datasets/rosbag.py:32-138), via the optional
`rosbags` package. Sequential-only: `__getitem__` ignores the index and returns
the next message (rosbag readers cannot seek cheaply, rosbag.py:85-89)."""

from __future__ import annotations

import os
import sys
from pathlib import Path

from kiss_icp_tpu_torch.tools.point_cloud2 import read_point_cloud


class RosbagDataset:
    def __init__(self, data_dir, topic=None, *_, **kwargs):
        try:
            from rosbags.highlevel import AnyReader
        except ImportError as e:
            raise ImportError(
                'rosbag loader requires rosbags: "pip install rosbags"'
            ) from e
        topic = topic or kwargs.get("topic")
        self.sequence_id = os.path.basename(str(data_dir)).split(".")[0]
        self.bag = AnyReader([Path(str(data_dir))])
        self.bag.open()
        self.topic = self.check_topic(topic)
        self.n_scans = self.bag.topics[self.topic].msgcount
        self.msgs = self.bag.messages(
            connections=[c for c in self.bag.connections if c.topic == self.topic]
        )

    def __del__(self):
        if hasattr(self, "bag"):
            try:
                self.bag.close()
            except Exception:
                pass

    def __len__(self):
        return self.n_scans

    def __getitem__(self, idx):
        # Sequential read: idx is ignored by design (rosbag.py:85-89).
        connection, timestamp, rawdata = next(self.msgs)
        msg = self.bag.deserialize(rawdata, connection.msgtype)
        return read_point_cloud(msg)

    def check_topic(self, topic):
        """Validate/auto-select the PointCloud2 topic (rosbag.py:104-138)."""
        point_cloud_topics = [
            c.topic
            for c in self.bag.connections
            if c.msgtype == "sensor_msgs/msg/PointCloud2"
        ]
        if topic and topic in point_cloud_topics:
            return topic
        if topic:
            # The requested topic is NOT a PointCloud2 topic of this bag:
            # error with the valid choices (reference rosbag.py:120-127)
            # instead of silently reading a different topic.
            print(f"[ERROR] Topic {topic} is not a PointCloud2 topic of "
                  f"this bag; available: {point_cloud_topics}",
                  file=sys.stderr)
            raise ValueError(f"invalid topic {topic!r}")
        if len(point_cloud_topics) == 1:
            return point_cloud_topics[0]
        if len(point_cloud_topics) == 0:
            print("[ERROR] Your bag has no sensor_msgs/msg/PointCloud2 topic",
                  file=sys.stderr)
            raise ValueError("no PointCloud2 topic in bag")
        print(f"[ERROR] Multiple PointCloud2 topics: {point_cloud_topics}; "
              "select one with --topic", file=sys.stderr)
        raise ValueError("ambiguous PointCloud2 topic")
