"""MCAP bag loader (reference datasets/mcap.py:29-116), via the optional
`mcap` + `mcap-ros2-support` packages. Sequential-only like the rosbag loader."""

from __future__ import annotations

import os
import sys
from kiss_icp_tpu_torch.tools.point_cloud2 import read_point_cloud


class McapDataset:
    def __init__(self, data_dir, topic=None, *_, **kwargs):
        try:
            from mcap.reader import make_reader
            from mcap_ros2.decoder import DecoderFactory
        except ImportError as e:
            raise ImportError(
                'mcap loader requires mcap: "pip install mcap mcap-ros2-support"'
            ) from e
        topic = topic or kwargs.get("topic")
        self.sequence_id = os.path.basename(str(data_dir)).split(".")[0]
        self._file = open(str(data_dir), "rb")
        self.reader = make_reader(self._file, decoder_factories=[DecoderFactory()])
        self.summary = self.reader.get_summary()
        self.topic = self.check_topic(topic)
        self.n_scans = self._count_messages()
        self.msgs = self.reader.iter_decoded_messages(topics=[self.topic])

    def __del__(self):
        if hasattr(self, "_file"):
            try:
                self._file.close()
            except Exception:
                pass

    def __len__(self):
        return self.n_scans

    def __getitem__(self, idx):
        _, _, _, msg = next(self.msgs)
        return read_point_cloud(msg)

    def _count_messages(self) -> int:
        channel_ids = [
            cid for cid, ch in self.summary.channels.items() if ch.topic == self.topic
        ]
        stats = self.summary.statistics
        if stats is not None and stats.channel_message_counts:
            return sum(stats.channel_message_counts.get(cid, 0) for cid in channel_ids)
        return sum(1 for _ in self.reader.iter_messages(topics=[self.topic]))

    def check_topic(self, topic):
        pc2_topics = []
        for channel in self.summary.channels.values():
            schema = self.summary.schemas[channel.schema_id]
            if schema.name == "sensor_msgs/msg/PointCloud2":
                pc2_topics.append(channel.topic)
        if topic and topic in pc2_topics:
            return topic
        if topic:
            # Invalid user topic: error listing the valid ones (reference
            # mcap.py:110-118), never silently substitute another sensor.
            print(f"[ERROR] Topic {topic} is not a PointCloud2 topic of "
                  f"this mcap; available: {pc2_topics}", file=sys.stderr)
            raise ValueError(f"invalid topic {topic!r}")
        if len(pc2_topics) == 1:
            return pc2_topics[0]
        if not pc2_topics:
            print("[ERROR] Your mcap has no sensor_msgs/msg/PointCloud2 topic",
                  file=sys.stderr)
            raise ValueError("no PointCloud2 topic in mcap")
        print(f"[ERROR] Multiple PointCloud2 topics: {pc2_topics}; select one "
              "with --topic", file=sys.stderr)
        raise ValueError("ambiguous PointCloud2 topic")
