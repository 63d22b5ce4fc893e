"""Ouster pcap loader (reference datasets/ouster.py:31-118), via the optional
`ouster-sdk`. Range images are converted to clouds with the sensor XYZ lookup
table; per-column stamps linspace(0,1,w) tiled over rows; zero-range returns
are filtered."""

from __future__ import annotations

import os

import numpy as np


class OusterDataset:
    def __init__(self, data_dir, meta=None, *_, **kwargs):
        try:
            from ouster.sdk import client, pcap  # ouster-sdk >= 0.10 layout
        except ImportError:
            try:
                from ouster import client, pcap  # older layout
            except ImportError as e:
                raise ImportError(
                    'ouster loader requires the SDK: "pip install ouster-sdk"'
                ) from e
        self._client = client
        meta = meta or kwargs.get("meta")
        if meta is None:
            # Default: json next to the pcap with the same stem.
            stem = os.path.splitext(str(data_dir))[0]
            meta = stem + ".json"
        with open(meta) as f:
            self.info = client.SensorInfo(f.read())
        self.sequence_id = os.path.basename(str(data_dir)).split(".")[0]
        self._source = pcap.Pcap(str(data_dir), self.info)
        self._scans_iter = client.Scans(self._source)
        self._xyz_lut = client.XYZLut(self.info)
        # Counting scans requires a full pass; do it once up front.
        self.n_scans = sum(1 for _ in client.Scans(pcap.Pcap(str(data_dir), self.info)))
        self._iter = iter(self._scans_iter)

    def __len__(self):
        return self.n_scans

    def __getitem__(self, idx):
        client = self._client
        scan = next(self._iter)
        xyz = self._xyz_lut(scan.field(client.ChanField.RANGE)).reshape(-1, 3)
        ranges = scan.field(client.ChanField.RANGE).reshape(-1)
        h, w = self.info.format.pixels_per_column, self.info.format.columns_per_frame
        timestamps = np.tile(np.linspace(0.0, 1.0, w, endpoint=False), (h, 1)).reshape(-1)
        keep = ranges > 0
        return xyz[keep].astype(np.float64), timestamps[keep]
