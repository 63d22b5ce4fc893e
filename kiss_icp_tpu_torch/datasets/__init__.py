"""Dataset loaders and the dataloader registry of the port.

The same registry as the JAX package's `datasets/__init__.py`: the same 15
loaders, sequence and jump lists and `guess_dataloader`, so the CLI offers
the same choices. Every loader is a numpy reader (the optional libraries of
`rosbag`, `mcap`, `ouster` and `nuscenes` are imported when the loader is
built, which raises ImportError without them); the engine that consumes
its scans runs on the GPU unless the caller asks for the CPU.

A loader is any object with:
  * `__len__()` -> number of scans
  * `__getitem__(idx)` -> either `points (N,3) float` or `(points, timestamps)`
  * optional `gt_poses` (M,4,4) numpy array
  * optional `apply_calibration(poses)` for writing results in the GT frame
  * optional `sequence_id` string used in result naming
"""

from __future__ import annotations

import importlib
from pathlib import Path
from typing import Any, Dict, List, Optional

# Loader name -> (module, class): the JAX package's set.
_LOADERS: Dict[str, str] = {
    "kitti": "kiss_icp_tpu_torch.datasets.kitti:KITTIOdometryDataset",
    "kitti_raw": "kiss_icp_tpu_torch.datasets.kitti_raw:KITTIRawDataset",
    "mulran": "kiss_icp_tpu_torch.datasets.mulran:MulranDataset",
    "ncd": "kiss_icp_tpu_torch.datasets.ncd:NewerCollegeDataset",
    "nclt": "kiss_icp_tpu_torch.datasets.nclt:NCLTDataset",
    "nuscenes": "kiss_icp_tpu_torch.datasets.nuscenes:NuScenesDataset",
    "apollo": "kiss_icp_tpu_torch.datasets.apollo:ApolloDataset",
    "boreas": "kiss_icp_tpu_torch.datasets.boreas:BoreasDataset",
    "tum": "kiss_icp_tpu_torch.datasets.tum:TUMDataset",
    "helipr": "kiss_icp_tpu_torch.datasets.helipr:HeLiPRDataset",
    "rosbag": "kiss_icp_tpu_torch.datasets.rosbag:RosbagDataset",
    "mcap": "kiss_icp_tpu_torch.datasets.mcap:McapDataset",
    "ouster": "kiss_icp_tpu_torch.datasets.ouster:OusterDataset",
    "generic": "kiss_icp_tpu_torch.datasets.generic:GenericDataset",
    "synthetic": "kiss_icp_tpu_torch.datasets.synthetic:SyntheticDataset",
}

# Loaders that take a sequence index (reference datasets/__init__.py:40-42).
SEQUENCE_DATALOADERS = ["kitti", "kitti_raw", "nuscenes", "helipr"]
# Loaders that support --jump (all but streaming readers,
# reference datasets/__init__.py:53-58).
NON_JUMPABLE_DATALOADERS = ["mcap", "ouster", "rosbag"]

# Cloud-file extensions the generic loader understands
# (reference datasets/__init__.py:27-37).
SUPPORTED_FILE_EXTENSIONS = {"bin", "pcd", "ply", "xyz", "obj", "ctm", "off", "stl"}


def available_dataloaders() -> List[str]:
    return sorted(_LOADERS)


def jumpable_dataloaders() -> List[str]:
    return [n for n in available_dataloaders() if n not in NON_JUMPABLE_DATALOADERS]


def sequence_dataloaders() -> List[str]:
    return list(SEQUENCE_DATALOADERS)


def supported_file_extensions() -> List[str]:
    return sorted(SUPPORTED_FILE_EXTENSIONS)


def dataset_factory(dataloader: str, data_dir: Path, *args: Any, **kwargs: Any):
    """Instantiate a loader by name (reference datasets/__init__.py:61-83)."""
    if dataloader not in _LOADERS:
        raise ValueError(
            f"Unknown dataloader '{dataloader}'. Supported: {available_dataloaders()}"
        )
    module_name, _, class_name = _LOADERS[dataloader].partition(":")
    module = importlib.import_module(module_name)
    cls = getattr(module, class_name)
    return cls(data_dir, *args, **kwargs)


def guess_dataloader(data: Path) -> Optional[str]:
    """Infer the dataloader from the path's extension/layout
    (reference tools/cmd.py:38-59)."""
    data = Path(data)
    if data.is_file():
        ext = data.suffix.lower()
        if ext == ".bag":
            return "rosbag"
        if ext == ".pcap":
            return "ouster"
        if ext == ".mcap":
            return "mcap"
        if data.name == "metadata.yaml":
            # The reference routes the bag's metadata file itself to rosbag
            # (tools/cmd.py:44-46).
            return "rosbag"
        return None
    if data.is_dir():
        entries = {p.name for p in data.iterdir()}
        if "metadata.yaml" in entries:
            # ROS2 bag directory, sqlite3 or mcap storage (reference
            # cmd.py:47-48 keys on metadata.yaml alone).
            return "rosbag"
        if "velodyne" in entries:  # KITTI-odometry sequence dir
            return None  # ambiguous: kitti wants the dataset root; let CLI decide
    return None
