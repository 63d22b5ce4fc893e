"""Dataset loaders and the dataloader registry of the port.

The same registry as the JAX package's `datasets/__init__.py`: the same 15
names, sequence and jump lists and `guess_dataloader`, so the CLI offers the
same choices. Three loaders are ported (`generic`, `kitti`, `synthetic`);
building any other raises `NotImplementedError` naming ROADMAP item 11.

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

# Loader name -> (module, class), for the loaders the port has.
_LOADERS: Dict[str, str] = {
    "kitti": "kiss_icp_tpu_torch.datasets.kitti:KITTIOdometryDataset",
    "generic": "kiss_icp_tpu_torch.datasets.generic:GenericDataset",
    "synthetic": "kiss_icp_tpu_torch.datasets.synthetic:SyntheticDataset",
}
# The JAX package's other loaders, still to be ported (ROADMAP item 11).
UNPORTED_DATALOADERS = ["kitti_raw", "mulran", "ncd", "nclt", "nuscenes", "apollo",
                        "boreas", "tum", "helipr", "rosbag", "mcap", "ouster"]

# Loaders that take a sequence index (reference datasets/__init__.py:40-42).
SEQUENCE_DATALOADERS = ["kitti", "kitti_raw", "nuscenes", "helipr"]
# Loaders that support --jump (all but streaming readers,
# reference datasets/__init__.py:53-58).
NON_JUMPABLE_DATALOADERS = ["mcap", "ouster", "rosbag"]

# Cloud-file extensions the generic loader understands
# (reference datasets/__init__.py:27-37).
SUPPORTED_FILE_EXTENSIONS = {"bin", "pcd", "ply", "xyz", "obj", "ctm", "off", "stl"}


def available_dataloaders() -> List[str]:
    return sorted([*_LOADERS, *UNPORTED_DATALOADERS])


def jumpable_dataloaders() -> List[str]:
    return [n for n in available_dataloaders() if n not in NON_JUMPABLE_DATALOADERS]


def sequence_dataloaders() -> List[str]:
    return list(SEQUENCE_DATALOADERS)


def supported_file_extensions() -> List[str]:
    return sorted(SUPPORTED_FILE_EXTENSIONS)


def dataset_factory(dataloader: str, data_dir: Path, *args: Any, **kwargs: Any):
    """Instantiate a loader by name (reference datasets/__init__.py:61-83)."""
    if dataloader in UNPORTED_DATALOADERS:
        raise NotImplementedError(
            f"the '{dataloader}' loader is not ported yet (ROADMAP item 11); "
            f"ported: {sorted(_LOADERS)}")
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
