"""The port's twelve remaining loaders and PointCloud2 decoding
(kiss_icp_tpu_torch.datasets, tools/point_cloud2.py) against the JAX
package's, and the port's CLI over each family on the CPU.

  * every loader, on the fixtures of tests/test_datasets_extended.py and
    tests/test_gated_loaders.py (the gated four through their in-memory
    fakes, installed into sys.modules per test), gives the JAX loader's
    scans, stamps, ground truth, calibration and frame stamps bit for bit;
  * the ImportError gates of the gated four hold without their libraries;
  * `read_point_cloud` equals JAX's on little- and big-endian messages, with
    and without a stamp field, with NaN rows;
  * `python -m kiss_icp_tpu_torch.tools.cmd --dataloader <family> --device
    cpu` runs each family on 3 frames of at most 2048 points, writes one
    pose a frame, and gives the poses of the port's KissICP on the CPU fed
    the JAX loader's arrays, within 1e-6 m.
"""

import json
import struct
import sys
import types

import numpy as np
import pytest
import torch
import yaml
from scipy.spatial.transform import Rotation

from kiss_icp_tpu import datasets as jdatasets
from kiss_icp_tpu.tools import point_cloud2 as jpc2
from kiss_icp_tpu_torch import datasets
from kiss_icp_tpu_torch.config import load_config
from kiss_icp_tpu_torch.datasets.synthetic import SyntheticDataset
from kiss_icp_tpu_torch.odometry import KissICP
from kiss_icp_tpu_torch.tools import cmd, point_cloud2

torch.set_num_threads(1)

FAMILIES = ["kitti_raw", "mulran", "ncd", "nclt", "nuscenes", "apollo", "boreas", "tum",
            "helipr", "rosbag", "mcap", "ouster"]
GATED = ["rosbag", "mcap", "ouster", "nuscenes"]


# ---------------------------------------------------------------- writers
def _write_pcd(path, pts):
    """tests/test_datasets_extended.py's binary x/y/z PCD."""
    header = (
        "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
        f"WIDTH {len(pts)}\nHEIGHT 1\nPOINTS {len(pts)}\nDATA binary\n"
    )
    rec = np.rec.fromarrays(
        [pts[:, 0], pts[:, 1], pts[:, 2]], formats="<f4,<f4,<f4", names="x,y,z"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(rec.tobytes())


class _Field:
    def __init__(self, name, offset, datatype, count=1):
        self.name, self.offset, self.datatype, self.count = name, offset, datatype, count


class _PC2Msg:
    """A PointCloud2 record: float32 x/y/z and, with `stamps`, a field `t`
    of `stamp_dtype` (tests/test_datasets_extended.py's _FakeMsg, with the
    byte order a parameter)."""

    def __init__(self, pts, stamps=None, stamp_dtype="u4", bigendian=False, extra=None):
        o = ">" if bigendian else "<"
        cols, fmts, names = [pts[:, 0], pts[:, 1], pts[:, 2]], [o + "f4"] * 3, ["x", "y", "z"]
        self.fields = [_Field("x", 0, 7), _Field("y", 4, 7), _Field("z", 8, 7)]
        codes = {"u4": 6, "f4": 7, "f8": 8, "u2": 4}
        offset = 12
        for name, values, dt in ([("intensity", extra, "f4")] if extra is not None else []) + (
                [("t", stamps, stamp_dtype)] if stamps is not None else []):
            self.fields.append(_Field(name, offset, codes[dt]))
            cols.append(values)
            fmts.append(o + dt)
            names.append(name)
            offset += np.dtype(dt).itemsize
        rec = np.rec.fromarrays(cols, formats=",".join(fmts), names=",".join(names))
        self.point_step = rec.itemsize
        self.width, self.height = len(pts), 1
        self.is_bigendian = bigendian
        self.data = rec.tobytes()


def _install(monkeypatch, modules):
    for name, mod in modules.items():
        monkeypatch.setitem(sys.modules, name, mod)


def _fake_rosbags(monkeypatch, msgs, topics=("/points",)):
    """tests/test_gated_loaders.py's `rosbags.highlevel.AnyReader`, serving
    `msgs` on the first PointCloud2 topic."""

    class _Conn:
        def __init__(self, topic, msgtype):
            self.topic, self.msgtype = topic, msgtype

    class AnyReader:
        def __init__(self, paths):
            assert len(paths) == 1
            self.connections = [_Conn("/tf", "tf2_msgs/msg/TFMessage")] + [
                _Conn(t, "sensor_msgs/msg/PointCloud2") for t in topics]
            self.topics = {t: types.SimpleNamespace(msgcount=len(msgs)) for t in topics}
            self.topics["/tf"] = types.SimpleNamespace(msgcount=99)

        def open(self):
            pass

        def close(self):
            pass

        def messages(self, connections):
            for i, msg in enumerate(msgs):
                yield connections[0], 1_000_000 * i, msg

        def deserialize(self, rawdata, msgtype):
            assert msgtype == "sensor_msgs/msg/PointCloud2"
            return rawdata

    highlevel = types.ModuleType("rosbags.highlevel")
    highlevel.AnyReader = AnyReader
    rosbags = types.ModuleType("rosbags")
    rosbags.highlevel = highlevel
    _install(monkeypatch, {"rosbags": rosbags, "rosbags.highlevel": highlevel})


def _fake_mcap(monkeypatch, msgs):
    """tests/test_gated_loaders.py's `mcap.reader` + `mcap_ros2.decoder`."""

    class _Schema:
        name = "sensor_msgs/msg/PointCloud2"

    class _Channel:
        def __init__(self, topic):
            self.topic = topic
            self.schema_id = 1

    class _Summary:
        channels = {10: _Channel("/lidar")}
        schemas = {1: _Schema()}
        statistics = types.SimpleNamespace(channel_message_counts={10: len(msgs)})

    class _Reader:
        def get_summary(self):
            return _Summary()

        def iter_decoded_messages(self, topics):
            assert topics == ["/lidar"]
            for i, msg in enumerate(msgs):
                yield (_Schema(), _Summary.channels[10], types.SimpleNamespace(log_time=i), msg)

    def make_reader(f, decoder_factories):
        assert decoder_factories and hasattr(f, "read")
        return _Reader()

    mcap_mod = types.ModuleType("mcap")
    reader_mod = types.ModuleType("mcap.reader")
    reader_mod.make_reader = make_reader
    mcap_mod.reader = reader_mod
    ros2_mod = types.ModuleType("mcap_ros2")
    dec_mod = types.ModuleType("mcap_ros2.decoder")
    dec_mod.DecoderFactory = type("DecoderFactory", (), {})
    ros2_mod.decoder = dec_mod
    _install(monkeypatch, {"mcap": mcap_mod, "mcap.reader": reader_mod,
                           "mcap_ros2": ros2_mod, "mcap_ros2.decoder": dec_mod})


def _fake_ouster(monkeypatch, dirs):
    """tests/test_gated_loaders.py's `ouster.sdk` client/pcap: range images
    in mm from `<pcap>.npy`, xyz = dirs * range_m."""

    class _Scan:
        def __init__(self, rng_img):
            self._rng_img = rng_img

        def field(self, chan):
            assert chan == "RANGE"
            return self._rng_img

    class SensorInfo:
        def __init__(self, meta_json):
            meta = json.loads(meta_json)
            self.format = types.SimpleNamespace(
                pixels_per_column=meta["pixels_per_column"],
                columns_per_frame=meta["columns_per_frame"])

    class Pcap:
        def __init__(self, path, info):
            self.frames = np.load(str(path) + ".npy")

    class Scans:
        def __init__(self, source):
            self._scans = [_Scan(f) for f in source.frames]

        def __iter__(self):
            return iter(self._scans)

    def XYZLut(info):
        def lut(rng_img):
            r_m = rng_img.reshape(-1, 1).astype(np.float64) / 1000.0
            return (dirs * r_m).reshape(rng_img.shape + (3,))
        return lut

    client = types.ModuleType("ouster.sdk.client")
    client.SensorInfo, client.Scans, client.XYZLut = SensorInfo, Scans, XYZLut
    client.ChanField = types.SimpleNamespace(RANGE="RANGE")
    pcap = types.ModuleType("ouster.sdk.pcap")
    pcap.Pcap = Pcap
    sdk = types.ModuleType("ouster.sdk")
    sdk.client, sdk.pcap = client, pcap
    ouster = types.ModuleType("ouster")
    ouster.sdk = sdk
    _install(monkeypatch, {"ouster": ouster, "ouster.sdk": sdk, "ouster.sdk.client": client,
                           "ouster.sdk.pcap": pcap})


def _write_ouster(root, monkeypatch, ranges, dirs):
    _fake_ouster(monkeypatch, dirs)
    path = root / "drive.pcap"
    path.write_bytes(b"pcap")
    np.save(str(path) + ".npy", ranges)
    _, h, w = ranges.shape
    (root / "drive.json").write_text(json.dumps({"pixels_per_column": h, "columns_per_frame": w}))
    return path


def _fake_nuscenes(monkeypatch, tables, scenes):
    class NuScenes:
        def __init__(self, dataroot, version):
            assert version == "v1.0-mini"
            self.dataroot = dataroot
            self.scene = scenes

        def get(self, table, token):
            return tables[table][token]

    nusc_mod = types.ModuleType("nuscenes")
    sub = types.ModuleType("nuscenes.nuscenes")
    sub.NuScenes = NuScenes
    nusc_mod.nuscenes = sub
    _install(monkeypatch, {"nuscenes": nusc_mod, "nuscenes.nuscenes": sub})


def _write_nuscenes(root, monkeypatch, clouds, ego_q, ego_t, calib=([1.0, 0, 0, 0], [0.9, 0, 1.8])):
    """tests/test_gated_loaders.py's devkit tables over (N, 5) sweeps; ego
    pose i = (ego_q[i] as xyzw, ego_t[i])."""
    (root / "v1.0-mini").mkdir()
    (root / "sweeps").mkdir()
    n = len(clouds)
    for i, pc in enumerate(clouds):
        full = np.zeros((len(pc), 5), np.float32)
        full[:, :3] = pc
        full.tofile(root / "sweeps" / f"lidar_{i}.pcd.bin")
    tables = {
        "sample": {"s0": {"data": {"LIDAR_TOP": "sd0"}}},
        "sample_data": {
            f"sd{i}": {"token": f"sd{i}", "next": f"sd{i + 1}" if i < n - 1 else "",
                       "filename": f"sweeps/lidar_{i}.pcd.bin", "ego_pose_token": f"ep{i}",
                       "calibrated_sensor_token": "cs0"} for i in range(n)},
        "ego_pose": {f"ep{i}": {"rotation": np.roll(ego_q[i], 1).tolist(),
                                "translation": list(ego_t[i])} for i in range(n)},
        "calibrated_sensor": {"cs0": {"rotation": list(calib[0]), "translation": list(calib[1])}},
    }
    _fake_nuscenes(monkeypatch, tables, [{"name": "scene-0001", "first_sample_token": "s0"},
                                         {"name": "scene-0999", "first_sample_token": "s0"}])
    return root


def _write_kitti_raw(root, scans4, oxts_rows, calib_rot, calib_t):
    from kiss_icp_tpu.datasets.kitti_raw import RAW_TO_ODOMETRY_MAPPING

    drive = root / RAW_TO_ODOMETRY_MAPPING["00"]
    velo, oxts = drive / "velodyne_points" / "data", drive / "oxts" / "data"
    velo.mkdir(parents=True)
    oxts.mkdir(parents=True)
    for i, (scan, vals) in enumerate(zip(scans4, oxts_rows)):
        scan.tofile(velo / f"{i:010d}.bin")
        np.savetxt(oxts / f"{i:010d}.txt", vals[None])
    with (root / "2011_10_03" / "calib_imu_to_velo.txt").open("w") as f:
        f.write("calib_time: 15-Mar-2012 11:37:16\n")
        f.write("R: " + " ".join(str(v) for v in calib_rot.ravel()) + "\n")
        f.write("T: " + " ".join(str(v) for v in calib_t) + "\n")
    return root


def _write_helipr_ouster(root, rng, n):
    scan_dir, gt_dir = root / "LiDAR" / "Ouster", root / "LiDAR_GT"
    scan_dir.mkdir(parents=True)
    gt_dir.mkdir(parents=True)
    rec = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("intensity", "<f4"),
                             ("t", "<u4"), ("reflectivity", "<u2"), ("ring", "<u2"),
                             ("ambient", "<u2")])
    rec["x"] = rng.uniform(-50, 50, n)
    rec["y"] = rng.uniform(-50, 50, n)
    rec["z"] = rng.uniform(-5, 5, n)
    rec["t"] = np.arange(n, dtype=np.uint32) * 1000
    rec.tofile(scan_dir / "1000000000.bin")
    q = Rotation.identity().as_quat()
    np.savetxt(gt_dir / "global_Ouster_gt.txt",
               np.array([[1000000000, 0, 0, 0, q[0], q[1], q[2], q[3]]]))


def _write_helipr_velodyne(root, clouds, stamps, poses):
    """The Velodyne layout ('=ffffHf': x y z intensity ring t), t float32
    seconds, one file per scan, GT rows [stamp x y z qx qy qz qw]."""
    scan_dir, gt_dir = root / "LiDAR" / "Velodyne", root / "LiDAR_GT"
    scan_dir.mkdir(parents=True)
    gt_dir.mkdir(parents=True)
    rows = []
    for i, (pts, t) in enumerate(zip(clouds, stamps)):
        rec = np.zeros(len(pts), dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                        ("intensity", "<f4"), ("ring", "<u2"), ("t", "<f4")])
        rec["x"], rec["y"], rec["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
        rec["ring"] = np.arange(len(pts)) % 16
        rec["t"] = t
        stamp = 1_000_000_000 + 100_000_000 * i
        rec.tofile(scan_dir / f"{stamp}.bin")
        q = Rotation.from_matrix(poses[i][:3, :3]).as_quat()
        rows.append([stamp, *poses[i][:3, 3], *q])
    np.savetxt(gt_dir / "global_Velodyne_gt.txt", np.array(rows))


def _write_helipr_aeva(root, rng):
    """Two Aeva scans, one before the no-intensity cutoff (25 B records) and
    one after it (29 B records)."""
    scan_dir = root / "LiDAR" / "Aeva"
    scan_dir.mkdir(parents=True)
    for stamp, fmt in ((1691936557946849000, "=ffffflB"), (1691936557946849999, "=ffffflBf")):
        with open(scan_dir / f"{stamp}.bin", "wb") as f:
            for i in range(200):
                vals = [*rng.uniform(-30, 30, 3), 0.5, -1.0, 1000 * i, 3]
                f.write(struct.pack(fmt, *vals, *([0.25] if fmt.endswith("f") else [])))


# ------------------------------------------- the JAX tests' own fixtures
# Each returns (data path, loader keywords); the gated ones install their
# fakes first.
def fx_mulran(root, monkeypatch):
    seq = root / "KAIST01"
    (seq / "Ouster").mkdir(parents=True)
    rng = np.random.default_rng(0)
    n = 64 * 1024
    for t in [100000000, 200000000]:
        rng.uniform(-50, 50, (n, 4)).astype(np.float32).tofile(seq / "Ouster" / f"{t}.bin")
    rows = []
    for i, t in enumerate(np.linspace(50000000, 250000000, 7)):
        pose34 = np.eye(4)[:3].copy()
        pose34[0, 3] = i * 1.0
        rows.append([t] + list(pose34.ravel()))
    np.savetxt(seq / "global_pose.csv", np.array(rows), delimiter=",")
    # The broken cloud (wrong size): no per-point stamps.
    rng.uniform(-50, 50, (100, 4)).astype(np.float32).tofile(seq / "Ouster" / "300000000.bin")
    return seq, {}


def fx_ncd(root, monkeypatch):
    seq = root / "quad"
    scans, gt_dir = seq / "raw_format" / "ouster_scan", seq / "ground_truth"
    scans.mkdir(parents=True)
    gt_dir.mkdir(parents=True)
    rng = np.random.default_rng(1)
    n = 64 * 1024
    for name in ["cloud_1583836591_182590976.pcd", "cloud_1583836592_182590976.pcd"]:
        _write_pcd(scans / name, rng.uniform(-20, 20, (n, 3)).astype(np.float32))
    _write_pcd(scans / "cloud_1583836593_0.pcd", rng.uniform(-20, 20, (50, 3)).astype(np.float32))
    gt_rows = []
    for i in range(3):
        q = Rotation.from_euler("z", 0.1 * i).as_quat()
        gt_rows.append([1583836591 + i, 0, i * 0.5, 0.0, 0.0, q[0], q[1], q[2], q[3]])
    np.savetxt(gt_dir / "registered_poses.csv", np.array(gt_rows), delimiter=",")
    return seq, {}


def fx_apollo(root, monkeypatch):
    seq = root / "session1"
    (seq / "pcds").mkdir(parents=True)
    (seq / "poses").mkdir(parents=True)
    rng = np.random.default_rng(2)
    for i in [1, 2, 10]:
        _write_pcd(seq / "pcds" / f"{i}.pcd", rng.uniform(-30, 30, (128, 3)).astype(np.float32))
    rows = []
    for i in range(3):
        q = Rotation.from_euler("z", 0.05 * i).as_quat()
        rows.append([i, 1000.0 + i, i * 2.0, 0, 0, q[0], q[1], q[2], q[3]])
    np.savetxt(seq / "poses" / "gt_poses.txt", np.array(rows))
    return seq, {}


def fx_boreas(root, monkeypatch):
    seq = root / "boreas-2021"
    (seq / "lidar").mkdir(parents=True)
    (seq / "applanix").mkdir(parents=True)
    rng = np.random.default_rng(3)
    for i in range(2):
        rng.uniform(-40, 40, (256, 6)).astype(np.float32).tofile(seq / "lidar" / f"{i}.bin")
    hdr = "t,x,y,z,vx,vy,vz,r,p,y,wz,wy,wx"
    rows = [[i, i * 1.0, 0, 0, 0, 0, 0, 0.0, 0.0, 0.1 * i, 0, 0, 0] for i in range(2)]
    np.savetxt(seq / "applanix" / "lidar_poses.csv", np.array(rows), delimiter=",",
               header=hdr, comments="")
    return seq, {}


def fx_nclt(root, monkeypatch):
    """test_nclt_scan_decode's int16 scaling, as a sequence with ground
    truth; the first and last scans lie outside its time span."""
    seq = root / "2012-01-08"
    (seq / "velodyne_sync").mkdir(parents=True)
    (root / "ground_truth").mkdir()
    rng = np.random.default_rng(9)
    for stamp in (1000, 2000, 3000, 4000, 9000):
        pts = rng.uniform(-40, 40, (300, 3))
        enc = np.stack([np.round((pts[:, 0] + 100.0) / 0.005), np.round((-pts[:, 1] + 100.0) / 0.005),
                        np.round((-pts[:, 2] + 100.0) / 0.005), np.zeros(300)], 1).astype(np.int16)
        enc.ravel().tofile(seq / "velodyne_sync" / f"{stamp}.bin")
    t = np.linspace(1500, 8000, 9)
    gt = np.stack([t, 0.1 * t, -0.02 * t, np.zeros(9), 0.01 * np.arange(9), np.zeros(9),
                   0.05 * np.arange(9)], 1)
    np.savetxt(root / "ground_truth" / "groundtruth_2012-01-08.csv", gt, delimiter=",")
    return seq, {}


def fx_helipr_ouster(root, monkeypatch):
    _write_helipr_ouster(root, np.random.default_rng(4), 500)
    return root, {"sequence": "Ouster"}


def fx_helipr_avia(root, monkeypatch):
    scan_dir, gt_dir = root / "LiDAR" / "Avia", root / "LiDAR_GT"
    scan_dir.mkdir(parents=True)
    gt_dir.mkdir(parents=True)
    rng = np.random.default_rng(8)
    n = 300
    xyz = rng.uniform(-40, 40, (n, 3)).astype(np.float32)
    stamps = (np.arange(n) * 100).astype(np.uint32)
    with open(scan_dir / "2000000000.bin", "wb") as f:
        for i in range(n):
            f.write(struct.pack("=fffBBBL", *xyz[i], 1, 2, 3, int(stamps[i])))
    q = Rotation.identity().as_quat()
    np.savetxt(gt_dir / "global_Avia_gt.txt",
               np.array([[2000000000, 0, 0, 0, q[0], q[1], q[2], q[3]]]))
    return root, {"sequence": "Avia"}


def fx_helipr_aeva(root, monkeypatch):
    _write_helipr_aeva(root, np.random.default_rng(12))
    return root, {"sequence": "Aeva"}


def fx_helipr_velodyne(root, monkeypatch):
    rng = np.random.default_rng(14)
    clouds = [rng.uniform(-40, 40, (400, 3)) for _ in range(2)]
    stamps = [np.sort(rng.uniform(0, 0.1, 400)).astype(np.float32) for _ in range(2)]
    poses = np.tile(np.eye(4), (2, 1, 1))
    poses[1, :3, 3] = [1.0, 0.2, 0.0]
    _write_helipr_velodyne(root, clouds, stamps, poses)
    return root, {"sequence": "Velodyne"}


def fx_kitti_raw(root, monkeypatch):
    rng = np.random.default_rng(7)
    n = 2048
    scans, oxts = [], []
    for i in range(3):
        scan = np.zeros((n, 4), np.float32)
        scan[:, :3] = rng.uniform(-40, 40, (n, 3))
        scans.append(scan)
        vals = np.zeros(30)
        vals[0], vals[1], vals[2], vals[5] = 49.0 + i * 1e-5, 8.43, 110.0, 0.02 * i
        oxts.append(vals)
    (root / "2011_10_03").mkdir()
    rot = Rotation.from_euler("zyx", [0.01, -0.02, 0.005]).as_matrix()
    _write_kitti_raw(root, scans, oxts, rot, [-0.8086759, 0.3195559, -0.7997231])
    return root, {"sequence": "00"}


def fx_tum(root, monkeypatch):
    from PIL import Image

    seq = root / "rgbd_dataset_freiburg1_xyz"
    (seq / "depth").mkdir(parents=True)
    depth = np.zeros((480, 640), np.uint16)
    depth[240, 320] = 2 * 5000
    depth[100, 50] = 10000
    depth[5, 5] = 5 * 5000
    for t in ["1305031102.160407", "1305031102.194330"]:
        Image.fromarray(depth).save(seq / "depth" / f"{t}.png")
        with (seq / "depth.txt").open("a") as f:
            f.write(f"{t} depth/{t}.png\n")
    q = Rotation.from_euler("z", 0.1).as_quat()
    with (seq / "groundtruth.txt").open("w") as f:
        f.write(f"1305031102.1600 1.0 2.0 3.0 {q[0]} {q[1]} {q[2]} {q[3]}\n")
        f.write(f"1305031102.1950 1.5 2.0 3.0 {q[0]} {q[1]} {q[2]} {q[3]}\n")
    return seq, {}


def fx_rosbag(root, monkeypatch):
    rng = np.random.default_rng(11)
    clouds = [rng.uniform(-20, 20, (256, 3)).astype(np.float32) for _ in range(3)]
    _fake_rosbags(monkeypatch, [_PC2Msg(p) for p in clouds])
    return root / "drive.bag", {}


def fx_mcap(root, monkeypatch):
    rng = np.random.default_rng(13)
    clouds = [rng.uniform(-15, 15, (128, 3)).astype(np.float32) for _ in range(2)]
    _fake_mcap(monkeypatch, [_PC2Msg(p) for p in clouds])
    path = root / "drive.mcap"
    path.write_bytes(b"\x89MCAP0\r\n")
    return path, {}


def fx_ouster(root, monkeypatch):
    h, w = 4, 16
    rng = np.random.default_rng(17)
    ranges = rng.integers(1000, 60000, size=(2, h, w)).astype(np.uint32)
    ranges[0, 0, 0] = 0
    ranges[1, 2, 5] = 0
    dirs = rng.normal(size=(h * w, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return _write_ouster(root, monkeypatch, ranges, dirs), {}


def fx_nuscenes(root, monkeypatch):
    rng = np.random.default_rng(19)
    clouds = [rng.uniform(-30, 30, (300, 3)).astype(np.float32) for _ in range(3)]
    q = Rotation.from_euler("z", 0.05).as_quat()
    _write_nuscenes(root, monkeypatch, clouds, [q] * 3, [[2.0 * i, 0.0, 0.0] for i in range(3)])
    return root, {"sequence": 1}


FIXTURES = {
    "mulran": fx_mulran, "ncd": fx_ncd, "apollo": fx_apollo, "boreas": fx_boreas,
    "nclt": fx_nclt, "helipr/Ouster": fx_helipr_ouster, "helipr/Avia": fx_helipr_avia,
    "helipr/Aeva": fx_helipr_aeva, "helipr/Velodyne": fx_helipr_velodyne,
    "kitti_raw": fx_kitti_raw, "tum": fx_tum, "rosbag": fx_rosbag, "mcap": fx_mcap,
    "ouster": fx_ouster, "nuscenes": fx_nuscenes,
}


def _unpack(item):
    return item if isinstance(item, tuple) else (item, None)


def _assert_same_arrays(a, b, what):
    assert type(a) is type(b), what
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


def _assert_loaders_equal(ds, jds):
    assert type(ds).__module__.startswith("kiss_icp_tpu_torch.datasets.")
    assert type(ds).__name__ == type(jds).__name__
    assert len(ds) == len(jds) > 0
    assert getattr(ds, "sequence_id", None) == getattr(jds, "sequence_id", None)
    for i in range(len(ds)):
        item, jitem = ds[i], jds[i]
        assert isinstance(item, tuple) == isinstance(jitem, tuple)
        for a, b, what in zip(_unpack(item), _unpack(jitem), ("points", "stamps")):
            _assert_same_arrays(a, b, f"frame {i} {what}")
    assert hasattr(ds, "gt_poses") == hasattr(jds, "gt_poses")
    if hasattr(jds, "gt_poses"):
        _assert_same_arrays(ds.gt_poses, jds.gt_poses, "gt_poses")
        if hasattr(jds, "apply_calibration"):
            _assert_same_arrays(ds.apply_calibration(ds.gt_poses),
                                jds.apply_calibration(jds.gt_poses), "apply_calibration")
    assert hasattr(ds, "apply_calibration") == hasattr(jds, "apply_calibration")
    assert hasattr(ds, "get_frames_timestamps") == hasattr(jds, "get_frames_timestamps")
    if hasattr(jds, "get_frames_timestamps"):
        _assert_same_arrays(ds.get_frames_timestamps(), jds.get_frames_timestamps(), "frame stamps")


@pytest.mark.parametrize("case", list(FIXTURES))
def test_loader_bit_equal_to_jax(case, tmp_path, monkeypatch):
    """Scans, stamps, ground truth and calibration bit for bit, through
    both registries."""
    name = case.split("/")[0]
    data, kw = FIXTURES[case](tmp_path, monkeypatch)
    ds = datasets.dataset_factory(name, data, topic=None, meta=None, **kw)
    jds = jdatasets.dataset_factory(name, data, topic=None, meta=None, **kw)
    _assert_loaders_equal(ds, jds)


def test_loader_specifics_as_jax(tmp_path, monkeypatch):
    """The JAX tests' own checks, on the port: mulran's broken cloud has no
    stamps, apollo sorts naturally, helipr rejects an unknown LiDAR, the
    rosbag topic is validated, nuScenes names a missing scene, the helipr
    record sizes follow the reference's struct formats."""
    from kiss_icp_tpu_torch.datasets import helipr as hp
    from kiss_icp_tpu_torch.datasets.apollo import ApolloDataset
    from kiss_icp_tpu_torch.datasets.mulran import MulranDataset
    from kiss_icp_tpu_torch.datasets.nuscenes import NuScenesDataset
    from kiss_icp_tpu_torch.datasets.rosbag import RosbagDataset

    seq, _ = fx_mulran(tmp_path / "m", monkeypatch)
    assert len(MulranDataset(seq)[2][1]) == 0
    seq, _ = fx_apollo(tmp_path / "a", monkeypatch)
    assert ApolloDataset(seq).scan_files[2].endswith("10.pcd")
    with pytest.raises(ValueError, match="Unsupported HeLiPR"):
        hp.HeLiPRDataset(tmp_path, "Livox2")
    for layout, fmt in (("Avia", "=fffBBBL"), ("Ouster", "=ffffIHHH"), ("Velodyne", "=ffffHf"),
                        ("Aeva", "=ffffflBf")):
        assert np.dtype(hp._LAYOUTS[layout]["dtype"]).itemsize == struct.calcsize(fmt)
    assert np.dtype(hp._LAYOUTS["Aeva"]["dtype_no_intensity"]).itemsize == \
        struct.calcsize("=ffffflB")
    _fake_rosbags(monkeypatch, [], topics=("/a", "/b"))
    with pytest.raises(ValueError, match="ambiguous"):
        RosbagDataset(tmp_path / "two_topics.bag")
    assert RosbagDataset(tmp_path / "two_topics.bag", topic="/b").topic == "/b"
    with pytest.raises(ValueError, match="invalid topic"):
        RosbagDataset(tmp_path / "two_topics.bag", topic="/tf")
    (tmp_path / "n").mkdir()
    root, _ = fx_nuscenes(tmp_path / "n", monkeypatch)
    with pytest.raises(ValueError, match="not found"):
        NuScenesDataset(root, 777)


@pytest.mark.parametrize("name", GATED)
def test_gated_loader_raises_importerror_without_its_library(name, tmp_path):
    for factory in (datasets.dataset_factory, jdatasets.dataset_factory):
        with pytest.raises(ImportError):
            factory(name, tmp_path / "x", sequence="0", topic=None, meta=None)


# ----------------------------------------------------------- PointCloud2
def _pc2_cases():
    rng = np.random.default_rng(5)
    pts = rng.uniform(-10, 10, (64, 3)).astype(np.float32)
    nan_pts = np.array([[1, 2, 3], [np.nan, 0, 0], [4, 5, 6]], dtype=np.float32)
    f_stamps = np.sort(rng.uniform(0.0, 0.1, 64)).astype(np.float32)
    return {
        # tests/test_datasets_extended.py:217-235
        "u32 stamps": _PC2Msg(pts, np.arange(64, dtype=np.uint32)),
        "NaN row, no stamps": _PC2Msg(nan_pts),
        "big-endian, f32 stamps and a NaN": _PC2Msg(
            np.concatenate([pts, nan_pts]), np.concatenate([f_stamps, [0.2, 0.3, 0.4]]).astype(
                np.float32), stamp_dtype="f4", bigendian=True),
        "intensity, no stamp field": _PC2Msg(pts, extra=rng.uniform(0, 1, 64).astype(np.float32)),
        "constant stamps": _PC2Msg(pts, np.full(64, 7, np.uint32)),
    }


@pytest.mark.parametrize("case", list(_pc2_cases()))
def test_read_point_cloud_equals_jax(case):
    msg = _pc2_cases()[case]
    (p, t), (jp, jt) = point_cloud2.read_point_cloud(msg), jpc2.read_point_cloud(msg)
    _assert_same_arrays(p, jp, "points")
    _assert_same_arrays(t, jt, "stamps")
    assert p.dtype == np.float64 and p.shape[1] == 3 and np.all(np.isfinite(p))
    if len(t):
        assert t.min() == 0.0 and t.max() in (0.0, 1.0)
    assert point_cloud2.TIME_FIELD_NAMES == jpc2.TIME_FIELD_NAMES


def test_read_point_cloud_big_endian_decodes_values():
    pts = np.array([[1.5, -2.0, 3.25], [4.0, 5.0, -6.5]], np.float32)
    p, t = point_cloud2.read_point_cloud(
        _PC2Msg(pts, np.array([0.25, 0.75], np.float32), stamp_dtype="f4", bigendian=True))
    np.testing.assert_array_equal(p, pts.astype(np.float64))
    np.testing.assert_array_equal(t, [0.0, 1.0])


# -------------------------------------------------- the CLI per family
CLI_CONFIG = {
    "data": {"max_range": 50.0, "min_range": 0.5},
    "mapping": {"voxel_size": 0.5},
    "engine": {"max_points_per_frame": 2048, "frame_capacity": 2048, "source_capacity": 1024,
               "map_capacity_log2": 15},
    "registration": {"max_num_iterations": 20},
}


def _synthetic(n=3):
    """3 frames of a 16 x 128-beam procedural LiDAR: at most 2048 points a
    frame, with per-point stamps and ground truth."""
    ds = SyntheticDataset(sequence=1, n_scans=n, n_beams=16, n_azimuth=128, max_range=50.0,
                          accel_frames=3)
    frames = [ds[i] for i in range(n)]
    assert all(len(p) <= 2048 for p, _ in frames)
    return frames, ds.gt_poses


def cli_kitti_raw(root, monkeypatch, frames, poses):
    scans = []
    for pts, _ in frames:
        scan = np.zeros((len(pts), 4), np.float32)
        scan[:, :3] = pts
        scans.append(scan)
    oxts = []
    for i, p in enumerate(poses):
        vals = np.zeros(30)
        vals[0], vals[1], vals[2] = 49.0 + p[0, 3] * 9e-6, 8.43 + p[1, 3] * 1.4e-5, 110.0
        oxts.append(vals)
    (root / "2011_10_03").mkdir()
    _write_kitti_raw(root, scans, oxts, np.eye(3), [0.0, 0.0, 0.0])
    return root, ["--sequence", "00"]


def cli_mulran(root, monkeypatch, frames, poses):
    seq = root / "KAIST02"
    (seq / "Ouster").mkdir(parents=True)
    rows = []
    for i, ((pts, _), pose) in enumerate(zip(frames, poses)):
        scan = np.zeros((len(pts), 4), np.float32)
        scan[:, :3] = pts
        stamp = 1_000_000_000 + 100_000_000 * i
        scan.tofile(seq / "Ouster" / f"{stamp}.bin")
        rows.append([stamp, *pose[:3].ravel()])
    np.savetxt(seq / "global_pose.csv", np.array(rows), delimiter=",")
    return seq, []


def cli_ncd(root, monkeypatch, frames, poses):
    seq = root / "quad"
    scans, gt_dir = seq / "raw_format" / "ouster_scan", seq / "ground_truth"
    scans.mkdir(parents=True)
    gt_dir.mkdir(parents=True)
    rows = []
    for i, ((pts, _), pose) in enumerate(zip(frames, poses)):
        _write_pcd(scans / f"cloud_{1583836591 + i}_0.pcd", pts.astype(np.float32))
        rows.append([1583836591 + i, 0, *pose[:3, 3], *Rotation.from_matrix(pose[:3, :3]).as_quat()])
    np.savetxt(gt_dir / "registered_poses.csv", np.array(rows), delimiter=",")
    return seq, []


def cli_nclt(root, monkeypatch, frames, poses):
    seq = root / "2013-01-10"
    (seq / "velodyne_sync").mkdir(parents=True)
    (root / "ground_truth").mkdir()
    for i, (pts, _) in enumerate(frames):
        enc = np.stack([np.round((pts[:, 0] + 100.0) / 0.005), np.round((-pts[:, 1] + 100.0) / 0.005),
                        np.round((-pts[:, 2] + 100.0) / 0.005), np.zeros(len(pts))], 1)
        enc.astype(np.int16).ravel().tofile(seq / "velodyne_sync" / f"{1000 * (i + 1)}.bin")
    t = np.array([0.0, 1000.0, 2000.0, 3000.0, 4000.0])
    idx = [0, 0, 1, 2, 2]
    gt = np.stack([t, *(poses[idx, j, 3] for j in range(3)), np.zeros(5), np.zeros(5),
                   np.zeros(5)], 1)
    np.savetxt(root / "ground_truth" / "groundtruth_2013-01-10.csv", gt, delimiter=",")
    return seq, []


def cli_nuscenes(root, monkeypatch, frames, poses):
    qs = [Rotation.from_matrix(p[:3, :3]).as_quat() for p in poses]
    _write_nuscenes(root, monkeypatch, [p.astype(np.float32) for p, _ in frames], qs,
                    [p[:3, 3] for p in poses])
    return root, ["--sequence", "1"]


def cli_apollo(root, monkeypatch, frames, poses):
    seq = root / "session2"
    (seq / "pcds").mkdir(parents=True)
    (seq / "poses").mkdir(parents=True)
    rows = []
    for i, ((pts, _), pose) in enumerate(zip(frames, poses)):
        _write_pcd(seq / "pcds" / f"{i + 1}.pcd", pts.astype(np.float32))
        rows.append([i, 1000.0 + i, *pose[:3, 3], *Rotation.from_matrix(pose[:3, :3]).as_quat()])
    np.savetxt(seq / "poses" / "gt_poses.txt", np.array(rows))
    return seq, []


def cli_boreas(root, monkeypatch, frames, poses):
    seq = root / "boreas-2022"
    (seq / "lidar").mkdir(parents=True)
    (seq / "applanix").mkdir(parents=True)
    for i, (pts, _) in enumerate(frames):
        scan = np.zeros((len(pts), 6), np.float32)
        scan[:, :3] = pts
        scan.tofile(seq / "lidar" / f"{i}.bin")
    rows = [[i, *p[:3, 3], 0, 0, 0, 0.0, 0.0, 0.0, 0, 0, 0] for i, p in enumerate(poses)]
    np.savetxt(seq / "applanix" / "lidar_poses.csv", np.array(rows), delimiter=",",
               header="t,x,y,z,vx,vy,vz,r,p,y,wz,wy,wx", comments="")
    return seq, []


def cli_tum(root, monkeypatch, frames, poses):
    """Depth PNGs of a tilted plane seen from a camera that slides 5 cm a
    frame, on a 40 x 30 pixel grid (1200 points)."""
    from PIL import Image

    seq = root / "rgbd_dataset_freiburg1_desk"
    (seq / "depth").mkdir(parents=True)
    v, u = np.mgrid[8:480:16, 8:640:16]
    gt = []
    for i in range(len(frames)):
        depth = np.zeros((480, 640), np.uint16)
        z = 2.0 + 0.002 * (u - 320) + 0.001 * (v - 240) + 0.05 * i + 0.2 * np.sin(u / 40.0)
        depth[v, u] = np.round(z * 5000).astype(np.uint16)
        stamp = f"{1305031102.0 + 0.033 * i:.6f}"
        Image.fromarray(depth).save(seq / "depth" / f"{stamp}.png")
        with (seq / "depth.txt").open("a") as f:
            f.write(f"{stamp} depth/{stamp}.png\n")
        gt.append(f"{stamp} 0.0 0.0 {0.05 * i} 0 0 0 1\n")
    (seq / "groundtruth.txt").write_text("".join(gt))
    return seq, []


def cli_helipr(root, monkeypatch, frames, poses):
    _write_helipr_velodyne(root, [p for p, _ in frames],
                           [(0.1 * t).astype(np.float32) for _, t in frames], poses)
    return root, ["--sequence", "Velodyne"]


def cli_rosbag(root, monkeypatch, frames, poses):
    _fake_rosbags(monkeypatch, [_PC2Msg(p.astype(np.float32), t.astype(np.float32), "f4")
                                for p, t in frames])
    return root / "drive.bag", []


def cli_mcap(root, monkeypatch, frames, poses):
    _fake_mcap(monkeypatch, [_PC2Msg(p.astype(np.float32), t.astype(np.float32), "f4")
                             for p, t in frames])
    path = root / "drive.mcap"
    path.write_bytes(b"\x89MCAP0\r\n")
    return path, []


def cli_ouster(root, monkeypatch, frames, poses):
    """A 16 x 128 range image per frame: each frame's points along one fixed
    table of directions (the first frame's), their ranges in mm."""
    h, w = 16, 128
    pts0 = frames[0][0]
    dirs = np.zeros((h * w, 3))
    dirs[:, 0] = 1.0
    dirs[: len(pts0)] = pts0 / np.linalg.norm(pts0, axis=1, keepdims=True)
    ranges = np.zeros((len(frames), h * w), np.uint32)
    for i, (pts, _) in enumerate(frames):
        k = min(len(pts), len(pts0))
        ranges[i, :k] = np.round(np.linalg.norm(pts[:k], axis=1) * 1000.0)
    return _write_ouster(root, monkeypatch, ranges.reshape(-1, h, w), dirs), []


CLI_WRITERS = {
    "kitti_raw": cli_kitti_raw, "mulran": cli_mulran, "ncd": cli_ncd, "nclt": cli_nclt,
    "nuscenes": cli_nuscenes, "apollo": cli_apollo, "boreas": cli_boreas, "tum": cli_tum,
    "helipr": cli_helipr, "rosbag": cli_rosbag, "mcap": cli_mcap, "ouster": cli_ouster,
}


def test_cli_writers_cover_every_family():
    assert sorted(CLI_WRITERS) == sorted(FAMILIES)
    assert sorted(FAMILIES + ["generic", "kitti", "synthetic"]) == datasets.available_dataloaders()


@pytest.mark.parametrize("name", FAMILIES)
def test_cli_runs_family_on_cpu(name, tmp_path, monkeypatch):
    """The port's CLI over a 3-frame fixture of the family: exit 0, one pose
    a frame, and the poses of KissICP on the CPU fed the JAX loader's
    arrays, within 1e-6 m."""
    frames, poses = _synthetic()
    data_root = tmp_path / "data"
    data_root.mkdir()
    data, flags = CLI_WRITERS[name](data_root, monkeypatch, frames, poses)
    out = tmp_path / "results"
    cfg_file = tmp_path / "cli.yml"
    cfg_file.write_text(yaml.safe_dump(dict(CLI_CONFIG, out_dir=str(out))))
    monkeypatch.chdir(tmp_path)
    assert cmd.main([str(data), "--dataloader", name, "--config", str(cfg_file),
                     "--device", "cpu", *flags]) == 0
    written = list((out / "latest").glob("*_poses.npy"))
    assert len(written) == 1
    got = np.load(written[0])

    seq = flags[1] if flags else None
    jds = jdatasets.dataset_factory(name, data, sequence=seq, topic=None, meta=None)
    assert got.shape == (len(jds), 4, 4) and len(jds) == 3
    icp = KissICP(load_config(cfg_file), device="cpu")
    ref = []
    for i in range(len(jds)):
        pts, stamps = _unpack(jds[i])
        assert 0 < len(pts) <= 2048
        icp.register_frame(pts, stamps)
        ref.append(icp.last_pose)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, np.stack(ref), rtol=0, atol=1e-6)
    assert (out / "latest" / "result_metrics.log").exists()
