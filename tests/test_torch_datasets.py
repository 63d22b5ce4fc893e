"""Port loaders, registry and IO (kiss_icp_tpu_torch.datasets, io/cloud_io.py,
io/native.py) against the JAX package's.

  * the registry: the same 15 names, sequence, jump and extension lists, the
    same `guess_dataloader` answers; loaders not ported yet raise
    NotImplementedError naming ROADMAP item 11;
  * `generic` and `kitti` on a KITTI tree give arrays bit-equal to JAX's
    loaders (scans, ground truth, calibration, frame stamps), and the cloud
    readers agree on PLY and PCD files;
  * the native decoder, built from native/scan_io.cpp with g++ into the
    test's directory, equals the numpy decode for every format.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from kiss_icp_tpu import datasets as jdatasets
from kiss_icp_tpu.io import cloud_io as jcloud_io
from kiss_icp_tpu.io import native as jnative
from kiss_icp_tpu_torch import datasets
from kiss_icp_tpu_torch.io import cloud_io, native

REPO = Path(__file__).resolve().parent.parent


def test_registry_matches_jax():
    assert datasets.available_dataloaders() == jdatasets.available_dataloaders()
    assert len(datasets.available_dataloaders()) == 15
    assert datasets.jumpable_dataloaders() == jdatasets.jumpable_dataloaders()
    assert datasets.sequence_dataloaders() == jdatasets.sequence_dataloaders()
    assert datasets.supported_file_extensions() == jdatasets.supported_file_extensions()
    assert sorted(datasets.UNPORTED_DATALOADERS + ["generic", "kitti", "synthetic"]) == \
        datasets.available_dataloaders()


@pytest.mark.parametrize("name", datasets.UNPORTED_DATALOADERS)
def test_unported_loader_raises(name, tmp_path):
    with pytest.raises(NotImplementedError, match="item 11"):
        datasets.dataset_factory(name, tmp_path, sequence=0, topic=None, meta=None)


def test_unknown_loader_raises():
    with pytest.raises(ValueError, match="Unknown dataloader"):
        datasets.dataset_factory("nope", "/tmp")


def test_guess_dataloader_matches_jax(tmp_path):
    paths = []
    for name in ("x.bag", "x.pcap", "x.mcap", "metadata.yaml", "x.bin"):
        (tmp_path / name).write_bytes(b"")
        paths.append(tmp_path / name)
    bag = tmp_path / "bagdir"
    bag.mkdir()
    (bag / "metadata.yaml").write_text("rosbag2_bagfile_information: {}")
    kitti_seq = tmp_path / "seq"
    (kitti_seq / "velodyne").mkdir(parents=True)
    empty = tmp_path / "empty"
    empty.mkdir()
    paths += [bag, kitti_seq, empty, tmp_path / "absent"]
    got = [datasets.guess_dataloader(p) for p in paths]
    assert got == [jdatasets.guess_dataloader(p) for p in paths]
    assert got[:4] == ["rosbag", "ouster", "mcap", "rosbag"] and got[5] == "rosbag"


def _make_kitti_tree(root, seq="00", n_scans=3):
    """The JAX package's test tree (tests/test_datasets.py), with a NaN
    point and a truncated record."""
    seq_dir = root / "sequences" / seq
    velo = seq_dir / "velodyne"
    velo.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(n_scans):
        pts = rng.uniform(-40, 40, (256, 4)).astype(np.float32)
        pts[3, 1] = np.nan
        np.concatenate([pts.ravel(), [1.0, 2.0]]).astype(np.float32).tofile(
            velo / f"{i:06d}.bin")
    tr = np.array([[0, -1, 0, 0.1], [0, 0, -1, -0.05], [1, 0, 0, 0.3]], np.float64)
    lines = ["P0: " + " ".join(["1"] * 12), "Tr: " + " ".join(map(str, tr.ravel()))]
    (seq_dir / "calib.txt").write_text("\n".join(lines))
    (seq_dir / "times.txt").write_text("\n".join(str(0.1 * i) for i in range(n_scans)))
    poses_dir = root / "poses"
    poses_dir.mkdir()
    poses = np.tile(np.eye(4)[:3].reshape(1, 12), (n_scans, 1))
    poses[:, 3] = np.arange(n_scans)
    np.savetxt(poses_dir / f"{seq}.txt", poses)
    return root


def test_kitti_loader_bit_equal_to_jax(tmp_path):
    _make_kitti_tree(tmp_path)
    ds = datasets.dataset_factory("kitti", tmp_path, sequence="0", topic=None, meta=None)
    jds = jdatasets.dataset_factory("kitti", tmp_path, sequence="0", topic=None, meta=None)
    assert len(ds) == len(jds) == 3 and ds.sequence_id == jds.sequence_id == "00"
    for i in range(3):
        (f, t), (jf, jt) = ds[i], jds[i]
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(t, jt)
        assert f.shape == (255, 3)  # the NaN point and the partial record dropped
    np.testing.assert_array_equal(ds.gt_poses, jds.gt_poses)
    np.testing.assert_array_equal(ds.apply_calibration(ds.gt_poses),
                                  jds.apply_calibration(jds.gt_poses))
    np.testing.assert_array_equal(ds.get_frames_timestamps(), jds.get_frames_timestamps())


def test_generic_loader_bit_equal_to_jax(tmp_path):
    velo = tmp_path / "scans"
    velo.mkdir()
    rng = np.random.default_rng(2)
    for i in (10, 2, 1):  # natural sorting: 2 before 10
        pts = rng.uniform(-10, 10, (64, 4)).astype(np.float32)
        pts[5, 0] = np.nan
        pts.tofile(velo / f"scan_{i}.bin")
    np.savetxt(velo / "scan_11.xyz", rng.uniform(-10, 10, (20, 3)))
    ds = datasets.dataset_factory("generic", velo)
    jds = jdatasets.dataset_factory("generic", velo)
    assert [p.name for p in ds.scan_files] == [p.name for p in jds.scan_files]
    assert ds.scan_files[1].name == "scan_2.bin" and ds.sequence_id == jds.sequence_id
    for i in range(len(ds)):
        (f, t), (jf, jt) = ds[i], jds[i]
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(t, jt)
    with pytest.raises(FileNotFoundError):
        datasets.dataset_factory("generic", tmp_path / "poses")


def test_cloud_readers_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    n = 50
    xyz = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    t = np.linspace(0, 0.1, n).astype(np.float64)
    rec = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("t", "<f8")])
    rec["x"], rec["y"], rec["z"], rec["t"] = xyz[:, 0], xyz[:, 1], xyz[:, 2], t
    ply = tmp_path / "a.ply"
    header = ("ply\nformat binary_little_endian 1.0\nelement vertex 50\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property double t\nend_header\n")
    ply.write_bytes(header.encode() + rec.tobytes())
    pcd = tmp_path / "b.pcd"
    pcd.write_bytes(("VERSION 0.7\nFIELDS x y z t\nSIZE 4 4 4 8\nTYPE F F F F\n"
                     "COUNT 1 1 1 1\nWIDTH 50\nHEIGHT 1\nPOINTS 50\nDATA binary\n"
                     ).encode() + rec.tobytes())
    xyz_file = tmp_path / "c.xyz"
    np.savetxt(xyz_file, xyz)
    for path in (ply, pcd, xyz_file):
        (p, ts), (jp, jts) = cloud_io.read_point_cloud(path), jcloud_io.read_point_cloud(path)
        np.testing.assert_array_equal(p, jp)
        assert (ts is None) == (jts is None)
        if ts is not None:
            np.testing.assert_array_equal(ts, jts)
    assert cloud_io.natural_sort(["s10", "s2", "S1"]) == jcloud_io.natural_sort(["s10", "s2", "S1"])


@pytest.fixture
def built_native(tmp_path, monkeypatch):
    """The port's native library, built from native/scan_io.cpp into the
    test's directory (as `make native` builds it beside io/native.py)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build native/scan_io.cpp")
    lib = tmp_path / "libkisstpu_native.so"
    subprocess.run([cxx, "-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-o", str(lib),
                    str(REPO / "native" / "scan_io.cpp")], check=True, timeout=300)
    monkeypatch.setattr(native, "_LIB_PATH", str(lib))
    monkeypatch.setattr(native, "_lib", None)
    assert native.available()
    return native


def _scan_files(tmp_path):
    rng = np.random.default_rng(5)
    f4 = rng.uniform(-50, 50, (300, 4)).astype(np.float32)
    f4[7, 2] = np.nan
    f4[9, 0] = 2e30
    p4 = tmp_path / "f4.bin"
    np.concatenate([f4.ravel(), [3.0]]).astype(np.float32).tofile(p4)  # truncated tail
    p6 = tmp_path / "f6.bin"
    rng.uniform(-10, 10, (64, 6)).astype(np.float32).tofile(p6)
    pn = tmp_path / "nclt.bin"
    rng.integers(0, 40000, (100, 4)).astype(np.int16).tofile(pn)
    return {native.FORMAT_F32X4: p4, native.FORMAT_F32X6: p6, native.FORMAT_NCLT: pn}


def test_native_decode_equals_numpy_decode(built_native, tmp_path):
    files = _scan_files(tmp_path)
    for fmt, path in files.items():
        ref = native._numpy_decode(str(path), fmt, 1 << 20)
        np.testing.assert_array_equal(ref, jnative._numpy_decode(str(path), fmt, 1 << 20))
        got = native.read_scan(path, fmt)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 if fmt == native.FORMAT_NCLT
                                   else 0, err_msg=str(fmt))
        assert native.read_scan(path, fmt, capacity=10).shape == (10, 3)
    assert native._numpy_decode(str(files[native.FORMAT_F32X4]), 0, 1 << 20).shape == (298, 3)
    pre = native.ScanPrefetcher([str(files[0])] * 5, native.FORMAT_F32X4, depth=2, threads=2)
    got = list(pre)
    pre.close()
    assert len(got) == 5
    for g in got:
        np.testing.assert_array_equal(g, native.read_scan(files[0], native.FORMAT_F32X4))


def test_kitti_loader_native_equals_numpy(built_native, tmp_path):
    _make_kitti_tree(tmp_path)
    with_lib = datasets.dataset_factory("kitti", tmp_path, sequence="0")[1][0]
    built_native._lib = None
    built_native._LIB_PATH = str(tmp_path / "absent.so")
    assert not built_native.available()
    np.testing.assert_array_equal(with_lib, datasets.dataset_factory(
        "kitti", tmp_path, sequence="0")[1][0])
