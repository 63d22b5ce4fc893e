"""The port's cloud readers (kiss_icp_tpu_torch/io/cloud_io.py) and
`checkpoint.save_state`: the twin of tests/test_io.py, on its files.

Round trips through synthetic files, and the error paths: NaN points
removed, a truncated PCD header and garbage raise, a PLY whose first element
is not `vertex` raises, the mesh extensions are gated on trimesh, and
`save_state` writes exactly the path it is given. On every file, JAX's
reader (kiss_icp_tpu/io/cloud_io.py) raises the same exception type or
returns the same arrays.
"""

import jax
import numpy as np
import pytest
import torch

from kiss_icp_tpu import datasets as jdatasets
from kiss_icp_tpu import odometry as jodo
from kiss_icp_tpu.config.schema import KISSConfig as JaxConfig
from kiss_icp_tpu.io import checkpoint as jcheckpoint
from kiss_icp_tpu.io import cloud_io as jcloud_io
from kiss_icp_tpu_torch import convert, datasets, odometry
from kiss_icp_tpu_torch.config.schema import KISSConfig
from kiss_icp_tpu_torch.io import checkpoint, cloud_io

torch.set_num_threads(1)


def _points(n=100, seed=0):
    return np.random.default_rng(seed).uniform(-50, 50, (n, 3))


def _read(name, path):
    """The port's reader `name` on `path`, held to JAX's: the same arrays."""
    pts, ts = getattr(cloud_io, name)(path)
    jpts, jts = getattr(jcloud_io, name)(path)
    np.testing.assert_array_equal(pts, jpts)
    assert pts.dtype == jpts.dtype
    assert (ts is None) == (jts is None)
    if ts is not None:
        np.testing.assert_array_equal(ts, jts)
    return pts, ts


def _raises(name, path, exc, match=None):
    """The port's reader and JAX's raise `exc` (matching `match`) on `path`."""
    for module in (cloud_io, jcloud_io):
        with pytest.raises(exc, match=match):
            getattr(module, name)(path)


def test_kitti_bin_roundtrip(tmp_path):
    pts = _points().astype(np.float32)
    raw = np.concatenate([pts, np.ones((len(pts), 1), np.float32)], axis=1)
    f = tmp_path / "000000.bin"
    raw.tofile(f)
    loaded, ts = _read("read_kitti_bin", f)
    np.testing.assert_allclose(loaded, pts, atol=1e-6)
    assert ts is None


def test_ply_binary_roundtrip(tmp_path):
    pts = _points(seed=1).astype(np.float32)
    stamps = np.linspace(0, 1, len(pts)).astype(np.float32)
    f = tmp_path / "cloud.ply"
    with open(f, "wb") as fh:
        fh.write(
            b"ply\nformat binary_little_endian 1.0\n"
            + f"element vertex {len(pts)}\n".encode()
            + b"property float x\nproperty float y\nproperty float z\n"
            + b"property float time\nend_header\n"
        )
        rec = np.rec.fromarrays([pts[:, 0], pts[:, 1], pts[:, 2], stamps], names="x,y,z,time")
        fh.write(rec.tobytes())
    loaded, ts = _read("read_ply", f)
    np.testing.assert_allclose(loaded, pts, atol=1e-6)
    np.testing.assert_allclose(ts, stamps, atol=1e-6)


def test_ply_ascii(tmp_path):
    pts = _points(10, seed=2)
    f = tmp_path / "cloud.ply"
    lines = ["ply", "format ascii 1.0", f"element vertex {len(pts)}",
             "property double x", "property double y", "property double z",
             "end_header"]
    lines += [" ".join(map(str, p)) for p in pts]
    f.write_text("\n".join(lines) + "\n")
    loaded, ts = _read("read_ply", f)
    np.testing.assert_allclose(loaded, pts, atol=1e-9)
    assert ts is None


def test_pcd_binary_roundtrip(tmp_path):
    pts = _points(seed=3).astype(np.float32)
    ts_field = np.arange(len(pts), dtype=np.uint32)
    f = tmp_path / "cloud.pcd"
    header = (
        "# .PCD v0.7\nVERSION 0.7\nFIELDS x y z t\nSIZE 4 4 4 4\nTYPE F F F U\n"
        f"COUNT 1 1 1 1\nWIDTH {len(pts)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {len(pts)}\nDATA binary\n"
    )
    rec = np.rec.fromarrays([pts[:, 0], pts[:, 1], pts[:, 2], ts_field], names="x,y,z,t",
                            formats="<f4,<f4,<f4,<u4")
    with open(f, "wb") as fh:
        fh.write(header.encode())
        fh.write(rec.tobytes())
    loaded, ts = _read("read_pcd", f)
    np.testing.assert_allclose(loaded, pts, atol=1e-6)
    np.testing.assert_allclose(ts, ts_field)


def test_pcd_ascii(tmp_path):
    pts = _points(8, seed=4)
    f = tmp_path / "cloud.pcd"
    header = (
        "VERSION 0.7\nFIELDS x y z\nSIZE 8 8 8\nTYPE F F F\nCOUNT 1 1 1\n"
        f"WIDTH {len(pts)}\nHEIGHT 1\nPOINTS {len(pts)}\nDATA ascii\n"
    )
    body = "\n".join(" ".join(map(str, p)) for p in pts)
    f.write_text(header + body + "\n")
    loaded, _ = _read("read_pcd", f)
    np.testing.assert_allclose(loaded, pts, atol=1e-9)


def test_nan_points_removed(tmp_path):
    pts = _points(10, seed=5)
    pts[3] = np.nan
    f = tmp_path / "cloud.xyz"
    np.savetxt(f, pts)
    loaded, _ = _read("read_point_cloud", f)
    assert len(loaded) == 9
    assert np.all(np.isfinite(loaded))


def test_natural_sort():
    names = ["scan_10.bin", "scan_2.bin", "scan_1.bin"]
    assert cloud_io.natural_sort(names) == ["scan_1.bin", "scan_2.bin", "scan_10.bin"]
    assert cloud_io.natural_sort(names) == jcloud_io.natural_sort(names)


def test_pcd_truncated_header_raises(tmp_path):
    """EOF before the DATA line raises instead of looping forever."""
    p = tmp_path / "bad.pcd"
    p.write_bytes(b"# .PCD v0.7\nVERSION 0.7\nFIELDS x y z\n")
    _raises("read_pcd", p, ValueError, "unterminated")
    q = tmp_path / "not_a.pcd"
    q.write_bytes(b"\x00\x01\x02garbage")
    _raises("read_pcd", q, ValueError)


def test_ply_non_vertex_first_raises(tmp_path):
    """Vertex data is parsed from body offset 0; a preceding element would
    silently decode garbage, so it raises."""
    p = tmp_path / "edgefirst.ply"
    p.write_bytes(
        b"ply\nformat binary_little_endian 1.0\n"
        b"element edge 2\nproperty int v1\nproperty int v2\n"
        b"element vertex 1\nproperty float x\nproperty float y\n"
        b"property float z\nend_header\n" + b"\x00" * 28
    )
    _raises("read_ply", p, ValueError, "precedes")


def test_mesh_extensions_are_gated(tmp_path):
    """obj/off/stl/ctm are supported extensions; without trimesh
    read_point_cloud raises a clean ImportError naming it."""
    p = tmp_path / "mesh.stl"
    p.write_bytes(b"solid x\nendsolid x\n")
    assert {"obj", "off", "stl", "ctm"} <= datasets.SUPPORTED_FILE_EXTENSIONS
    assert datasets.SUPPORTED_FILE_EXTENSIONS == jdatasets.SUPPORTED_FILE_EXTENSIONS
    try:
        import trimesh  # noqa: F401
        has_trimesh = True
    except ImportError:
        has_trimesh = False
    if has_trimesh:
        pts, ts = _read("read_point_cloud", p)
        assert pts.shape[1] == 3
    else:
        _raises("read_point_cloud", p, ImportError, "trimesh")


def _save_state_config(cls):
    cfg = cls()
    cfg.mapping.voxel_size = 1.0
    cfg.engine.max_points_per_frame = 256
    cfg.engine.frame_capacity = 256
    cfg.engine.source_capacity = 128
    cfg.engine.map_capacity_log2 = 10
    return cfg


def test_save_state_exact_path(tmp_path):
    """save_state writes EXACTLY the requested path, also without a .npz
    suffix; the port and JAX read it back to the same leaves, and JAX's
    writer keeps the exact path too."""
    cfg, jcfg = _save_state_config(KISSConfig), _save_state_config(JaxConfig)
    state = odometry.init_state(cfg, device="cpu")
    p = tmp_path / "run.state"
    checkpoint.save_state(p, state)
    assert sorted(q.name for q in tmp_path.iterdir()) == ["run.state"]
    leaves = convert.state_to_numpy(state)
    for got in (convert.state_to_numpy(checkpoint.load_checkpoint(p, cfg, "cpu")),
                jax.tree_util.tree_leaves(jcheckpoint.load_checkpoint(p, jcfg))):
        assert len(got) == len(leaves)
        for a, b in zip(got, leaves):
            np.testing.assert_array_equal(np.asarray(a), b)
    jp = tmp_path / "jax.state"
    jcheckpoint.save_state(jp, jodo.init_state(jcfg))
    assert jp.exists() and not (tmp_path / "jax.state.npz").exists()
