"""Self-contained point-cloud file readers (pure numpy).

The reference pulls in open3d / trimesh / PyntCloud for cloud files
(python/kiss_icp/datasets/generic.py:67-151, ncd.py:58-59, tum.py). Those are
heavyweight optional dependencies used only to parse a few simple formats, so
this framework ships its own numpy readers for PLY (ascii +
binary_little_endian), PCD (ascii + binary), KITTI .bin, and whitespace XYZ.

Every reader returns `(points (N,3) float64, timestamps (N,) float64 or None)`;
per-point timestamps are sniffed from fields named t / timestamp / timestamps /
time / stamps (the same set the reference sniffs, generic.py:96-105,
tools/point_cloud2.py:67-73).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np

TIME_FIELD_NAMES = ("t", "timestamp", "timestamps", "time", "stamps")

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def natural_sort(paths) -> List:
    """Sort 'scan_2' before 'scan_10' (replacement for the natsort dep,
    reference generic.py uses natsorted)."""

    def key(p):
        s = str(p)
        return [int(tok) if tok.isdigit() else tok.lower() for tok in re.split(r"(\d+)", s)]

    return sorted(paths, key=key)


def _extract(points_struct: np.ndarray, names) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    fields = {n.lower(): n for n in names}
    if not {"x", "y", "z"} <= set(fields):
        raise ValueError(f"No x/y/z fields in cloud (has: {list(names)})")
    pts = np.stack(
        [points_struct[fields[a]].astype(np.float64) for a in ("x", "y", "z")], axis=1
    )
    ts = None
    for cand in TIME_FIELD_NAMES:
        if cand in fields:
            ts = points_struct[fields[cand]].astype(np.float64)
            break
    finite = np.all(np.isfinite(pts), axis=1)
    if not finite.all():
        pts = pts[finite]
        ts = ts[finite] if ts is not None else None
    return pts, ts


def read_ply(path: Union[str, Path]) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Minimal PLY reader: ascii 1.0 and binary_little_endian 1.0, vertex element."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # list of (name, count, [(prop_name, dtype_str)])
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unterminated PLY header")
            tokens = line.decode("ascii", "replace").split()
            if not tokens or tokens[0] == "comment":
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                cur = (tokens[1], int(tokens[2]), [])
                elements.append(cur)
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    cur[2].append((tokens[-1], None))  # unsupported in fast path
                else:
                    cur[2].append((tokens[2], _PLY_DTYPES[tokens[1]]))
            elif tokens[0] == "end_header":
                break
        body = f.read()

    for name, count, props in elements:
        if name != "vertex":
            # Body parsing below reads from byte offset 0, which is only the
            # vertex data when vertex is the FIRST element; fail loudly
            # instead of silently decoding another element's bytes as
            # coordinates.
            raise ValueError(
                f"{path}: element '{name}' precedes 'vertex' — only "
                "vertex-first PLY layouts are supported"
            )
        if any(dt is None for _, dt in props):
            raise ValueError(f"{path}: list properties in vertex element unsupported")
        if fmt == "ascii":
            text = body.decode("ascii", "replace").split()
            ncol = len(props)
            arr = np.array(text[: count * ncol], dtype=np.float64).reshape(count, ncol)
            struct = {pname: arr[:, i] for i, (pname, _) in enumerate(props)}
            names = [p for p, _ in props]
            rec = np.rec.fromarrays(
                [struct[n] for n in names], names=",".join(names)
            )
            return _extract(rec, names)
        elif fmt == "binary_little_endian":
            dtype = np.dtype([(pname, "<" + dt) for pname, dt in props])
            rec = np.frombuffer(body, dtype=dtype, count=count)
            return _extract(rec, rec.dtype.names)
        else:
            raise ValueError(f"{path}: unsupported PLY format {fmt}")
    raise ValueError(f"{path}: no vertex element")


def read_pcd(path: Union[str, Path]) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Minimal PCD v0.7 reader: ascii and binary DATA, no compression."""
    with open(path, "rb") as f:
        header = {}
        while True:
            raw = f.readline()
            if not raw:  # EOF before a DATA line: truncated / not a PCD
                raise ValueError(f"{path}: unterminated PCD header")
            line = raw.decode("ascii", "replace").strip()
            if line.startswith("#") or not line:
                continue
            key, _, rest = line.partition(" ")
            header[key.upper()] = rest.split()
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"]
        sizes = list(map(int, header["SIZE"]))
        types = header["TYPE"]
        counts = list(map(int, header.get("COUNT", ["1"] * len(fields))))
        n = int(header["POINTS"][0])
        mode = header["DATA"][0]

        np_types = []
        for fname, size, typ, cnt in zip(fields, sizes, types, counts):
            base = {"F": "f", "I": "i", "U": "u"}[typ] + str(size)
            if cnt == 1:
                np_types.append((fname, "<" + base))
            else:
                np_types.append((fname, "<" + base, (cnt,)))
        dtype = np.dtype(np_types)

        if mode == "ascii":
            body = f.read().decode("ascii", "replace")
            flat_names = []
            cols = []
            arr = np.loadtxt(body.splitlines(), dtype=np.float64, ndmin=2)
            i = 0
            for fname, cnt in zip(fields, counts):
                if cnt == 1:
                    flat_names.append(fname)
                    cols.append(arr[:, i])
                i += cnt
            rec = np.rec.fromarrays(cols, names=",".join(flat_names))
            return _extract(rec, flat_names)
        elif mode == "binary":
            rec = np.frombuffer(f.read(), dtype=dtype, count=n)
            names = [nm for nm in rec.dtype.names]
            return _extract(rec, names)
        else:
            raise ValueError(f"{path}: unsupported PCD DATA mode {mode}")


def read_kitti_bin(path: Union[str, Path]) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """KITTI velodyne .bin: float32 (N, 4) [x y z intensity]
    (reference kitti.py:66)."""
    pts = np.fromfile(path, dtype=np.float32).reshape(-1, 4)[:, :3]
    return pts.astype(np.float64), None


def read_xyz(path: Union[str, Path]) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    arr = np.loadtxt(path, dtype=np.float64, ndmin=2)
    pts = arr[:, :3]
    return pts[np.all(np.isfinite(pts), axis=1)], None


def read_mesh(path: Union[str, Path]) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Mesh formats (obj/off/stl/ctm): vertices via trimesh, like the
    reference's reader cascade (generic.py:120-135). Gated optional
    dependency — everything else in this module is pure numpy."""
    try:
        import trimesh
    except ImportError as e:
        raise ImportError(
            f"reading {Path(path).suffix} files requires trimesh "
            "(pip install trimesh)"
        ) from e
    mesh = trimesh.load(str(path), force="mesh")
    pts = np.asarray(mesh.vertices, dtype=np.float64)
    return pts[np.all(np.isfinite(pts), axis=1)], None


_READERS = {
    ".bin": read_kitti_bin,
    ".ply": read_ply,
    ".pcd": read_pcd,
    ".xyz": read_xyz,
    # Mesh formats of the reference's supported set (datasets/__init__.py:
    # 27-37): vertices only, trimesh-gated.
    ".obj": read_mesh,
    ".off": read_mesh,
    ".stl": read_mesh,
    ".ctm": read_mesh,
}


def read_point_cloud(path: Union[str, Path]) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Autodetecting reader (reference generic.py:67-151 reader cascade)."""
    path = Path(path)
    reader = _READERS.get(path.suffix.lower())
    if reader is None:
        raise ValueError(
            f"Unsupported cloud extension '{path.suffix}' "
            f"(supported: {sorted(_READERS)})"
        )
    return reader(path)
