"""The port's quantized (u16 voxel-relative) map storage against its own
f32 layout: the twin of tests/test_quantized_map.py, with its fixtures and
bounds.

The u16 store must (a) round-trip points to within one quantization step
(voxel_size / 65535), (b) return the same nearest neighbours as f32 up to
that step, and (c) leave the closed-loop trajectory within 2e-3 of f32's.
The query goes through K2's wrapper (its plain version here); the closed
loop is tests/torch_properties.py's, which chip_smoke.py's phase
"properties" also runs on the card.
"""

import dataclasses

import numpy as np
import torch

import torch_properties as tp
from kiss_icp_tpu_torch.kernels import nn27
from kiss_icp_tpu_torch.ops import hash_map, voxel

torch.set_num_threads(1)

F32 = hash_map.MapConfig(voxel_size=1.0, max_distance=60.0, capacity_log2=13)
U16 = dataclasses.replace(F32, storage="u16")
EPS = F32.voxel_size / 65535.0  # one quantization step


def _cloud(n=2000, seed=0, scale=30.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-scale, scale, (n, 3)).astype(np.float32))


def _both(pts):
    valid = torch.ones(len(pts), dtype=torch.bool)
    m32, s32 = hash_map.insert(F32, hash_map.create_map(F32), pts, valid)
    m16, s16 = hash_map.insert(U16, hash_map.create_map(U16), pts, valid)
    return m32, s32, m16, s16


def test_encode_decode_roundtrip():
    pts = _cloud()
    keys = voxel.point_to_voxel(pts, U16.voxel_size)
    enc = hash_map.encode_points(U16, pts, keys)
    assert enc.dtype == torch.uint16
    dec = hash_map.decode_points(U16, enc, keys)
    np.testing.assert_allclose(dec.numpy(), pts.numpy(), atol=EPS)
    # Re-encoding a decoded value is a fixpoint (untouched lanes keep bits).
    enc2 = hash_map.encode_points(U16, dec, keys)
    np.testing.assert_array_equal(enc2.view(torch.int16).numpy(), enc.view(torch.int16).numpy())


def test_storage_dtype_and_memory():
    m16 = hash_map.create_map(U16)
    m32 = hash_map.create_map(F32)
    assert m16.points.dtype == torch.uint16
    assert m16.points.nbytes * 2 == m32.points.nbytes


def test_query_matches_f32_within_quantization():
    m32, _, m16, _ = _both(_cloud(3000, seed=1))
    q = _cloud(500, seed=2, scale=28.0)
    qv = torch.ones(500, dtype=torch.bool)
    r32 = nn27.query_nearest(F32, m32, q, qv)
    r16 = nn27.query_nearest(U16, m16, q, qv)

    np.testing.assert_array_equal(r32.found.numpy(), r16.found.numpy())
    f = r32.found.numpy()
    assert f.sum() > 100
    np.testing.assert_allclose(r16.distances.numpy()[f], r32.distances.numpy()[f], atol=1e-3)
    np.testing.assert_allclose(r16.neighbors.numpy()[f], r32.neighbors.numpy()[f], atol=2 * EPS)


def test_insert_counts_match_f32():
    m32, s32, m16, s16 = _both(_cloud(4000, seed=3))
    assert int(s32.num_added_points) == int(s16.num_added_points)
    np.testing.assert_array_equal(m32.counts.numpy(), m16.counts.numpy())


def test_trim_matches_f32():
    m32, _, m16, _ = _both(_cloud(3000, seed=4, scale=80.0))
    occupied = int((m32.counts > 0).sum())
    origin = torch.zeros(3)
    t32 = hash_map.trim(F32, m32, origin)  # in place
    t16 = hash_map.trim(U16, m16, origin)
    kept = t32.counts.numpy() > 0
    np.testing.assert_array_equal(kept, t16.counts.numpy() > 0)
    assert 0 < kept.sum() < occupied


def test_closed_loop_trajectory_parity():
    np.testing.assert_allclose(tp.closed_loop_poses("u16", "cpu"),
                               tp.closed_loop_poses("f32", "cpu"), atol=2e-3)
