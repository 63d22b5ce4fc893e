"""The port's pod program over two processes: the twin of
tests/test_pod_2proc.py.

Two gloo ranks (tests/torch_multihost_worker.py, mode "pod") run the
("seq", "map") pod program of 2 x 4 with "seq" across the processes and
each sequence's 4 map shards in its own process, on tests/pod_worker.py's
scans and config; this process runs the same grid alone. The two-process
poses and iterations, gathered over "seq", equal the one-process ones bit
for bit (JAX's test holds 1e-5 m): the sequences exchange nothing inside a
frame, and each rank runs its rows as the single process does.
"""

import numpy as np
import torch

import torch_multihost_worker as w

torch.set_num_threads(1)

RANK_TIMEOUT_S = 60


def test_two_process_pod_matches_single_process(tmp_path):
    got = w.launch("pod", tmp_path / "pod.npz", RANK_TIMEOUT_S)
    poses, iters = w.pod_run()
    assert poses.shape == (w.POD_BATCH, w.N_FRAMES, 4, 4)
    assert np.all(np.isfinite(poses))
    # Each sequence moves at its own velocity: the rows' poses differ.
    assert len({poses[i, -1, 0, 3] for i in range(w.POD_BATCH)}) == w.POD_BATCH
    np.testing.assert_array_equal(got["poses"], poses)
    np.testing.assert_array_equal(got["iters"], iters)
