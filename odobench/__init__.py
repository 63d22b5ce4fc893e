"""The benchmark of kiss_icp_tpu_torch: `python3 -m odobench.run` (see run.py)."""
