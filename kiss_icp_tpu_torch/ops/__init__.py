"""Tensor operations of the odometry step (ports of kiss_icp_tpu/ops)."""
