"""Datasets of the port (the procedural synthetic LiDAR sequence)."""
