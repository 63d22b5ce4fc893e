"""Single-process composition of rclpy nodes.

The reference ships its node as an rclcpp *component*
(ros/src/OdometryServer.cpp:74, registered via
RCLCPP_COMPONENTS_REGISTER_NODE and loadable into a `component_container`
for shared-process, intra-process-communication deployment). rclcpp
containers cannot host Python nodes, so this module provides the rclpy
analog: instantiate the odometry node together with any number of other
rclpy nodes in ONE process on one MultiThreadedExecutor — one DDS
participant, no per-node process overhead, and rmw-level local delivery for
intra-process topics.

Extra nodes are given as `module.path:factory` specs; each factory is called
with no arguments and must return an rclpy Node (the same contract as a
component's constructor):

    python -m kiss_icp_tpu_torch.ros.container my_pkg.viz:make_node
"""

from __future__ import annotations

import importlib
import re
import sys

# STRICT spec shape: dotted python module path ':' python identifier. ROS
# CLI tokens must never match — remaps/params look like 'name:=value'
# ('__node:=x', 'topic:=/points'), which ':=' rules out, and '--ros-args'
# starts with '-'.
_SPEC_RE = re.compile(
    r"^[A-Za-z_][A-Za-z0-9_]*(\.[A-Za-z_][A-Za-z0-9_]*)*"
    r":[A-Za-z_][A-Za-z0-9_]*$"
)


def split_specs(argv):
    """(node factory specs, remaining ROS args). A single argv element may
    carry several whitespace-separated specs (launch passes the
    `extra_nodes` argument as ONE token)."""
    specs, ros_args = [], []
    for a in argv:
        if not a.strip():
            continue  # launch passes extra_nodes:="" as one empty token
        parts = a.split()
        if parts and all(_SPEC_RE.match(p) for p in parts):
            specs.extend(parts)
        else:
            ros_args.append(a)
    return specs, ros_args


def _resolve(spec: str):
    """`module.path:callable` -> node factory."""
    module_name, _, attr = spec.partition(":")
    if not attr:
        raise ValueError(
            f"node spec {spec!r} must look like 'module.path:factory'"
        )
    module = importlib.import_module(module_name)
    return getattr(module, attr)


def main(args=None):
    import rclpy
    from rclpy.executors import MultiThreadedExecutor

    from kiss_icp_tpu_torch.ros.odometry_server import get_node_class

    specs, ros_args = split_specs(args if args is not None else sys.argv[1:])

    rclpy.init(args=ros_args or None)
    nodes = [get_node_class()()]
    for spec in specs:
        nodes.append(_resolve(spec)())

    executor = MultiThreadedExecutor()
    for node in nodes:
        executor.add_node(node)
    try:
        executor.spin()
    finally:
        for node in nodes:
            if hasattr(node, "save_checkpoint_if_configured"):
                node.save_checkpoint_if_configured()
            node.destroy_node()
        rclpy.shutdown()


if __name__ == "__main__":  # pragma: no cover
    main()
