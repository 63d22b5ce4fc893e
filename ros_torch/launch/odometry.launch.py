"""Launch the port's odometry node (+ optional rviz and bag playback).

The launch file of `ros/` for the PyTorch/CUDA engine: one node with topic
remapping and the ROS-level arguments exposed, an rviz instance gated on
`visualize`, and optional `ros2 bag play` of a given bagfile. One more
argument, `device` (default "cuda"), is the torch device the engine runs on;
"cpu" runs the plain PyTorch path, and the node never falls back to it by
itself. Core pipeline parameters load from the package's config/config.yaml
(override with `config_file:=...`).

    ros2 launch kiss_icp_tpu_torch odometry.launch.py topic:=/points
"""

from launch import LaunchDescription
from launch.actions import DeclareLaunchArgument, ExecuteProcess
from launch.conditions import IfCondition
from launch.substitutions import (
    LaunchConfiguration,
    PathJoinSubstitution,
    PythonExpression,
)
from launch_ros.actions import Node
from launch_ros.substitutions import FindPackageShare

PACKAGE = "kiss_icp_tpu_torch"


def generate_launch_description():
    topic = LaunchConfiguration("topic")
    bagfile = LaunchConfiguration("bagfile", default="")
    visualize = LaunchConfiguration("visualize", default="false")

    declared = [
        DeclareLaunchArgument("topic", description="PointCloud2 topic to subscribe"),
        DeclareLaunchArgument("bagfile", default_value="",
                              description="Optional ros2 bag to play"),
        DeclareLaunchArgument("visualize", default_value="false",
                              description="Start rviz + publish debug clouds"),
        DeclareLaunchArgument("base_frame", default_value=""),
        DeclareLaunchArgument("lidar_odom_frame", default_value="odom_lidar"),
        DeclareLaunchArgument("publish_odom_tf", default_value="true"),
        DeclareLaunchArgument("invert_odom_tf", default_value="false"),
        DeclareLaunchArgument("use_sim_time", default_value="true"),
        DeclareLaunchArgument("device", default_value="cuda",
                              description="Torch device of the engine: cuda or cpu"),
        DeclareLaunchArgument(
            "config_file",
            default_value=PathJoinSubstitution(
                [FindPackageShare(PACKAGE), "config", "config.yaml"]
            ),
        ),
    ]

    odometry_node = Node(
        package=PACKAGE,
        executable="kiss_icp_tpu_torch_node",
        name="kiss_icp_tpu_torch_node",
        output="screen",
        remappings=[("pointcloud_topic", topic)],
        parameters=[
            {
                "base_frame": LaunchConfiguration("base_frame"),
                "lidar_odom_frame": LaunchConfiguration("lidar_odom_frame"),
                "publish_odom_tf": LaunchConfiguration("publish_odom_tf"),
                "invert_odom_tf": LaunchConfiguration("invert_odom_tf"),
                "publish_debug_clouds": visualize,
                "use_sim_time": LaunchConfiguration("use_sim_time"),
                "device": LaunchConfiguration("device"),
            },
            LaunchConfiguration("config_file"),
        ],
    )

    rviz_node = Node(
        package="rviz2",
        executable="rviz2",
        output="screen",
        arguments=[
            "-d",
            PathJoinSubstitution([FindPackageShare(PACKAGE), "rviz",
                                  "kiss_icp_tpu_torch.rviz"]),
        ],
        condition=IfCondition(visualize),
    )

    bag_play = ExecuteProcess(
        cmd=["ros2", "bag", "play", bagfile, "--clock", "1000.0"],
        output="screen",
        condition=IfCondition(PythonExpression(["'", bagfile, "' != ''"])),
    )

    return LaunchDescription(declared + [odometry_node, rviz_node, bag_play])
