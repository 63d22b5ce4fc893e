"""Launch the port's odometry node composed with other rclpy nodes in ONE process.

The composition launch file of `ros/` for the PyTorch/CUDA engine:
`kiss_icp_tpu_torch.ros.container` spins the odometry node plus any
`module.path:factory` node specs on one MultiThreadedExecutor, a single
process and DDS participant. One more argument, `device` (default "cuda"),
is the torch device the engine runs on.

    ros2 launch kiss_icp_tpu_torch composition.launch.py topic:=/points \
        extra_nodes:="my_pkg.monitor:make_node"
"""

from launch import LaunchDescription
from launch.actions import DeclareLaunchArgument
from launch.substitutions import LaunchConfiguration
from launch_ros.actions import Node

PACKAGE = "kiss_icp_tpu_torch"


def generate_launch_description():
    topic = LaunchConfiguration("topic")
    extra_nodes = LaunchConfiguration("extra_nodes", default="")

    declared = [
        DeclareLaunchArgument("topic", description="PointCloud2 topic to subscribe"),
        DeclareLaunchArgument(
            "extra_nodes", default_value="",
            description="Space-separated module.path:factory specs of other "
                        "rclpy nodes to compose into the same process",
        ),
        DeclareLaunchArgument("base_frame", default_value=""),
        DeclareLaunchArgument("lidar_odom_frame", default_value="odom_lidar"),
        DeclareLaunchArgument("publish_odom_tf", default_value="true"),
        DeclareLaunchArgument("use_sim_time", default_value="true"),
        DeclareLaunchArgument("device", default_value="cuda",
                              description="Torch device of the engine: cuda or cpu"),
    ]

    container = Node(
        package=PACKAGE,
        executable="kiss_icp_tpu_torch_container",
        name="kiss_icp_tpu_torch_container",
        output="screen",
        arguments=[extra_nodes],
        parameters=[
            {
                "pointcloud_topic": topic,
                "base_frame": LaunchConfiguration("base_frame"),
                "lidar_odom_frame": LaunchConfiguration("lidar_odom_frame"),
                "publish_odom_tf": LaunchConfiguration("publish_odom_tf"),
                "use_sim_time": LaunchConfiguration("use_sim_time"),
                "device": LaunchConfiguration("device"),
            }
        ],
    )
    return LaunchDescription(declared + [container])
