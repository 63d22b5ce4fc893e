"""ament_python packaging for the ROS 2 node of the PyTorch/CUDA port.

The engine ships in the repository's own wheel (`pip install .[torch]` at the
repository root installs `kiss_icp_tpu_torch` with its CUDA sources); this
colcon package installs the node and container entry points plus the
launch, rviz and config files. It is the port's sibling of `ros/`, which
starts the JAX package's node.
"""

import os
from glob import glob

from setuptools import setup

package_name = "kiss_icp_tpu_torch"

setup(
    name=package_name,
    version="0.3.0",
    packages=[],
    data_files=[
        ("share/ament_index/resource_index/packages",
         [os.path.join("resource", package_name)]),
        (f"share/{package_name}", ["package.xml"]),
        (f"share/{package_name}/launch", glob("launch/*.launch.py")),
        (f"share/{package_name}/rviz", glob("rviz/*.rviz")),
        (f"share/{package_name}/config", glob("config/*.yaml")),
    ],
    install_requires=["setuptools"],
    zip_safe=True,
    entry_points={
        "console_scripts": [
            "kiss_icp_tpu_torch_node = kiss_icp_tpu_torch.ros.odometry_server:main",
            "kiss_icp_tpu_torch_container = kiss_icp_tpu_torch.ros.container:main",
        ],
    },
)
