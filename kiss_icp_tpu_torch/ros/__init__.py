"""ROS 2 odometry node of the port (rclpy shell over the GPU engine)."""
