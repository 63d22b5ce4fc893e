"""The port's ROS 2 ament package (`ros_torch/`), read without ROS: no rclpy,
launch or launch_ros is needed.

  * package.xml parses; its name is setup.py's `package_name` and the
    ament index marker under resource/;
  * setup.py's console scripts (read by calling it under a stand-in for
    `setuptools.setup`) are the node and the container, each resolving to a
    callable of `kiss_icp_tpu_torch.ros`; its data files carry the launch,
    rviz and config files;
  * each launch file (read with `ast`) names the package and its executable,
    declares every argument of its `ros/` twin plus `device` (default
    "cuda"), and passes `device` to the node;
  * every key of config/config.yaml, commented or set, is a parameter the
    node declares (`kiss_icp_tpu_torch/ros/core.py` `DEFAULT_PARAMETERS`),
    and it holds every key of `ros/config/config.yaml` plus `device`;
  * `ros/`, the JAX package's ament package, is byte for byte what it was.
"""

import ast
import hashlib
import importlib
import os
import re
import runpy
import xml.etree.ElementTree as ET
from pathlib import Path

import pytest
import setuptools
import yaml

from kiss_icp_tpu_torch.ros.core import DEFAULT_PARAMETERS

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "ros_torch"
NAME = "kiss_icp_tpu_torch"
EXECUTABLES = {"kiss_icp_tpu_torch_node": "kiss_icp_tpu_torch.ros.odometry_server:main",
               "kiss_icp_tpu_torch_container": "kiss_icp_tpu_torch.ros.container:main"}
# sha256 over (path, bytes) of every file of ros/, in path order, as the
# tree stood before the port began; ros/ is the JAX package's and stays so.
ROS_DIGEST = "b79eea04cb5290ee77135249ddba99b920308cfd550e117b152d5049dbf35337"


@pytest.fixture(scope="module")
def setup_kwargs():
    """The keyword arguments ros_torch/setup.py passes to setuptools.setup,
    run from its own directory (it globs relative paths)."""
    seen = {}
    real = setuptools.setup
    setuptools.setup = lambda **kw: seen.update(kw)
    cwd = Path.cwd()
    try:
        os.chdir(PKG)
        globals_ = runpy.run_path(str(PKG / "setup.py"))
    finally:
        os.chdir(cwd)
        setuptools.setup = real
    return seen, globals_


def test_package_xml_names_the_package(setup_kwargs):
    kwargs, globals_ = setup_kwargs
    root = ET.parse(PKG / "package.xml").getroot()
    assert root.tag == "package" and root.get("format") == "3"
    assert root.findtext("name") == NAME
    assert globals_["package_name"] == kwargs["name"] == NAME
    assert (PKG / "resource" / NAME).is_file()
    assert root.find("export").findtext("build_type") == "ament_python"
    description = " ".join(root.findtext("description").split())
    assert "PyTorch" in description and "CUDA" in description
    assert "XLA" not in description and "jitted" not in description


def test_console_scripts_resolve_to_the_port_node(setup_kwargs):
    kwargs, _ = setup_kwargs
    scripts = dict(re.match(r"^\s*(\S+)\s*=\s*(\S+)\s*$", s).groups()
                   for s in kwargs["entry_points"]["console_scripts"])
    assert scripts == EXECUTABLES
    for target in scripts.values():
        module, _, attr = target.partition(":")
        assert module.startswith("kiss_icp_tpu_torch.ros.")
        assert callable(getattr(importlib.import_module(module), attr)), target
    shared = {dest: files for dest, files in kwargs["data_files"]}
    assert shared["share/ament_index/resource_index/packages"] == [f"resource/{NAME}"]
    assert shared[f"share/{NAME}"] == ["package.xml"]
    assert sorted(shared[f"share/{NAME}/launch"]) == [
        "launch/composition.launch.py", "launch/odometry.launch.py"]
    assert shared[f"share/{NAME}/config"] == ["config/config.yaml"]
    assert shared[f"share/{NAME}/rviz"] == [f"rviz/{NAME}.rviz"]
    assert (PKG / "setup.cfg").read_text().count(f"$base/lib/{NAME}") == 2


def _launch_facts(path: Path):
    """(PACKAGE constant, {argument: default}, executables of Node(...),
    the parameter dict keys passed to the package's own node)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    package, args, executables, params = None, {}, [], set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "PACKAGE" for t in node.targets):
            package = ast.literal_eval(node.value)
        if not isinstance(node, ast.Call) or not isinstance(node.func, ast.Name):
            continue
        kw = {k.arg: k.value for k in node.keywords}
        if node.func.id == "DeclareLaunchArgument":
            default = kw.get("default_value")
            args[ast.literal_eval(node.args[0])] = (
                ast.literal_eval(default) if isinstance(default, ast.Constant) else
                None if default is None else "<substitution>")
        elif node.func.id == "Node" and isinstance(kw.get("package"), ast.Name):
            executables.append(ast.literal_eval(kw["executable"]))
            for p in ast.walk(kw["parameters"]):
                if isinstance(p, ast.Dict):
                    params.update(ast.literal_eval(k) for k in p.keys)
    return package, args, executables, params


@pytest.mark.parametrize("name,executable", [
    ("odometry.launch.py", "kiss_icp_tpu_torch_node"),
    ("composition.launch.py", "kiss_icp_tpu_torch_container"),
])
def test_launch_file_starts_the_port_with_a_device_argument(name, executable):
    package, args, executables, params = _launch_facts(PKG / "launch" / name)
    assert package == NAME
    assert executables == [executable]
    _, jax_args, _, jax_params = _launch_facts(REPO / "ros" / "launch" / name)
    assert set(args) == set(jax_args) | {"device"}
    assert args["device"] == "cuda"
    assert all(args[a] == d for a, d in jax_args.items()), (args, jax_args)
    assert params == jax_params | {"device"}
    assert params <= set(DEFAULT_PARAMETERS) | {"use_sim_time"}


def _config_keys(path: Path):
    """The parameter keys under ros__parameters: (set, commented out)."""
    text = path.read_text()
    top = yaml.safe_load(text)
    (node, body), = top.items()
    set_keys = set(body["ros__parameters"])
    commented = set(re.findall(r"^ {4}# ?([a-z_]+):", text, flags=re.M))
    return node, set_keys, commented


def test_config_keys_are_node_parameters():
    node, set_keys, commented = _config_keys(PKG / "config" / "config.yaml")
    assert node == "kiss_icp_tpu_torch_node"  # the launch file's node name
    keys = set_keys | commented
    assert keys <= set(DEFAULT_PARAMETERS), keys - set(DEFAULT_PARAMETERS)
    _, jax_set, jax_commented = _config_keys(REPO / "ros" / "config" / "config.yaml")
    assert set_keys == jax_set
    assert keys == jax_set | jax_commented | {"device"}


def test_jax_ros_package_is_unchanged():
    h = hashlib.sha256()
    files = sorted(p for p in (REPO / "ros").rglob("*")
                   if p.is_file() and "__pycache__" not in p.parts)
    for p in files:
        h.update(p.relative_to(REPO).as_posix().encode() + b"\0")
        h.update(p.read_bytes())
    assert h.hexdigest() == ROS_DIGEST
