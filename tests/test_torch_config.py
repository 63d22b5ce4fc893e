"""Port config (kiss_icp_tpu_torch.config) against the JAX package's.

One YAML file must drive both packages: `config_to_dict` is compared exactly
(same keys, same values, same types) for the defaults and both shipped YAML
files. Every option runs on the port, `engine.map_shards > 1` included (the
map-sharded engine), and is accepted as JAX accepts it.
"""

from pathlib import Path

import pytest
import torch

from kiss_icp_tpu.config import load_config as jax_load_config
from kiss_icp_tpu.config import config_to_dict as jax_to_dict
from kiss_icp_tpu_torch.config import config_from_dict, config_to_dict, load_config
from kiss_icp_tpu_torch.config.parser import ENV_PREFIX

torch.set_num_threads(1)

CONFIG_DIR = Path(__file__).resolve().parent.parent / "config"


@pytest.mark.parametrize("name", [None, "basic.yaml", "advanced.yaml"])
def test_config_dict_equal(name):
    path = None if name is None else CONFIG_DIR / name
    ours = config_to_dict(load_config(path))
    ref = jax_to_dict(jax_load_config(path))
    assert ours == ref
    assert {k: type(v) for k, v in ours["engine"].items()} == \
        {k: type(v) for k, v in ref["engine"].items()}


def test_env_prefix(monkeypatch):
    assert ENV_PREFIX == "kiss_icp_tpu_torch_"
    monkeypatch.setenv("kiss_icp_tpu_torch_data", '{"max_range": 40.0}')
    cfg = load_config(None)
    assert cfg.data.max_range == 40.0
    assert cfg.mapping.voxel_size == 0.4


@pytest.mark.parametrize("shards", [2, 4])
def test_unported_options_raise(shards):
    """No option is refused any more: `engine.map_shards > 1` is accepted as
    JAX accepts it (the same dict through both packages' config)."""
    cfg = load_config(None)
    cfg.engine.map_shards = shards
    jcfg = jax_load_config(None)
    jcfg.engine.map_shards = shards
    assert config_to_dict(cfg) == jax_to_dict(jcfg)
    assert config_from_dict(config_to_dict(cfg)).engine.map_shards == shards


@pytest.mark.parametrize("key,value", [
    ("nn_mode", "pallas_fused"), ("gn_unroll", 3), ("donate_state", False),
    ("use_pallas", True), ("use_pallas", False),
    ("nn_mode", "loop27"), ("nn_mode", "compact"), ("nn_mode", "compact_loop"),
    ("nn_mode", "cached"), ("deskew_refine", 1), ("deskew_refine_map", True),
    ("ground_align", 0.1), ("map_shards", 1),
])
def test_compat_options_accepted(key, value):
    cfg = load_config(None)
    setattr(cfg.engine, key, value)
    jcfg = jax_load_config(None)
    setattr(jcfg.engine, key, value)
    assert config_to_dict(cfg) == jax_to_dict(jcfg)
