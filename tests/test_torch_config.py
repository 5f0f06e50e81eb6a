"""The port's config loader against the JAX package's: `model.dropout` and
`model.remat`, which JAX's CGICConfig keeps and the port's does not have
yet, raise unless they are off (ROADMAP queue 1 item 12), where they used
to be dropped without a word; off, and in both shipped YAMLs, the configs
load as in JAX."""
import os

import pytest
import yaml

from control_gic_tpu.config import load_config as j_load_config
from control_gic_tpu_torch.config import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _yaml(tmp_path, **model):
    with open(os.path.join(ROOT, "configs", "train.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["model"].update(model)
    path = str(tmp_path / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


@pytest.mark.parametrize("model, key", [({"dropout": 0.1}, "dropout"),
                                        ({"remat": True}, "remat"),
                                        ({"dropout": 0.1, "remat": True},
                                         "dropout")])
def test_unported_model_keys_raise(tmp_path, model, key):
    path = _yaml(tmp_path, **model)
    jcfg = j_load_config(path).model        # JAX keeps them
    assert (jcfg.dropout, jcfg.remat) == (model.get("dropout", 0.0),
                                          model.get("remat", False))
    with pytest.raises(NotImplementedError, match=f"{key}.*item 12"):
        load_config(path)


@pytest.mark.parametrize("model", [{"dropout": 0.0}, {"remat": False},
                                   {"dropout": 0, "remat": False}])
def test_model_keys_off_load(tmp_path, model):
    path = _yaml(tmp_path, **model)
    assert load_config(path).model.ch == j_load_config(path).model.ch == 128


@pytest.mark.parametrize("name", ["inference.yaml", "train.yaml"])
def test_shipped_configs_load(name):
    path = os.path.join(ROOT, "configs", name)
    cfg, jcfg = load_config(path), j_load_config(path)
    assert jcfg.model.dropout == 0.0 and not jcfg.model.remat
    assert (cfg.model.ch, cfg.model.ch_mult, cfg.ratios) == \
        (jcfg.model.ch, jcfg.model.ch_mult, jcfg.ratios)
