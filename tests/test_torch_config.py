"""The port's config dataclasses and presets equal the JAX package's, field
by field (mrp_gnn_tpu_torch/config.py vs mrp_gnn_tpu/config.py)."""

import dataclasses

import pytest

from mrp_gnn_tpu import config as jcfg
from mrp_gnn_tpu_torch import config as tcfg


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_preset_equals_jax_preset(name):
    assert sorted(tcfg.PRESETS) == sorted(jcfg.PRESETS)
    want = dataclasses.asdict(jcfg.get_config(name))
    got = dataclasses.asdict(tcfg.get_config(name))
    assert got == want


@pytest.mark.parametrize("cls", ["ModelConfig", "DataConfig", "TrainConfig",
                                 "ParallelConfig", "ExperimentConfig"])
def test_dataclass_fields_match(cls):
    def fields(mod):
        def plain(d):  # a default that is itself a config compares by value
            return dataclasses.asdict(d) if dataclasses.is_dataclass(d) else d
        return [(f.name, plain(f.default)) for f in
                dataclasses.fields(getattr(mod, cls))]
    assert fields(tcfg) == fields(jcfg)


def test_unknown_preset_raises():
    with pytest.raises(ValueError, match="unknown config"):
        tcfg.get_config("no_such_preset")
