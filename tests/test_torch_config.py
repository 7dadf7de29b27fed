"""The PyTorch port's Config reads every config the JAX reference writes:
the reference's Config().to_dict() and every artifacts/*_config.json load
and round-trip; the schema has the reference's fields and defaults (but
for the documented hier_agg); edge_target becomes the enum; unknown keys
raise."""

import dataclasses
import json
import pathlib

import pytest

from image_compression_tpu import config as jconfig
from image_compression_torch import config as tconfig

ARTIFACTS = sorted((pathlib.Path(__file__).resolve().parent.parent
                    / "artifacts").glob("*_config.json"))


def test_reference_default_config_round_trips():
    raw = jconfig.Config().to_dict()
    cfg = tconfig.Config.from_dict(raw)
    assert cfg.to_dict() == raw
    assert cfg.edge_target is tconfig.EdgeTarget.GRAPH
    # through a JSON file, as the reference writes them
    as_json = json.loads(json.dumps(raw))
    assert json.loads(json.dumps(
        tconfig.Config.from_dict(as_json).to_dict())) == as_json


@pytest.mark.parametrize("path", ARTIFACTS, ids=lambda p: p.name)
def test_artifact_configs_load_and_round_trip(path):
    cfg = tconfig.Config.from_json(path)
    ref = jconfig.Config.from_json(path).to_dict()
    ours = cfg.to_dict()
    ours["multicut"].pop("hier_agg")
    ref["multicut"].pop("hier_agg")
    assert ours == ref
    assert tconfig.Config.from_dict(cfg.to_dict()).to_dict() == cfg.to_dict()


def test_artifacts_present():
    assert len(ARTIFACTS) >= 5


@pytest.mark.parametrize("name", ["Config", "RewardConfig", "MulticutConfig",
                                  "PretrainConfig", "RLConfig"])
def test_schema_and_defaults_equal_reference(name):
    ours, ref = getattr(tconfig, name)(), getattr(jconfig, name)()
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(ref)]
    a, b = dataclasses.asdict(ours), dataclasses.asdict(ref)
    if name == "Config":
        a["multicut"].pop("hier_agg")
        b["multicut"].pop("hier_agg")
        assert a.pop("edge_target").value == b.pop("edge_target").value
    if name == "MulticutConfig":
        assert (a.pop("hier_agg"), b.pop("hier_agg")) == ("matrix", "pixel")
    assert a == b
    assert [e.value for e in tconfig.EdgeTarget] == \
        [e.value for e in jconfig.EdgeTarget]


def test_from_dict_converts_and_rejects():
    cfg = tconfig.Config.from_dict({"edge_target": "slic",
                                    "slice_container": "pack",
                                    "reward": {"beta": 0.5}})
    assert cfg.edge_target is tconfig.EdgeTarget.SLIC
    assert cfg.slice_container == "pack" and cfg.reward.beta == 0.5
    with pytest.raises(KeyError):
        tconfig.Config.from_dict({"no_such_key": 1})
    with pytest.raises(TypeError):
        tconfig.Config.from_dict({"reward": {"no_such_field": 1}})
