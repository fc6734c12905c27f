"""Port parity for elasticity: ``deepspeed_tpu_torch/elasticity`` against
``deepspeed_tpu/elasticity`` on the same configs (exact: pure integer
arithmetic), the errors each raises, the scheduler-config check, and the
elastic batch triangle that each package's DeepSpeedConfig applies."""

import json

import pytest

import deepspeed_tpu.elasticity as jel
import deepspeed_tpu_torch.elasticity as tel
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.version import version as jversion
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as TConfig
from deepspeed_tpu_torch.version import version as tversion


def _elastic(**kw):
    cfg = {"enabled": True, "max_train_batch_size": 10000,
           "micro_batch_sizes": [8, 12, 16, 17], "min_gpus": 32,
           "max_gpus": 1500, "min_time": 20, "version": 0.1}
    cfg.update(kw)
    return {"elasticity": cfg}


CONFIGS = [
    _elastic(),
    _elastic(max_train_batch_size=2000, micro_batch_sizes=[2, 4],
             min_gpus=1, max_gpus=64),
    _elastic(micro_batch_sizes=[1, 3, 5], min_gpus=1, max_gpus=16,
             max_train_batch_size=720),
    _elastic(prefer_larger_batch=False, min_gpus=1, max_gpus=100),
    _elastic(max_train_batch_size=500, micro_batch_sizes=[6, 10],
             min_gpus=2, max_gpus=40),
    {"elasticity": {"enabled": True, "max_train_batch_size": 96,
                    "micro_batch_sizes": [4]}},
]


def test_version_is_the_jax_packages():
    assert tversion == jversion


@pytest.mark.parametrize("i", range(len(CONFIGS)))
def test_compute_elastic_config_matches_jax(i):
    got = tel.compute_elastic_config(ds_config=CONFIGS[i],
                                     target_deepspeed_version=tversion)
    want = jel.compute_elastic_config(ds_config=CONFIGS[i],
                                      target_deepspeed_version=jversion)
    assert got == want
    batch, valid = got
    for ws in valid[:3] + valid[-2:]:
        assert tel.compute_elastic_config(
            ds_config=CONFIGS[i], target_deepspeed_version=tversion,
            world_size=ws) == jel.compute_elastic_config(
            ds_config=CONFIGS[i], target_deepspeed_version=jversion,
            world_size=ws)


BAD = [
    ({}, "ElasticityConfigError"),
    ({"elasticity": {"enabled": False}}, "ElasticityConfigError"),
    ({"elasticity": {"enabled": True}}, "ElasticityConfigError"),
    ({"elasticity": {"enabled": True, "max_train_batch_size": 10}},
     "ElasticityConfigError"),
    (_elastic(micro_batch_sizes=4), "ElasticityConfigError"),
    (_elastic(micro_batch_sizes=[4, 2.5]), "ElasticityConfigError"),
    (_elastic(micro_batch_sizes=[4, -2]), "ElasticityConfigError"),
    (_elastic(min_gpus=0), "ElasticityConfigError"),
    (_elastic(min_gpus=10, max_gpus=5), "ElasticityConfigError"),
    (_elastic(min_time=-1), "ElasticityConfigError"),
    (_elastic(version=0.2), "ElasticityConfigError"),
    (_elastic(version=0.05), "NotImplementedError"),
]


@pytest.mark.parametrize("i", range(len(BAD)))
def test_errors_match_jax(i):
    cfg, kind = BAD[i]
    with pytest.raises(Exception) as want:
        jel.compute_elastic_config(ds_config=cfg,
                                   target_deepspeed_version=jversion)
    with pytest.raises(Exception) as got:
        tel.compute_elastic_config(ds_config=cfg,
                                   target_deepspeed_version=tversion)
    assert type(got.value).__name__ == type(want.value).__name__ == kind
    assert str(got.value) == str(want.value)


def test_incompatible_world_size_and_old_version_raise():
    _, valid = tel.compute_elastic_config(CONFIGS[0], tversion)
    bad = max(valid) + 1
    with pytest.raises(tel.ElasticityIncompatibleWorldSize):
        tel.compute_elastic_config(CONFIGS[0], tversion, world_size=bad)
    with pytest.raises(tel.ElasticityError):
        tel.compute_elastic_config(CONFIGS[0], "0.3.7")
    with pytest.raises(ValueError):
        tel.compute_elastic_config("not a dict", tversion)


def test_scheduler_config_must_match(monkeypatch):
    runtime = CONFIGS[1]["elasticity"]
    monkeypatch.setenv("DEEPSPEED_ELASTICITY_CONFIG", json.dumps(runtime))
    tel.ensure_immutable_elastic_config(runtime)
    monkeypatch.setenv("DEEPSPEED_ELASTICITY_CONFIG", json.dumps(
        dict(runtime, max_train_batch_size=4000)))
    with pytest.raises(tel.ElasticityConfigError) as got:
        tel.ensure_immutable_elastic_config(runtime)
    with pytest.raises(jel.ElasticityConfigError) as want:
        jel.ensure_immutable_elastic_config(runtime)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("world_size", [1, 2, 4, 8])
def test_config_applies_the_elastic_batch_like_jax(world_size):
    """DeepSpeedConfig overwrites the batch triangle with the elastic
    schedule for its world size, as the JAX config does."""
    def make():
        return dict(CONFIGS[1], bf16={"enabled": True},
                    zero_optimization={"stage": 2})

    got = TConfig(None, param_dict=make(), world_size=world_size)
    want = JConfig(None, param_dict=make(), world_size=world_size)
    for name in ("train_batch_size", "train_micro_batch_size_per_gpu",
                 "gradient_accumulation_steps", "elasticity_enabled"):
        assert getattr(got, name) == getattr(want, name), name


def test_config_refuses_batch_keys_beside_elasticity():
    cfg = dict(CONFIGS[1], train_batch_size=8)
    with pytest.raises(tel.ElasticityConfigError) as got:
        TConfig(None, param_dict=dict(cfg), world_size=2)
    with pytest.raises(jel.ElasticityConfigError) as want:
        JConfig(None, param_dict=dict(cfg), world_size=2)
    assert str(got.value) == str(want.value)
    cfg["elasticity"] = dict(cfg["elasticity"],
                             ignore_non_elastic_batch_info=True)
    assert TConfig(None, param_dict=dict(cfg), world_size=2) \
        .train_batch_size == 1680
