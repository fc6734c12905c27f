"""Elasticity config object and exception hierarchy (counterpart of
``deepspeed_tpu/elasticity/config.py``)."""

import json

from deepspeed_tpu_torch.elasticity.constants import (
    ENABLED,
    ENABLED_DEFAULT,
    IGNORE_NON_ELASTIC_BATCH_INFO,
    IGNORE_NON_ELASTIC_BATCH_INFO_DEFAULT,
    MAX_ACCEPTABLE_BATCH_SIZE,
    MAX_ACCEPTABLE_BATCH_SIZE_DEFAULT,
    MAX_GPUS,
    MAX_GPUS_DEFAULT,
    MICRO_BATCHES,
    MICRO_BATCHES_DEFAULT,
    MIN_GPUS,
    MIN_GPUS_DEFAULT,
    MIN_TIME,
    MIN_TIME_DEFAULT,
    PREFER_LARGER_BATCH,
    PREFER_LARGER_BATCH_DEFAULT,
    VERSION,
    VERSION_DEFAULT,
)


class ElasticityError(Exception):
    """Base exception for all elasticity related errors."""


class ElasticityConfigError(ElasticityError):
    """Elasticity configuration error."""


class ElasticityIncompatibleWorldSize(ElasticityError):
    """World size incompatible with the given elastic config."""


class ElasticityConfig:
    """Elastic config parsed from the ``elasticity`` block of ds_config.

    When enabled, ``max_train_batch_size`` and ``micro_batch_sizes`` are
    required; validation as in the JAX package.
    """

    def __init__(self, param_dict):
        self.enabled = param_dict.get(ENABLED, ENABLED_DEFAULT)
        if self.enabled:
            if MAX_ACCEPTABLE_BATCH_SIZE not in param_dict:
                raise ElasticityConfigError(
                    "Elasticity config missing {}".format(MAX_ACCEPTABLE_BATCH_SIZE))
            if MICRO_BATCHES not in param_dict:
                raise ElasticityConfigError(
                    "Elasticity config missing {}".format(MICRO_BATCHES))
            self.max_acceptable_batch_size = param_dict[MAX_ACCEPTABLE_BATCH_SIZE]
            self.micro_batches = param_dict[MICRO_BATCHES]
        else:
            self.max_acceptable_batch_size = param_dict.get(
                MAX_ACCEPTABLE_BATCH_SIZE, MAX_ACCEPTABLE_BATCH_SIZE_DEFAULT)
            self.micro_batches = param_dict.get(MICRO_BATCHES, MICRO_BATCHES_DEFAULT)

        if not isinstance(self.micro_batches, list):
            raise ElasticityConfigError(
                "Elasticity expected value of {} to be a list of micro batches, "
                "instead is: {}, containing: {}".format(
                    MICRO_BATCHES, type(self.micro_batches), self.micro_batches))
        if not all(isinstance(m, int) for m in self.micro_batches):
            raise ElasticityConfigError(
                "Elasticity expected {} to only contain a list of integers, "
                "instead contains: {}".format(MICRO_BATCHES, self.micro_batches))
        if not all(m > 0 for m in self.micro_batches):
            raise ElasticityConfigError(
                "Elasticity expected {} to only contain positive integers, "
                "instead contains: {}".format(MICRO_BATCHES, self.micro_batches))

        self.min_gpus = param_dict.get(MIN_GPUS, MIN_GPUS_DEFAULT)
        self.max_gpus = param_dict.get(MAX_GPUS, MAX_GPUS_DEFAULT)
        if self.min_gpus < 1 or self.max_gpus < 1:
            raise ElasticityConfigError(
                "Elasticity min/max gpus must be > 0, given min_gpus: {}, "
                "max_gpus: {}".format(self.min_gpus, self.max_gpus))
        if self.max_gpus < self.min_gpus:
            raise ElasticityConfigError(
                "Elasticity min_gpus cannot be greater than max_gpus, given "
                "min_gpus: {}, max_gpus: {}".format(self.min_gpus, self.max_gpus))

        self.min_time = param_dict.get(MIN_TIME, MIN_TIME_DEFAULT)
        if self.min_time < 0:
            raise ElasticityConfigError(
                "Elasticity min time needs to be >= 0: given {}".format(self.min_time))

        self.version = param_dict.get(VERSION, VERSION_DEFAULT)
        self.prefer_larger_batch_size = param_dict.get(PREFER_LARGER_BATCH,
                                                       PREFER_LARGER_BATCH_DEFAULT)
        self.ignore_non_elastic_batch_info = param_dict.get(
            IGNORE_NON_ELASTIC_BATCH_INFO, IGNORE_NON_ELASTIC_BATCH_INFO_DEFAULT)

    def repr(self):
        return self.__dict__

    def __repr__(self):
        return json.dumps(self.__dict__, sort_keys=True, indent=4)
