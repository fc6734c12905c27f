"""Ahead-of-time elasticity: pick a total batch size valid for many GPU counts.

Counterpart of ``deepspeed_tpu/elasticity/elasticity.py``, line for line
(pure arithmetic). Candidate batch sizes are each micro-batch (and their
LCM) scaled by the largest highly composite number that keeps the product
under ``max_train_batch_size``; the winner is the candidate divisible by
the most GPU counts (data-parallel ranks) in [min_gpus, max_gpus]. The
global batch stays constant across world sizes through gradient
accumulation.
"""

import json
import math
import os
import re
from functools import reduce

from deepspeed_tpu_torch.elasticity.config import (
    ElasticityConfig,
    ElasticityConfigError,
    ElasticityError,
    ElasticityIncompatibleWorldSize,
)
from deepspeed_tpu_torch.elasticity.constants import (
    DEEPSPEED_ELASTICITY_CONFIG,
    ELASTICITY,
    ENABLED,
    ENABLED_DEFAULT,
    LATEST_ELASTICITY_VERSION,
    MINIMUM_DEEPSPEED_VERSION,
)
from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.version import version as __version__

# Thirty-eight smallest highly composite numbers — enough to support batch
# sizes up to ~720K (reference elasticity.py:17-58).
HCN_LIST = [
    1, 2, 4, 6, 12, 24, 36, 48, 60, 120, 180, 240, 360, 720, 840, 1260, 1680,
    2520, 5040, 7560, 10080, 15120, 20160, 25200, 27720, 45360, 50400, 55440,
    83160, 110880, 166320, 221760, 277200, 332640, 498960, 554400, 665280,
    720720
]


def get_candidate_batch_sizes(base_list, max_acceptable_batch_size):
    candidates = set()
    for base in base_list:
        batch_size = base
        for hcn in HCN_LIST:
            if base * hcn > max_acceptable_batch_size:
                break
            batch_size = base * hcn
        candidates.add(batch_size)
    return list(candidates)


def get_valid_gpus(batch_size, micro_batches, min_valid_gpus, max_valid_gpus):
    """All GPU counts g in range such that batch_size is divisible by g*mb for some mb."""
    valid_gpus = set()
    for micro_batch in micro_batches:
        if batch_size % micro_batch != 0:
            continue
        max_gpus = batch_size // micro_batch
        if min_valid_gpus <= max_gpus <= max_valid_gpus:
            valid_gpus.add(max_gpus)
        for i in range(1, max_gpus // 2 + 1):
            if max_gpus % i == 0 and min_valid_gpus <= i <= max_valid_gpus:
                valid_gpus.add(i)
    return sorted(valid_gpus)


def get_best_candidates(candidate_batch_sizes, micro_batches, min_gpus, max_gpus,
                        prefer_larger):
    max_valid_gpus = 0
    valid_gpus = None
    final_batch_size = int(min(micro_batches))
    for batch_size in candidate_batch_sizes:
        current_valid_gpus = get_valid_gpus(batch_size, micro_batches, min_gpus,
                                            max_gpus)
        better_count = len(current_valid_gpus) > max_valid_gpus
        tie = len(current_valid_gpus) == max_valid_gpus
        tie_break = (prefer_larger and batch_size > final_batch_size) or \
                    (not prefer_larger and batch_size < final_batch_size)
        if better_count or (tie and tie_break):
            max_valid_gpus = len(current_valid_gpus)
            valid_gpus = current_valid_gpus
            final_batch_size = batch_size
    return final_batch_size, valid_gpus


def _get_compatible_gpus_v01(micro_batches,
                             max_acceptable_batch_size,
                             min_gpus=None,
                             max_gpus=None,
                             prefer_larger=True):
    if min_gpus is None:
        min_gpus = 1
    if max_gpus is None:
        max_gpus = int(max_acceptable_batch_size / min(micro_batches))

    assert all(mb <= max_acceptable_batch_size for mb in micro_batches), (
        "All micro batches must be less than or equal to "
        "max_acceptable_batch_size: {}".format(max_acceptable_batch_size))

    lcm = reduce(lambda a, b: a * b // math.gcd(a, b), micro_batches)
    base_list = list(micro_batches) + [lcm]

    candidate_batch_sizes = get_candidate_batch_sizes(base_list,
                                                      max_acceptable_batch_size)
    return get_best_candidates(candidate_batch_sizes,
                               micro_batches,
                               min_gpus,
                               max_gpus,
                               prefer_larger)


def _parse_version(version_str):
    matched = re.search(r"^(\d+)\.(\d+)\.(\d+)", version_str)
    if matched:
        return int(matched.group(1)), int(matched.group(2)), int(matched.group(3))
    matched = re.search(r"^(\d+)\.(\d+)", version_str)
    assert matched is not None, (
        "Unable to parse version number, expecting major.minor[.patch] format "
        "but received {}".format(version_str))
    return int(matched.group(1)), int(matched.group(2)), 0


def _compatible_ds_version_check(target_deepspeed_version):
    min_version = _parse_version(MINIMUM_DEEPSPEED_VERSION)
    trg_version = _parse_version(target_deepspeed_version)
    err_str = ("Target deepspeed version of {} is not compatible with minimum "
               "version {} supporting elasticity.".format(
                   target_deepspeed_version, MINIMUM_DEEPSPEED_VERSION))
    # Component-wise gate, matching reference elasticity.py:186-198.
    if trg_version[0] < min_version[0] or trg_version[1] < min_version[1] or \
            trg_version[2] < min_version[2]:
        raise ElasticityError(err_str)
    return True


def elasticity_enabled(ds_config):
    if ELASTICITY not in ds_config:
        return False
    return ds_config[ELASTICITY].get(ENABLED, ENABLED_DEFAULT)


def ensure_immutable_elastic_config(runtime_elastic_config_dict):
    """Ensure the resource scheduler saw the same elastic config as the runtime."""
    if DEEPSPEED_ELASTICITY_CONFIG in os.environ:
        scheduler_elastic_config = ElasticityConfig(
            json.loads(os.environ[DEEPSPEED_ELASTICITY_CONFIG]))
        runtime_elastic_config = ElasticityConfig(runtime_elastic_config_dict)
        err_str = ("Elastic config '{0}={1}' seen by resource scheduler does "
                   "not match config passed to runtime {0}={2}")
        for attr in ("max_acceptable_batch_size", "micro_batches", "version"):
            sched_val = getattr(scheduler_elastic_config, attr)
            run_val = getattr(runtime_elastic_config, attr)
            if sched_val != run_val:
                raise ElasticityConfigError(err_str.format(attr, sched_val, run_val))
    else:
        logger.warning(
            "Unable to find DEEPSPEED_ELASTICITY_CONFIG environment variable, "
            "cannot guarantee resource scheduler will scale this job using "
            "compatible GPU counts.")


def compute_elastic_config(ds_config, target_deepspeed_version, world_size=0):
    """Compute (final_batch_size, valid_gpus[, micro_batch_size]) for an elastic job.

    Deterministic for a given ds_config; intended to be called by both the
    scheduler and the runtime (reference elasticity.py:240-334).
    """
    if not isinstance(ds_config, dict):
        raise ValueError(
            "Expected ds_config to be a dictionary but received a {}, "
            "containing: {}".format(type(ds_config), ds_config))

    if ELASTICITY not in ds_config:
        raise ElasticityConfigError(
            "'{}' is missing from config json, please add it if running an "
            "elastic training job.".format(ELASTICITY))

    elastic_config_dict = ds_config[ELASTICITY]
    if not elastic_config_dict.get(ENABLED, ENABLED_DEFAULT):
        raise ElasticityConfigError(
            "Elasticity is disabled, please enable it ('enabled':true) if "
            "running an elastic training job.")

    elastic_config = ElasticityConfig(elastic_config_dict)

    if float(elastic_config.version) > LATEST_ELASTICITY_VERSION:
        raise ElasticityConfigError(
            "Attempting to run elasticity version {} but runtime only supports "
            "up to {}".format(elastic_config.version, LATEST_ELASTICITY_VERSION))

    if not _compatible_ds_version_check(target_deepspeed_version):
        raise ElasticityError(
            "Unable to run elasticity on target deepspeed version of {}, "
            "currently {}".format(target_deepspeed_version, __version__))

    if float(elastic_config.version) == 0.1:
        final_batch_size, valid_gpus = _get_compatible_gpus_v01(
            micro_batches=elastic_config.micro_batches,
            max_acceptable_batch_size=elastic_config.max_acceptable_batch_size,
            min_gpus=elastic_config.min_gpus,
            max_gpus=elastic_config.max_gpus,
            prefer_larger=elastic_config.prefer_larger_batch_size)
        final_batch_size = int(final_batch_size)
    else:
        raise NotImplementedError(
            "Unable to find elastic logic for version: {}".format(
                elastic_config.version))

    if world_size > 0:
        if world_size not in valid_gpus:
            raise ElasticityIncompatibleWorldSize(
                "World size ({}) is not valid with the current list of valid "
                "GPU counts: {}".format(world_size, valid_gpus))
        # Pick the largest micro batch size that evenly divides the per-GPU batch.
        micro_batch_size = None
        for mbsz in sorted(set(elastic_config.micro_batches), reverse=True):
            if final_batch_size // world_size % mbsz == 0:
                micro_batch_size = mbsz
                break
        assert micro_batch_size is not None, (
            "Unable to find divisible micro batch size world_size={}, "
            "final_batch_size={}, and micro_batches={}.".format(
                world_size, final_batch_size, elastic_config.micro_batches))
        return final_batch_size, valid_gpus, micro_batch_size

    return final_batch_size, valid_gpus
