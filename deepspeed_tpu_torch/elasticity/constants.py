"""Elasticity config keys (the port's own copy of
``deepspeed_tpu/elasticity/constants.py``)."""

ELASTICITY = "elasticity"

LATEST_ELASTICITY_VERSION = 0.1

ENABLED = "enabled"
ENABLED_DEFAULT = False

# Max acceptable train_batch_size
MAX_ACCEPTABLE_BATCH_SIZE = "max_train_batch_size"
MAX_ACCEPTABLE_BATCH_SIZE_DEFAULT = 2000

# Acceptable micro batch sizes, same as train_micro_batch_size_per_gpu
MICRO_BATCHES = "micro_batch_sizes"
MICRO_BATCHES_DEFAULT = [2, 4, 6]

MIN_GPUS = "min_gpus"
MIN_GPUS_DEFAULT = 1
MAX_GPUS = "max_gpus"
MAX_GPUS_DEFAULT = 10000

MIN_TIME = "min_time"
MIN_TIME_DEFAULT = 0

PREFER_LARGER_BATCH = "prefer_larger_batch"
PREFER_LARGER_BATCH_DEFAULT = True

IGNORE_NON_ELASTIC_BATCH_INFO = "ignore_non_elastic_batch_info"
IGNORE_NON_ELASTIC_BATCH_INFO_DEFAULT = False

VERSION = "version"
VERSION_DEFAULT = LATEST_ELASTICITY_VERSION

MINIMUM_DEEPSPEED_VERSION = "0.3.8"

DEEPSPEED_ELASTICITY_CONFIG = "DEEPSPEED_ELASTICITY_CONFIG"
