"""Config helpers: the scalar getter and the duplicate-key-rejecting JSON
object hook (counterpart of ``deepspeed_tpu/runtime/config_utils.py``)."""


def get_scalar_param(param_dict, param_name, param_default_value):
    return param_dict.get(param_name, param_default_value)


def dict_raise_error_on_duplicate_keys(ordered_pairs):
    """Reject duplicate keys while building a dict from JSON pairs."""
    d = dict((k, v) for k, v in ordered_pairs)
    if len(d) != len(ordered_pairs):
        counter = {}
        for k, _ in ordered_pairs:
            counter[k] = counter.get(k, 0) + 1
        keys = [k for k, v in counter.items() if v > 1]
        raise ValueError("Duplicate keys in DeepSpeed config: {}".format(keys))
    return d
