"""ZeRO: the config, the host offload tier (``offload``) and the stages
partitioned over a data group (``partition``)."""
