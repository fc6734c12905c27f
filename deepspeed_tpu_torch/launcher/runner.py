"""deepspeed CLI runner: the multi-node job launcher.

Counterpart of ``deepspeed_tpu/launcher/runner.py`` (the reference's
``deepspeed/launcher/runner.py``): hostfile parsing (``worker-N
slots=M``), the ``--include``/``--exclude`` slot filters and
``--num_nodes``/``--num_gpus``, the base64 ``world_info``, then the launch:
on one node, ``launcher/launch.py`` directly; on several, through pdsh,
Open MPI or MVAPICH (``launcher/multinode_runner.py``).

A slot is a GPU. ``launch.py`` starts one process per slot, as the
reference does (the JAX launcher starts one per host instead). Without a
hostfile the pool is this host with ``--num_gpus`` slots (on a host
without GPUs, that many host ranks that train over gloo), or else
``torch.cuda.device_count()``.
"""

import argparse
import base64
import collections
import json
import os
import subprocess
import sys
from copy import deepcopy

from deepspeed_tpu_torch.utils.logging import logger

DLTS_HOSTFILE = "/job/hostfile"
EXPORT_ENVS = ["NCCL", "PYTHON", "PATH", "CUDA", "TORCH"]
DEEPSPEED_ENVIRONMENT_NAME = ".deepspeed_env"
DEEPSPEED_ENVIRONMENT_PATHS = [os.path.expanduser("~"), "."]
PDSH_MAX_FAN_OUT = 1024


def parse_args(args=None):
    parser = argparse.ArgumentParser(
        description="DeepSpeed runner (PyTorch port) to launch distributed "
        "multi-node training jobs")
    parser.add_argument("-H", "--hostfile", type=str, default=DLTS_HOSTFILE,
                        help="Hostfile path (in MPI style) that defines the "
                        "resource pool (e.g. worker-0 slots=4)")
    parser.add_argument("-i", "--include", type=str, default="",
                        help="Specify hardware resources to use as "
                        "NODE_SPEC[@NODE_SPEC ...]")
    parser.add_argument("-e", "--exclude", type=str, default="",
                        help="Specify hardware resources to exclude; mutually "
                        "exclusive with --include")
    parser.add_argument("--num_nodes", type=int, default=-1,
                        help="Total number of worker nodes to run on")
    parser.add_argument("--num_gpus", type=int, default=-1,
                        help="Max number of GPUs to use on each node")
    parser.add_argument("--master_port", default=29500, type=int,
                        help="Port used by torch.distributed for rendezvous")
    parser.add_argument("--master_addr", default="", type=str,
                        help="IP address of node 0 (coordinator)")
    parser.add_argument("--launcher", default="pdsh", type=str,
                        help="Multi-node launcher backend: pdsh, openmpi or "
                        "mvapich")
    parser.add_argument("--launcher_args", default="", type=str,
                        help="Pass launcher-specific arguments as one quoted "
                        "string")
    parser.add_argument("--force_multi", action="store_true",
                        help="Force multi-node mode even with a single node")
    parser.add_argument("user_script", type=str,
                        help="User script to launch")
    parser.add_argument("user_args", nargs=argparse.REMAINDER)
    return parser.parse_args(args=args)


def fetch_hostfile(hostfile_path):
    """Parse 'hostname slots=N' lines (reference runner.py:115-143)."""
    if not os.path.isfile(hostfile_path):
        logger.warning("Unable to find hostfile, will proceed with training "
                       "with local resources only.")
        return None

    resource_pool = collections.OrderedDict()
    with open(hostfile_path, "r") as fd:
        for line in fd.readlines():
            line = line.strip()
            if line == "":
                continue
            try:
                hostname, slots = line.split()
                _, slot_count = slots.split("=")
                slot_count = int(slot_count)
            except ValueError as err:
                logger.error("Hostfile is not formatted correctly, unable to "
                             "proceed with training.")
                raise err
            if hostname in resource_pool:
                logger.error("Hostfile contains duplicate hosts, unable to "
                             "proceed with training.")
                raise ValueError(
                    "host {} is already defined".format(hostname))
            resource_pool[hostname] = slot_count
    return resource_pool


def parse_resource_filter(host_info, include_str="", exclude_str=""):
    """NODE_SPEC[@NODE_SPEC ...] with NODE_SPEC = NAME[:SLOT[,SLOT ...]]
    (reference runner.py:146-235; same syntax and errors)."""
    NODE_SEP = "@"
    SLOT_LIST_START = ":"
    SLOT_SEP = ","

    if include_str != "" and exclude_str != "":
        raise ValueError("include_str and exclude_str are mutually exclusive.")
    if include_str == "" and exclude_str == "":
        return host_info

    filtered_hosts = dict()
    if include_str:
        parse_str = include_str
    if exclude_str != "":
        filtered_hosts = deepcopy(host_info)
        parse_str = exclude_str

    for node_config in parse_str.split(NODE_SEP):
        if SLOT_LIST_START in node_config:
            hostname, slots = node_config.split(SLOT_LIST_START)
            slots = [int(x) for x in slots.split(SLOT_SEP)]
            if hostname not in host_info:
                raise ValueError(
                    "Hostname '{}' not found in hostfile".format(hostname))
            for s in slots:
                if s not in host_info[hostname]:
                    raise ValueError(
                        "No slot '{}' specified on host '{}'".format(
                            s, hostname))
            if include_str:
                filtered_hosts[hostname] = slots
            elif exclude_str:
                for s in slots:
                    logger.info("removing {} from {}".format(s, hostname))
                    filtered_hosts[hostname].remove(s)
        else:
            hostname = node_config
            if hostname not in host_info:
                raise ValueError(
                    "Hostname '{}' not found in hostfile".format(hostname))
            if include_str:
                filtered_hosts[hostname] = host_info[hostname]
            elif exclude_str:
                filtered_hosts[hostname] = []

    del_keys = []
    for hostname in filtered_hosts:
        filtered_hosts[hostname] = list(set(filtered_hosts[hostname]))
        if len(filtered_hosts[hostname]) == 0:
            del_keys.append(hostname)
    for name in del_keys:
        del filtered_hosts[name]

    ordered_hosts = collections.OrderedDict()
    for host in host_info:
        if host in filtered_hosts:
            ordered_hosts[host] = sorted(filtered_hosts[host])
    return ordered_hosts


def parse_inclusion_exclusion(resource_pool, inclusion, exclusion):
    active_resources = collections.OrderedDict()
    for hostname, slots in resource_pool.items():
        active_resources[hostname] = list(range(slots))
    return parse_resource_filter(active_resources,
                                 include_str=inclusion,
                                 exclude_str=exclusion)


def encode_world_info(world_info):
    world_info_json = json.dumps(world_info).encode("utf-8")
    return base64.urlsafe_b64encode(world_info_json).decode("utf-8")


def main(args=None):
    args = parse_args(args)

    resource_pool = fetch_hostfile(args.hostfile)
    if resource_pool is None:
        # This host alone: --num_gpus ranks (without a GPU, host ranks), or
        # every GPU it has.
        slots = args.num_gpus
        if slots <= 0:
            import torch

            slots = torch.cuda.device_count()
        if slots == 0:
            raise RuntimeError("Unable to proceed, no GPU resources "
                               "available (pass --num_gpus to start that "
                               "many ranks on the host)")
        resource_pool = collections.OrderedDict([("localhost", slots)])
        args.master_addr = args.master_addr or "127.0.0.1"

    if args.num_nodes >= 0 or args.num_gpus >= 0:
        if args.include != "" or args.exclude != "":
            raise ValueError(
                "Cannot specify num_nodes/gpus with include/exclude")

    active_resources = parse_inclusion_exclusion(resource_pool,
                                                 args.include,
                                                 args.exclude)
    if args.num_nodes > 0:
        active_resources = collections.OrderedDict(
            list(active_resources.items())[:args.num_nodes])
    if args.num_gpus > 0:
        for host in active_resources:
            active_resources[host] = list(range(args.num_gpus))

    multi_node = args.force_multi or len(active_resources) > 1
    env = os.environ.copy()

    if not multi_node:
        # One node: launcher.launch starts a process per slot here.
        world_info = encode_world_info(
            {host: slots for host, slots in active_resources.items()})
        cmd = [sys.executable, "-u", "-m",
               "deepspeed_tpu_torch.launcher.launch",
               "--world_info={}".format(world_info),
               "--master_addr={}".format(args.master_addr or "127.0.0.1"),
               "--master_port={}".format(args.master_port),
               "--node_rank=0",
               args.user_script] + args.user_args
        logger.info("cmd = {}".format(" ".join(cmd)))
        result = subprocess.Popen(cmd, env=env)
        result.wait()
        return result.returncode

    # Multi-node
    from deepspeed_tpu_torch.launcher.multinode_runner import (
        MVAPICHRunner, OpenMPIRunner, PDSHRunner)
    world_info = encode_world_info(
        {host: slots for host, slots in active_resources.items()})
    if args.launcher == "pdsh":
        runner = PDSHRunner(args, world_info)
    elif args.launcher == "openmpi":
        runner = OpenMPIRunner(args, world_info, active_resources)
    elif args.launcher == "mvapich":
        runner = MVAPICHRunner(args, world_info, active_resources)
    else:
        raise NotImplementedError(
            "Unknown launcher {}".format(args.launcher))
    if not runner.backend_exists():
        raise RuntimeError("launcher '{}' not installed".format(args.launcher))

    curr_path = os.path.abspath(".")
    env["PYTHONPATH"] = curr_path + ":" + env.get("PYTHONPATH", "")

    for var in env.keys():
        if any(var.startswith(name) for name in EXPORT_ENVS):
            runner.add_export(var, env[var])

    for environ_path in DEEPSPEED_ENVIRONMENT_PATHS:
        environ_file = os.path.join(environ_path, DEEPSPEED_ENVIRONMENT_NAME)
        if os.path.isfile(environ_file):
            with open(environ_file, "r") as fd:
                for var in fd.readlines():
                    key, val = var.split("=", 1)
                    runner.add_export(key, val.strip())

    cmd = runner.get_cmd(env, active_resources)
    logger.info("cmd = {}".format(" ".join(cmd)))
    result = subprocess.Popen(cmd, env=env)
    result.wait()
    return result.returncode


if __name__ == "__main__":
    sys.exit(main())
