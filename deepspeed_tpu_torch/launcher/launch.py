"""Per-node launcher: one process per local GPU.

Counterpart of ``deepspeed_tpu/launcher/launch.py`` with the reference's
torch semantics (``deepspeed/launcher/launch.py``): from ``--world_info``
(base64 JSON ``{hostname: [gpu ids]}``) and ``--node_rank`` it starts one
process of the training script per GPU of this node, with

- ``CUDA_VISIBLE_DEVICES``: this node's GPU ids;
- ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` (every node's GPUs);
- ``RANK`` (global, in world_info's order) and ``LOCAL_RANK``;
- ``--local_rank=<i>`` before the script's own arguments.

``utils/distributed.init_distributed`` reads that environment. The JAX
launcher starts one process per host instead (its runtime drives every
local chip from one process).

SIGINT and SIGTERM are forwarded to every child. When a child exits with
an error the others are terminated and the launcher exits with that
child's code; it exits 0 when every child did.

    python -m deepspeed_tpu_torch.launcher.launch --world_info=<b64> \\
        --node_rank=0 --master_addr=127.0.0.1 --master_port=29500 \\
        train.py --deepspeed_config ds.json
"""

import argparse
import base64
import json
import os
import signal
import subprocess
import sys
import time

from deepspeed_tpu_torch.utils.logging import logger


def parse_args(args=None):
    parser = argparse.ArgumentParser(
        description="DeepSpeed per-node launcher (PyTorch port): one process "
        "per local GPU")
    parser.add_argument("--node_rank", type=int, default=0,
                        help="Rank of this node in the job")
    parser.add_argument("--master_addr", default="127.0.0.1", type=str,
                        help="Address of the rank-0 node")
    parser.add_argument("--master_port", default=29500, type=int,
                        help="Port of the torch.distributed rendezvous")
    parser.add_argument("--world_info", default="None", type=str,
                        help="base64-encoded {hostname: [gpu ids]} "
                        "dictionary")
    parser.add_argument("training_script", type=str,
                        help="User training script")
    parser.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return parser.parse_args(args=args)


def rank_environments(world_info, node_rank, master_addr, master_port,
                      base_env=None):
    """The environment of each local process, in local-rank order: this
    node's GPUs in CUDA_VISIBLE_DEVICES, the global RANK from world_info's
    order, LOCAL_RANK, WORLD_SIZE and the rendezvous address."""
    nodes = list(world_info.keys())
    local_node = nodes[node_rank]
    local_gpu_ids = world_info[local_node]
    first = sum(len(world_info[n]) for n in nodes[:node_rank])
    world = sum(len(ids) for ids in world_info.values())
    envs = []
    for local_rank in range(len(local_gpu_ids)):
        env = dict(os.environ if base_env is None else base_env)
        env["CUDA_VISIBLE_DEVICES"] = ",".join(map(str, local_gpu_ids))
        env["MASTER_ADDR"] = master_addr
        env["MASTER_PORT"] = str(master_port)
        env["WORLD_SIZE"] = str(world)
        env["RANK"] = str(first + local_rank)
        env["LOCAL_RANK"] = str(local_rank)
        envs.append(env)
    return envs


def main(args=None):
    args = parse_args(args)
    world_info = json.loads(base64.urlsafe_b64decode(args.world_info))
    envs = rank_environments(world_info, args.node_rank, args.master_addr,
                             args.master_port)
    logger.info("launch: node_rank=%d local ranks=%d world_size=%s "
                "rendezvous=%s:%s", args.node_rank, len(envs),
                envs[0]["WORLD_SIZE"] if envs else 0, args.master_addr,
                args.master_port)
    processes = []
    for local_rank, env in enumerate(envs):
        cmd = [sys.executable, "-u", args.training_script,
               "--local_rank={}".format(local_rank)] + \
            args.training_script_args
        processes.append(subprocess.Popen(cmd, env=env))

    def forward(signum, frame):
        for p in processes:
            if p.poll() is None:
                p.send_signal(signum)

    signal.signal(signal.SIGTERM, forward)
    signal.signal(signal.SIGINT, forward)
    alive = list(processes)
    code = 0
    while alive:
        for p in list(alive):
            rc = p.poll()
            if rc is None:
                continue
            alive.remove(p)
            if rc != 0 and code == 0:
                code = rc
                logger.error("launch: rank process %d exited with %d; "
                             "terminating the others", p.pid, rc)
                for q in alive:
                    q.terminate()
        time.sleep(0.05)
    return code


if __name__ == "__main__":
    sys.exit(main())
