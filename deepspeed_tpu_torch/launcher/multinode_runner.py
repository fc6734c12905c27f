"""Multi-node runners (counterpart of
``deepspeed_tpu/launcher/multinode_runner.py``; the reference's
PDSHRunner, OpenMPIRunner and MVAPICHRunner): each builds the command line
that starts the job on every node. pdsh starts one
``deepspeed_tpu_torch.launcher.launch`` per node, which starts a process
per GPU; the MPI runners start one rank per GPU slot themselves
(``utils/distributed.mpi_discovery`` reads their environment).
"""

import os
import shutil
import sys
import tempfile
from abc import ABC, abstractmethod

from deepspeed_tpu_torch.utils.logging import logger


class MultiNodeRunner(ABC):
    def __init__(self, args, world_info_base64):
        self.args = args
        self.user_arguments = self.parse_user_args()
        self.user_script = args.user_script
        self.world_info_base64 = world_info_base64
        self.exports = {}

    @abstractmethod
    def backend_exists(self):
        ...

    @abstractmethod
    def get_cmd(self, environment, active_resources):
        ...

    def add_export(self, key, var):
        self.exports[key.strip()] = var.strip()

    def parse_user_args(self):
        return self.args.user_args


class PDSHRunner(MultiNodeRunner):
    def __init__(self, args, world_info_base64):
        super().__init__(args, world_info_base64)

    def backend_exists(self):
        return shutil.which("pdsh") is not None

    def get_cmd(self, environment, active_resources):
        environment["PDSH_RCMD_TYPE"] = "ssh"
        active_workers = ",".join(active_resources.keys())
        logger.info("Running on the following workers: %s", active_workers)

        pdsh_cmd_args = ["pdsh", "-f", "1024", "-w", active_workers]
        exports = ""
        for key, val in self.exports.items():
            exports += "export {}={}; ".format(key, val)

        # %n maps to the pdsh node index → node_rank (reference :62-69).
        deepspeed_launch = [
            exports,
            "cd {};".format(os.path.abspath(".")),
            sys.executable, "-u", "-m", "deepspeed_tpu_torch.launcher.launch",
            "--world_info={}".format(self.world_info_base64),
            "--node_rank=%n",
            "--master_addr={}".format(self.args.master_addr),
            "--master_port={}".format(self.args.master_port),
        ]
        return pdsh_cmd_args + deepspeed_launch + [self.user_script] + \
            list(self.user_arguments)


class OpenMPIRunner(MultiNodeRunner):
    def __init__(self, args, world_info_base64, resource_pool):
        super().__init__(args, world_info_base64)
        self.resource_pool = resource_pool

    def backend_exists(self):
        return shutil.which("ompi_info") is not None

    def get_cmd(self, environment, active_resources):
        # One rank per GPU slot.
        total_processes = sum(len(s) for s in self.resource_pool.values())
        hosts = ",".join("{}:{}".format(h, len(s))
                         for h, s in self.resource_pool.items())
        mpirun_cmd = [
            "mpirun", "-n", str(total_processes), "-host", hosts,
            "--mca", "btl", "^openib",
            "--mca", "btl_tcp_if_include", "eth0",
        ] + self.args.launcher_args.split()
        export_cmd = []
        for key, val in self.exports.items():
            export_cmd += ["-x", "{}={}".format(key, val)]
        python_exec = [sys.executable, "-u"]
        return mpirun_cmd + export_cmd + python_exec + [self.user_script] + \
            list(self.user_arguments)


class MVAPICHRunner(MultiNodeRunner):
    def __init__(self, args, world_info_base64, resource_pool):
        super().__init__(args, world_info_base64)
        self.resource_pool = resource_pool
        # The reference's MVAPICH defaults (CUDA-aware, GPUDirect RDMA).
        self.add_export("MV2_SMP_USE_CMA", "0")
        self.add_export("MV2_DEBUG_SHOW_BACKTRACE", "1")
        self.add_export("MV2_USE_CUDA", "1")
        self.add_export("MV2_SUPPORT_DL", "1")
        self.add_export("MV2_ENABLE_AFFINITY", "0")
        self.add_export("MV2_INTER_ALLGATHER_TUNING", "5")
        self.add_export("MV2_CUDA_USE_NAIVE", "0")

    def backend_exists(self):
        mpiname_exists = shutil.which("mpiname") is not None
        if not mpiname_exists:
            logger.warning("mpiname does not exist, mvapich is not installed "
                           "properly")
        return mpiname_exists

    def get_cmd(self, environment, active_resources):
        total_processes = sum(len(s) for s in self.resource_pool.values())
        hostfile = os.path.join(tempfile.gettempdir(),
                                "deepspeed_mvapich_hostfile")
        with open(hostfile, "w") as fd:
            for host, slots in self.resource_pool.items():
                fd.write("{}:{}\n".format(host, len(slots)))
        mpirun_cmd = [
            "mpirun", "-np", str(total_processes), "--hostfile", hostfile,
        ] + self.args.launcher_args.split()
        export_cmd = []
        for key, val in self.exports.items():
            export_cmd += ["-env", "{}={}".format(key, val)]
        python_exec = [sys.executable, "-u"]
        return mpirun_cmd + export_cmd + python_exec + [self.user_script] + \
            list(self.user_arguments)
