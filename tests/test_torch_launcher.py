"""Port parity for the launcher: ``launcher/runner.py``'s hostfile parsing,
``--include``/``--exclude`` filters and ``world_info`` against
``deepspeed_tpu/launcher/runner.py`` (the JAX ``test_run.py`` cases), the
multi-node command lines, and ``launcher/launch.py``'s per-GPU spawn (the
reference's torch semantics; the JAX launcher starts one process per
host): the environment of each rank, argument passing, and a failing
rank failing the launch."""

import base64
import collections
import json
import os
import subprocess
import sys
import time

import pytest

from deepspeed_tpu.launcher import runner as jrun
from deepspeed_tpu_torch.launcher import launch as tlaunch
from deepspeed_tpu_torch.launcher import runner as trun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pool():
    return collections.OrderedDict([("worker-0", 4), ("worker-1", 4)])


def test_hostfile_parses_as_jax(tmp_path):
    hf = tmp_path / "hostfile"
    hf.write_text("worker-0 slots=4\nworker-1 slots=2\n\n")
    assert trun.fetch_hostfile(str(hf)) == jrun.fetch_hostfile(str(hf))
    assert trun.fetch_hostfile(str(tmp_path / "absent")) is None


@pytest.mark.parametrize("text", ["worker-0 slots=four\n",
                                  "worker-0 slots=4\nworker-0 slots=2\n"])
def test_bad_hostfile_raises_as_jax(tmp_path, text):
    hf = tmp_path / "hostfile"
    hf.write_text(text)
    with pytest.raises(ValueError):
        jrun.fetch_hostfile(str(hf))
    with pytest.raises(ValueError):
        trun.fetch_hostfile(str(hf))


FILTERS = [("worker-0", ""), ("worker-1:0,2", ""),
           ("worker-0@worker-1:0,2", ""), ("", "worker-1:0"),
           ("", "worker-0"), ("", ""), ("worker-1:3,1,1", "")]


@pytest.mark.parametrize("include,exclude", FILTERS)
def test_include_exclude_match_jax(include, exclude):
    assert trun.parse_inclusion_exclusion(_pool(), include, exclude) == \
        jrun.parse_inclusion_exclusion(_pool(), include, exclude)


@pytest.mark.parametrize("include,exclude", [
    ("worker-0", "worker-1"), ("worker-9", ""), ("worker-0:9", "")])
def test_bad_filters_raise_as_jax(include, exclude):
    with pytest.raises(ValueError) as want:
        jrun.parse_inclusion_exclusion(_pool(), include, exclude)
    with pytest.raises(ValueError) as got:
        trun.parse_inclusion_exclusion(_pool(), include, exclude)
    assert str(got.value) == str(want.value)


def test_world_info_encodes_as_jax():
    info = {"worker-0": [0, 1], "worker-1": [0]}
    assert trun.encode_world_info(info) == jrun.encode_world_info(info)
    assert json.loads(base64.urlsafe_b64decode(
        trun.encode_world_info(info))) == info


def test_parse_args_match_jax():
    argv = ["--hostfile", "hf", "--num_nodes", "2", "--num_gpus", "4",
            "--master_port", "29600", "--master_addr", "10.0.0.1",
            "train.py", "--deepspeed_config", "ds.json"]
    got, want = vars(trun.parse_args(argv)), vars(jrun.parse_args(argv))
    assert got == want


def test_pdsh_command_starts_the_ports_launch_per_node():
    from deepspeed_tpu_torch.launcher.multinode_runner import PDSHRunner

    args = trun.parse_args(["--master_addr", "10.0.0.1", "train.py",
                            "--deepspeed_config", "ds.json"])
    runner = PDSHRunner(args, "e30=")
    runner.add_export("NCCL_DEBUG", "INFO")
    cmd = runner.get_cmd({}, _pool())
    line = " ".join(cmd)
    assert cmd[0] == "pdsh" and "worker-0,worker-1" in line
    assert "deepspeed_tpu_torch.launcher.launch" in line
    assert "--node_rank=%n" in line and "export NCCL_DEBUG=INFO" in line
    assert cmd[-3:] == ["train.py", "--deepspeed_config", "ds.json"]


def test_mpi_commands_start_one_rank_per_gpu(tmp_path, monkeypatch):
    import tempfile

    from deepspeed_tpu_torch.launcher.multinode_runner import (
        MVAPICHRunner, OpenMPIRunner)

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # its hostfile

    args = trun.parse_args(["train.py"])
    active = collections.OrderedDict([("worker-0", [0, 1, 2, 3]),
                                      ("worker-1", [0, 2])])
    cmd = OpenMPIRunner(args, "e30=", active).get_cmd({}, active)
    assert cmd[cmd.index("-n") + 1] == "6"
    assert cmd[cmd.index("-host") + 1] == "worker-0:4,worker-1:2"
    cmd = MVAPICHRunner(args, "e30=", active).get_cmd({}, active)
    assert cmd[cmd.index("-np") + 1] == "6"
    assert (tmp_path / "deepspeed_mvapich_hostfile").read_text() == \
        "worker-0:4\nworker-1:2\n"


def test_rank_environments_over_two_nodes():
    info = {"a": [0, 1], "b": [2, 3, 5]}
    envs = tlaunch.rank_environments(info, 1, "10.0.0.1", 29700,
                                     base_env={})
    assert [e["RANK"] for e in envs] == ["2", "3", "4"]
    assert [e["LOCAL_RANK"] for e in envs] == ["0", "1", "2"]
    assert {e["WORLD_SIZE"] for e in envs} == {"5"}
    assert {e["CUDA_VISIBLE_DEVICES"] for e in envs} == {"2,3,5"}
    assert {e["MASTER_ADDR"] for e in envs} == {"10.0.0.1"}
    assert {e["MASTER_PORT"] for e in envs} == {"29700"}


def _launch(tmp_path, script_text, args=(), timeout=60):
    script = tmp_path / "stub.py"
    script.write_text(script_text)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    return subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.launcher.runner",
         "--num_gpus", "2", "--master_port", "29871", str(script)] +
        list(args), capture_output=True, text=True, timeout=timeout,
        env=env, cwd=str(tmp_path))


def test_runner_spawns_one_process_per_gpu(tmp_path):
    """``runner --num_gpus 2`` on a host without a hostfile: two processes,
    each with its rank's environment and ``--local_rank`` first."""
    proc = _launch(tmp_path, (
        "import json, os, sys\n"
        "keys = ('MASTER_ADDR', 'MASTER_PORT', 'RANK', 'WORLD_SIZE',\n"
        "        'LOCAL_RANK', 'CUDA_VISIBLE_DEVICES')\n"
        "with open('rank_' + os.environ['RANK'] + '.json', 'w') as f:\n"
        "    json.dump([{k: os.environ.get(k) for k in keys},\n"
        "               sys.argv[1:]], f)\n"), ["--flag", "v"])
    assert proc.returncode == 0, proc.stderr
    assert sorted(os.listdir(tmp_path)) == ["rank_0.json", "rank_1.json",
                                            "stub.py"]
    for r in range(2):
        env, argv = json.loads((tmp_path / "rank_{}.json".format(r))
                               .read_text())
        assert env == {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "29871",
                       "RANK": str(r), "WORLD_SIZE": "2",
                       "LOCAL_RANK": str(r), "CUDA_VISIBLE_DEVICES": "0,1"}
        assert argv == ["--local_rank={}".format(r), "--flag", "v"]


def test_a_failing_rank_fails_the_launch(tmp_path):
    """Rank 1 exits 3 at once while rank 0 would sleep for a minute: the
    launcher terminates rank 0 and exits 3."""
    t0 = time.monotonic()
    proc = _launch(tmp_path, (
        "import os, sys, time\n"
        "if os.environ['RANK'] == '1':\n"
        "    sys.exit(3)\n"
        "time.sleep(60)\n"))
    assert proc.returncode == 3
    assert time.monotonic() - t0 < 30


def test_runner_without_gpus_or_num_gpus_raises(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no GPU resources"):
        trun.main(["--hostfile", str(tmp_path / "absent"), "train.py"])
