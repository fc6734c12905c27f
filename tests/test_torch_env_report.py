"""``python -m deepspeed_tpu_torch.env_report`` on the CPU: it runs in a
fresh interpreter, says there is no GPU, lists every CUDA library and host
op with its source, the autotune tables, and exits 0.
"""

import os
import subprocess
import sys

import torch

from deepspeed_tpu_torch import env_report
from deepspeed_tpu_torch.op_builder import builder

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_runs_and_exits_zero_without_a_gpu(tmp_path):
    env = dict(os.environ, XDG_CACHE_HOME=str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.env_report"], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    text = out.stdout
    if not torch.cuda.is_available():
        assert "GPU ........" in text and "torch.cuda.is_available() is " \
            "False" in text
    for name in builder.sources():
        assert "csrc/{}.cu".format(name) in text
    for name in ("cpu_adam", "cpu_lamb", "flatten_unflatten", "lut"):
        assert "csrc/host/{}.cpp".format(name) in text
    assert "bundled table" in text and "user cache table" in text
    assert "DS_TPU" not in out.stderr


def test_report_pieces(capsys):
    rows = env_report.op_report()
    kinds = {name: kind for name, kind, *_ in rows}
    assert kinds["lut"] == "host c++" and kinds["flash_attention"] == "cuda"
    assert env_report.main() == 0
    if not torch.cuda.is_available():
        assert env_report.device_report() is None
    assert "lut [host c++]" in capsys.readouterr().out
