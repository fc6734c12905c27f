"""graftlint over the port (``deepspeed_tpu_torch.analysis``), on the CPU.

Each rule has a positive case (source that breaks its invariant in torch
idioms: exactly that rule fires, the stated number of times) and a
negative one (the sanctioned form: silent under every rule). Suppression
comments, the shrink-only baseline and the CLI's exit codes behave as the
JAX package's. The port itself passes against its own baseline, which is
empty, and the JAX package's rules and the port's agree on the JAX
package's own contract markers (``hot_path`` is an identity decorator).
"""

import json
import os

import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.analysis import analyze_source as janalyze_source
from deepspeed_tpu_torch.analysis import (AnalysisConfig, analyze_source,
                                          apply_baseline, collect_findings,
                                          load_baseline, write_baseline)
from deepspeed_tpu_torch.analysis.__main__ import main
from deepspeed_tpu_torch.analysis.annotations import hot_path

torch.set_num_threads(1)

PKG = os.path.dirname(os.path.abspath(deepspeed_tpu_torch.__file__))
BASELINE = os.path.join(PKG, "analysis", "baseline.json")
HOT = "from deepspeed_tpu_torch.analysis.annotations import hot_path\n"

# rule -> (source that breaks it, findings expected, the sanctioned form),
# each file placed at the path the rule scopes.
CASES = {
    "HOSTSYNC": ("deepspeed_tpu_torch/ops/x.py", HOT + (
        "import numpy as np\n"
        "import torch\n"
        "@hot_path\n"
        "def step(t, ev, pool):\n"
        "    a = t.item()\n"
        "    b = t.tolist()\n"
        "    c = t.cpu()\n"
        "    d = int(t[0])\n"
        "    e = np.asarray(t)\n"
        "    torch.cuda.synchronize()\n"
        "    ev.synchronize()\n"
        "    return a, b, c, d, e\n"
        "def elsewhere(engine, kv_pool):\n"
        "    snap = engine._harvest.read()\n"
        "    return kv_pool.max_active_frontier()\n"), 9, HOT + (
        "@hot_path\n"
        "def step(t, n):\n"
        "    return t[:, :int(t.shape[1])] * float(n) + len(t)\n"
        "def report(engine, kv_pool, snap):\n"
        "    return kv_pool.max_active_frontier(snap), engine.metrics()\n")),
    "RECOMPILE": ("deepspeed_tpu_torch/inference/other.py", (
        "import torch\n"
        "def capture(fn):\n"
        "    g = torch.cuda.CUDAGraph()\n"
        "    with torch.cuda.graph(g):\n"
        "        fn()\n"
        "class Engine:\n"
        "    def step(self, x, live):\n"
        "        key = (x.shape[0], bool(live), [1])\n"
        "        self._run_program(key)\n"), 4, (
        "class Engine:\n"
        "    def step(self, pf, live):\n"
        "        key = (pf is not None, any(r.temperature > 0 for r in live))\n"
        "        self._run_program(key)\n")),
    "DONATION": ("deepspeed_tpu_torch/runtime/x.py", (
        "def upload(dev, host, vals):\n"
        "    dev.copy_(host, non_blocking=True)\n"
        "    host[0] = vals\n"
        "def upload2(self, dev):\n"
        "    out = self._stage.to(dev, non_blocking=True)\n"
        "    self._stage.zero_()\n"
        "    return out\n"), 2, (
        "def upload(dev, host, vals, stream):\n"
        "    dev.copy_(host, non_blocking=True)\n"
        "    stream.synchronize()\n"
        "    host[0] = vals\n"
        "def upload2(dev, host):\n"
        "    dev.copy_(host, non_blocking=True)\n"
        "    host = host.clone()\n"
        "    host[0] = 1\n"
        "    return host\n")),
    "DETERMINISM": ("deepspeed_tpu_torch/loadgen/workload.py", (
        "import random\n"
        "import time\n"
        "import numpy as np\n"
        "import torch\n"
        "def draw(n, t):\n"
        "    a = time.time()\n"
        "    b = random.random()\n"
        "    c = np.random.rand(n)\n"
        "    d = torch.randint(0, 9, (n,))\n"
        "    t.normal_()\n"
        "    return a, b, c, d, torch.multinomial(t, 1)\n"), 6, (
        "import numpy as np\n"
        "import torch\n"
        "def draw(n, seed, t):\n"
        "    g = torch.Generator().manual_seed(seed)\n"
        "    rng = np.random.default_rng(seed)\n"
        "    t.normal_(generator=g)\n"
        "    return rng.random(n), torch.randint(0, 9, (n,), generator=g)\n")),
    "THREADRACE": ("deepspeed_tpu_torch/inference/x.py", (
        "class ServingFleet:\n"
        "    _THREAD_OWNED = frozenset({'owned'})\n"
        "    def __init__(self):\n"
        "        self._build()\n"
        "    def _build(self):\n"
        "        self.ok = 1\n"
        "    def pump(self):\n"
        "        self.count = 2\n"
        "        self._build()\n"), 2, (
        "class ServingFleet:\n"
        "    _THREAD_OWNED = frozenset({'owned'})\n"
        "    def __init__(self):\n"
        "        self._build()\n"
        "    def _build(self):\n"
        "        self.ok = 1\n"
        "    def pump(self):\n"
        "        with self._lock:\n"
        "            self.count = 2\n"
        "        self.owned = 3\n")),
    "ADAPTER": ("deepspeed_tpu_torch/inference/engine2.py", (
        "from deepspeed_tpu_torch.models.generation import ServingWeights\n"
        "from deepspeed_tpu_torch.models import generation\n"
        "import deepspeed_tpu_torch.models.generation\n"), 3, (
        "from deepspeed_tpu_torch.inference.adapters.gpt2 import "
        "ServingWeights\n")),
}


@pytest.mark.parametrize("rule", sorted(CASES))
def test_each_rule_fires_on_its_breach_only(rule):
    path, bad, count, _ = CASES[rule]
    findings = analyze_source(path, bad)
    assert {f.rule for f in findings} == {rule}, findings
    assert len(findings) == count, [f.render() for f in findings]


@pytest.mark.parametrize("rule", sorted(CASES))
def test_each_rules_sanctioned_form_is_silent(rule):
    path, _, _, good = CASES[rule]
    assert analyze_source(path, good) == []


def test_sanctioned_sites():
    """The engine's step may read the harvest; the engine's program cache
    and the compiled pipeline may capture; a listed hot function is hot
    without its decorator."""
    read = ("class InferenceEngine:\n"
            "    _THREAD_OWNED = frozenset()\n"
            "    def _step_chunked(self):\n"
            "        return self._harvest.read()\n")
    assert analyze_source("deepspeed_tpu_torch/inference/engine.py",
                          read) == []
    assert len(analyze_source("deepspeed_tpu_torch/inference/fleet.py",
                              read)) == 1
    cap = "import torch\ndef f():\n    return torch.cuda.CUDAGraph()\n"
    assert analyze_source("deepspeed_tpu_torch/runtime/pipe/compiled.py",
                          cap) == []
    inside = ("import torch\nclass _StepGraph:\n    def _begin(self):\n"
              "        return torch.cuda.CUDAGraph()\n")
    assert analyze_source("deepspeed_tpu_torch/inference/engine.py",
                          inside) == []
    hot = "def decode_step(model, tok, cache):\n    return tok.item()\n"
    assert [f.rule for f in analyze_source(
        "deepspeed_tpu_torch/models/generation.py", hot)] == ["HOSTSYNC"]


def test_suppression_comments():
    base = HOT + "@hot_path\ndef step(t):\n"
    same = base + "    return t.item()  # graftlint: disable=HOSTSYNC\n"
    above = base + "    # graftlint: disable=HOSTSYNC\n    return t.item()\n"
    every = base + "    return t.item()  # graftlint: disable=all\n"
    other = base + "    return t.item()  # graftlint: disable=DONATION\n"
    for src in (same, above, every):
        assert analyze_source("deepspeed_tpu_torch/x.py", src) == []
    assert len(analyze_source("deepspeed_tpu_torch/x.py", other)) == 1
    # The JAX analyzer reads the same comments.
    assert janalyze_source("deepspeed_tpu/x.py", same.replace(
        "deepspeed_tpu_torch", "deepspeed_tpu")) == []


def test_baseline_is_shrink_only(tmp_path):
    path, bad, count, _ = CASES["DONATION"]
    findings = analyze_source(path, bad)
    bl = str(tmp_path / "baseline.json")
    write_baseline(bl, findings)
    entries = load_baseline(bl)
    assert len(entries) == count
    new, stale = apply_baseline(findings, entries)
    assert new == [] and stale == []
    new, stale = apply_baseline(findings[:1], entries)  # one debt paid
    assert new == [] and len(stale) == 1
    new, stale = apply_baseline(findings, entries[:1])  # one new finding
    assert len(new) == 1 and stale == []


def test_cli_exit_codes(tmp_path, capsys):
    bad = tmp_path / "deepspeed_tpu_torch" / "runtime" / "x.py"
    bad.parent.mkdir(parents=True)
    bad.write_text(CASES["DONATION"][1])
    bl = str(tmp_path / "bl.json")
    assert main([str(bad), "--baseline", "none"]) == 1
    assert main([str(bad), "--baseline", bl, "--write-baseline"]) == 0
    assert main([str(bad), "--baseline", bl]) == 0
    bad.write_text(CASES["DONATION"][3])
    assert main([str(bad), "--baseline", bl]) == 1  # stale entries
    capsys.readouterr()
    assert main([str(bad), "--baseline", "none", "--format", "json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["findings"] == [] and out["baseline_size"] == 0


def test_the_port_passes_against_its_baseline(capsys):
    """``python -m deepspeed_tpu_torch.analysis deepspeed_tpu_torch``: no
    new finding and no stale entry; the baseline is empty."""
    findings = collect_findings([PKG], AnalysisConfig())
    baseline = load_baseline(BASELINE)
    new, stale = apply_baseline(findings, baseline)
    assert new == [], "\n".join(f.render() for f in new)
    assert stale == [] and baseline == []
    assert main([PKG]) == 0
    assert "0 new finding(s)" in capsys.readouterr().out


def test_hot_path_is_an_identity_decorator_on_the_ports_sites():
    from deepspeed_tpu_torch.inference.adapters.gpt2 import GPT2Adapter
    from deepspeed_tpu_torch.ops.transformer.kernels import decode_attention

    def f(x):
        return x

    assert hot_path(f) is f and f.__graftlint_hot_path__
    for fn in (decode_attention.flash_decode_attention,
               decode_attention.quantize_kv, GPT2Adapter.decode_step):
        assert getattr(fn, "__graftlint_hot_path__", False), fn
    n = sum(open(os.path.join(root, name)).read().count("\n@hot_path\n") +
            open(os.path.join(root, name)).read().count("    @hot_path\n")
            for root, _, files in os.walk(PKG) for name in files
            if name.endswith(".py") and "analysis" not in root)
    assert n == 32  # the JAX package's 34 sites but its two write-backs
