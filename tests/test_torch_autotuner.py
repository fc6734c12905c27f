"""The port's autotuner (``ops/autotuner.py``) on the CPU, its sweeps mocked.

The JAX autotuner's tests, ported: the selection order (memo, the user
cache over the bundled table, the default), memoization with tuning off,
an online sweep picking the fastest candidate and writing the user cache
(read back by a fresh process's tables), ``force`` re-sweeping over a
table row, a table-only lookup for a call that cannot sweep, ranks of a
job reading the bundled table only, and no sweep while a stream captures.
The key format is JAX's (``table_key``; the flash signature is JAX's
``flash_signature``), with the port's ``cuda::<device name>`` platform,
and ``validate_table`` accepts the bundled file and refuses what JAX's
refuses. The flash backward consults the table only through
``_flash_bwd_mode``; ``DS_TPU_FLASH_BWD`` overrides it and the 6 MiB rule
stays the default where no row exists.
"""

import json

import jax.numpy as jnp
import pytest
import torch

from deepspeed_tpu.ops.transformer.kernels.attention import (
    flash_signature as jflash_signature)
from deepspeed_tpu_torch.ops import autotuner
from deepspeed_tpu_torch.ops.transformer.kernels import attention

torch.set_num_threads(1)

PLAT = "cuda::NVIDIA H100 80GB HBM3"
KEY = PLAT + "::flash_attention::sig1"


@pytest.fixture()
def tuner(monkeypatch, tmp_path):
    monkeypatch.setattr(autotuner, "_MEMO", {})
    monkeypatch.setattr(autotuner, "_USER", None)
    monkeypatch.setattr(autotuner, "platform", lambda device=None: PLAT)
    monkeypatch.setattr(autotuner, "capturing", lambda: False)
    monkeypatch.delenv("DS_TPU_AUTOTUNE", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    return autotuner


def _tables(monkeypatch, tuner, bundled=None, user=None):
    monkeypatch.setattr(tuner, "_tables",
                        lambda: (bundled or {}, user or {}))


def _runs(log, slow=None):
    def make_run(cand):
        log.append(cand)

        def run():
            if cand == slow:
                sum(range(200000))
        return run
    return make_run


def test_user_table_wins_over_bundled(tuner, monkeypatch):
    _tables(monkeypatch, tuner, bundled={KEY: {"choice": "fused"}},
            user={KEY: {"choice": "split"}})
    got = tuner.autotune("flash_attention", "sig1", ["fused", "split"],
                         make_run=None, default="fused")
    assert got == "split" and tuner._MEMO[KEY] == "split"


def test_default_and_memo_when_tuning_off(tuner, monkeypatch):
    _tables(monkeypatch, tuner)
    log = []
    got = tuner.autotune("flash_attention", "sig1", ["fused", "split"],
                         make_run=_runs(log), default="fused")
    assert got == "fused" and not log and tuner._MEMO[KEY] == "fused"


def test_online_sweep_picks_fastest_and_writes_the_user_cache(tuner,
                                                              monkeypatch):
    monkeypatch.setenv("DS_TPU_AUTOTUNE", "1")
    log = []
    got = tuner.autotune("flash_attention", "sig1", ["fused", "split"],
                         make_run=_runs(log, slow="fused"), default="fused",
                         repeats=2)
    assert got == "split" and log == ["fused", "split"]
    with open(tuner._user_cache_path()) as f:
        row = json.load(f)[KEY]
    assert row["choice"] == "split" and row["candidates_timed"] == 2
    assert set(row["timings"]) == {"fused", "split"}
    assert row["seconds"] == min(row["timings"].values())
    assert tuner.validate_table({KEY: row}) == 1
    # A fresh process: the memo empty, the cache read back from disk.
    monkeypatch.setattr(tuner, "_MEMO", {})
    monkeypatch.setattr(tuner, "_USER", None)
    monkeypatch.delenv("DS_TPU_AUTOTUNE")
    assert tuner.autotune("flash_attention", "sig1", ["fused", "split"],
                          make_run=None, default="fused") == "split"


def test_force_resweeps_despite_table_entry(tuner, monkeypatch):
    monkeypatch.setenv("DS_TPU_AUTOTUNE", "force")
    _tables(monkeypatch, tuner, bundled={KEY: {"choice": "fused"}})
    log = []
    got = tuner.autotune("flash_attention", "sig1", ["fused", "split"],
                         make_run=_runs(log, slow="fused"), default="fused",
                         repeats=1)
    assert log and got == "split"


def test_force_still_serves_table_to_calls_that_cannot_sweep(tuner,
                                                            monkeypatch):
    monkeypatch.setenv("DS_TPU_AUTOTUNE", "force")
    _tables(monkeypatch, tuner, bundled={KEY: {"choice": "split"}})
    assert tuner.autotune("flash_attention", "sig1", [], make_run=None,
                          default="fused") == "split"


def test_multiprocess_uses_bundled_only_and_ignores_force(tuner,
                                                         monkeypatch):
    monkeypatch.setenv("DS_TPU_AUTOTUNE", "force")
    monkeypatch.setattr(tuner, "_multiprocess", lambda: True)
    _tables(monkeypatch, tuner, bundled={KEY: {"choice": "fused"}},
            user={KEY: {"choice": "split"}})
    assert tuner.autotune("flash_attention", "sig1", ["fused", "split"],
                          make_run=None, default="split") == "fused"


def test_no_sweep_while_capturing(tuner, monkeypatch):
    """During a capture only the tables are read; the default is not
    memoized, so an eager call afterwards still sweeps."""
    monkeypatch.setenv("DS_TPU_AUTOTUNE", "1")
    monkeypatch.setattr(tuner, "capturing", lambda: True)
    _tables(monkeypatch, tuner)
    log = []
    got = tuner.autotune("flash_attention", "sig1", ["fused", "split"],
                         make_run=_runs(log), default="fused")
    assert got == "fused" and not log and KEY not in tuner._MEMO
    monkeypatch.setattr(tuner, "capturing", lambda: False)
    tuner.autotune("flash_attention", "sig1", ["fused", "split"],
                   make_run=_runs(log), default="fused", repeats=1)
    assert log == ["fused", "split"]


def test_no_sweep_off_the_card(tuner, monkeypatch):
    monkeypatch.setenv("DS_TPU_AUTOTUNE", "1")
    monkeypatch.setattr(tuner, "platform", lambda device=None: "cpu")
    log = []
    assert tuner.autotune("flash_attention", "sig1", ["fused", "split"],
                          make_run=_runs(log), default="fused") == "fused"
    assert not log


def test_key_and_signature_formats_are_jaxs():
    sig = attention.flash_signature(8, 16, 1024, 1024, 64, torch.bfloat16,
                                    True)
    assert sig == jflash_signature(8, 16, 1024, 1024, 64, jnp.bfloat16,
                                   True)
    assert sig == "b8_h16_tq1024_tkv1024_d64_bfloat16_c1"
    assert autotuner.table_key("flash_attention", sig, "cpu") == \
        "cpu::flash_attention::" + sig
    assert autotuner._split_key(PLAT + "::flash_attention::" + sig) == \
        [PLAT, "flash_attention", sig]


def test_bundled_table_passes_schema_and_holds_card_rows_only():
    with open(autotuner._BUNDLED_PATH) as f:
        table = json.load(f)
    assert autotuner.validate_table(table, source="bundled") == len(table)
    for key, row in table.items():
        assert key.startswith(PLAT + "::flash_attention::"), key
        assert set(row["timings"]) == {"fused", "split"}
        assert row["choice"] == min(row["timings"], key=row["timings"].get)


@pytest.mark.parametrize("table, match", [
    ([1, 2], "JSON object"),
    ({"flash_attention::sig": {"choice": "fused"}}, "does not parse"),
    ({"cuda::::sig": {"choice": "fused"}}, "does not parse"),
    ({KEY: ["fused"]}, "'choice'"),
    ({KEY: {"winner": "fused"}}, "'choice'"),
    ({KEY: {"choice": []}}, "empty choice"),
    ({KEY: {"choice": "fast"}}, "not one of"),
    ({KEY: {"choice": [128]}}, "not one of"),
    ({PLAT + "::other::sig": {"choice": [0]}}, "neither"),
    ({PLAT + "::other::sig": {"choice": True}}, "neither"),
])
def test_validate_table_refuses(table, match):
    with pytest.raises(ValueError, match=match):
        autotuner.validate_table(table)


def test_flash_backward_mode_order(monkeypatch):
    """``DS_TPU_FLASH_BWD`` wins; else the autotuner with the 6 MiB rule as
    its default (fused at T 1024, split at T 8192)."""
    monkeypatch.setattr(autotuner, "_MEMO", {})
    q = torch.zeros(1, 2, 1024, 64, dtype=torch.bfloat16)
    long = torch.zeros(1, 2, 8192, 64, dtype=torch.bfloat16)
    args = (None, None, None, None, True, 0.125)
    monkeypatch.setenv("DS_TPU_FLASH_BWD", "split")
    assert attention._flash_bwd_mode(q, q, q, *args) == "split"
    monkeypatch.delenv("DS_TPU_FLASH_BWD")
    assert attention._flash_bwd_mode(q, q, q, *args) == "fused"
    assert attention._flash_bwd_mode(long, long, long, *args) == "split"
    seen = []
    monkeypatch.setattr(autotuner, "autotune",
                        lambda *a, **k: seen.append((a, k)) or "split")
    assert attention._flash_bwd_mode(q, q, q, *args) == "split"
    (kernel, sig, cands, _), kw = seen[0]
    assert (kernel, cands, kw["default"]) == ("flash_attention",
                                              ["fused", "split"], "fused")
    assert sig == "b1_h2_tq1024_tkv1024_d64_bfloat16_c1"
