"""The port's two measurement tools: `pls_tpu_torch.tools.accumulator_sweep`
(the chunk-size sweep of the streaming statistics update) and
`pls_tpu_torch.tools.flagship_wall` (the cold-process wall of the nir CLI).

Without a card the sweep and the flagship wall on the card exit 1; the
flagship wall on the CPU runs the nir CLI in a subprocess and prints its
JSON keys.  The runs on the card are marked `gpu` and skip here.
"""

from __future__ import annotations

import json

import pytest
import torch

from pls_tpu_torch.tools import accumulator_sweep, flagship_wall

FLAGSHIP_KEYS = {"workload", "device", "walls_sec", "cold_sec", "warm_best_sec"}
SWEEP_ROW_KEYS = {"ms_per_update", "tflops", "chunk_gbps", "gemm_tflops", "gemm_share",
                  "ms_range"}


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tool measures the card")


@pytest.mark.parametrize("tool,argv", [(accumulator_sweep, []),
                                       (flagship_wall, []),
                                       (flagship_wall, ["--device", "cuda", "--runs", "1"])],
                         ids=["accumulator_sweep", "flagship_wall", "flagship_wall_cuda"])
def test_exits_1_without_a_card(monkeypatch, capsys, tool, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main(argv) == 1
    captured = capsys.readouterr()
    assert "no CUDA device" in captured.err and captured.out == ""


def test_flagship_wall_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "flagship.json"
    assert flagship_wall.main(["--device", "cpu", "--runs", "1", "--out", str(out)]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec) == FLAGSHIP_KEYS and rec["device"] == "cpu"
    assert len(rec["walls_sec"]) == 1 and rec["cold_sec"] == rec["warm_best_sec"] > 0
    assert json.loads(out.read_text()) == rec


def test_flagship_wall_refuses_no_runs():
    with pytest.raises(SystemExit):
        flagship_wall.main(["--device", "cpu", "--runs", "0"])


@pytest.mark.gpu
def test_accumulator_sweep_on_the_card(capsys):
    _needs_card()
    assert accumulator_sweep.main(["--k", "1024", "--m", "4", "--chunks", "1024", "2048",
                                   "--reps", "2"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["K"] == 1024 and rec["M"] == 4 and rec["device"]
    assert set(rec["sweep"]) == {"f32_1024", "bf16_1024", "f32_2048", "bf16_2048"}
    for row in rec["sweep"].values():
        assert set(row) == SWEEP_ROW_KEYS
        assert row["ms_per_update"] > 0 and 0 < row["gemm_share"]
        assert row["ms_range"][0] <= row["ms_range"][1]


@pytest.mark.gpu
def test_flagship_wall_on_the_card(capsys):
    _needs_card()
    assert flagship_wall.main(["--runs", "2"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec) == FLAGSHIP_KEYS and torch.cuda.get_device_name(0) in rec["device"]
    assert rec["warm_best_sec"] == min(rec["walls_sec"]) and rec["cold_sec"] == rec["walls_sec"][0]
