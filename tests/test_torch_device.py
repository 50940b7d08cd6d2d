"""The port's entry points run on the card unless the caller asks for the CPU.

With `torch.cuda.is_available` patched to False (a machine with no card),
each entry point that makes its own tensors raises RuntimeError naming
`device="cpu"` when it is given no device, and runs on the CPU when it is
given one.  A tensor the caller passes keeps its device.  The CLI, the
`.npy` entry points and `default_device` are checked in
tests/test_torch_deflate.py.
"""

import numpy as np
import pytest
import torch

from pls_tpu_torch import config
from pls_tpu_torch.convert import fit_from_numpy, fit_to_numpy, stats_from_numpy
from pls_tpu_torch.model import PLSModel
from pls_tpu_torch.models import streaming

_RNG = np.random.default_rng(10)
X = _RNG.normal(size=(24, 5))
Y = _RNG.normal(size=(24, 2))


def _chunks():
    return [(X[:12], Y[:12]), (X[12:], Y[12:])]


def _model(tmp_path, **device):
    return PLSModel(X, Y, max_components=2, **device).W


def _load(tmp_path, **device):
    path = str(tmp_path / "model.npz")
    PLSModel(X, Y, max_components=2, device="cpu").save(path, include_data=True)
    return PLSModel.load(path, **device).X


def _fit_from_numpy(tmp_path, **device):
    fit = PLSModel(X, Y, max_components=2, device="cpu").fit_state
    return fit_from_numpy(fit_to_numpy(fit), "kernel1", **device).W


def _stats_accumulator(tmp_path, **device):
    return streaming.StatsAccumulator(5, 2, **device).update(X, Y).XX


def _fold_stats_accumulator(tmp_path, **device):
    return streaming.FoldStatsAccumulator(5, 2, 2, **device).update(X, Y, np.arange(24) % 2).XXf


def _collect_moments(tmp_path, **device):
    return streaming.collect_moments(_chunks(), 5, 2, **device)[0]


def _fit_streaming(tmp_path, **device):
    return streaming.fit_streaming(_chunks(), 5, 2, 2, **device).W


def _fit_streaming_csv(tmp_path, **device):
    xp, yp = tmp_path / "x.csv", tmp_path / "y.csv"
    np.savetxt(xp, X, delimiter=",")
    np.savetxt(yp, Y, delimiter=",")
    return streaming.fit_streaming_csv(xp, yp, 2, chunk_rows=8, **device).W


def _stats_from_numpy(tmp_path, **device):
    arrays = dict(XX=X.T @ X, XY=X.T @ Y, YY=Y.T @ Y, sx=X.sum(0), sy=Y.sum(0), n=24)
    return stats_from_numpy(arrays, **device).XX


ENTRY_POINTS = [_model, _load, _fit_from_numpy, _stats_accumulator, _fold_stats_accumulator,
                _collect_moments, _fit_streaming, _fit_streaming_csv, _stats_from_numpy]


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ENTRY_POINTS, ids=lambda f: f.__name__.lstrip("_"))
def test_entry_point_needs_the_cpu_asked_for(entry, no_card, tmp_path):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        entry(tmp_path)
    assert entry(tmp_path, device="cpu").device.type == "cpu"


def test_model_follows_the_device_of_its_tensors(no_card):
    m = PLSModel(torch.from_numpy(X), torch.from_numpy(Y), max_components=2)
    assert m.X.device.type == m.W.device.type == "cpu"


@pytest.mark.parametrize("device,like,expected", [
    ("cpu", None, "cpu"), (None, torch.zeros(1), "cpu"), ("cpu", np.zeros(1), "cpu"),
])
def test_resolve_device(device, like, expected, no_card):
    assert config.resolve_device(device, like).type == expected
    with pytest.raises(RuntimeError, match="--device cpu"):
        config.resolve_device(None, np.zeros(1))
