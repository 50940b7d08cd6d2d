"""The port's entry points run on the card unless the caller asks for the CPU.

With `torch.cuda.is_available` patched to False (a machine with no card),
each entry point that makes its own tensors raises RuntimeError naming
`device="cpu"` when it is given no device, and runs on the CPU when it is
given one.  A tensor the caller passes keeps its device.  The CLI, the
`.npy` entry points and `default_device` are checked in
tests/test_torch_deflate.py.  The entry points of the rest of the public
API (inference, select, sampling, transfer, checkpoint and the model
families that take numpy data) are called through `_numpy_entry`.
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


def _load_fit(tmp_path, **device):
    import pls_tpu_torch as tt

    path = str(tmp_path / "fit.npz")
    tt.save_fit(PLSModel(X, Y, max_components=2, device="cpu").fit_state, path)
    return tt.load_fit(path, **device).W


def _load_fit_orbax(tmp_path, **device):
    import pls_tpu_torch as tt

    tt.save_fit_orbax(PLSModel(X, Y, max_components=2, device="cpu").fit_state,
                      str(tmp_path / "ckpt"))
    return tt.load_fit_orbax(str(tmp_path / "ckpt"), **device).W


def _recursive(tmp_path, **device):
    import pls_tpu_torch as tt

    return tt.RecursivePLS(5, 2, **device).update(X, Y).XX


def _oplsda_classifier(tmp_path, **device):
    import pls_tpu_torch as tt

    est = tt.OPLSDAClassifier(1, 1, **device).fit(X, (Y[:, 0] > 0).astype(int))
    return est._fit.W_o


def _numpy_entry(name, *args, **kw):
    """An entry point of pls_tpu_torch taking numpy data, called on X/Y's
    rows; the result's first tensor."""
    def call(tmp_path, **device):
        import pls_tpu_torch as tt

        out = getattr(tt, name)(*args, **kw, **device)
        while not isinstance(out, torch.Tensor):
            fields = [f for f in ("W", "F", "V", "pls", "paths_se", "WJ") if hasattr(out, f)]
            if isinstance(out, tuple):
                out = out[0]
            elif fields:
                out = getattr(out, fields[0])
            else:  # numpy results (indices, iPLS/UVE tables): computed where asked
                return torch.zeros(0, device=device.get("device", "cuda"))
        return out

    call.__name__ = "_" + name
    return call


_T = np.arange(24.0) % 7 + 1.0
_EVENT = (np.arange(24) % 3 > 0).astype(float)
_X3 = np.stack([X, 0.5 * X], axis=2)  # (24, 5, 2)
_XNAN = X.copy()
_XNAN[2, 1] = np.nan
_BLOCKS = [[0, 1], [2, 3, 4]]

ENTRY_POINTS = [_model, _load, _fit_from_numpy, _stats_accumulator, _fold_stats_accumulator,
                _collect_moments, _fit_streaming, _fit_streaming_csv, _stats_from_numpy,
                _load_fit, _load_fit_orbax, _recursive, _oplsda_classifier,
                _numpy_entry("jackknife_coefficients", X, Y, 2),
                _numpy_entry("coefficient_significance", X, Y, 2),
                _numpy_entry("permutation_test", X, Y, 2, 3, 0),
                _numpy_entry("ipls", X, Y, 2, 2, 3),
                _numpy_entry("ipls_forward", X, Y, 2, 2, 3),
                _numpy_entry("ipls_backward", X, Y, 2, 2, 3),
                _numpy_entry("uve_pls", X, Y, 2, 3),
                _numpy_entry("kennard_stone", X, 4),
                _numpy_entry("spxy", X, Y, 4),
                _numpy_entry("duplex", X, 4),
                _numpy_entry("ks_train_test_split", X, train_size=4),
                _numpy_entry("direct_standardization", X, 1.1 * X),
                _numpy_entry("piecewise_ds", X, 1.1 * X, 1, 1),
                _numpy_entry("epo", X, 2),
                _numpy_entry("epo_difference_matrix", X, 1.1 * X),
                _numpy_entry("fit_mbpls", [X[:, :2], X[:, 2:]], Y, 2),
                _numpy_entry("fit_plscox", X, _T, _EVENT, 2),
                _numpy_entry("fit_npls", _X3, Y, 2),
                _numpy_entry("fit_o2pls", X, Y, 1, 1, 1),
                _numpy_entry("nan_column_stats", _XNAN),
                _numpy_entry("fit_nipals_missing", _XNAN, Y, 2),
                _numpy_entry("impute_pls", _XNAN, Y, 2, n_outer=2),
                _numpy_entry("fit_plspm", X, _BLOCKS, [[0, 0], [1, 0]]),
                _numpy_entry("bootstrap_plspm", X, _BLOCKS, [[0, 0], [1, 0]], 3)]


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
