"""The check's power: a run whose timed path is broken underneath comes
out not correct, and so does the control (the reference one precision
down in the program's place).  At a tiny size on the CPU; the control at
the cell's own size runs on the card (marked gpu).

The faults each cell can have, planted in the program by monkeypatching:
- "state": a step that returns its state unchanged (every component after
  the first repeats the first);
- "half": half of the batch left out, the rest standing for it (the
  deflation pass over half of X's rows, doubled; LOO/LSO fold batches
  whose second half reuses the first half's models; k-fold downdates by
  half of each fold's rows, scaled up);
- "answer": an answer altered where it is produced (the largest
  coefficient doubled; one row's CV errors doubled).
One card holds every cell, so no exchange between chips can be left out.
"""

from __future__ import annotations

import json
import math

import pytest
import torch

import pls_tpu_torch.cv.kfold as kfold
import pls_tpu_torch.cv.loo as loo
import pls_tpu_torch.cv.lso as lso
import pls_tpu_torch.models.kernel_pls as kp
import pls_tpu_torch.models.predict as predict
from pls_tpu_torch.model import PLSModel
from pls_tpu_torch.types import PLSFit, Residual
from portbench import control, harness
from portbench.tests import tiny

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def _repeat_first(fit: PLSFit, A: int) -> PLSFit:
    rep = lambda v: v[..., :1].expand(*v.shape[:-1], A).contiguous()  # noqa: E731
    return PLSFit(W=rep(fit.W), P=rep(fit.P), Q=rep(fit.Q), R=rep(fit.R),
                  T=rep(fit.T) if fit.T.shape[-1] else fit.T, method=fit.method)


def state(mp):
    fk, k2 = kp._fit_kernel, kp._kernel2_loop
    mp.setattr(kp, "_fit_kernel", lambda X, Y, A, *a, **k: _repeat_first(fk(X, Y, 1, *a, **k), A))
    mp.setattr(kp, "_kernel2_loop",
               lambda mv, XY, A, *a, **k: _repeat_first(k2(mv, XY, 1, *a, **k), A))


def half(mp):
    dp = kp.deflate_pass

    def half_pass(X, r):
        n = X.shape[0] // 2
        t, tt, p = dp(X[:n].contiguous(), r)
        return torch.cat([t, t.new_zeros(X.shape[0] - n)]), 2 * tt, 2 * p

    mp.setattr(kp, "deflate_pass", half_pass)
    for mod in (loo, lso):
        ff = mod.fit_folds

        def half_folds(X, Y, masks, A, *a, _ff=ff, **k):
            h = (masks.shape[0] + 1) // 2
            f = _ff(X, Y, masks[:h], A, *a, **k)
            idx = torch.arange(masks.shape[0]) % h
            return PLSFit(W=f.W[idx], P=f.P[idx], Q=f.Q[idx], R=f.R[idx], T=f.T[idx],
                          method=f.method)

        mp.setattr(mod, "fit_folds", half_folds)
    bd = kfold.fit_from_stats_blockdowndated

    def half_rows(XX, XY, Xf, Yf, A, **k):
        n = Xf.shape[-2] // 2
        return bd(XX, XY, Xf[..., :n, :] * math.sqrt(2), Yf[..., :n, :] * math.sqrt(2), A, **k)

    mp.setattr(kfold, "fit_from_stats_blockdowndated", half_rows)


def answer(mp):
    coef = predict.coefficients

    def altered(fit, comp=None):
        B = coef(fit, comp).clone()
        flat = B.view(-1)
        flat[flat.abs().argmax()] *= 2
        return B

    mp.setattr(predict, "coefficients", altered)
    for name in ("cv_LOO", "cv_KFOLD"):
        cv = getattr(PLSModel, name)

        def doubled(self, *a, _cv=cv, **k):
            r = _cv(self, *a, **k)
            e = r.errors.clone()
            e[:, 0] *= 2
            return Residual(errors=e, method=r.method)

        mp.setattr(PLSModel, name, doubled)


@pytest.mark.parametrize("fault", [state, half, answer], ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch, tmp_path):
    fault(monkeypatch)
    _, _, (correct, rows, failed) = tiny.run(workload, tmp_path)
    assert not correct and failed > 0, rows


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    c = tiny.cell(workload)
    got = control.readings(workload, 2**31 + 9, "cpu", True, c)
    limits = {k: v for k, v in c.limits.items() if k != "margins"}
    assert all(got["program"][k] <= v for k, v in limits.items()), got
    assert any(got["control"][k] > v for k, v in limits.items()), got


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control at the cell's own size")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct_at_the_cell_size(workload, card):
    c = harness.Cell.load(workload)
    limits = {k: v for k, v in c.limits.items() if k != "margins"}
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        got = control.readings(workload, seed, card, True, c)
        assert all(got["program"][k] <= v for k, v in limits.items()), got
        assert any(got["control"][k] > v for k, v in limits.items()), got
