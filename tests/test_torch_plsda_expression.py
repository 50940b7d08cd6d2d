"""PLS-DA of the port against the benchmark's plain float64 reference
(`portbench/reference/plsda.py`) on seeded tumour expression profiles
(`portbench/expression.py`, the model of the `tcga-pancan-plsda-10k-20k-33`
configuration): 33 tumour types (M = 33, one past the Jacobi kernel's 32,
so every component's eigenvector takes `torch.linalg.eigh`), an odd gene
count, and unexpressed genes that `ZScorer` maps to 0.

On the CPU at small sizes; on the card (marked gpu) at the configuration's
own shape, 10 267 × 20 531, A = 32, where every pass takes the cluster
path with 4-byte staging.  Compared as the cell compares (`jobs/plsda.py`):
B at every truncation, T up to sign, the held-out decision values, and the
held-out classes where the reference's top two lie more than the margin
apart.  On the CPU the classifier is also held to the JAX package's
(`pls_tpu.models.plsda.PLSDAClassifier`) in float64 on the same 33 types."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pls_tpu.models.plsda import PLSDAClassifier as JaxPLSDA
from pls_tpu_torch.models import predict
from pls_tpu_torch.models.plsda import PLSDAClassifier
from pls_tpu_torch.ops import deflate, eigen
from portbench import expression
from portbench.common import rel, rel_columns
from portbench.reference import plsda as ref_plsda

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "portbench/configs/tcga-pancan-plsda-10k-20k-33.json").read_text())
LIMITS = json.loads((ROOT / "portbench/limits/pancan.plsda-f32.json").read_text())
# (coef, scores, decision) relative tolerances.  float32 on the CPU: the
# largest of 6 seeds at each size read 1.4e-6, 2.5e-6 and 8.8e-7, about
# 2**-24 amplified by X's conditioning and the components' eigengaps;
# float64: the same algorithm apart only in summation order
TOL = {torch.float32: (2e-5, 3e-5, 1e-5), torch.float64: (1e-10, 1e-10, 1e-10)}


def _readings(clf, A, X, y, X_new, margin):
    """(coef, scores, decision) relative gaps and the clear classes missed."""
    want = ref_plsda.fit(X, y, A)
    B = [predict.coefficients(clf._fit, c) for c in range(1, A + 1)]
    ref_d = want.decision(X_new)
    got_d = torch.as_tensor(clf.decision_function(X_new))
    top2 = torch.topk(ref_d, 2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > margin
    moved = torch.argmax(got_d.to(ref_d.device), 1) != torch.argmax(ref_d, 1)
    return (max(rel(B[c], want.B[c]) for c in range(A)), rel_columns(clf._fit.T, want.fit.T),
            rel(got_d, ref_d), int((moved & clear).sum()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("N,K", [(300, 1537), (600, 401)], ids=["k_above_n", "k_below_n"])
def test_the_classifier_matches_the_reference_on_33_types(N, K, dtype):
    X, y, X_new, _ = expression.library({**CONFIG, "N": N, "K": K}, 64, N + K, "cpu")
    X, X_new = X.to(dtype), X_new.to(dtype)
    A = 8
    before = dict(eigen.path_calls)
    clf = PLSDAClassifier(n_components=A, device="cpu").fit(X, y.numpy())
    assert eigen.path_calls == {**before, "eigh": before["eigh"] + A}
    assert list(clf.classes_) == list(range(33))
    coef, scores, decision, missed = _readings(clf, A, X, y, X_new, 1e-3)
    tol = TOL[dtype]
    assert coef <= tol[0] and scores <= tol[1] and decision <= tol[2], (coef, scores, decision)
    assert missed == 0


def test_the_classifier_matches_jax_on_33_types():
    # float64 on both sides, constant genes included: the same z-scoring
    # and guard, the same 33 indicator columns, the same eight components
    X, y, X_new, _ = expression.library({**CONFIG, "N": 300, "K": 1537}, 64, 17, "cpu")
    X, X_new, y = X.double().numpy(), X_new.double().numpy(), y.numpy()
    mine = PLSDAClassifier(n_components=8, device="cpu").fit(X, y)
    ref = JaxPLSDA(8).fit(X, y)
    assert list(mine.classes_) == list(ref.classes_) == list(range(33))
    for got, want in ((mine.decision_function(X_new), ref.decision_function(X_new)),
                      (mine.predict_proba(X_new), ref.predict_proba(X_new))):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, atol=1e-9 * np.abs(want).max())
    np.testing.assert_array_equal(mine.predict(X_new), ref.predict(X_new))
    T, Tref = mine.transform(X_new), np.asarray(ref.transform(X_new))
    np.testing.assert_allclose(T * np.sign(np.sum(T * Tref, 0)), Tref,
                               atol=1e-9 * np.abs(Tref).max())


def test_constant_genes_take_unit_spread_and_score_zero():
    X, y, X_new, _ = expression.library({**CONFIG, "N": 120, "K": 900}, 40, 3, "cpu")
    const = (X == 0).all(0)
    assert int(const.sum()) == 9
    clf = PLSDAClassifier(n_components=4, device="cpu").fit(X, y.numpy())
    assert bool((clf._x_scaler.stdev[const] == 1).all())
    assert bool((clf._scale_x(X_new)[:, const] == 0).all())
    assert bool(torch.isfinite(torch.as_tensor(clf.decision_function(X_new))).all())


def test_held_out_types_are_mostly_told_apart_at_the_cut():
    X, y, X_new, y_new = expression.library({**CONFIG, "N": 600, "K": 1537}, 200, 5, "cpu")
    clf = PLSDAClassifier(n_components=32, device="cpu").fit(X, y.numpy())
    assert np.mean(clf.predict(X_new) == y_new.numpy()) >= 0.7  # chance is 1/33


@pytest.mark.gpu
def test_the_cell_s_fit_on_the_card_matches_the_reference():
    # the timed job at the configuration's shape: 32 passes on the cluster
    # path (vec 1, clusters of 2, "split" staging), 32 eigenvectors by
    # eigh, within the cell's limits of the float64 reference
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's shape on the card")
    dev = torch.device("cuda", 0)
    A = CONFIG["A"]
    X, y, X_new, _ = expression.library(CONFIG, 2000, 2**31 + 21, dev)
    assert X.shape == (10_267, 20_531)
    paths, eigs = dict(deflate.path_calls), dict(eigen.path_calls)
    stagings = dict(deflate.staging_calls)
    clf = PLSDAClassifier(n_components=A, device=dev).fit(X, y.cpu().numpy())
    torch.cuda.synchronize()
    assert deflate.path_calls == {**paths, "cluster": paths["cluster"] + A}
    # K odd: every row slice's aligned body by one bulk copy, its edges by words
    assert deflate.staging_calls == {**stagings, "split": stagings["split"] + A}
    assert eigen.path_calls == {**eigs, "eigh": eigs["eigh"] + A}
    Xz = clf._scale_x(X)
    plan = deflate.plan_for(Xz, torch.zeros(X.shape[1], device=dev))
    assert (plan.path, plan.vec, plan.C) == ("cluster", 1, 2)
    coef, scores, decision, missed = _readings(clf, A, X, y, X_new, LIMITS["margins"]["decision"])
    assert coef <= LIMITS["coef_rel"] and scores <= LIMITS["scores_rel"], (coef, scores)
    assert decision <= LIMITS["decision_rel"] and missed == 0, (decision, missed)
