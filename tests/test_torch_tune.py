"""The port's tuning (tune.py) against the JAX package's.

Inputs are made from a seed with numpy; both packages run in float64 on
the CPU.  `kfold_split` is index-for-index `pls_tpu.tune.kfold_split` for
the same key (an int seed here, `jax.random.key(seed)` there).
`grid_search_cv` on its fast path (masked fits per setting, every
n_components read off the largest; the folds in one batch, or in batches
of 1 and 2) and on the estimator loop gives JAX's per-fold RMSE to 1e-9
relative and the same best parameters; the paths agree with each other
as they do in the JAX package.  `nested_cv_components` and `nested_grid_search_cv` choose what
JAX chooses, with the same fold RMSEP to 1e-9; `tune_spls_keepx` and
`tune_kpls` too.  The `gpu` case runs the batched grid search in float32
on the card against its folds' un-batched fits (K1) and the estimator
loop.
"""

import jax
import numpy as np
import pytest
import torch

import pls_tpu as pt
import pls_tpu_torch as tt
from pls_tpu import tune as jtune
from pls_tpu_torch import tune as ttune

RTOL = 1e-9


def _data(seed=0, n=60, k=10, m=1, noise=0.3):
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, 3))
    X = L @ rng.normal(size=(3, k)) + noise * rng.normal(size=(n, k)) + rng.normal(size=k)
    Y = L @ rng.normal(size=(3, m)) + noise * rng.normal(size=(n, m)) + 5.0
    return X, Y


def _results_equal(mine, ref, rtol=RTOL):
    best_t, res_t = mine
    best_j, res_j = ref
    assert best_t.params == best_j.params
    assert len(res_t) == len(res_j)
    for a, b in zip(res_t, res_j):
        assert a.params == b.params
        np.testing.assert_allclose(a.fold_rmse, b.fold_rmse, rtol=rtol)
        assert a.rmse == pytest.approx(b.rmse, rel=rtol)


@pytest.mark.parametrize("n,k,seed", [(23, 4, 0), (60, 5, 1), (101, 7, 42), (10, 10, None)])
def test_kfold_split_equals_jax(n, k, seed):
    mine = ttune.kfold_split(n, k, seed)
    ref = jtune.kfold_split(n, k, None if seed is None else jax.random.key(seed))
    for (a, b), (c, d) in zip(mine, ref):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    with pytest.raises(ValueError):
        ttune.kfold_split(10, 11)


@pytest.mark.parametrize("batched", [None, False])
@pytest.mark.parametrize("grid", [{"n_components": [1, 2, 4, 6]},
                                  {"n_components": [2, 3], "scale": [True, False]},
                                  {"method": ["kernel1", "kernel2"]}],
                         ids=["ncomp", "mixed", "method"])
def test_grid_search_cv_matches_jax(grid, batched):
    X, Y = _data(seed=2, m=2)
    tgrid, jgrid = dict(grid), dict(grid)
    if "method" in grid:
        tgrid["method"] = [tt.METHOD(v) for v in grid["method"]]
        jgrid["method"] = [pt.METHOD(v) for v in grid["method"]]
    mine = tt.grid_search_cv(lambda: tt.PLSRegressor(device="cpu"), tgrid, X, Y, n_folds=5,
                             key=1, batched=batched)
    ref = pt.grid_search_cv(pt.PLSRegressor, jgrid, X, Y, n_folds=5, key=jax.random.key(1),
                            batched=batched)
    for r in mine[1] + [mine[0]]:  # the params carry the port's METHOD: compare by value
        r.params = {k: getattr(v, "value", v) for k, v in r.params.items()}
    for r in ref[1] + [ref[0]]:
        r.params = {k: getattr(v, "value", v) for k, v in r.params.items()}
    _results_equal(mine, ref)


def test_batched_path_equals_the_estimator_loop():
    X, Y = _data(seed=3)
    grid = {"n_components": [1, 3, 5]}
    fast = tt.grid_search_cv(lambda: tt.PLSRegressor(device="cpu"), grid, X, Y, key=0)
    slow = tt.grid_search_cv(lambda: tt.PLSRegressor(device="cpu"), grid, X, Y, key=0,
                             batched=False)
    _results_equal(fast, slow, 1e-9)


@pytest.mark.parametrize("batch_size", [1, 2])
def test_fold_batches_equal_one_batch(batch_size):
    # un-batched fits (1) and a short last batch (2 of 5) against the one
    # batch the policy gives data this small; with and without scaling
    X, Y = _data(seed=9, m=2)
    grid = {"n_components": [1, 3, 5], "scale": [True, False]}
    one = tt.grid_search_cv(lambda: tt.PLSRegressor(device="cpu"), grid, X, Y, key=4)
    some = tt.grid_search_cv(lambda: tt.PLSRegressor(device="cpu"), grid, X, Y, key=4,
                             batch_size=batch_size)
    _results_equal(some, one, 1e-10)


def test_grid_search_takes_tensors_on_their_device():
    X, Y = _data(seed=4)
    a = tt.grid_search_cv(lambda: tt.PLSRegressor(device="cpu"), {"n_components": [1, 2]},
                          torch.as_tensor(X), torch.as_tensor(Y), key=2)
    b = tt.grid_search_cv(lambda: tt.PLSRegressor(device="cpu"), {"n_components": [1, 2]},
                          X, Y, key=2, batched=False)
    _results_equal(a, b, 1e-9)
    c = tt.grid_search_cv(lambda: tt.PLSRegressor(device="cpu"), {"n_components": [1, 2]},
                          torch.as_tensor(X), torch.as_tensor(Y), key=2, batched=False)
    _results_equal(b, c, 0)


@pytest.mark.parametrize("select", ["wilcoxon", "min"])
def test_nested_cv_components_matches_jax(select):
    X, Y = _data(seed=5, n=70, m=2)
    X = (X - X.mean(0)) / X.std(0, ddof=1)
    Y = (Y - Y.mean(0)) / Y.std(0, ddof=1)
    mine = tt.nested_cv_components(X, Y, 6, k_outer=4, k_inner=5, select=select, key=3,
                                   device="cpu")
    ref = pt.nested_cv_components(X, Y, 6, k_outer=4, k_inner=5, select=select, key=3)
    np.testing.assert_array_equal(mine.chosen, ref.chosen)
    np.testing.assert_allclose(mine.fold_rmsep, ref.fold_rmsep, rtol=RTOL)
    np.testing.assert_allclose(mine.rmsep, ref.rmsep, rtol=RTOL)
    with pytest.raises(ValueError, match="unknown select"):
        tt.nested_cv_components(X, Y, 3, select="max", device="cpu")


def test_nested_grid_search_cv_matches_jax():
    X, Y = _data(seed=6, n=50)
    mine = tt.nested_grid_search_cv(lambda: tt.PLSRegressor(device="cpu"),
                                    {"n_components": [1, 2, 4]}, X, Y, k_outer=3, k_inner=4,
                                    key=7)
    ref = pt.nested_grid_search_cv(pt.PLSRegressor, {"n_components": [1, 2, 4]}, X, Y,
                                   k_outer=3, k_inner=4, key=7)
    assert list(mine.chosen) == list(ref.chosen)
    np.testing.assert_allclose(mine.fold_rmsep, ref.fold_rmsep, rtol=RTOL)
    np.testing.assert_allclose(mine.rmsep, ref.rmsep, rtol=RTOL)


def test_tune_spls_keepx_matches_jax():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(48, 20))
    beta = np.zeros(20)
    beta[[4, 11, 15]] = [2.0, -2.0, 1.5]
    y = X @ beta + 0.1 * rng.normal(size=48)
    mine = tt.tune_spls_keepx(X, y, 1, [1, 3, 20], n_folds=4, key=3, device="cpu")
    ref = pt.tune_spls_keepx(X, y, 1, [1, 3, 20], n_folds=4, key=jax.random.key(3))
    _results_equal(mine, ref)
    assert mine[0].params["keep_x"] == 3


def test_tune_kpls_matches_jax():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(40, 3))
    y = np.sin(2 * X[:, 0]) + 0.1 * rng.normal(size=40)
    mine = tt.tune_kpls(X, y, gamma_grid=[0.1, 1.0], ncomp_grid=[2, 4], n_folds=4, key=5,
                        device="cpu")
    ref = pt.tune_kpls(X, y, gamma_grid=[0.1, 1.0], ncomp_grid=[2, 4], n_folds=4,
                       key=jax.random.key(5))
    _results_equal(mine, ref, 1e-8)


def test_nested_cv_needs_the_card_without_a_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: numpy data goes to it")
    X, Y = _data()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.nested_cv_components(X, Y, 3)


def test_estimator_profile_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run")
    from pls_tpu_torch.tools import estimator_profile

    assert estimator_profile.main([]) == 1


@pytest.mark.gpu
def test_batched_grid_search_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pls_tpu_torch.ops import deflate

    X, Y = _data(seed=8, n=2000, k=100, m=3)
    grid = {"n_components": [1, 3, 6]}
    card = tt.grid_search_cv(lambda: tt.PLSRegressor(), grid, X, Y, key=0)
    before = deflate.launches["deflate_f32"]
    per_fold = tt.grid_search_cv(lambda: tt.PLSRegressor(), grid, X, Y, key=0, batch_size=1)
    assert deflate.launches["deflate_f32"] - before == 5 * 6  # K1, A_max a fold
    slow = tt.grid_search_cv(lambda: tt.PLSRegressor(), grid, X, Y, key=0, batched=False)
    for other in (per_fold, slow):
        assert card[0].params == other[0].params
        for a, b in zip(card[1], other[1]):
            np.testing.assert_allclose(a.fold_rmse, b.fold_rmse, rtol=1e-4)
