"""XᵀX by its upper block triangle (pls_tpu_torch.ops.stats.gram).

On the CPU: the triangle against the whole product in float64 (1e-13
relative) and float32 (within float32 rounding of the float64 XᵀX of the
same values), at K a multiple of the strip width and not; exact symmetry;
the one whole product wherever the planner gives one strip, bit for bit;
the planner's rule at the cells' widths (K = 5000 in strips, nir's 401
whole); and, with a strip width small enough to split the test data, the
downdated cross-validations (k-fold, LOO, LSO) through `global_stats` on
the triangle, in float64 against the JAX package to 1e-10 and with the
widened-bfloat16 X, counted by `gram_calls`.

On the card (`gpu`): the default plan at 20 000 × 5 000 float32 within
1e-6 relative (Frobenius) of the float64 XᵀX and no further from it than
the whole product; exactly symmetric; its peak device memory at most K²·4
bytes above the whole product's, so no copy of X is made.
"""

import jax
import numpy as np
import pytest
import torch

import pls_tpu.cv.kfold as jk
import pls_tpu.cv.loo as jloo
import pls_tpu.cv.lso as jlso
import pls_tpu_torch as tt
from pls_tpu_torch.cv.loo import global_stats
from pls_tpu_torch.ops import stats

TOL = 1e-10


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm(a.double() - b.double()) / torch.linalg.norm(b.double()))


def _data(n=60, k=24, m=2, seed=3):
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, 3))
    X = L @ rng.normal(size=(3, k)) + 0.3 * rng.normal(size=(n, k))
    Y = L @ rng.normal(size=(3, m)) + 0.3 * rng.normal(size=(n, m))
    return (X - X.mean(0)) / X.std(0, ddof=1), (Y - Y.mean(0)) / Y.std(0, ddof=1)


@pytest.fixture
def narrow(monkeypatch):
    """Strips of 8 columns from 16 columns on: the test data in strips."""
    monkeypatch.setattr(stats, "_GRAM_WIDTH", 8)
    monkeypatch.setattr(stats, "_GRAM_MIN_K", 16)


@pytest.mark.parametrize("K", [24, 27, 29])  # a multiple of 8; a short last strip; a long one
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_triangle_matches_whole_product(dtype, K):
    X = torch.from_numpy(np.random.default_rng(K).normal(size=(300, K))).to(dtype)
    plan = stats.gram_plan(K, 8, 0)
    assert len(plan) == round(K / 8) and plan[-1][1] == K
    G = stats.gram(X, plan)
    assert G.dtype == dtype and G.shape == (K, K)
    assert torch.equal(G, G.mT)
    exact = X.double().mT @ X.double()
    if dtype == torch.float64:
        assert _rel(G, exact) < 1e-13
    else:
        assert _rel(G, exact) < 1e-6
        assert _rel(G, X.mT @ X) < 1e-6


def test_triangle_is_exactly_symmetric_on_every_plan():
    X = torch.from_numpy(np.random.default_rng(1).normal(size=(50, 37)))
    for width in (3, 5, 8, 16, 25):
        G = stats.gram(X, stats.gram_plan(37, width, 0))
        assert torch.equal(G, G.mT), width
        assert _rel(G, X.mT @ X) < 1e-13, width


def test_one_strip_is_the_whole_product():
    X = torch.from_numpy(np.random.default_rng(2).normal(size=(80, 401))).float()
    assert stats.gram_plan(401) == [(0, 401, 0, 401)]
    before = dict(stats.gram_calls)
    assert torch.equal(stats.gram(X), X.mT @ X)
    assert stats.gram_calls == {**before, "full": before["full"] + 1}
    # a width that rounds to one strip keeps the whole product too
    assert stats.gram_plan(20, 16, 0) == [(0, 20, 0, 20)]


def test_planner_rule_at_the_cells_widths():
    assert stats._GRAM_WIDTH % 128 == 0
    plan = stats.gram_plan(5000)  # synth100k.kfold10
    assert len(plan) > 1
    assert plan[0][0] == 0 and plan[-1][1] == 5000
    assert all(a[1] == b[0] for a, b in zip(plan, plan[1:]))
    assert all(c0 == r0 and c1 == 5000 for r0, _, c0, c1 in plan)
    assert all(r1 - r0 == stats._GRAM_WIDTH for r0, r1, *_ in plan[:-1])
    assert stats._GRAM_WIDTH / 2 <= plan[-1][1] - plan[-1][0] < 1.5 * stats._GRAM_WIDTH
    assert len(stats.gram_plan(401)) == 1  # nir
    assert len(stats.gram_plan(stats._GRAM_MIN_K - 1)) == 1
    assert len(stats.gram_plan(stats._GRAM_MIN_K)) > 1


def test_global_stats_takes_the_triangle_on_both_branches(narrow):
    X, Y = (torch.from_numpy(a).float() for a in _data(k=29))
    before = stats.gram_calls["triangle"]
    XX, XY, Xs, acc = global_stats(X, Y, None)
    assert stats.gram_calls["triangle"] == before + 1
    assert torch.equal(XX, XX.mT) and _rel(XX, X.mT @ X) < 1e-6
    XX, XY, Xs, acc = global_stats(X, Y, "bf16")  # the widened-bf16 X
    assert stats.gram_calls["triangle"] == before + 2
    assert Xs.dtype == torch.bfloat16 and XX.dtype == acc == torch.float32
    Xw = Xs.float()
    assert torch.equal(XX, XX.mT) and _rel(XX, Xw.double().mT @ Xw.double()) < 1e-6
    assert _rel(XX, Xw.mT @ Xw) < 1e-6


def _j(*a):
    return [jax.numpy.asarray(x) for x in a]


def _t(*a):
    return [torch.from_numpy(np.asarray(x)) for x in a]


def _close(mine, ref):
    mine, ref = np.asarray(mine), np.asarray(ref)
    assert np.abs(mine - ref).max() <= TOL * max(np.abs(ref).max(), 1.0)


def test_downdated_cvs_on_the_triangle_match_jax(narrow):
    X, Y = _data(k=24)
    before = stats.gram_calls["triangle"]
    mine = tt.cv_kfold_downdate(*_t(X, Y), 3, k=5, key=2, batch_size=3)
    assert stats.gram_calls["triangle"] == before + 1
    _close(mine.errors, jk.cv_kfold_downdate(*_j(X, Y), 3, k=5, key=2).errors)
    mine = tt.cv_loo_downdate(*_t(X, Y), 3, batch_size=7)
    _close(mine.errors, jloo.cv_loo_downdate(*_j(X, Y), 3).errors)
    parts = tt.GccRng().lso_partitions(60, 12)
    mine = tt.cv_lso_downdate(*_t(X, Y), 3, 0.3, 12, partitions=parts, batch_size=5)
    _close(mine.errors, jlso.cv_lso_downdate(*_j(X, Y), 3, 0.3, 12, partitions=parts).errors)
    assert stats.gram_calls["triangle"] == before + 3


def test_kfold_bf16_on_the_triangle(narrow, monkeypatch):
    X, Y = (torch.from_numpy(a).float() for a in _data(k=24))
    tri = tt.cv_kfold_downdate(X, Y, 3, k=5, key=2, x_storage="bf16")
    monkeypatch.setattr(stats, "_GRAM_MIN_K", 10**9)  # the whole product
    whole = tt.cv_kfold_downdate(X, Y, 3, k=5, key=2, x_storage="bf16")
    assert _rel(tri.errors, whole.errors) < 1e-5


# ---------- on the card ----------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's products and memory are measured there")
    return torch.device("cuda")


@pytest.mark.gpu
def test_triangle_on_the_card():
    dev = _card()
    from pls_tpu_torch.models.kernel_pls import _prec_ctx

    N, K = 20_000, 5_000
    g = torch.Generator(dev).manual_seed(11)
    X = torch.randn((N, 30), generator=g, device=dev) @ torch.randn((30, K), generator=g, device=dev)
    X += 0.5 * torch.randn((N, K), generator=g, device=dev)
    exact = X.double().mT @ X.double()
    with _prec_ctx("highest"):
        assert len(stats.gram_plan(K)) > 1
        whole = X.mT @ X
        tri = stats.gram(X)
        assert torch.equal(tri, tri.mT)
        e_whole, e_tri = _rel(whole, exact), _rel(tri, exact)
        assert e_tri <= 1e-6 and e_tri <= e_whole, (e_tri, e_whole)
        del whole, tri, exact
        peaks = {}
        for name, fn in (("whole", lambda: X.mT @ X), ("triangle", lambda: stats.gram(X))):
            fn()  # warm: cuBLAS's workspace
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            G = fn()
            torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated() - base
            del G
    assert peaks["triangle"] <= peaks["whole"] + K * K * 4, peaks
