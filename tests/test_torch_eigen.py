"""The dominant eigenvector (pls_tpu_torch.ops.eigen): its Jacobi kernel,
the kernel's plain twin, and the choice of path.

`jacobi_dominant_plain` repeats `csrc/eigen.cu` operation for operation in
float64.  On the CPU it is held to LAPACK's `eigh` (`torch.linalg.eigh`) up
to sign: 1e-12 for float64 C (an eigenvector's error is about ε‖C‖ over
the eigengap: 2e-13 at the 1e-3 relative gap below), and 1e-6 relative
for float32 C against float64 `eigh` of the same float32 values (the
result is rounded to float32 once).  The matrices: random PSD,
rank-deficient PSD, diagonal, and PSD with a 1e-3 relative gap between
its two largest eigenvalues, at M = 1, 2, 3, 10, 17 and 32.  On them the
sweep cap is never reached, and the sign and tie rules hold.  A float64
fit whose eigenvectors the twin takes matches the JAX package's fit
(`pls_tpu.models.kernel_pls.fit`, eigh there) to 1e-10 after aligning
each component's sign, as tests/test_torch_kernel_pls.py holds the port's
own fit.

The CUDA kernel runs only on a card: those cases are marked `gpu` and
skip here.  On the card they hold the kernel to the twin bit for bit (the
same IEEE operations in the same order) and to float64 `eigh` as above,
at batches 1, 8 and 600;
relaunches are bit-identical; M = 33 takes `eigh`, in float64 for float32
C too, and a float32 fit at 3000×700×33 matches the JAX package's float64
fit within 1e-5 of each array's largest entry; a 20-component
float32 fit at 2000×300×10 makes no host sync and matches the CPU's
float64 fit within chip_smoke.py's FIT_COEF_RTOL; and float64 fits on the
card, every eigenvector by the kernel, match the JAX package's fit on the
CPU as above (1e-10 up to sign).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pls_tpu as pt
from pls_tpu.models import kernel_pls as jax_kernel_pls
import pls_tpu_torch as tt
from pls_tpu_torch.models import kernel_pls
from pls_tpu_torch.ops import eigen

MS = (1, 2, 3, 10, 17, 32)
KINDS = ("psd", "rank", "diagonal", "gap")
FIT_COEF_RTOL = 1e-3  # chip_smoke.py: float32 against float64 of the same fit


def _matrices(kind: str, B: int, M: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    if kind == "psd":
        G = rng.normal(size=(B, M, M))
    elif kind == "rank":
        G = rng.normal(size=(B, M, max(1, M // 3)))
    elif kind == "diagonal":
        return torch.from_numpy(np.stack([np.diag(rng.permutation(M) + 1.0) for _ in range(B)]))
    else:
        out = []
        for _ in range(B):
            Q, _ = np.linalg.qr(rng.normal(size=(M, M)))
            lam = rng.uniform(0.0, 0.9, M)
            lam[0] = 1.0
            if M > 1:
                lam[1] = 1.0 - 1e-3
            out.append((Q * lam) @ Q.T)
        return torch.from_numpy(np.stack(out))
    return torch.from_numpy(G @ np.swapaxes(G, 1, 2))


def _eigh_error(v: torch.Tensor, C: torch.Tensor) -> float:
    """Largest entry of |v − ±u| over the batch, u the dominant eigenvector
    of float64 `eigh` of C (as stored), its sign aligned to v."""
    u = torch.linalg.eigh(C.double().cpu()).eigenvectors[..., -1]
    v = v.double().cpu()
    s = torch.where((v * u).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    return float((v - s * u).abs().max())


def _assert_sign_rule(v: torch.Tensor) -> None:
    big = v.abs().argmax(-1, keepdim=True)  # the first of equal magnitudes
    assert bool((torch.take_along_dim(v, big, -1) > 0).all())


def _fit_data(seed: int, n: int, k: int, m: int, a: int = 4):
    """tests/test_torch_kernel_pls.py's inputs: a rank-a latent model plus
    noise, z-scored, float64."""
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, a))
    X = L @ rng.normal(size=(a, k)) + 0.1 * rng.normal(size=(n, k))
    Y = L @ rng.normal(size=(a, m)) + 0.1 * rng.normal(size=(n, m))
    X = (X - X.mean(0)) / X.std(0, ddof=1)
    Y = (Y - Y.mean(0)) / Y.std(0, ddof=1)
    return X, Y


def _assert_matches_jax(f, X, Y, A: int, method: str, atol: float = 1e-10,
                        scaled: float = 0.0) -> None:
    """f (the port's fit, any device) against the JAX package's float64
    fit of the same inputs on the CPU: W, P, R, Q, T after aligning each
    component's sign by W, and the coefficients directly, each within atol
    plus `scaled` times its largest entry."""
    ref = jax_kernel_pls.fit(jnp.asarray(X), jnp.asarray(Y), A, pt.METHOD(method))
    mine = {name: getattr(f, name).double().cpu().numpy() for name in ("W", "P", "R", "Q", "T")}
    mine["B"] = tt.coefficients(f).double().cpu().numpy()
    s = np.sign(np.sum(mine["W"] * np.asarray(ref.W), axis=0))
    s[s == 0] = 1.0
    for name, v in mine.items():
        r = np.asarray(pt.coefficients(ref) if name == "B" else getattr(ref, name))
        assert v.shape == r.shape, name
        if v.size:
            tol = atol + scaled * np.abs(r).max()
            np.testing.assert_allclose(v if name == "B" else v * s, r, atol=tol, err_msg=name)


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("kind", KINDS)
def test_jacobi_plain_matches_lapack(kind, M):
    C = _matrices(kind, 8, M, seed=M)
    v, sweeps = eigen._jacobi(C)
    assert int(sweeps.max()) < eigen.MAX_SWEEPS
    assert _eigh_error(v, C) < 1e-12
    _assert_sign_rule(v)
    C32 = C.float()
    v32 = eigen.jacobi_dominant_plain(C32)
    assert v32.dtype == torch.float32
    assert _eigh_error(v32, C32) < 1e-6
    _assert_sign_rule(v32)
    if kind == "diagonal":  # no rotation: the unit vector of the largest entry
        assert torch.equal(v, torch.nn.functional.one_hot(C.diagonal(0, -2, -1).argmax(-1), M).double())


def test_jacobi_plain_tie_rules():
    # a tie of eigenvalues: the lowest index
    C = torch.diag(torch.tensor([1.0, 3.0, 0.5, 3.0], dtype=torch.float64))
    assert eigen.jacobi_dominant_plain(C).tolist() == [0.0, 1.0, 0.0, 0.0]
    # the sign, where the two entries differ by rounding alone
    for off in (-1.0, 1.0):
        v = eigen.jacobi_dominant_plain(torch.tensor([[1.0, off], [off, 1.0]], dtype=torch.float64))
        _assert_sign_rule(v)
        assert abs(float(v[0] * v[1]) - off / 2) < 1e-15
    # a zero matrix: the first unit vector; a non-finite entry: NaN
    assert eigen.jacobi_dominant_plain(torch.zeros(3, 3)).tolist() == [1.0, 0.0, 0.0]
    C = torch.eye(3, dtype=torch.float64)
    C[1, 2] = float("inf")
    assert bool(torch.isnan(eigen.jacobi_dominant_plain(C)).all())


@pytest.mark.parametrize("M", [4, 33])
def test_cpu_takes_eigh(M):
    C = _matrices("psd", 5, M, seed=1)
    before = dict(eigen.path_calls)
    v = eigen.dominant_eigenvector(C)
    assert eigen.path_calls == {**before, "eigh": before["eigh"] + 1}
    assert torch.equal(v, torch.linalg.eigh(C).eigenvectors[..., -1])


def test_power_iters_take_the_power_method():
    C = _matrices("psd", 5, 4, seed=2)
    before = dict(eigen.path_calls)
    v = eigen.dominant_eigenvector(C, 40)
    assert eigen.path_calls == {**before, "power": before["power"] + 1}
    assert _eigh_error(v, C) < 1e-8


@pytest.mark.parametrize("C,match", [
    (torch.eye(3), "CUDA"),
    (torch.eye(3, dtype=torch.float64), "CUDA"),
    (torch.eye(3, dtype=torch.bfloat16), "float32/float64"),
    (torch.eye(3, dtype=torch.float16), "float32/float64"),
    (torch.zeros(3, 4), r"\(\.\.\., M, M\)"),
    (torch.zeros(3), r"\(\.\.\., M, M\)"),
    (torch.eye(33), "M <= 32"),
    (torch.eye(4)[:, ::2][:2], "contiguous"),
])
def test_cuda_wrapper_refuses(C, match):
    before = dict(eigen.path_calls)
    with pytest.raises(ValueError, match=match):
        eigen.jacobi_dominant_cuda(C)
    assert eigen.path_calls == before  # a refused call launches nothing and counts nothing


@pytest.mark.parametrize("method", ["kernel1", "kernel2"])
def test_fit_through_the_twin_matches_jax(monkeypatch, method):
    calls = []

    def twin(C, power_iters=None):
        assert power_iters is None
        calls.append(C.shape)
        return eigen.jacobi_dominant_plain(C)

    monkeypatch.setattr(kernel_pls, "dominant_eigenvector", twin)
    X, Y = _fit_data(seed=9, n=60, k=15, m=3)
    f = kernel_pls.fit(torch.from_numpy(X), torch.from_numpy(Y), 5, tt.METHOD(method))
    assert calls == [(3, 3)] * 5
    _assert_matches_jax(f, X, Y, 5, method)


# ---------- on the card ----------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 8, 600])
@pytest.mark.parametrize("M", MS)
def test_kernel_matches_plain_and_eigh(M, B):
    dev = _card()
    for kind in KINDS:
        C = _matrices(kind, B, M, seed=M + B)
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-6)):
            Cd = C.to(dtype)
            before = eigen.path_calls["kernel"]
            v = eigen.dominant_eigenvector(Cd.to(dev))
            assert eigen.path_calls["kernel"] == before + 1
            assert v.dtype == dtype and v.shape == (B, M)
            plain = eigen.jacobi_dominant_plain(Cd)
            assert torch.equal(v.cpu(), plain), (kind, dtype)
            assert _eigh_error(v, Cd) < tol, (kind, dtype)
            _assert_sign_rule(v.cpu())


@pytest.mark.gpu
def test_kernel_rules_and_relaunch():
    dev = _card()
    C = _matrices("psd", 64, 10, seed=5).to(dev)
    a = eigen.dominant_eigenvector(C)
    b = eigen.dominant_eigenvector(C)
    assert torch.equal(a, b)
    _assert_sign_rule(a.cpu())
    C2 = torch.tensor([[1.0, -1.0], [-1.0, 1.0]], dtype=torch.float64)
    assert torch.equal(eigen.dominant_eigenvector(C2.to(dev)).cpu(), eigen.jacobi_dominant_plain(C2))
    D = torch.diag(torch.tensor([1.0, 3.0, 0.5, 3.0], dtype=torch.float64, device=dev))
    assert eigen.dominant_eigenvector(D).tolist() == [0.0, 1.0, 0.0, 0.0]
    bad = torch.eye(3, device=dev)
    bad[0, 1] = float("nan")
    assert bool(torch.isnan(eigen.dominant_eigenvector(bad)).all())
    # a batch with no matrix launches nothing
    assert eigen.dominant_eigenvector(torch.zeros(0, 3, 3, device=dev)).shape == (0, 3)
    # a strided C runs on its contiguous copy
    wide = _matrices("psd", 4, 6, seed=6).to(dev)
    assert torch.equal(eigen.dominant_eigenvector(wide.mT),
                       eigen.dominant_eigenvector(wide.mT.contiguous()))


@pytest.mark.gpu
def test_wide_m_takes_eigh_on_the_card():
    # past the kernel's 32 eigh solves in float64, as the kernel does, and
    # rounds float32 C's vector to float32 once
    dev = _card()
    C = _matrices("psd", 3, 33, seed=7)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-6)):
        Cd = C.to(dtype)
        before = dict(eigen.path_calls)
        v = eigen.dominant_eigenvector(Cd.to(dev))
        assert eigen.path_calls == {**before, "eigh": before["eigh"] + 1}
        assert v.dtype == dtype and v.shape == (3, 33)
        assert _eigh_error(v, Cd) < tol, dtype


@pytest.mark.gpu
def test_fit_on_the_card_makes_no_host_sync():
    dev = _card()
    rng = np.random.default_rng(8)
    L = rng.normal(size=(2000, 12))
    X = L @ rng.normal(size=(12, 300)) + 0.3 * rng.normal(size=(2000, 300))
    Y = L @ rng.normal(size=(12, 10)) + 0.1 * rng.normal(size=(2000, 10))
    X = (X - X.mean(0)) / X.std(0, ddof=1)
    Y = (Y - Y.mean(0)) / Y.std(0, ddof=1)
    Xc, Yc = torch.from_numpy(X).float().to(dev), torch.from_numpy(Y).float().to(dev)
    kernel_pls.fit(Xc, Yc, 20)  # builds and loads the kernels
    torch.cuda.synchronize()
    before = dict(eigen.path_calls)
    torch.cuda.set_sync_debug_mode("error")
    try:
        f = kernel_pls.fit(Xc, Yc, 20)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert eigen.path_calls == {**before, "kernel": before["kernel"] + 20}
    ref = kernel_pls.fit(torch.from_numpy(X), torch.from_numpy(Y), 20)
    B, Bref = (fit.R.double().cpu() @ fit.Q.double().cpu().T for fit in (f, ref))
    assert float(torch.linalg.norm(B - Bref) / torch.linalg.norm(Bref)) < FIT_COEF_RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["kernel1", "kernel2"])
def test_float64_card_fit_matches_jax(method):
    dev = _card()
    X, Y = _fit_data(seed=10, n=400, k=40, m=3)
    before = dict(eigen.path_calls)
    f = kernel_pls.fit(torch.from_numpy(X).to(dev), torch.from_numpy(Y).to(dev), 8,
                       tt.METHOD(method))
    assert eigen.path_calls == {**before, "kernel": before["kernel"] + 8}
    assert f.W.is_cuda and f.W.dtype == torch.float64
    _assert_matches_jax(f, X, Y, 8, method)


@pytest.mark.gpu
def test_float32_card_fit_past_the_kernel_matches_jax():
    # M = 33, one past the kernel: every eigenvector by eigh in float64,
    # the passes in float32.  Each entry within 1e-5 of its array's
    # largest: the passes' 700-term float32 sums are about 2**-24 * 700**0.5
    # = 1.6e-6 of it; the CPU's float32 fit, eigh in float32, read up to
    # 5e-6 (T) at these inputs
    dev = _card()
    X, Y = _fit_data(seed=11, n=3000, k=700, m=33, a=8)
    before = dict(eigen.path_calls)
    f = kernel_pls.fit(torch.from_numpy(X).float().to(dev), torch.from_numpy(Y).float().to(dev), 8)
    assert eigen.path_calls == {**before, "eigh": before["eigh"] + 8}
    assert f.W.is_cuda and f.W.dtype == torch.float32
    _assert_matches_jax(f, X, Y, 8, "kernel1", atol=0.0, scaled=1e-5)
