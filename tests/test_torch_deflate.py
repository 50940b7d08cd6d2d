"""The port's deflation pass (pls_tpu_torch.ops.deflate) against the JAX package.

`deflate_pass_plain` is the CUDA kernel's plain twin.  It is held against
the TPU kernel itself, `pls_tpu.ops.deflate._deflate_pass_pallas`, run in
interpret mode on the CPU as tests/test_pallas.py runs it, for float32 and
bfloat16 X; in float64 against `deflate_pass_xla`.  Inputs come from numpy
with a seed and go to both packages as the same arrays.

Tolerances: in float32 and bf16 both sides accumulate in float32 in
another order, so t, p and tt agree to 1e-5 relative to their largest
entry (the TPU kernel's own contract against f64, tools/tpu_smoke.py:67).
The bf16 inputs are bit-identical (both packages round to nearest even).
In float64 the two products agree to 1e-12.

The CUDA kernel itself runs only on a card: those cases are marked `gpu`
and skip here.  On the card they hold the kernel against the plain version
on the same inputs (1e-5 relative) at the CPU shapes, at K too wide for
the staged form (the two-pass wide-K form), and with an r that is not
16-byte aligned.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pls_tpu.ops.deflate import _deflate_pass_pallas, deflate_pass_xla
from pls_tpu_torch.ops import deflate
from pls_tpu_torch.utils import nvcc

SHAPES = [(256, 128), (300, 200), (64, 640), (130, 128), (60, 401)]


def _operands(N, K, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(N, K)), rng.normal(size=K)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,K", SHAPES)
def test_plain_matches_pallas_kernel(N, K, dtype):
    X, r = _operands(N, K)
    X32, r32 = X.astype(np.float32), r.astype(np.float32)
    Xj = jnp.asarray(X32).astype(dtype)
    t, tt, p = _deflate_pass_pallas(Xj, jnp.asarray(r32), interpret=True)
    Xt = torch.from_numpy(X32).to(getattr(torch, dtype))
    np.testing.assert_array_equal(Xt.float().numpy(), np.asarray(Xj.astype(jnp.float32)))
    t2, tt2, p2 = deflate.deflate_pass_plain(Xt, torch.from_numpy(r32))
    assert t2.dtype == tt2.dtype == p2.dtype == torch.float32
    assert t2.shape == (N,) and p2.shape == (K,) and tt2.shape == ()
    assert _rel(t2, t) < 1e-5
    assert _rel(p2, p) < 1e-5
    assert abs(float(tt2) - float(tt)) / float(tt) < 1e-5


@pytest.mark.parametrize("N,K", [(256, 128), (60, 401)])
def test_plain_matches_xla_in_float64(N, K):
    X, r = _operands(N, K, seed=1)
    t, tt, p = deflate_pass_xla(jnp.asarray(X), jnp.asarray(r))
    t2, tt2, p2 = deflate.deflate_pass_plain(torch.from_numpy(X), torch.from_numpy(r))
    assert t2.dtype == torch.float64
    np.testing.assert_allclose(t2.numpy(), np.asarray(t), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(p2.numpy(), np.asarray(p), rtol=1e-12, atol=1e-10)
    assert abs(float(tt2) - float(tt)) / float(tt) < 1e-12


def test_cpu_tensor_takes_plain_version_and_counts_nothing():
    X, r = _operands(64, 32, seed=2)
    Xt, rt = torch.from_numpy(X).float(), torch.from_numpy(r).float()
    before = dict(deflate.launches)
    out = deflate.deflate_pass(Xt, rt)
    for a, b in zip(out, deflate.deflate_pass_plain(Xt, rt)):
        assert torch.equal(a, b)
    assert deflate.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_dispatcher_takes_plain_version_off_the_kernel(dtype):
    # a CPU tensor of any dtype, like float64 X on a card, never reaches the kernel
    X, r = _operands(48, 24, seed=5)
    Xt = torch.from_numpy(X).to(dtype)
    rt = torch.from_numpy(r).to(torch.float64 if dtype == torch.float64 else torch.float32)
    before = dict(deflate.launches)
    out = deflate.deflate_pass(Xt, rt)
    for a, b in zip(out, deflate.deflate_pass_plain(Xt, rt)):
        assert torch.equal(a, b)
    assert deflate.launches == before


def test_cuda_wrapper_refuses_cpu_tensors():
    X, r = _operands(16, 8, seed=3)
    with pytest.raises(ValueError, match="CUDA"):
        deflate.deflate_pass_cuda(torch.from_numpy(X).float(), torch.from_numpy(r).float())


def test_nvcc_missing_raises(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        nvcc.nvcc_path()


def test_library_name_follows_source():
    path = nvcc.library_path("deflate.cu")
    assert path.parent == nvcc.BUILD_DIR
    assert path.name.startswith("deflate-") and path.suffix == ".so"
    assert path == nvcc.library_path("deflate.cu")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,K", SHAPES + [(4096, 5000)])
def test_cuda_kernel_matches_plain(N, K, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    X, r = _operands(N, K, seed=4)
    _kernel_vs_plain(torch.from_numpy(X).float().cuda().to(dtype),
                     torch.from_numpy(r).float().cuda())


def _kernel_vs_plain(Xc, rc):
    name = deflate.kernel_name(Xc.dtype)
    before = deflate.launches[name]
    t, tt, p = deflate.deflate_pass(Xc, rc)
    t2, tt2, p2 = deflate.deflate_pass(Xc, rc)
    torch.cuda.synchronize()
    assert deflate.launches[name] == before + 2
    assert torch.equal(t, t2) and torch.equal(p, p2) and torch.equal(tt, tt2)
    tp, ttp, pp = deflate.deflate_pass_plain(Xc, rc)
    assert _rel(t.cpu(), tp.cpu()) < 1e-5
    assert _rel(p.cpu(), pp.cpu()) < 1e-5
    assert abs(float(tt) - float(ttp)) / float(ttp) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,K", [(64, 20000), (300, 30000), (33, 30001)])
def test_cuda_kernel_wide_k(N, K, dtype):
    # K at the staged form's limit (bf16 K=20000: one row per tile) and above
    # it (one row and the p accumulator do not fit in shared memory)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    X, r = _operands(N, K, seed=6)
    _kernel_vs_plain(torch.from_numpy(X).float().cuda().to(dtype),
                     torch.from_numpy(r).float().cuda())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_unaligned_r(dtype):
    # r a contiguous slice 4 bytes into its storage: not 16-byte aligned
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    X, r = _operands(256, 640, seed=7)
    buf = torch.from_numpy(np.concatenate([[0.0], r])).float().cuda()
    rc = buf[1:]
    assert rc.is_contiguous() and rc.data_ptr() % 16
    _kernel_vs_plain(torch.from_numpy(X).float().cuda().to(dtype), rc)
