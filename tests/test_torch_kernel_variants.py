"""The kernel variants of the sweep (pls_tpu_torch.ops.deflate_variants) against the JAX package.

The JAX sweep's kernels (tools/kernel_variants.py) are closures inside its
`main()`, which returns before building them on a CPU backend, so the
port's plain versions are held against what the JAX package computes the
same way, with nothing in it changed:

- K3 (`make_vpu_1k`, both `tt_inside`) and K5 (`make_vpu_bf16`) against
  `pls_tpu.ops.deflate._deflate_pass_pallas(..., interpret=True)`, whose
  bodies `_kernel_f32` / `_kernel_bf16` are the sweep's VPU kernel bodies;
  for `tt_inside` the reference tt is t·t of the JAX t.  Tolerance 1e-5
  relative to the largest entry: both sides sum in float32 in another
  order (the TPU kernel's own contract against f64, tools/tpu_smoke.py:67).
- K4 at HIGHEST (`make_mxu`, bf16×6 on a three-way split, which carries
  the 24 bits of each float32 operand) against `deflate_pass_xla` in
  float32, at 1e-5 for the same reason.
- K4 at DEFAULT and HIGH against `jax.lax.dot_general` on explicitly
  bf16-rounded or hi/lo-split jnp operands (the CPU backend ignores
  `precision`), at 1e-5: products of bf16 values are exact in float32, so
  only the order of the float32 sums differs.  p is held at 1e-5 against
  the JAX products of the port's own t, split the same way (and at HIGH
  against JAX's whole chain too): at DEFAULT a last-bit difference in the
  float32 t can round it to the neighbouring bf16 value, which moves p by
  more than the float32 bound.  A control, p of the port's t left
  unrounded, must lie outside 1e-5, so the check sees the rounding of t.

Inputs come from numpy.random.default_rng(seed) and go to both packages as
the same arrays.  The CUDA kernels run only on a card: those cases are
marked `gpu` and skip here.  On the card they hold every variant of the
sweep's default lists against its plain version at 1e-5 (K4's p against
`mxu_plain_p` of the kernel's own t), with two bit-identical launches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pls_tpu.ops.deflate import _deflate_pass_pallas, deflate_pass_xla
from pls_tpu_torch.ops import deflate_variants as dv
from pls_tpu_torch.tools import kernel_variants as kv
from pls_tpu_torch.utils import nvcc

SHAPES = [(256, 128), (300, 200), (130, 128), (60, 401), (1037, 96)]  # 1037: ragged N
RTOL = 1e-5
ALL_VARIANTS = kv.default_variants(False) + kv.default_variants(True)


def _operands(N, K, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(N, K)).astype(np.float32), rng.normal(size=K).astype(np.float32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _rel_tt(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


@pytest.mark.parametrize("tt_inside", [False, True])
@pytest.mark.parametrize("N,K", SHAPES)
def test_vpu_f32_plain_matches_pallas_kernel(N, K, tt_inside):
    X, r = _operands(N, K)
    t, tt, p = _deflate_pass_pallas(jnp.asarray(X), jnp.asarray(r), interpret=True)
    if tt_inside:
        tt = jnp.dot(t, t, precision=jax.lax.Precision.HIGHEST)
    t2, tt2, p2 = dv.make_vpu_1k(4, tt_inside)(torch.from_numpy(X), torch.from_numpy(r))
    assert _rel(t2, t) < RTOL and _rel(p2, p) < RTOL and _rel_tt(tt2, tt) < RTOL


@pytest.mark.parametrize("N,K", SHAPES)
def test_vpu_bf16_plain_matches_pallas_kernel(N, K):
    X, r = _operands(N, K, seed=1)
    Xj = jnp.asarray(X).astype(jnp.bfloat16)
    t, tt, p = _deflate_pass_pallas(Xj, jnp.asarray(r), interpret=True)
    Xt = torch.from_numpy(X).to(torch.bfloat16)
    np.testing.assert_array_equal(Xt.float().numpy(), np.asarray(Xj.astype(jnp.float32)))
    t2, tt2, p2 = dv.make_vpu_bf16(4)(Xt, torch.from_numpy(r))
    assert _rel(t2, t) < RTOL and _rel(p2, p) < RTOL and _rel_tt(tt2, tt) < RTOL


@pytest.mark.parametrize("N,K", SHAPES)
def test_mxu_highest_plain_matches_xla(N, K):
    X, r = _operands(N, K, seed=2)
    t, tt, p = deflate_pass_xla(jnp.asarray(X), jnp.asarray(r))
    t2, tt2, p2 = dv.make_mxu(16, "HIGHEST")(torch.from_numpy(X), torch.from_numpy(r))
    assert _rel(t2, t) < RTOL and _rel(p2, p) < RTOL and _rel_tt(tt2, tt) < RTOL


def _jsplit(x, n):
    parts, rest = [], x
    for _ in range(n):
        s = rest.astype(jnp.bfloat16).astype(jnp.float32)
        parts.append(s)
        rest = rest - s
    return parts


def _jproducts(A, b, passes):
    terms = [(2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)][6 - passes:]
    return sum(
        jax.lax.dot_general(A[i], b[j], (((1,), (0,)), ((), ())),
                            precision=jax.lax.Precision.HIGHEST,
                            preferred_element_type=jnp.float32)
        for i, j in terms
    )


@pytest.mark.parametrize("prec", ["DEFAULT", "HIGH"])
@pytest.mark.parametrize("N,K", SHAPES)
def test_mxu_plain_matches_split_dot_general(N, K, prec):
    X, r = _operands(N, K, seed=3)
    passes = dv.PRECISIONS[prec]
    n = {1: 1, 3: 2}[passes]
    xs = _jsplit(jnp.asarray(X), n)
    xts = [x.T for x in xs]
    t = _jproducts(xs, _jsplit(jnp.asarray(r), n), passes)
    p = _jproducts(xts, _jsplit(t, n), passes)
    t2, tt2, p2 = dv.make_mxu(16, prec)(torch.from_numpy(X), torch.from_numpy(r))
    t_port = jnp.asarray(t2.numpy())
    p_of_port_t = _jproducts(xts, _jsplit(t_port, n), passes)
    assert _rel(t2, t) < RTOL
    assert _rel(p2, p_of_port_t) < RTOL
    if prec == "HIGH":
        assert _rel(p2, p) < RTOL
    else:  # the control: p on the port's t left unrounded falls outside RTOL
        assert _rel(_jproducts(xts, [t_port], passes), p_of_port_t) > 10 * RTOL
    assert _rel_tt(tt2, jnp.dot(t, t, precision=jax.lax.Precision.HIGHEST)) < RTOL


def test_mxu_default_differs_from_exact_by_bf16_rounding():
    # DEFAULT is one bf16 pass: visibly inexact, at about the bf16 ulp
    X, r = _operands(256, 128, seed=4)
    Xt, rt = torch.from_numpy(X), torch.from_numpy(r)
    _, _, p = dv.make_mxu(8, "DEFAULT")(Xt, rt)
    _, _, p_exact = dv.vpu_f32_plain(Xt, rt)
    assert 1e-4 < _rel(p, p_exact) < 3e-2


@pytest.mark.parametrize("n", [1, 2, 3])
def test_bf16_split_parts(n):
    x = torch.from_numpy(_operands(64, 64, seed=5)[0])
    parts = dv.bf16_split(x, n)
    assert len(parts) == n
    for s in parts:
        assert torch.equal(s, s.to(torch.bfloat16).float())  # each part is a bf16 value
    err = float((x - sum(parts)).abs().max() / x.abs().max())
    assert err < {1: 2.0 ** -8, 2: 2.0 ** -16, 3: 2.0 ** -23}[n]


@pytest.mark.parametrize("v", ALL_VARIANTS, ids=lambda v: v.name)
def test_variant_on_cpu_takes_plain_version(v):
    X, r = _operands(37, 21, seed=6)
    Xt, rt = torch.from_numpy(X).to(v.dtype), torch.from_numpy(r)
    before = dict(dv.launches)
    t, tt, p = v(Xt, rt)
    assert dv.launches == before
    assert t.dtype == tt.dtype == p.dtype == torch.float32
    assert t.shape == (37,) and p.shape == (21,) and tt.shape == ()
    for a, b in zip((t, tt, p), v.plain(Xt, rt)):
        assert torch.equal(a, b)


def test_default_variants_cover_the_design_points():
    names = [v.name for v in ALL_VARIANTS]
    assert len(set(names)) == len(names)
    f32 = kv.default_variants(False)
    vpu = [v for v in f32 if v.kind == "vpu_f32"]
    assert {v.tn for v in vpu} == {1, 2, 4, 8}
    assert {v.stages for v in vpu} == {1, 2}
    assert {v.smem_kb for v in vpu} == {None, 110}  # 1 or 2 blocks per SM
    assert any(v.tt_inside for v in vpu)
    assert {v.prec for v in f32 if v.kind == "mxu_f32"} == set(dv.PRECISIONS)
    assert all(v.kind == "vpu_bf16" for v in kv.default_variants(True))


@pytest.mark.parametrize("make", [
    lambda: dv.make_vpu_1k(9, False),
    lambda: dv.make_vpu_1k(4, False, stages=3),
    lambda: dv.make_vpu_1k(4, False, smem_kb=0),
    lambda: dv.make_mxu(17, "HIGH"),
    lambda: dv.make_mxu(8, "FASTEST"),
    lambda: dv.Variant("vpu_bf16", 4, tt_inside=True),
    lambda: dv.Variant("vpu_f32", 4, prec="HIGH"),
])
def test_variant_rejects_bad_knobs(make):
    with pytest.raises(ValueError):
        make()


def test_cuda_wrapper_refuses_cpu_tensors():
    X, r = _operands(16, 8, seed=7)
    with pytest.raises(ValueError, match="CUDA"):
        dv.make_vpu_1k(4, False).cuda(torch.from_numpy(X), torch.from_numpy(r))


def test_sweep_exits_nonzero_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kv.main(["--n", "64", "--k", "32"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_library_name_follows_source():
    path = nvcc.library_path("deflate_variants.cu")
    assert path.parent == nvcc.BUILD_DIR
    assert path.name.startswith("deflate_variants-") and path.suffix == ".so"


@pytest.mark.gpu
@pytest.mark.parametrize("N,K", [(130, 96), (300, 401), (1037, 96), (4096, 5000)])
@pytest.mark.parametrize("v", ALL_VARIANTS, ids=lambda v: v.name)
def test_cuda_variant_matches_plain(v, N, K):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    X, r = _operands(N, K, seed=8)
    Xc, rc = torch.from_numpy(X).cuda().to(v.dtype), torch.from_numpy(r).cuda()
    before = dv.launches[v.kind]
    out = v(Xc, rc)
    again = v(Xc, rc)
    torch.cuda.synchronize()
    assert dv.launches[v.kind] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    t, tt, p = (o.cpu() for o in out)
    tp, ttp, pp = (o.cpu() for o in v.plain(Xc, rc))
    assert _rel(t, tp) < RTOL and _rel_tt(tt, ttp) < RTOL
    if v.prec:  # K4: the second product on the kernel's own t
        assert _rel(p, dv.mxu_plain_p(Xc, out[0], v.prec).cpu()) < RTOL
    if v.prec != "DEFAULT":
        assert _rel(p, pp) < RTOL
