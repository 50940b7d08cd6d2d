"""The kernel variants of the sweep (pls_tpu_torch.ops.deflate_variants) against the JAX package.

The JAX sweep's kernels (tools/kernel_variants.py) are closures inside its
`main()`, which returns before building them on a CPU backend, so the
port's plain versions are held against what the JAX package computes the
same way, with nothing in it changed:

- K3 (`make_vpu_1k`, both `tt_inside`) and K5 (`make_vpu_bf16`, and
  `make_cols_bf16`, the column-owning design, whose plain version is the
  same) against
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
`mxu_plain_p` of the kernel's own t), with two bit-identical launches, and
K4 at chip_smoke.py's VARIANT_SHAPES on the path each shape takes (the
ring of 8-row TMA slots, or the scalar-staged tiles for K % 4 != 0 and
misaligned X).

K4's ring plan (`mxu_plan`: pitch, slots, slot bytes, blocks) is plain
Python and is held here against the H100's limits (232 448 bytes of
shared memory a block, 132 SMs), and its pitch against the bank
arithmetic the kernel's comment gives.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import VARIANT_SHAPES
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
    before, paths = dict(dv.launches), dict(dv.mxu_path_launches)
    t, tt, p = v(Xt, rt)
    assert dv.launches == before and dv.mxu_path_launches == paths
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
    bf16 = kv.default_variants(True)
    # the row-staged K5 rows stay beside the column-owning ones, in one sweep
    assert {v.kind for v in bf16} == {"vpu_bf16", "cols_bf16"}
    assert all(v.dtype == torch.bfloat16 for v in bf16)


def test_cols_variants_names_and_parameters():
    cols = [v for v in kv.default_variants(True) if v.kind == "cols_bf16"]
    assert [v.name for v in cols] == [f"cols_bf16_{c}_s{s}" for c in ("w16", "w8x2")
                                      for s in (2, 3, 4)]
    assert {(v.warps, v.blocks, v.stages) for v in cols} == {
        (w, b, s) for w, b in dv.COLS_CONFIGS for s in kv.COLS_STAGES}
    # a class of its own: the row-staged knobs (tn, smem_kb, tt_inside, prec) do not apply
    assert all(isinstance(v, dv.ColsVariant) and v.dtype == torch.bfloat16 for v in cols)
    assert not any(hasattr(v, "tn") or hasattr(v, "prec") for v in cols)
    assert dv.make_cols_bf16(8, 3, 2) == dv.ColsVariant(8, 3, 2)


@pytest.mark.parametrize("N,K,takes", [(37, 24, True), (300, 401, False), (64, 5004, False),
                                       (64, 10_240, True), (8, 10_248, False)])
def test_cols_variant_takes_k_multiple_of_8_within_its_registers(N, K, takes):
    X = torch.zeros((N, K), dtype=torch.bfloat16)
    assert dv.make_cols_bf16(16, 3).takes(X) is takes
    assert dv.make_cols_bf16(8, 3, 2).takes(X) is (takes and K <= 5120)
    assert dv.make_vpu_bf16(8).takes(X)


@pytest.mark.parametrize("make", [
    lambda: dv.make_vpu_1k(9, False),
    lambda: dv.make_vpu_1k(4, False, stages=3),
    lambda: dv.make_vpu_1k(4, False, smem_kb=0),
    lambda: dv.make_mxu(17, "HIGH"),
    lambda: dv.make_mxu(8, "FASTEST"),
    lambda: dv.make_mxu(8, "HIGH", stages=5),  # the ring holds at most 4 slots
    lambda: dv.make_mxu(8, "HIGH", stages=0),
    lambda: dv.Variant("vpu_bf16", 4, tt_inside=True),
    lambda: dv.Variant("vpu_f32", 4, prec="HIGH"),
    lambda: dv.make_cols_bf16(8, 3),  # 8 warps run two blocks per SM
    lambda: dv.make_cols_bf16(16, 3, 2),
    lambda: dv.make_cols_bf16(16, 1),
    lambda: dv.make_cols_bf16(16, 9),
    lambda: dv.Variant("cols_bf16", 2),  # the column-owning design is a ColsVariant
    lambda: dv.make_cols_bf16(12, 3),  # 12 warps: measured 1.5x slower than 16, dropped
    lambda: dv.Variant("vpu_bf16", 0),
    lambda: dv.Variant("mxu_f32", 8),  # the mma form needs its precision
])
def test_variant_rejects_bad_knobs(make):
    with pytest.raises(ValueError):
        make()


# ---------- K4's ring plan, against the H100's limits ----------
H100_SMEM_OPTIN, H100_SMS = 232_448, 132
RING_STATIC_SMEM = 2 * 4 * 8 + 2 * 8 * 8 * 4  # full/empty mbarriers, the t partials
H100_RING_BUDGET = H100_SMEM_OPTIN - RING_STATIC_SMEM


@pytest.mark.parametrize("K", [15, 96, 401, 2048, 5000])
def test_mxu_pitch_keeps_fragment_loads_off_shared_banks(K):
    P = dv.mxu_pitch(K)
    assert P >= -(-K // 16) * 16 and P % 32 == 8 and P - K < 40
    g, q = np.meshgrid(np.arange(8), np.arange(4), indexing="ij")
    # phase 1: 8-byte loads of columns 2q, 2q + 1 at rows g, by half-warps
    for half in (g < 4, g >= 4):
        words = (g * P + 2 * q)[half]
        banks = np.concatenate([words % 32, (words + 1) % 32])
        assert len(set(banks.tolist())) == 32  # sixteen lanes, thirty-two banks
    # phase 2: scalar loads at rows 2q + b, column g: at most two lanes a bank
    for b in (0, 1):
        counts = np.bincount(((2 * q + b) * P + g).ravel() % 32, minlength=32)
        assert counts.max() <= 2
    # the unpadded pitch of K = 2048 put eight lanes in one bank
    assert np.bincount(((g * 2048 + 2 * q).ravel()) % 32).max() == 8


@pytest.mark.parametrize("passes", [1, 3, 6])
@pytest.mark.parametrize("K", [15, 96, 401, 2048, 5000])
def test_mxu_plan_against_h100_limits(K, passes):
    N = 65_536
    plans = {st: dv.mxu_plan(N, K, passes, st, H100_RING_BUDGET, H100_SMS)
             for st in range(1, dv.MXU_MAX_STAGES + 1)}
    if K % 4:  # the bulk copies move whole rows of 16-byte units: the scalar path
        assert all(p is None for p in plans.values())
        return
    P = dv.mxu_pitch(K)
    fixed = -(-4 * K // 16) * 16 + -(-2 * P * {1: 1, 3: 2, 6: 3}[passes] // 16) * 16
    for asked, plan in plans.items():
        assert plan.pitch == P and plan.slot_bytes == dv.MXU_ROWS * P * 4
        assert plan.smem == fixed + plan.stages * plan.slot_bytes <= H100_RING_BUDGET
        assert plan.G == H100_SMS
        most = (H100_RING_BUDGET - fixed) // plan.slot_bytes
        assert plan.stages == min(asked, most, dv.MXU_MAX_STAGES)
    if K == 2048:  # the sweep's rows: 2 and 3 slots of 64.25 KB both fit
        assert [plans[st].stages for st in kv.MXU_STAGES] == [2, 3]
        assert plans[4].stages == 3
    if K == 5000:  # one 157 KB slot: the wide-K case, correct and timed, not tuned
        assert {p.stages for p in plans.values()} == {1}
    if K == 96:
        assert plans[4].stages == 4 and plans[4].smem < 20_000


def test_mxu_plan_refuses_k_past_one_slot_and_caps_blocks_at_tiles():
    assert dv.mxu_plan(1000, 8192, 1, 2, H100_RING_BUDGET, H100_SMS) is None  # 263 KB a slot
    assert dv.mxu_plan(20, 96, 1, 2, H100_RING_BUDGET, H100_SMS).G == 3  # ceil(20 / 8) tiles


@pytest.mark.parametrize("N,K,offset,path", [
    (130, 96, 0, "ring"), (65_536, 2048, 0, "ring"), (4096, 5000, 0, "ring"),
    (300, 401, 0, "staged"), (10, 15, 0, "staged"),  # K % 4 != 0
    (130, 96, 1, "staged"),  # X not 16-byte aligned
    (64, 8192, 0, "staged"),  # not one 8-row slot fits
])
def test_mxu_launch_plan_picks_its_path(monkeypatch, N, K, offset, path):
    """K4's choice between its ring and the scalar-staged tiles, with the
    device's limits faked as the H100's (the launch itself needs a card)."""
    monkeypatch.setattr(dv, "_mxu_plan", lambda dev, N, K, passes, stages: dv.mxu_plan(
        N, K, passes, stages, H100_RING_BUDGET, H100_SMS))
    staged_calls = []

    def fake_plan(dev, code, vec, N, K, rows, stages, smem_kb, passes):
        staged_calls.append((code, vec, rows, stages, passes))
        return min(H100_SMS, -(-N // rows)), rows, 1

    monkeypatch.setattr(dv, "_plan", fake_plan)
    X = torch.zeros(N * K + offset)[offset:].view(N, K)
    r = torch.zeros(K)
    v = dv.make_mxu(16, "HIGH", stages=3)
    vec, G, R, stages, per_sm, ring = v._launch_plan(X, r)
    assert ring == (path == "ring")
    if ring:
        assert (vec, R, per_sm) == (4, dv.MXU_ROWS, 1) and not staged_calls
        assert stages == (1 if K == 5000 else 3) and G == min(H100_SMS, -(-N // 8))
    else:  # scalar staging, 16 rows, at most two buffers, sized for HIGH's two planes
        assert staged_calls == [(2, 1, 16, 2, 3)] and (vec, R, stages) == (1, 16, 2)


def test_mxu_rows_are_ring_slot_counts_at_every_precision():
    mxu = [v for v in kv.default_variants(False) if v.kind == "mxu_f32"]
    assert [v.name for v in mxu] == [f"mxu_{p}_r8_s{s}" for p in dv.PRECISIONS
                                     for s in kv.MXU_STAGES]
    assert all(v.tn == dv.MXU_ROWS for v in mxu)
    assert set(dv.mxu_path_launches) == {"ring", "staged"}


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
    if not v.takes(Xc):  # cols_bf16 at K % 8 != 0 refuses, never falls back
        with pytest.raises(ValueError, match="K % 8"):
            v(Xc, rc)
        return
    before = dv.launches[v.kind]
    out = v(Xc, rc)
    again = v(Xc, rc)
    torch.cuda.synchronize()
    assert dv.launches[v.kind] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    t, tt, p = (o.cpu() for o in out)
    tp, ttp, pp = (o.cpu() for o in v.plain(Xc, rc))
    assert _rel(t, tp) < RTOL and _rel_tt(tt, ttp) < RTOL
    prec = getattr(v, "prec", None)
    if prec:  # K4: the second product on the kernel's own t
        assert _rel(p, dv.mxu_plain_p(Xc, out[0], prec).cpu()) < RTOL
    if prec != "DEFAULT":
        assert _rel(p, pp) < RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("stages", [2, 3])
@pytest.mark.parametrize("prec", list(dv.PRECISIONS))
@pytest.mark.parametrize("N,K", VARIANT_SHAPES + [(130, 96)])
def test_cuda_mxu_on_its_path_matches_plain(N, K, prec, stages):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    X, r = _operands(N, K, seed=9)
    Xc, rc = torch.from_numpy(X).cuda(), torch.from_numpy(r).cuda()
    v = dv.make_mxu(dv.MXU_ROWS, prec, stages)
    cases = [(Xc, "ring" if K % 4 == 0 else "staged")]
    if K % 4 == 0:  # X 16-byte misaligned: the scalar-staged path
        buf = torch.empty(N * K + 1, device="cuda")
        Xm = buf[1:].view(N, K)
        Xm.copy_(Xc)
        cases.append((Xm, "staged"))
    for XX, path in cases:
        before = dict(dv.mxu_path_launches)
        out = v(XX, rc)
        again = v(XX, rc)
        torch.cuda.synchronize()
        assert dv.mxu_path_launches[path] == before[path] + 2
        assert all(torch.equal(a, b) for a, b in zip(out, again))
        tp, ttp, pp = v.plain(XX, rc)
        assert _rel(out[0].cpu(), tp.cpu()) < RTOL and _rel_tt(out[1].cpu(), ttp.cpu()) < RTOL
        assert _rel(out[2].cpu(), dv.mxu_plain_p(XX, out[0], prec).cpu()) < RTOL
        if prec != "DEFAULT":
            assert _rel(out[2].cpu(), pp.cpu()) < RTOL
