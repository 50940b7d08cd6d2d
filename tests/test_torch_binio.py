""".npy ingest of the port (pls_tpu_torch.utils.binio) against the JAX package.

Files written by `pls_tpu.utils.binio.write_npy_chunked` (float32 and,
through ml_dtypes, bfloat16) are read by the port without ml_dtypes, and
the port's files by numpy.  Streaming keeps order threaded or not, O_DIRECT
reads at odd sizes equal buffered ones, a pooled chunk stays intact for
two further yields, and bad inputs raise.  `cv_kfold_npy` and
`cv_repeated_kfold_npy` run through both packages on the same files in
float32, held to tests/test_binio.py:200-211's tolerances (PRESS 2e-4
relative or 1e-5 of Y's energy, per-row errors 1e-4), with the same
optimal component counts.  The `gpu` cases run the stats pass and
`cv_kfold_npy` on CUDA in float32 against the same run on the CPU in
float64.
"""

import os

import ml_dtypes
import numpy as np
import pytest
import torch

import pls_tpu as pt
import pls_tpu.utils.binio as jb
import pls_tpu_torch as tt
import pls_tpu_torch.utils.binio as tb


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_binio")
    rng = np.random.default_rng(5)
    X = rng.normal(size=(500, 24)).astype(np.float32)
    Y = (X @ rng.normal(size=(24, 2)) + 0.1 * rng.normal(size=(500, 2))).astype(np.float32)
    xp, yp = str(d / "x.npy"), str(d / "y.npy")
    jb.write_npy_chunked(xp, (X[i : i + 128] for i in range(0, 500, 128)))
    jb.write_npy_chunked(yp, [Y])
    xb = str(d / "xb.npy")
    jb.write_npy_chunked(xb, [X.astype(ml_dtypes.bfloat16)])
    return xp, yp, xb, X, Y


def test_reads_jax_files_f32_and_bf16(files):
    xp, yp, xb, X, Y = files
    assert tb.npy_shape(xp) == ((500, 24), torch.float32)
    assert tb.npy_shape(xb) == ((500, 24), torch.bfloat16)
    got = torch.cat(list(tb.stream_npy(xb, 128)))
    assert got.dtype == torch.bfloat16
    # torch's round-to-nearest-even equals ml_dtypes' on the same floats
    assert torch.equal(got, torch.from_numpy(X).to(torch.bfloat16))
    assert np.array_equal(got.float().numpy(), X.astype(ml_dtypes.bfloat16).astype(np.float32))


def test_port_writes_plain_npy(tmp_path, files):
    _, _, _, X, _ = files
    p = str(tmp_path / "w.npy")
    assert tb.write_npy_chunked(p, (torch.from_numpy(X[i : i + 77]) for i in range(0, 500, 77))) == (500, 24)
    assert np.array_equal(np.load(p), X)
    pb = str(tmp_path / "wb.npy")
    tb.write_npy_chunked(pb, [X[:100], X[100:]], dtype=torch.bfloat16)
    assert jb.npy_shape(pb) == ((500, 24), np.dtype(ml_dtypes.bfloat16))
    back = np.concatenate(list(jb.stream_npy(pb, 64))).astype(np.float32)
    assert np.array_equal(back, X.astype(ml_dtypes.bfloat16).astype(np.float32))
    # a 1-D block is a column
    p1 = str(tmp_path / "one.npy")
    assert tb.write_npy_chunked(p1, [np.arange(5.0)]) == (5, 1)
    with pytest.raises(ValueError, match="empty chunk iterable"):
        tb.write_npy_chunked(str(tmp_path / "e.npy"), iter([]))
    with pytest.raises(ValueError, match="does not match"):
        tb.write_npy_chunked(str(tmp_path / "m.npy"), [X[:3], X[:3, :5]])


@pytest.mark.parametrize("threaded", [True, False])
@pytest.mark.parametrize("reuse", [True, False])
def test_stream_order(files, threaded, reuse):
    xp, _, _, X, _ = files
    chunks = [c.clone() for c in tb.stream_npy(xp, 200, threaded=threaded, reuse_buffers=reuse)]
    assert [c.shape[0] for c in chunks] == [200, 200, 100]
    assert np.array_equal(torch.cat(chunks).numpy(), X)


def test_direct_io_odd_sizes_match_buffered(tmp_path):
    X = np.random.default_rng(7).normal(size=(101, 37)).astype(np.float32)  # 148-byte rows
    p = str(tmp_path / "odd.npy")
    jb.write_npy_chunked(p, [X])
    assert os.path.getsize(p) % 4096 != 0
    for chunk in (7, 33, 101):
        for direct in (True, False):
            got = torch.cat([c.clone() for c in tb.stream_npy(
                p, chunk, reuse_buffers=True, direct=direct)])
            assert np.array_equal(got.numpy(), X)
    with pytest.raises(ValueError, match="reuse_buffers"):
        next(tb.stream_npy(p, 10, direct=True))


def test_pool_contract_two_further_yields(files):
    xp, _, _, X, _ = files
    held, snaps = [], []
    for c in tb.stream_npy(xp, 50, reuse_buffers=True, threaded=True):
        held.append(c)
        snaps.append(c.clone())
        if len(held) > 2:
            assert torch.equal(held[-3], snaps[-3])
            held.pop(0)
            snaps.pop(0)


def test_device_stream_cpu_copies_and_casts(files):
    xp, _, _, X, _ = files
    outs = list(tb.device_stream(tb.stream_npy(xp, 100, reuse_buffers=True), device="cpu"))
    assert np.array_equal(torch.cat(outs).numpy(), X)  # copies survive the pool's reuse
    outs = list(tb.device_stream(tb.stream_npy(xp, 100, reuse_buffers=True), device="cpu",
                                 cast=torch.bfloat16))
    assert torch.equal(torch.cat(outs), torch.from_numpy(X).to(torch.bfloat16))
    pairs = list(tb.npy_chunks(xp, files[1], 128))
    assert len(pairs) == 4 and pairs[-1][0].shape == (116, 24) and pairs[-1][1].shape == (116, 2)


def test_ingest_validation(files, tmp_path):
    xp, yp, _, X, Y = files
    yshort = str(tmp_path / "yshort.npy")
    jb.write_npy_chunked(yshort, [Y[:400]])
    with pytest.raises(ValueError, match="row-count mismatch"):
        tb.stats_from_npy(xp, yshort, device="cpu")
    with pytest.raises(ValueError, match="row-count mismatch"):
        tb.fold_stats_from_npy(xp, yshort, np.zeros(500, np.int64), 2, device="cpu")
    with pytest.raises(ValueError, match="row-count mismatch"):
        tb.cv_kfold_npy(xp, yshort, 3, k=2, device="cpu")
    with pytest.raises(ValueError, match="different numbers of rows"):
        next(tb.npy_chunks(xp, yshort, 100))
    with pytest.raises(ValueError, match=r"\[0, 2\)"):
        tb.fold_stats_from_npy(xp, yp, np.full(500, 7), 2, device="cpu")
    with pytest.raises(ValueError, match="X must be 2-D"):
        tb.cv_kfold_npy(_one_d(tmp_path, Y), yp, 3, device="cpu")
    assert tb.auto_chunk_rows(torch.bfloat16) == 32768 and tb.auto_chunk_rows(torch.float32) == 16384


def _one_d(tmp_path, Y):
    p = str(tmp_path / "y1d.npy")
    np.save(p, Y[:, 0])
    return p


def test_stats_from_npy_matches_jax(files, tmp_path):
    xp, yp, xb, X, Y = files
    mine = tb.stats_from_npy(xp, yp, chunk_rows=128, device="cpu")
    ref = jb.stats_from_npy(xp, yp, chunk_rows=128)
    for name in ("XX", "XY", "YY", "sx", "sy"):
        np.testing.assert_allclose(getattr(mine, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=2e-5, atol=2e-5)
    assert mine.n == int(ref.n) == 500
    np.testing.assert_allclose(tt.coefficients(tb.fit_streaming_npy(xp, yp, 3, device="cpu")).numpy(),
                               np.asarray(pt.coefficients(jb.fit_streaming_npy(xp, yp, 3))),
                               rtol=1e-4, atol=1e-5)
    # bf16 on disk selects the narrow path by itself, as in the JAX package
    mb = tb.stats_from_npy(xb, yp, chunk_rows=200, device="cpu")
    rb = jb.stats_from_npy(xb, yp, chunk_rows=200)
    assert mb.x_storage == "bf16" and rb.x_storage == "bf16"
    np.testing.assert_allclose(mb.XX.numpy(), np.asarray(rb.XX), rtol=1e-5, atol=1e-4)
    # a 1-D Y file streams as one column
    y1 = _one_d(tmp_path, Y)
    acc = tb.stats_from_npy(xp, y1, device="cpu")
    assert acc.XY.shape == (24, 1)
    np.testing.assert_allclose(acc.XY[:, 0].numpy(), X.T @ Y[:, 0], rtol=2e-5, atol=1e-4)


def _compare_kfold(mine, ref, Y):
    (s_m, r_m), (s_r, r_r) = mine, ref
    energy = float((Y.astype(np.float64) ** 2).sum(0).max())
    np.testing.assert_allclose(s_m.press, s_r.press, rtol=2e-4, atol=1e-5 * energy)
    np.testing.assert_allclose(s_m.rmse, s_r.rmse, rtol=2e-4, atol=1e-5 * energy)
    assert np.array_equal(s_m.nf, np.asarray(s_r.nf))
    if r_r is None:
        assert r_m is None
        return
    assert r_m.method == r_r.method
    np.testing.assert_allclose(r_m.errors.numpy(), np.asarray(r_r.errors), rtol=1e-4, atol=1e-4)
    assert np.array_equal(tt.optimal_num_components(r_m).numpy(),
                          np.asarray(pt.optimal_num_components(r_r)))


@pytest.mark.parametrize("x_file", ["f32", "bf16"])
def test_cv_kfold_npy_matches_jax(files, x_file):
    xp, yp, xb, X, Y = files
    path = xp if x_file == "f32" else xb
    mine = tb.cv_kfold_npy(path, yp, 4, k=5, key=9, chunk_rows=128, device="cpu")
    ref = jb.cv_kfold_npy(path, yp, 4, k=5, key=9, chunk_rows=128)
    _compare_kfold(mine, ref, Y)
    if x_file == "f32":
        # PRESS of the closed form is Σ errors² of the residual pass.  (Not
        # for bf16 X: there XᵀY takes Y rounded to bf16, as in the JAX
        # package, and YᵀY does not, so the closed form is not the
        # residual pass's sum.)
        s, r = mine
        np.testing.assert_allclose(s.press, (r.errors.double() ** 2).sum(1).numpy(), rtol=1e-3)


def test_cv_kfold_npy_zscore_and_press_only(tmp_path):
    rng = np.random.default_rng(31)
    X = (rng.normal(size=(400, 20)) * 2 + 7).astype(np.float32)
    Y = (X @ rng.normal(size=(20, 2)) + rng.normal(size=(400, 2))).astype(np.float32)
    rx, ry = str(tmp_path / "rx.npy"), str(tmp_path / "ry.npy")
    jb.write_npy_chunked(rx, [X])
    jb.write_npy_chunked(ry, [Y])
    assign = tt.kfold_assignments(400, 4, 2).numpy()
    mine = tb.cv_kfold_npy(rx, ry, 3, k=4, assignments=assign, chunk_rows=128, zscore=True,
                           device="cpu")
    ref = jb.cv_kfold_npy(rx, ry, 3, k=4, assignments=assign, chunk_rows=128, zscore=True)
    Yz = (Y - Y.mean(0)) / Y.std(0, ddof=1)
    _compare_kfold(mine, ref, Yz)
    mine = tb.cv_kfold_npy(rx, ry, 3, k=4, key=1, chunk_rows=200, residual_pass=False,
                           device="cpu")
    ref = jb.cv_kfold_npy(rx, ry, 3, k=4, key=1, chunk_rows=200, residual_pass=False)
    _compare_kfold(mine, ref, Y)


def test_cv_repeated_kfold_npy_matches_jax(files):
    xp, yp, _, _, Y = files
    press, rmse, runs = tb.cv_repeated_kfold_npy(xp, yp, 3, k=4, repeats=2, key=5, chunk_rows=200,
                                                 device="cpu")
    rp, rr, rruns = jb.cv_repeated_kfold_npy(xp, yp, 3, k=4, repeats=2, key=5, chunk_rows=200)
    energy = float((Y.astype(np.float64) ** 2).sum(0).max())
    np.testing.assert_allclose(press, rp, rtol=2e-4, atol=1e-5 * energy)
    np.testing.assert_allclose(rmse, rr, rtol=2e-4, atol=1e-5 * energy)
    for (s, r), (sr, _) in zip(runs, rruns):
        assert r is None
        np.testing.assert_allclose(s.press, sr.press, rtol=2e-4, atol=1e-5 * energy)
    assert not np.allclose(runs[0][0].press, runs[1][0].press)
    with pytest.raises(ValueError, match="repeats"):
        tb.cv_repeated_kfold_npy(xp, yp, 3, repeats=0, device="cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_stats_pass_cuda_f32_vs_cpu_f64(files, cuda):
    xp, yp, _, _, _ = files
    g = tb.stats_from_npy(xp, yp, chunk_rows=128, device=cuda)
    c = tb.stats_from_npy(xp, yp, chunk_rows=128, device="cpu", dtype=torch.float64)
    assert g.XX.device.type == "cuda" and g.XX.dtype == torch.float32
    for name in ("XX", "XY", "YY", "sx", "sy"):
        ref = getattr(c, name)
        err = (getattr(g, name).cpu().double() - ref).abs().max() / ref.abs().max()
        assert float(err) < 1e-5, name


@pytest.mark.gpu
@pytest.mark.parametrize("zscore", [False, True])
def test_cv_kfold_npy_cuda_f32_vs_cpu_f64(files, cuda, zscore):
    xp, yp, _, _, Y = files
    s_g, r_g = tb.cv_kfold_npy(xp, yp, 4, k=5, key=9, chunk_rows=128, zscore=zscore, device=cuda)
    s_c, r_c = tb.cv_kfold_npy(xp, yp, 4, k=5, key=9, chunk_rows=128, zscore=zscore, device="cpu",
                               dtype=torch.float64)
    assert r_g.errors.device.type == "cuda"
    energy = float((Y.astype(np.float64) ** 2).sum(0).max())
    np.testing.assert_allclose(s_g.press, s_c.press, rtol=2e-4, atol=1e-5 * energy)
    np.testing.assert_allclose(r_g.errors.cpu().double().numpy(), r_c.errors.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(tt.optimal_num_components(r_g).cpu(), tt.optimal_num_components(r_c))
