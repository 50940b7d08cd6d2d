"""The PLS-DA cell's own pieces on the CPU: the spectra generator
(`portbench/spectra.py`), the job's least work (`portbench/roofline_plsda.py`)
on shapes worked by hand, and the plain reference's eigengaps and
decision values (`portbench/reference/plsda.py`)."""

from __future__ import annotations

import json
import math

import pytest
import torch

from portbench import harness, roofline, roofline_plsda, spectra
from portbench.reference import plsda as ref_plsda

CONFIG = json.loads((harness.ROOT / "portbench/configs/maldi-plsda-20k-6k-10.json").read_text())
SMALL = {**CONFIG, "N": 96, "K": 1536, "M": 4}


def test_species_take_shares_by_inverse_rank():
    counts = spectra.species_counts(20000, 10)
    assert sum(counts) == 20000 and counts == sorted(counts, reverse=True)
    assert counts[0] / 20000 == pytest.approx(0.3414, abs=1e-3)
    assert counts[9] / 20000 == pytest.approx(0.0341, abs=1e-3)
    assert spectra.species_counts(12, 10) == [2, 2] + [1] * 8
    with pytest.raises(ValueError):
        spectra.species_counts(9, 10)


def test_the_full_axis_spans_2_to_20_kda():
    mz = spectra.mz_axis(CONFIG, "cpu")
    assert mz.shape == (6000,)  # DRIAMS's 3 Da bins
    assert float(mz[0]) == pytest.approx(2001.5) and float(mz[-1]) == pytest.approx(19998.5)


def test_the_library_is_the_seed_s():
    X, y, Xn, yn = spectra.library(SMALL, 32, 11, "cpu")
    X2, y2, Xn2, yn2 = spectra.library(SMALL, 32, 11, "cpu")
    assert torch.equal(X, X2) and torch.equal(y, y2) and torch.equal(Xn, Xn2)
    assert not torch.equal(X, spectra.library(SMALL, 32, 12, "cpu")[0])
    assert X.shape == (96, 1536) and Xn.shape == (32, 1536) and X.dtype == torch.float32
    assert torch.bincount(y, minlength=4).tolist() == spectra.species_counts(96, 4)
    assert torch.bincount(yn, minlength=4).tolist() == spectra.species_counts(32, 4)
    # each spectrum scaled by its total ion current to a mean intensity of 1
    assert torch.allclose(X.mean(1), torch.ones(96), atol=1e-5)
    # the held-out batch is a second draw: no row of it is a training row
    assert float(torch.cdist(Xn, X).min()) > 0.1


def test_peaks_widen_with_mass_and_species_own_theirs():
    pk = spectra.peaks(CONFIG, torch.Generator().manual_seed(0), "cpu")
    a = CONFIG["assumed"]
    assert pk.profiles.shape == (a["shared_peaks"] + 10 * a["species_peaks"], 6000)
    assert (pk.owner == -1).sum() == a["shared_peaks"]
    assert torch.bincount(pk.owner[pk.owner >= 0]).tolist() == [a["species_peaks"]] * 10
    # a Gaussian's area over its height is sd·√(2π), sd = m / (R · FWHM per sd),
    # kept by the binning even where the peak is narrower than a bin (at 2 kDa
    # sd is 1.4 Da in 3 Da bins)
    centre = (pk.profiles.double() * pk.mz).sum(1) / pk.profiles.double().sum(1)
    area = pk.profiles.double().sum(1) * CONFIG["bin_da"]
    inner = (centre > 2100) & (centre < 19900)
    sd = centre / (a["resolution"] * spectra.FWHM_PER_SD)
    assert torch.allclose(area[inner], (sd * math.sqrt(2 * math.pi))[inner], rtol=1e-3)
    assert float(sd[inner].min()) < CONFIG["bin_da"]
    # a bin holds the peak's mean over the bin: never above the peak's height
    assert float(pk.profiles.max()) <= 1.0


def test_the_job_s_work_by_hand():
    N, K, M, A, Nh = 10, 4, 2, 3, 5
    vectors = A * (K + N + K + 1)
    # X read A + 1 times: the moments share XᵀY's read
    assert roofline_plsda.job_bytes(N, K, M, A, Nh) == 4 * (4 * N * K + N * M + Nh * K
                                                            + vectors + Nh * M)
    fit = roofline.fit_flops(N, K, M, A)  # XᵀY and the components, as a fit counts them
    assert roofline_plsda.job_flops(N, K, M, A, Nh) == 3 * N * K + fit + 2 * Nh * K * (1 + M) + Nh * M


def test_the_cell_is_bound_by_bytes_at_about_3_ms():
    N, K, M, A, Nh = 20000, 6000, 10, 20, 2000
    b = roofline_plsda.job_bytes(N, K, M, A, Nh)
    f = roofline_plsda.job_flops(N, K, M, A, Nh)
    assert roofline.least_seconds(b, f) == pytest.approx(b / 3.35e12)
    assert roofline.least_seconds(b, f) == pytest.approx((21 * N * K + Nh * K) * 4 / 3.35e12,
                                                         rel=1e-3)
    assert roofline.least_seconds(b, f) == pytest.approx(3.024e-3, rel=1e-3)


def test_the_reference_s_eigengaps_follow_the_deflated_cross_products():
    X, y, _, _ = spectra.library(SMALL, 8, 5, "cpu")
    m = ref_plsda.fit(X, y, 5)
    Xz = m.z(X)
    Yc = torch.nn.functional.one_hot(y, 4).double() - m.priors
    T, Q = m.fit.T, m.fit.Q
    for a in range(5):
        XY = Xz.mT @ (Yc - T[:, :a] @ Q[:, :a].mT)  # XᵀY after a components
        lam = torch.linalg.eigvalsh(XY.mT @ XY)
        assert float(m.gaps[a]) == pytest.approx(float((lam[-1] - lam[-2]) / lam[-1]), rel=1e-8)
    assert ((m.gaps > 0) & (m.gaps <= 1)).all()


def test_the_reference_s_decision_adds_the_priors_to_z_scored_x_times_b():
    X, y, Xn, _ = spectra.library(SMALL, 8, 6, "cpu")
    m = ref_plsda.fit(X, y, 3)
    mean, sd = X.double().mean(0), X.double().std(0)
    want = ((Xn.double() - mean) / sd) @ m.B[-1] + torch.bincount(y).double() / len(y)
    assert torch.allclose(m.decision(Xn), want, atol=1e-10)
    assert torch.allclose(m.decision(Xn, comp=1), ((Xn.double() - mean) / sd) @ m.B[0] + m.priors,
                          atol=1e-10)
