"""Seeded MALDI-TOF mass spectra of a few species, for the PLS-DA cell.

Both sides of a comparison get the same arrays from here: the program
under test and the plain reference (`portbench/reference/plsda.py`).
Everything is drawn on the device by one `torch.Generator` from the seed,
in a few large calls.  It imports nothing of the program, of the JAX
package or of JAX.

The peak model (the configuration's `assumed` keys):

- the m/z axis: K bins of `bin_da` Da from `mz_min_da`, the
  configuration's own keys (DRIAMS's 6 000 bins of 3 Da span 2 000-20 000
  Da);
- `shared_peaks` peaks common to every species and `species_peaks` of
  each species' own, at fixed m/z drawn log-uniformly over the axis;
  each a Gaussian whose width grows with mass, FWHM = m / `resolution`
  (linear-mode TOF), binned as a binned spectrum is: a bin holds the
  peak's mean over the bin's width (a peak narrower than a bin keeps its
  area and its centre);
- each peak's base height log-normal across peaks (`peak_height_sd`);
  a species' own peaks scaled by its separation, `separation` times
  `separation_decay` to the species' rank, so that no two species stand
  equally far from the rest and XYᵀXY's leading eigenvalues are not tied
  by construction;
- per spectrum: every peak's height times a mean-one log-normal factor
  (`intensity_sd`), a baseline decaying from the low-mass end
  (`baseline` times a mean-one log-normal factor of sd
  `baseline_sd`, e-folding over `baseline_decay_da`), and additive
  Gaussian noise (`noise`);
- the spectrum is then scaled by its total ion current, to a mean
  intensity of 1 a bin.

Species take shares ∝ 1/rank (10 species: 34.1 % down to 3.4 %), as
whole counts by largest remainder (at least one spectrum a species) in
an order drawn from the seed.  The held-out batch is a second draw of
spectra from the same species and peaks, so it holds no copy of a
training spectrum.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

FWHM_PER_SD = 2 * math.sqrt(2 * math.log(2))


def species_counts(n: int, species: int) -> list[int]:
    """Spectra a species among `n`, shares ∝ 1/rank, whole by largest
    remainder with at least one each."""
    if n < species:
        raise ValueError(f"{n} spectra cannot hold {species} species")
    w = [1.0 / (j + 1) for j in range(species)]
    exact = [(n - species) * x / sum(w) for x in w]
    counts = [1 + int(e) for e in exact]
    order = sorted(range(species), key=lambda j: (int(exact[j]) - exact[j], j))
    for j in order[:n - sum(counts)]:
        counts[j] += 1
    return counts


@dataclass
class Peaks:
    """The peak model of one seed: each peak's profile over the bins
    (P, K), base height (P,), and owner (P,): -1 for a shared peak, else
    the species whose own it is."""

    profiles: torch.Tensor
    heights: torch.Tensor
    owner: torch.Tensor
    mz: torch.Tensor  # the bins' centres (K,), Da


def mz_axis(config: dict, device) -> torch.Tensor:
    """The bins' centres (K,), Da."""
    k = torch.arange(config["K"], device=device, dtype=torch.float64)
    return config["mz_min_da"] + (k + 0.5) * config["bin_da"]


def peaks(config: dict, g: torch.Generator, device) -> Peaks:
    a, M = config["assumed"], config["M"]
    mz = mz_axis(config, device)
    P = a["shared_peaks"] + M * a["species_peaks"]
    lo, hi = math.log(float(mz[0])), math.log(float(mz[-1]))
    u = torch.rand(P, generator=g, device=device, dtype=torch.float64)
    centre = torch.exp(lo + (hi - lo) * u)
    sd = centre / (a["resolution"] * FWHM_PER_SD)
    h = config["bin_da"]
    edges = torch.cat([mz - h / 2, mz[-1:] + h / 2])
    cdf = torch.special.ndtr((edges[None, :] - centre[:, None]) / sd[:, None])
    profiles = (cdf[:, 1:] - cdf[:, :-1]) * (sd[:, None] * math.sqrt(2 * math.pi) / h)
    base = torch.exp(a["peak_height_sd"] * torch.randn(P, generator=g, device=device,
                                                       dtype=torch.float64))
    owner = torch.full((P,), -1, dtype=torch.int64, device=device)
    owner[a["shared_peaks"]:] = torch.arange(M, device=device).repeat_interleave(a["species_peaks"])
    sep = a["separation"] * a["separation_decay"] ** owner.clamp(min=0).double()
    base = torch.where(owner >= 0, base * sep, base)
    return Peaks(profiles.float(), base.float(), owner, mz)


def draw(config: dict, pk: Peaks, n: int, g: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """n spectra (n, K) float32 and their species (n,) int64."""
    a, M = config["assumed"], config["M"]
    device = pk.profiles.device
    counts = torch.tensor(species_counts(n, M), device=device)
    species = torch.arange(M, device=device).repeat_interleave(counts)
    species = species[torch.randperm(n, generator=g, device=device)]
    s = a["intensity_sd"]
    H = torch.exp(s * torch.randn((n, pk.heights.shape[0]), generator=g, device=device) - s * s / 2)
    present = (pk.owner[None, :] < 0) | (pk.owner[None, :] == species[:, None])
    H = H * pk.heights[None, :] * present
    X = H @ pk.profiles
    b = a["baseline_sd"]
    level = a["baseline"] * torch.exp(b * torch.randn(n, generator=g, device=device) - b * b / 2)
    shape = torch.exp(-(pk.mz - pk.mz[0]) / a["baseline_decay_da"]).float()
    X.addr_(level, shape)
    X.add_(torch.randn(X.shape, generator=g, device=device), alpha=a["noise"])
    X.mul_(X.shape[1] / X.sum(1, keepdim=True))
    return X, species


def library(config: dict, held_out: int, seed: int, device):
    """(X (N, K), species (N,), X_new (held_out, K), species_new) of one
    seed: the training library and the held-out batch, float32 on
    `device`."""
    g = torch.Generator(device).manual_seed(seed)
    pk = peaks(config, g, device)
    X, y = draw(config, pk, config["N"], g)
    X_new, y_new = draw(config, pk, held_out, g)
    return X, y, X_new, y_new
