"""Seeded ¹H NMR spectra of timed 24-h urine collections from a cohort of
four countries, for the OPLS-DA cell.

Both sides of a comparison get the same arrays from here: the program
under test and the plain reference (`portbench/reference/oplsda.py`).
Everything is drawn on the device by one `torch.Generator` from the seed,
in a few large calls.  It imports nothing of the program, of the JAX
package or of JAX.

The published shape is the configuration's: N spectra, two collections
from each of N / 2 participants, of M countries enrolled in the stated
proportions, by K points of the kept chemical-shift axis.  The rest is
the configuration's `assumed` keys:

- the axis (`axis`): K points spaced evenly over the kept regions of
  `kept_ppm` less `excluded_ppm` (water and urea), ascending; at the
  configuration's K = round(kept width × `spectral_points` /
  `spectral_width_ppm`) (`grid_points`) the spacing is the digitised
  spectrum's to 1 part in 10⁵;
- a library (`library`) of `metabolites` compounds, a share
  `aromatic_share` of them with their signals in 6.6-9.4 ppm, the rest in
  0.8-4.4 ppm; each has 1 to `max_signals` signals, each a singlet,
  doublet, triplet or quartet (binomial line weights) of 1-3 protons,
  couplings uniform in `coupling_hz`; every line is a Lorentzian of full
  width `linewidth_hz` at the field `field_mhz` (published), of height the line's
  protons times the compound's concentration;
- a share `ph_sensitive_share` of the compounds is pH-sensitive: each of
  its signals moves by α·Δ ppm, α ~ N(0, `ph_shift_ppm`²) a signal and Δ
  the collection's pH offset ~ N(0, `ph_sd`²), clamped to ±3 sd and
  rounded to one of `ph_levels` levels (so the spectra of one level share
  one bank of line shapes);
- a participant's log concentration of compound m is μ_m ~ N(0,
  `abundance_sd`²) plus N(0, `biological_sd`²), plus the country's effect
  on its `country_markers` marker compounds (no compound marks two
  countries), ± `country_effect` with the sign drawn, so that every pair of
  countries stands apart on the markers of both; plus sex (a share
  `sex_share` of the
  compounds, ± `sex_effect` about the midpoint of the two sexes), plus
  age (uniform 40-59, standardised; a share `age_share`, `age_effect` a
  standard deviation of age, signed), plus `diet_modules` dietary modules
  (a share `module_share` of the compounds each, loading N(0,
  `module_loading`²), activity N(0, 1) a participant) that no country
  shifts;
- each collection adds N(0, `within_sd`²) to every log concentration and
  is diluted by exp(N(0, `dilution_sd`²)) as a whole;
- `drugs` drug metabolites (compounds of the library's kind), present in
  a participant's two collections with the probabilities
  `drug_prevalence`, at exp(N(0, `drug_sd`²)) units, diluted with the
  urine;
- a baseline a collection: an offset, a slope over the axis and a broad
  hump (a Gaussian at `hump_ppm` of sd `hump_width_ppm`), each N(0,
  `baseline_sd`²);
- white noise N(0, `noise`²) on every point, last.

So the Y-orthogonal variation has at least ten independent sources:
dilution, pH, sex, age, each drug, the three baseline terms and the
dietary modules.  Participants take the countries' shares of the
enrolment (`enrolment`) as whole counts by largest remainder, at least
one each, in an order drawn from the seed.  The held-out batch is a
second draw of participants from the same library and effects, so it
holds no collection of a training participant.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def grid_points(config: dict) -> int:
    """The points of the digitised spectrum that fall in the kept regions:
    round(kept width × points / spectral width)."""
    a = config["assumed"]
    (lo, hi), (xlo, xhi) = a["kept_ppm"], a["excluded_ppm"]
    return round(((hi - lo) - (xhi - xlo)) * a["spectral_points"] / a["spectral_width_ppm"])


def axis(config: dict, device="cpu") -> torch.Tensor:
    """(K,) float64 chemical shifts in ppm, ascending: K points evenly over
    the kept regions, the excluded region jumped over."""
    a = config["assumed"]
    (lo, hi), (xlo, xhi) = a["kept_ppm"], a["excluded_ppm"]
    K = config["K"]
    u = (torch.arange(K, dtype=torch.float64, device=device) + 0.5) * (
        ((hi - lo) - (xhi - xlo)) / K)
    below = xlo - lo
    return torch.where(u < below, lo + u, xhi + (u - below))


def shares(n: int, enrolment: dict) -> list[int]:
    """Participants a country among `n`, in proportion to its enrolment,
    whole by largest remainder with at least one each (countries in the
    dict's order)."""
    w = list(enrolment.values())
    if n < len(w):
        raise ValueError(f"{n} participants cannot hold {len(w)} countries")
    exact = [(n - len(w)) * x / sum(w) for x in w]
    counts = [1 + int(e) for e in exact]
    order = sorted(range(len(w)), key=lambda j: (int(exact[j]) - exact[j], j))
    for j in order[:n - sum(counts)]:
        counts[j] += 1
    return counts


@dataclass
class Library:
    """The spectral and biological model of one seed.

    Lines (n_lines,): position (ppm, float64), weight (protons ×
    multiplet share), owner (compound), pH sensitivity α (ppm a pH unit,
    0 for a fixed signal).  Compounds: `metabolites` of the library, then
    the drugs.  mu, sex, age (L,) and country (M, L), modules (Q, L) act
    on the log concentrations of the library's compounds; `levels` are the
    pH offsets; `baseline` (3, K) the offset, slope and hump shapes."""

    axis: torch.Tensor
    gamma: float
    pos: torch.Tensor
    weight: torch.Tensor
    owner: torch.Tensor
    alpha: torch.Tensor
    n_compounds: int
    mu: torch.Tensor
    sex: torch.Tensor
    age: torch.Tensor
    country: torch.Tensor
    modules: torch.Tensor
    levels: torch.Tensor
    baseline: torch.Tensor

    def bank(self, level: float, sensitive: bool) -> torch.Tensor:
        """(n_compounds, K) float32 line shapes at pH offset `level`, of the
        compounds whose lines are pH-sensitive (`sensitive`) or fixed."""
        keep = (self.alpha != 0) if sensitive else (self.alpha == 0)
        pos = self.pos[keep] + self.alpha[keep] * level
        d = (self.axis[None, :] - pos[:, None]) / self.gamma
        shape = (self.weight[keep][:, None] / (1 + d * d)).float()
        out = torch.zeros(self.n_compounds, self.axis.shape[0], device=shape.device)
        return out.index_add_(0, self.owner[keep], shape)


def _compounds(n: int, a: dict, field_mhz: float, device, kw: dict):
    """Lines of n compounds: (pos, weight, owner, signal), positions in ppm."""
    S = a["max_signals"]
    signals = 1 + torch.randint(S, (n,), **kw)
    aromatic = torch.rand(n, **kw) < a["aromatic_share"]
    lo = torch.where(aromatic, 6.6, 0.8).double()
    hi = torch.where(aromatic, 9.4, 4.4).double()
    at = lo[:, None] + (hi - lo)[:, None] * torch.rand(n, S, dtype=torch.float64, **kw)
    mult = 1 + torch.randint(4, (n, S), **kw)  # singlet .. quartet
    protons = 1 + torch.randint(3, (n, S), **kw)
    jl, jh = a["coupling_hz"]
    J = (jl + (jh - jl) * torch.rand(n, S, dtype=torch.float64, **kw)) / field_mhz
    k = torch.arange(4, device=device)
    binom = torch.tensor([[1, 0, 0, 0], [1, 1, 0, 0], [1, 2, 1, 0], [1, 3, 3, 1]],
                         dtype=torch.float64, device=device)
    share = binom[mult - 1] / binom[mult - 1].sum(-1, keepdim=True)  # (n, S, 4)
    pos = at[..., None] + (k - (mult[..., None] - 1) / 2) * J[..., None]
    live = (k < mult[..., None]) & (torch.arange(S, device=device)[:, None]
                                    < signals[:, None, None])
    weight = protons[..., None] * share
    owner = torch.arange(n, device=device)[:, None, None].expand(n, S, 4)
    signal = torch.arange(S, device=device)[None, :, None].expand(n, S, 4)
    return pos[live], weight[live], owner[live], signal[live]


def library(config: dict, g: torch.Generator, device) -> Library:
    a, K, M = config["assumed"], config["K"], config["M"]
    kw = {"generator": g, "device": device}
    L, D = a["metabolites"], a["drugs"]
    pos, weight, owner, signal = _compounds(L + D, a, config["field_mhz"], device, kw)
    sensitive = torch.rand(L + D, **kw) < a["ph_sensitive_share"]
    sensitive[L:] = False  # drugs hold their place
    slope = a["ph_shift_ppm"] * torch.randn(L + D, a["max_signals"], dtype=torch.float64, **kw)
    alpha = torch.where(sensitive[owner], slope[owner, signal], 0.0)

    def subset(share):
        return (torch.rand(L, **kw) < share).float()

    mu = a["abundance_sd"] * torch.randn(L, **kw)
    sign = torch.where(torch.rand(L, **kw) < 0.5, -1.0, 1.0)
    sex = a["sex_effect"] * sign * subset(a["sex_share"])
    sign = torch.where(torch.rand(L, **kw) < 0.5, -1.0, 1.0)
    age = a["age_effect"] * sign * subset(a["age_share"])
    marks = torch.randperm(L, **kw)[:M * a["country_markers"]].view(M, -1)
    sign = torch.where(torch.rand(marks.shape, **kw) < 0.5, -1.0, 1.0)
    country = torch.zeros(M, L, device=device).scatter_(1, marks, a["country_effect"] * sign)
    Q = a["diet_modules"]
    member = (torch.rand(Q, L, **kw) < a["module_share"]).float()
    modules = a["module_loading"] * torch.randn(Q, L, **kw) * member
    n = a["ph_levels"]
    levels = 3 * a["ph_sd"] * torch.linspace(-1, 1, n, dtype=torch.float64, device=device)
    ax = axis(config, device)
    lo, hi = ax[0], ax[-1]
    u = 2 * (ax - lo) / (hi - lo) - 1
    hump = torch.exp(-0.5 * ((ax - a["hump_ppm"]) / a["hump_width_ppm"]) ** 2)
    baseline = torch.stack([torch.ones_like(ax), u, hump]).float()
    gamma = a["linewidth_hz"] / 2 / config["field_mhz"]  # half width at half height, ppm
    return Library(ax, gamma, pos, weight, owner, alpha, L + D, mu, sex, age, country, modules,
                   levels, baseline)


def draw(config: dict, lib: Library, n: int, g: torch.Generator):
    """n spectra (n, K) float32, two collections a participant in
    consecutive rows, and their countries (n,) int64."""
    if n % 2:
        raise ValueError(f"{n} spectra are not two collections a participant")
    a, M = config["assumed"], config["M"]
    device = lib.mu.device
    kw = {"generator": g, "device": device}
    P, L, D = n // 2, lib.mu.shape[0], a["drugs"]
    counts = torch.tensor(shares(P, config["enrolment"]), device=device)
    country = torch.arange(M, device=device).repeat_interleave(counts)
    country = country[torch.randperm(P, **kw)]
    sex = (torch.rand(P, **kw) < 0.5).float() - 0.5
    age = (40 + 19 * torch.rand(P, **kw) - 49.5) / (19 / 12 ** 0.5)
    diet = torch.randn(P, lib.modules.shape[0], **kw)
    logc = (lib.mu + a["biological_sd"] * torch.randn(P, L, **kw) + lib.country[country]
            + sex[:, None] * lib.sex + age[:, None] * lib.age + diet @ lib.modules)
    present = (torch.rand(P, D, **kw) < torch.tensor(a["drug_prevalence"], device=device)).float()
    dose = present * torch.exp(a["drug_sd"] * torch.randn(P, D, **kw))
    # two collections a participant: the day's variation and the dilution
    c = torch.exp(logc.repeat_interleave(2, 0) + a["within_sd"] * torch.randn(n, L, **kw))
    c = torch.cat([c, dose.repeat_interleave(2, 0)], 1)
    c *= torch.exp(a["dilution_sd"] * torch.randn(n, 1, **kw))
    X = c @ lib.bank(0.0, sensitive=False)
    shift = (a["ph_sd"] * torch.randn(n, **kw)).clamp(-3 * a["ph_sd"], 3 * a["ph_sd"])
    step = (lib.levels[1] - lib.levels[0]) if len(lib.levels) > 1 else 1.0
    level = torch.round((shift.double() - lib.levels[0]) / step).long()
    for b in torch.unique(level).tolist():
        rows = torch.nonzero(level == b)[:, 0]
        X.index_add_(0, rows, c[rows] @ lib.bank(float(lib.levels[b]), sensitive=True))
    X.addmm_(a["baseline_sd"] * torch.randn(n, 3, **kw), lib.baseline)
    X.add_(torch.randn(X.shape, **kw), alpha=a["noise"])
    return X, country.repeat_interleave(2)


def cohort(config: dict, held_out: int, seed: int, device):
    """(X (N, K), countries (N,), X_new (held_out, K), countries_new) of
    one seed: the training cohort and the held-out batch, float32 on
    `device`."""
    g = torch.Generator(device).manual_seed(seed)
    lib = library(config, g, device)
    X, y = draw(config, lib, config["N"], g)
    X_new, y_new = draw(config, lib, held_out, g)
    return X, y, X_new, y_new
