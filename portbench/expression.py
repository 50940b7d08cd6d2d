"""Seeded gene-expression profiles of tumours of many types, for the
pan-cancer PLS-DA cell.

Both sides of a comparison get the same arrays from here: the program
under test and the plain reference (`portbench/reference/plsda.py`).
Everything is drawn on the device by one `torch.Generator` from the seed,
in a few large calls.  It imports nothing of the program, of the JAX
package or of JAX.

The published shape is the configuration's: N tumours of M types by K
genes (TCGA's gene-level RNASeqV2 matrix).  The expression model is the
configuration's `assumed` keys, on the log2(RSEM + 1) scale:

- gene g has a mean μ_g ~ N(`gene_mean`, `gene_mean_sd`²) and a spread
  σ_g, log-normal about `gene_sd` (log sd `gene_sd_spread`); a share
  `unexpressed_share` of the genes, drawn from the seed, reads 0 in every
  tumour, library and held-out alike (constant columns);
- `modules` co-expression modules of `module_genes` genes each, drawn
  with replacement over the genes, each gene's loading N(0,
  `module_loading`²); a tumour's activity of each module is N(0, 1);
- each type has `markers` marker genes, up-regulated with probability
  `marker_up`, of effect `marker_effect` (in units of σ_g) times a
  mean-one log-normal factor of sd `marker_effect_sd`, times
  `effect_decay` to the type's rank, so that no two types stand equally
  far from the rest and XYᵀXY's leading eigenvalues are not tied by
  construction;
- a tumour's purity π ~ Beta(`purity_a`, `purity_b`), both whole
  numbers, scales its type's effects (the non-tumour share of a sample
  carries none), and its depth shifts every expressed gene by N(0,
  `depth_sd`²) (log2 of a library size factor);
- the rest is N(0, `noise`²) in units of σ_g; then the log scale's floor,
  0.

    x_ig = max(0, μ_g + σ_g (Σ_l f_il L_lg + π_i E_type(i),g + noise ε_ig) + d_i)

Types take shares ∝ `type_share_ratio` to the rank (10.3 % down to
0.36 % for 33 types at 0.9: 1 057 of 10 267 tumours, near TCGA-BRCA's
1 100, down to 37, near TCGA-CHOL's 36), as whole counts by largest
remainder with at least one tumour a type, in an order drawn from the
seed.  The held-out
batch is a second draw from the same genes, modules and markers, so it
holds no copy of a training tumour.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def type_counts(n: int, types: int, ratio: float) -> list[int]:
    """Tumours a type among `n`, shares ∝ ratio to the rank, whole by
    largest remainder with at least one each."""
    if n < types:
        raise ValueError(f"{n} tumours cannot hold {types} types")
    w = [ratio ** j for j in range(types)]
    exact = [(n - types) * x / sum(w) for x in w]
    counts = [1 + int(e) for e in exact]
    order = sorted(range(types), key=lambda j: (int(exact[j]) - exact[j], j))
    for j in order[:n - sum(counts)]:
        counts[j] += 1
    return counts


@dataclass
class Genes:
    """The expression model of one seed: each gene's mean and spread (K,),
    whether it is expressed (K,), the modules' loadings (L, K) and the
    types' effects (M, K), in units of the gene's spread."""

    mean: torch.Tensor
    sd: torch.Tensor
    expressed: torch.Tensor
    loadings: torch.Tensor
    effects: torch.Tensor


def genes(config: dict, g: torch.Generator, device) -> Genes:
    a, K, M = config["assumed"], config["K"], config["M"]
    kw = {"generator": g, "device": device}
    mean = a["gene_mean"] + a["gene_mean_sd"] * torch.randn(K, **kw)
    sd = a["gene_sd"] * torch.exp(a["gene_sd_spread"] * torch.randn(K, **kw))
    expressed = torch.ones(K, dtype=torch.bool, device=device)
    expressed[torch.randperm(K, **kw)[:round(a["unexpressed_share"] * K)]] = False
    L, size = a["modules"], a["module_genes"]
    loadings = torch.zeros(L, K, device=device)
    members = torch.randint(K, (L, size), **kw)
    loadings.scatter_add_(1, members, a["module_loading"] * torch.randn(L, size, **kw))
    marks = torch.rand(M, K, **kw).argsort(1)[:, :a["markers"]]
    s = a["marker_effect_sd"]
    effect = a["marker_effect"] * torch.exp(s * torch.randn(M, a["markers"], **kw) - s * s / 2)
    up = torch.rand(M, a["markers"], **kw) < a["marker_up"]
    decay = a["effect_decay"] ** torch.arange(M, device=device, dtype=torch.float32)
    effects = torch.zeros(M, K, device=device)
    effects.scatter_(1, marks, torch.where(up, effect, -effect) * decay[:, None])
    return Genes(mean, sd, expressed, loadings, effects)


def draw(config: dict, gm: Genes, n: int, g: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """n profiles (n, K) float32 and their types (n,) int64."""
    a, M = config["assumed"], config["M"]
    device = gm.mean.device
    counts = torch.tensor(type_counts(n, M, a["type_share_ratio"]), device=device)
    types = torch.arange(M, device=device).repeat_interleave(counts)
    types = types[torch.randperm(n, generator=g, device=device)]
    # Beta(a, b) of whole a, b: Ga / (Ga + Gb), a gamma of whole shape k the
    # sum of k standard exponentials
    e = -torch.log1p(-torch.rand(n, a["purity_a"] + a["purity_b"], generator=g, device=device))
    purity = e[:, :a["purity_a"]].sum(1) / e.sum(1)
    f = torch.randn(n, gm.loadings.shape[0], generator=g, device=device)
    X = f @ gm.loadings
    X.addmm_(torch.nn.functional.one_hot(types, M).float() * purity[:, None], gm.effects)
    X.add_(torch.randn(X.shape, generator=g, device=device), alpha=a["noise"])
    X.mul_(gm.sd).add_(gm.mean)
    X.add_(a["depth_sd"] * torch.randn(n, 1, generator=g, device=device))
    X.clamp_(min=0.0).mul_(gm.expressed)
    return X, types


def library(config: dict, held_out: int, seed: int, device):
    """(X (N, K), types (N,), X_new (held_out, K), types_new) of one seed:
    the training library and the held-out batch, float32 on `device`."""
    g = torch.Generator(device).manual_seed(seed)
    gm = genes(config, g, device)
    X, y = draw(config, gm, config["N"], g)
    X_new, y_new = draw(config, gm, held_out, g)
    return X, y, X_new, y_new
