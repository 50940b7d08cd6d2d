"""The benchmark's inputs, made from a configuration and a seed.

Both sides of a comparison get the same inputs from here: the program
under test and the plain reference (`portbench/reference/`).

- `latent`: X (N, K) and Y (N, M) of a latent-variable model, made on the
  device by one `torch.Generator` from the seed in a few large calls:
  X = L Px + noise, Y = L Py + noise with L (N, rank) standard normal,
  then both z-scored by column, as chip_smoke.py's `make_big` makes its
  100000×5000×10 data.
- `csv_matrix`: a headerless CSV of numbers, read as float64 on the host.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def _z(X: torch.Tensor) -> torch.Tensor:
    d = X - X.mean(0)
    sd = torch.sqrt((d * d).sum(0) / (X.shape[0] - 1))
    return d / torch.where(sd == 0, torch.ones_like(sd), sd)


def latent(config: dict, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 X (N, K) and Y (N, M) on `device` from `seed`; the shape,
    the latent rank and the noise levels are the configuration's."""
    N, K, M = config["N"], config["K"], config["M"]
    a = config["assumed"]
    g = torch.Generator(device).manual_seed(seed)
    L = torch.randn((N, a["latent_rank"]), generator=g, device=device)
    X = L @ torch.randn((a["latent_rank"], K), generator=g, device=device)
    X += a["x_noise"] * torch.randn((N, K), generator=g, device=device)
    Y = L @ torch.randn((a["latent_rank"], M), generator=g, device=device)
    Y += a["y_noise"] * torch.randn((N, M), generator=g, device=device)
    del L
    return _z(X), _z(Y)


def csv_matrix(path: str) -> np.ndarray:
    """A headerless numeric CSV (a path relative to the checkout) as a
    2-D float64 array."""
    return np.atleast_2d(np.loadtxt(ROOT / path, delimiter=",", dtype=np.float64, ndmin=2))
