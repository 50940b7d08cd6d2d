"""Pieces the job modules share: the seeded sample of answers kept for the
check, the comparisons, and the device's synchronisation."""

from __future__ import annotations

import random

import torch


class Reservoir:
    """A uniform sample of at most `size` of the answers offered, drawn
    from the seed (reservoir sampling), so that the answers checked after
    the window are spread over all of it without knowing its length."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self._rng = random.Random(seed)
        self.items: list = []
        self._seen = 0

    def offer(self, item) -> None:
        self._seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = self._rng.randrange(self._seen)
            if j < self.size:
                self.items[j] = item


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rel(a, ref) -> float:
    """‖a − ref‖ / ‖ref‖ (Frobenius), in float64."""
    a = torch.as_tensor(a).double()
    ref = torch.as_tensor(ref).double().to(a.device)
    return float(torch.linalg.vector_norm(a - ref) / torch.linalg.vector_norm(ref))


def rel_columns(a, ref) -> float:
    """The largest column-wise rel() over the last axis, each column of `a`
    first given the sign that matches ref's (an eigenvector's sign is
    arbitrary)."""
    a = torch.as_tensor(a).double()
    ref = torch.as_tensor(ref).double().to(a.device)
    s = torch.sign((a * ref).sum(-2, keepdim=True))
    num = torch.linalg.vector_norm(a * torch.where(s == 0, 1.0, s) - ref, dim=-2)
    return float((num / torch.linalg.vector_norm(ref, dim=-2)).max())


def missed(chosen, allowed: list[set[int]]) -> int:
    """How many responses' chosen counts lie outside the allowed sets."""
    return sum(int(c) not in ok for c, ok in zip(chosen, allowed, strict=True))
