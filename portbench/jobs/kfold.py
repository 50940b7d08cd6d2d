"""Job `kfold`: a k-fold cross-validated choice of component count at
scale, as a user runs it on a fitted model: `PLSModel.cv_KFOLD(k,
assignments=…)` on its default path (XᵀX and XᵀY once, then each fold
refitted by algorithm #2 from the statistics downdated by its rows, folds
in batches), PRESS and `optimal_num_components`.

The model is fitted once at set-up.  Each job takes fold assignments of its
own from a pool drawn from the seed (arange(N) % k, permuted), so every
job does the same work on other folds; the benchmark hands the same
assignments to the reference.

Checked, for a seeded sample of the window's CVs: the fold errors, PRESS
and the chosen counts against the plain reference in float64.  The
errors are compared truncation by truncation, and the median of the
truncations' relative gaps is the number: where the top two eigenvalues
of one fold's XYᵀXY nearly meet, that component's direction is ill
defined in any precision and its truncation alone reads up to 1e-4 (a
relative eigengap of 2e-3 in one of 55 seeds), while lower and higher
truncations agree again.  A chosen count is wrong only where the
reference's own choice is not borderline.
Control: the reference in float32 with TF32 products in the program's
place.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import inputs, roofline
from portbench.common import Reservoir, missed, rel, sync
from portbench.reference import pls as ref


class Job:
    def __init__(self, config: dict, mix: dict, seed: int, device: torch.device):
        from pls_tpu_torch.cv.validation import optimal_num_components, validation
        from pls_tpu_torch.model import PLSModel
        from pls_tpu_torch.types import METHOD, RESS

        self.device = device
        self.A, self.k, self.alpha = config["A"], mix["k"], mix["alpha"]
        self.traced = mix["traced"]
        self.kept = Reservoir(mix["checked"], seed)
        self.X, self.Y = inputs.latent(config, seed, device)
        (N, K), M = self.X.shape, self.Y.shape[1]
        rng = np.random.default_rng(seed)
        self.pool = [rng.permutation(np.arange(N) % self.k) for _ in range(mix["assignments"])]
        self.model = PLSModel(self.X, self.Y, METHOD(config["method"]), self.A)
        self._choose = lambda res: optimal_num_components(res, self.alpha)
        self._press = lambda res: validation(res, RESS)
        self.work = (roofline.kfold_bytes(N, K, M, self.A, self.k, 4),
                     roofline.kfold_flops(N, K, M, self.A, self.k))

    def run(self, i: int):
        j = i % len(self.pool)
        res = self.model.cv_KFOLD(self.k, assignments=self.pool[j])
        press = self._press(res)
        chosen = self._choose(res).tolist()
        sync(self.device)
        return j, res.errors, press, chosen

    def keep(self, answer) -> None:
        self.kept.offer(answer)

    def release(self) -> None:
        self.model = None

    def _reference(self, j: int, ar: ref.Arith) -> torch.Tensor:
        assign = torch.from_numpy(self.pool[j])
        return ref.kfold_errors(self.X, self.Y, assign, self.k, self.A, ar)

    def _compare(self, answer, want: torch.Tensor, margins: dict) -> dict:
        _, errors, press, chosen = answer
        P = ref.press(want)
        allowed = ref.admissible_counts(want, self.alpha, margins["p"], margins["press"])
        by_c = [rel(errors[..., c], want[..., c]) for c in range(want.shape[-1])]
        return {
            "errors_rel": float(torch.tensor(by_c).median()),
            "press_rel": float(((press.double() - P).abs() / P).max()),
            "choice_missed": missed(chosen, allowed),
        }

    def check(self, limits: dict) -> list[dict]:
        return [self._compare(a, self._reference(a[0], ref.F64), limits["margins"])
                for a in self.kept.items]

    def control(self, limits: dict) -> dict:
        """The readings of the reference in float32 with TF32 products in the
        program's place, on the pool's first assignments."""
        low = self._reference(0, ref.TF32)
        chosen = [min(a) for a in ref.admissible_counts(low, self.alpha)]
        return self._compare((0, low, ref.press(low), chosen), self._reference(0, ref.F64),
                             limits["margins"])
