"""Job `plsda`: one species classifier trained and applied, as a
scikit-learn user runs it: `PLSDAClassifier(n_components=A, device=card)
.fit(X, species)` on the training library, with the species a host numpy
array, then `decision_function(X_new)` on the held-out batch.  The
classifier z-scores X internally, fits PLS2 on the centred one-hot
indicators (kernel #1: K1 on float32 X) and adds the class priors back.

Inputs: `portbench/spectra.py` from the seed, the same arrays for the
reference.  `work` is `roofline_plsda`'s count of one job; `passes` and
`pass_work` are one deflation pass a component, as in `jobs/fit.py`.

Checked, for a seeded sample of the window's jobs, against the plain
float64 reference (`reference/plsda.py`) on the same spectra:
- `coef_rel`: the largest over truncations c of ‖B_c − B_c,ref‖ /
  ‖B_c,ref‖, B in the classifier's z-scored space (from its R and Q);
- `scores_rel`: T's columns, each up to sign (an eigenvector's sign is
  arbitrary);
- `decision_rel`: the held-out decision values, relative;
- `class_missed`: held-out spectra whose predicted species differs from
  the reference's where the reference's top two decision values lie
  more than `margins.decision` apart.
Also read, unlimited: `eigengap_min`, the reference's smallest relative
eigengap g_a = (λ1 − λ2) / λ1 of a component's XYᵀXY, where a near tie
would leave that component's direction ill defined in any precision
(66 seeds on an H100 read 1.1e-2 at the least, with no reading near its
limit).
Control: the reference in float32 with TF32 products in the program's
place.
"""

from __future__ import annotations

import torch

from portbench import roofline, roofline_plsda, spectra
from portbench.common import Reservoir, rel, rel_columns, sync
from portbench.reference import pls as ref
from portbench.reference import plsda as ref_plsda


class Job:
    def __init__(self, config: dict, mix: dict, seed: int, device: torch.device):
        from pls_tpu_torch.models import plsda

        self._new = lambda: plsda.PLSDAClassifier(n_components=self.A, device=device)
        self.device = device
        self.A = config["A"]
        self.traced = mix["traced"]
        self.kept = Reservoir(mix["checked"], seed)
        self.X, labels, self.X_new, _ = spectra.library(config, mix["held_out"], seed, device)
        self.labels = labels
        self.species = labels.cpu().numpy()  # host labels, as a scikit-learn user gives them
        (N, K), Nh = self.X.shape, self.X_new.shape[0]
        M = config["M"]
        self.work = (roofline_plsda.job_bytes(N, K, M, self.A, Nh),
                     roofline_plsda.job_flops(N, K, M, self.A, Nh))
        self.passes = self.A
        self.pass_work = (roofline.pass_bytes(N, K, 4), roofline.pass_flops(N, K))

    def run(self, i: int):
        clf = self._new().fit(self.X, self.species)
        d = clf.decision_function(self.X_new)
        sync(self.device)
        return clf._fit, d

    def keep(self, answer) -> None:
        self.kept.offer(answer)

    def release(self) -> None:
        """Nothing of the program's stays but the kept answers."""

    def _reference(self, ar: ref.Arith) -> ref_plsda.Model:
        return ref_plsda.fit(self.X, self.labels, self.A, ar)

    def _compare(self, answer, want: ref_plsda.Model, margins: dict) -> dict:
        """answer: (R, Q, T, the held-out decision values)."""
        R, Q, T, d = answer
        Bc = torch.cumsum(R.double().mT[:, :, None] * Q.double().mT[:, None, :], dim=0)
        got = torch.as_tensor(d)
        ref_d = want.decision(self.X_new)
        top2 = torch.topk(ref_d, 2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) > margins["decision"]
        moved = torch.argmax(got.to(ref_d.device), 1) != torch.argmax(ref_d, 1)
        return {
            "coef_rel": max(rel(Bc[c], want.B[c]) for c in range(Bc.shape[0])),
            "scores_rel": rel_columns(T, want.fit.T),
            "decision_rel": rel(got, ref_d),
            "class_missed": int((moved & clear).sum()),
            "eigengap_min": float(want.gaps.min()),
        }

    def check(self, limits: dict) -> list[dict]:
        want = self._reference(ref.F64)
        return [self._compare((fit.R, fit.Q, fit.T, d), want, limits["margins"])
                for fit, d in self.kept.items]

    def control(self, limits: dict) -> dict:
        """The readings of the reference in float32 with TF32 products in
        the program's place."""
        low = self._reference(ref.TF32)
        answer = (low.fit.R, low.fit.Q, low.fit.T, low.decision(self.X_new, ref.TF32))
        return self._compare(answer, self._reference(ref.F64), limits["margins"])
