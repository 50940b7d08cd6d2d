"""Job `oplsda`: one metabolic-phenotyping model trained and applied, as a
scikit-learn user runs it: `OPLSDAClassifier(n_components=A,
n_ortho=n_o, device=card).fit(X, countries)` on the cohort's spectra,
with the countries a host numpy array, then `decision_function(X_new)` on
the held-out batch.  The classifier z-scores X internally, strips n_o
Y-orthogonal components from it (the filter deflates X itself), fits
PLS2 of A components on the centred one-hot indicators of the filtered X
(kernel #1: K1 on float32 X), applies the filter again to the training X
for the S-plot, and filters the held-out batch before its decision
values.

Inputs: `portbench/nmr.py` from the seed, the same arrays for the
reference.  `work` is `roofline_oplsda`'s count of one job; `passes` and
`pass_work` are the predictive fit's deflation passes, one a component,
as in `jobs/plsda.py`.  `x_passes` is the program's counter
`models.opls.x_elements` (its tally of the X-sized elements that the
filter's and `correct`'s operations read and write, which
`tests/test_torch_tracing.py` holds to the operations PyTorch
dispatches), summed over the last job run, over N·K of the training X
(None where the program has no such counter).

Checked, for a seeded sample of the window's jobs, against the plain
float64 reference (`reference/oplsda.py`) on the same spectra:
- `coef_rel`: the largest over truncations c of ‖B_c − B_c,ref‖ /
  ‖B_c,ref‖, B in the classifier's filtered z-scored space (from its R
  and Q);
- `ortho_removed_rel`: the orthogonal variation the filter removed from
  the training X, T_o P_oᵀ (each orthogonal score with its loading, so
  no sign to match), relative;
- `decision_rel`: the held-out decision values, relative;
- `class_missed`: held-out spectra whose predicted country differs from
  the reference's where the reference's top two decision values lie
  more than `margins.decision` apart.
Also read, unlimited (the limits file names none of them):
- `scores_rel`: the predictive scores T's columns, each up to sign, and
  `splot_rel`: the S-plot's p(corr), up to one sign (r₁'s).  Over 260
  seeds on an H100 the sound runs read up to 1.0e-4 and 2.3e-5, the
  control down to 2.1e-4 and 4.9e-5: no limit lies between with room on
  both sides, and the control fails `coef_rel` and `decision_rel` on
  every one of those seeds;
- `ortho_scores_rel`: T_o's columns, each up to sign (an eigenvector's
  sign is arbitrary, and w_o's follows w's), the worst column.  Two
  orthogonal components of near-equal weight can turn within their
  plane, and sound float32 runs then read up to 1.9e-3 in two columns
  (the float64 port 4.4e-13, 1 000 times float64's rounding), while T_o
  P_oᵀ, which is all that the filter hands on, stays at 1.6e-6; over 260
  seeds the worst sound column read 6.1e-4 and the control's best
  3.1e-4;
- `eigengap_min`, the reference's smallest relative eigengap (λ1 − λ2) /
  λ1 of an XYᵀXY whose eigenvector gives a weight (the filter's
  components and the fit's), and `wo_norm_min`, the smallest ‖w_o‖
  before normalisation (near zero either leaves a direction ill defined
  in any precision).
Control: the reference in float32 with TF32 products in the program's
place.
"""

from __future__ import annotations

import torch

from portbench import nmr, roofline, roofline_oplsda
from portbench.common import Reservoir, rel, rel_columns, sync
from portbench.reference import oplsda as ref_oplsda
from portbench.reference import pls as ref


def x_elements() -> int | None:
    """The program's `models.opls.x_elements`, summed over its operations,
    or None where the program has no such counter."""
    from pls_tpu_torch.models import opls

    counter = getattr(opls, "x_elements", None)
    return None if counter is None else sum(counter.values())


class Job:
    def __init__(self, config: dict, mix: dict, seed: int, device: torch.device):
        from pls_tpu_torch.models import oplsda

        self._new = lambda: oplsda.OPLSDAClassifier(n_components=self.A, n_ortho=self.n_ortho,
                                                    device=device)
        self.device = device
        self.A, self.n_ortho = config["A"], config["n_ortho"]
        self.traced = mix["traced"]
        self.kept = Reservoir(mix["checked"], seed)
        self.X, self.labels, self.X_new, _ = nmr.cohort(config, mix["held_out"], seed, device)
        self.countries = self.labels.cpu().numpy()  # host labels, as a scikit-learn user gives them
        (N, K), Nh = self.X.shape, self.X_new.shape[0]
        M = config["M"]
        self.work = (roofline_oplsda.job_bytes(N, K, M, self.A, self.n_ortho, Nh),
                     roofline_oplsda.job_flops(N, K, M, self.A, self.n_ortho, Nh))
        self.passes = self.A
        self.pass_work = (roofline.pass_bytes(N, K, 4), roofline.pass_flops(N, K))
        self.x_passes = None

    def run(self, i: int):
        before = x_elements()
        clf = self._new().fit(self.X, self.countries)
        d = clf.decision_function(self.X_new)
        sync(self.device)
        if before is not None:
            self.x_passes = (x_elements() - before) / self.X.numel()
        f = clf._fit
        return f.T_o, f.P_o, f.pls.R, f.pls.Q, f.pls.T, clf.s_plot()[1], d

    def keep(self, answer) -> None:
        self.kept.offer(answer)

    def release(self) -> None:
        """Nothing of the program's stays but the kept answers."""

    def _reference(self, ar: ref.Arith) -> ref_oplsda.Model:
        return ref_oplsda.fit(self.X, self.labels, self.A, self.n_ortho, ar)

    def _compare(self, answer, want: ref_oplsda.Model, ref_d, margins: dict) -> dict:
        """answer: (T_o, P_o, R, Q, T, p(corr), the held-out decision
        values)."""
        T_o, P_o, R, Q, T, p_corr, d = answer
        Bc = torch.cumsum(R.double().mT[:, :, None] * Q.double().mT[:, None, :], dim=0)
        got = torch.as_tensor(d).to(ref_d.device)
        top2 = torch.topk(ref_d, 2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) > margins["decision"]
        moved = torch.argmax(got, 1) != torch.argmax(ref_d, 1)
        return {
            "coef_rel": max(rel(Bc[c], want.B[c]) for c in range(Bc.shape[0])),
            "ortho_removed_rel": rel(T_o.double() @ P_o.double().mT, want.T_o @ want.P_o.mT),
            "scores_rel": rel_columns(T, want.fit.T),
            "decision_rel": rel(got, ref_d),
            "splot_rel": rel_columns(torch.as_tensor(p_corr)[:, None], want.splot[1][:, None]),
            "class_missed": int((moved & clear).sum()),
            "eigengap_min": float(want.gaps.min()),
            "wo_norm_min": float(want.wo_norms.min()),
            "ortho_scores_rel": rel_columns(T_o, want.T_o),
        }

    def check(self, limits: dict) -> list[dict]:
        want = self._reference(ref.F64)
        ref_d = want.decision(self.X_new)
        return [self._compare(answer, want, ref_d, limits["margins"])
                for answer in self.kept.items]

    def control(self, limits: dict) -> dict:
        """The readings of the reference in float32 with TF32 products in
        the program's place."""
        low = self._reference(ref.TF32)
        answer = (low.T_o, low.P_o, low.fit.R, low.fit.Q, low.fit.T, low.splot[1],
                  low.decision(self.X_new, ref.TF32))
        del low
        want = self._reference(ref.F64)
        return self._compare(answer, want, want.decision(self.X_new), limits["margins"])
