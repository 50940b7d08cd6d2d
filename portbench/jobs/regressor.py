"""Job `regressor`: one calibration model trained and applied, as a
scikit-learn user runs it at scale: `PLSRegressor(n_components=A,
device=card).fit(X, Y)` on the configuration's N × K × M, then
`predict(X_new)` on a batch of new rows.  The estimator z-scores X and Y
into copies of its own, fits kernel PLS #1 (K1 on float32 X) and
predicts in raw units.

Inputs (`draw`): the configuration's rank-`latent_rank` latent model
(`inputs.latent`'s, without its last step, the z-scoring: the estimator
does it), X = L Px + `x_noise` E, Y = L Py + `y_noise` F, on the device
from the seed; the new rows from the same loadings Px, Py under a second
generator stream (seeded with the seed + 2⁴⁰), so that they share no
draw with the training rows.  `work` is `roofline_plsda`'s count at M
responses and the new rows (the z-scoring of X folds into XᵀY's read as
that module says); `passes` and `pass_work` are one deflation pass a
component, as in `jobs/fit.py`.

Checked, for a seeded sample of the window's jobs, against the plain
float64 reference (`reference/pls.py`'s kernel algorithm #1 on X and Y
z-scored as the estimator does: column means, N − 1 standard deviations,
a constant column's taken as 1):
- `coef_rel`: the largest over truncations c of ‖B_c − B_c,ref‖ /
  ‖B_c,ref‖ in raw units (B_c = R_c Q_cᵀ scaled by the y and x spreads),
  and the estimator's `coef_` against the last;
- `pred_rel`: the new rows' predictions, relative;
- `scores_rel`: T's columns, each up to sign.
Control: the reference in float32 with TF32 products in the program's
place.
"""

from __future__ import annotations

import torch

from portbench import roofline, roofline_plsda
from portbench.common import Reservoir, rel, rel_columns, sync
from portbench.reference import pls as ref

STREAM = 2**40  # added to the seed for the new rows' generator


def draw(config: dict, n_new: int, seed: int, device):
    """float32 X (N, K), Y (N, M) and X_new (n_new, K) on `device`."""
    N, K, M = config["N"], config["K"], config["M"]
    a = config["assumed"]
    g = torch.Generator(device).manual_seed(seed)
    r = a["latent_rank"]
    L = torch.randn((N, r), generator=g, device=device)
    Px = torch.randn((r, K), generator=g, device=device)
    X = L @ Px
    X += a["x_noise"] * torch.randn((N, K), generator=g, device=device)
    Y = L @ torch.randn((r, M), generator=g, device=device)
    Y += a["y_noise"] * torch.randn((N, M), generator=g, device=device)
    g_new = torch.Generator(device).manual_seed(seed + STREAM)
    X_new = torch.randn((n_new, r), generator=g_new, device=device) @ Px
    X_new += a["x_noise"] * torch.randn((n_new, K), generator=g_new, device=device)
    return X, Y, X_new


def _moments(X: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Column means and N − 1 standard deviations, a zero one taken as 1."""
    mean = X.mean(0)
    d = X - mean
    sd = torch.sqrt((d * d).sum(0) / (X.shape[0] - 1))
    return mean, torch.where(sd == 0, torch.ones_like(sd), sd)


class Job:
    def __init__(self, config: dict, mix: dict, seed: int, device: torch.device):
        from pls_tpu_torch.estimator import PLSRegressor

        self._new = lambda: PLSRegressor(n_components=self.A, device=device)
        self.device = device
        self.A = config["A"]
        self.traced = mix["traced"]
        self.kept = Reservoir(mix["checked"], seed)
        self.X, self.Y, self.X_new = draw(config, mix["predict_rows"], seed, device)
        (N, K), M, Nh = self.X.shape, self.Y.shape[1], self.X_new.shape[0]
        self.work = (roofline_plsda.job_bytes(N, K, M, self.A, Nh),
                     roofline_plsda.job_flops(N, K, M, self.A, Nh))
        self.passes = self.A
        self.pass_work = (roofline.pass_bytes(N, K, 4), roofline.pass_flops(N, K))

    def run(self, i: int):
        reg = self._new().fit(self.X, self.Y)
        pred = reg.predict(self.X_new)
        sync(self.device)
        f = reg._fit
        return (f.R, f.Q, f.T, reg._x_scaler.stdev, reg._y_scaler.stdev, reg.coef_, pred)

    def keep(self, answer) -> None:
        self.kept.offer(answer)

    def release(self) -> None:
        """Nothing of the program's stays but the kept answers."""

    def _reference(self, ar: ref.Arith):
        """(B at every truncation in raw units (A, K, M), the new rows'
        predictions, T) of the reference in `ar`'s arithmetic."""
        X, Y = self.X.to(ar.dtype), self.Y.to(ar.dtype)
        mx, sx = _moments(X)
        my, sy = _moments(Y)
        fit = ref.kernel_pls((X - mx) / sx, (Y - my) / sy, self.A, ar)
        del X
        Bz = fit.coefficients()
        pred = ar.mm((self.X_new.to(ar.dtype) - mx) / sx, Bz[-1]) * sy + my
        return Bz * sy / sx[:, None], pred, fit.T

    @staticmethod
    def _compare(answer, want) -> dict:
        R, Q, T, sx, sy, coef, pred = answer
        B_raw, ref_pred, ref_T = want
        Bc = torch.cumsum(R.double().mT[:, :, None] * Q.double().mT[:, None, :], dim=0)
        Bc = Bc * sy.double() / sx.double()[:, None]
        coef = torch.as_tensor(coef).mT
        return {
            "coef_rel": max([rel(coef, B_raw[-1])]
                            + [rel(Bc[c], B_raw[c]) for c in range(B_raw.shape[0])]),
            "pred_rel": rel(pred, ref_pred),
            "scores_rel": rel_columns(T, ref_T),
        }

    def check(self, limits: dict) -> list[dict]:
        want = self._reference(ref.F64)
        return [self._compare(answer, want) for answer in self.kept.items]

    def control(self, limits: dict) -> dict:
        """The readings of the reference in float32 with TF32 products in
        the program's place."""
        B, pred, T = self._reference(ref.TF32)
        want_B, want_pred, want_T = self._reference(ref.F64)
        return {"coef_rel": max(rel(B[c], want_B[c]) for c in range(B.shape[0])),
                "pred_rel": rel(pred, want_pred), "scores_rel": rel_columns(T, want_T)}
