"""Job `fit`: one model of the configuration's A components, as a user
builds it at scale: `PLSModel(X, Y, method, A)` and its coefficients.

The mix may store X in bfloat16 (`"x_storage": "bf16"`): the program then
rounds X, and Y in XᵀY, to bfloat16 and accumulates in float32.  The
reference computes in float64 on the inputs as the mix stores them.

Checked: the coefficients at every truncation and the scores T (each
column up to sign: an eigenvector's sign is arbitrary) of a seeded sample
of the window's fits, against the reference's algorithm #1.  Control: the
reference in the program's place one precision down, float32 with TF32
products for float32 X, float8 (e4m3) X for bfloat16 X.
"""

from __future__ import annotations

import torch

from portbench import inputs, roofline
from portbench.common import Reservoir, rel, rel_columns, sync
from portbench.reference import pls as ref


class Job:
    def __init__(self, config: dict, mix: dict, seed: int, device: torch.device):
        from pls_tpu_torch.model import PLSModel
        from pls_tpu_torch.types import METHOD

        self._new_model = lambda: PLSModel(self.X, self.Y, METHOD(config["method"]), self.A,
                                           x_storage=self.x_storage)
        self.device = device
        self.A = config["A"]
        self.x_storage = mix.get("x_storage")
        self.traced = mix["traced"]
        self.kept = Reservoir(mix["checked"], seed)
        self.X, self.Y = inputs.latent(config, seed, device)
        (N, K), M = self.X.shape, self.Y.shape[1]
        itemsize = 2 if self.x_storage else 4
        self.work = (roofline.fit_bytes(N, K, M, self.A, itemsize),
                     roofline.fit_flops(N, K, M, self.A))
        self.passes = self.A
        self.pass_work = (roofline.pass_bytes(N, K, itemsize), roofline.pass_flops(N, K))

    def run(self, i: int):
        m = self._new_model()
        B = m.coefficients()
        sync(self.device)
        f = m.fit_state
        return f.R, f.Q, f.T, B

    def keep(self, answer) -> None:
        self.kept.offer(answer)

    def release(self) -> None:
        """Nothing of the program's stays but the kept answers."""

    def _stored(self, x_dtype) -> tuple[torch.Tensor, torch.Tensor]:
        """X and Y as the configuration stores them for the fit."""
        if x_dtype is None:
            return self.X, self.Y
        return self.X.to(x_dtype), self.Y.to(torch.bfloat16)

    def _reference(self) -> ref.Fit:
        X, Y = self._stored(torch.bfloat16 if self.x_storage else None)
        return ref.kernel_pls(X, Y, self.A, ref.F64)

    @staticmethod
    def _compare(answer, fit: ref.Fit) -> dict:
        R, Q, T, B = answer
        Bc = torch.cumsum(R.double().mT[:, :, None] * Q.double().mT[:, None, :], dim=0)
        Bref = fit.coefficients()
        coef = max([rel(B, Bref[-1])] + [rel(Bc[c], Bref[c]) for c in range(Bref.shape[0])])
        return {"coef_rel": coef, "scores_rel": rel_columns(T, fit.T)}

    def check(self, limits: dict) -> list[dict]:
        fit = self._reference()
        return [self._compare(answer, fit) for answer in self.kept.items]

    def control(self, limits: dict) -> dict:
        """The readings of the control: the reference one precision down in
        the program's place."""
        fit = self._reference()
        if self.x_storage:
            X, Y = self._stored(torch.float8_e4m3fn)
            low = ref.kernel_pls(X, Y, self.A, ref.F64)
        else:
            low = ref.kernel_pls(self.X, self.Y, self.A, ref.TF32)
        return self._compare((low.R, low.Q, low.T, low.coefficients()[-1]), fit)
