"""Job `calibrate`: the reference CLI's whole job, `pls X.csv Y.csv A`,
as `config.run_pipeline` runs it, with its report printed to a text sink:
read the two CSVs, z-score, fit, print the state and the explained
variance, leave-one-out, leave-some-out (the reference's libstdc++
partitions under a seed of each job's own, drawn from the run's seed),
RMSE and the Wilcoxon choice of component count.

Checked, for a seeded sample of the window's calibrations: the printed
state (P, W, R, Q, T and the coefficients, as printed), the explained
variance, the LOO and LSO RMSE tables and the chosen counts, against the
plain reference in float64 on the same files and partitions.  A chosen
count is wrong only where the reference's own choice is not borderline
(`reference.pls.admissible_counts` with the limits' margins).  Control: the
reference in float32 with TF32 products in the program's place.
"""

from __future__ import annotations

import io

import numpy as np
import torch

from portbench import gcc_rng, inputs
from portbench.common import Reservoir, missed, rel, sync
from portbench.reference import pls as ref

STATE = ("P", "W", "R", "Q", "T", "coefficients")


def parse_state(text: str) -> dict[str, np.ndarray]:
    """The matrices the CLI printed under the labels of STATE."""
    out: dict[str, np.ndarray] = {}
    label, rows = None, []
    for line in text.splitlines() + [""]:
        try:
            row = [float(v) for v in line.split()]
        except ValueError:
            row = None
        if label is not None and row:
            rows.append(row)
            continue
        if label is not None:
            out[label] = np.array(rows)
            label = None
        if line.strip().removesuffix(":") in STATE and line.strip().endswith(":"):
            label, rows = line.strip()[:-1], []
    return out


def _host(v) -> torch.Tensor:
    return torch.as_tensor(v).double().cpu()


class Job:
    def __init__(self, config: dict, mix: dict, seed: int, device: torch.device):
        from pls_tpu_torch.config import PLSRunConfig, run_pipeline

        self.device = device
        self.A = config["A"]
        self.alpha = mix["alpha"]
        self.traced = mix["traced"]
        self.kept = Reservoir(mix["checked"], seed)
        x_file, y_file = (str(inputs.ROOT / config["data"][k]) for k in ("X", "Y"))
        self.X_raw = torch.from_numpy(inputs.csv_matrix(config["data"]["X"])).to(device)
        self.Y_raw = torch.from_numpy(inputs.csv_matrix(config["data"]["Y"])).to(device)
        N = self.X_raw.shape[0]
        self.trials = mix["lso_trials_per_row"] * N
        self.test = int(mix["lso_fraction"] * N + 0.5)  # the reference's rounding
        self.seeds = np.random.default_rng(seed).integers(0, 2**32, size=4096)
        self._new_config = lambda s: PLSRunConfig(
            x_file, y_file, self.A, dtype=config["dtype"], lso_fraction=mix["lso_fraction"],
            lso_trials=self.trials, alpha=self.alpha, seed=s)
        self._run = run_pipeline
        self.work = None

    def run(self, i: int):
        s = int(self.seeds[i % len(self.seeds)])
        sink = io.StringIO()
        report = self._run(self._new_config(s), file=sink, device=self.device)
        sync(self.device)
        return s, sink.getvalue(), report

    def keep(self, answer) -> None:
        self.kept.offer(answer)

    def release(self) -> None:
        """The pipeline keeps nothing between calibrations."""

    def _reference(self, seed: int, ar: ref.Arith) -> dict:
        N = self.X_raw.shape[0]
        parts = torch.from_numpy(gcc_rng.lso_partitions(seed, N, self.trials))
        return ref.calibration(self.X_raw, self.Y_raw, self.A, parts, N - self.test, ar)

    def _compare(self, got: dict, want: dict, margins: dict) -> dict:
        state = max(rel(_host(got["state"][k]), _host(want["state"][k])) for k in STATE)
        ev = float((_host(got["ev"]) - _host(want["ev"])).abs().max())
        rmse = 0.0
        chosen_missed = 0
        for cv in ("loo", "lso"):
            r = _host(ref.rmse(want[cv]))
            rmse = max(rmse, float(((_host(got[cv + "_rmse"]) - r).abs() / r).max()))
            allowed = ref.admissible_counts(want[cv], self.alpha, margins["p"], margins["press"])
            chosen_missed += missed(got[cv + "_choice"], allowed)
        return {"state_rel": state, "ev_abs": ev, "rmse_rel": rmse, "choice_missed": chosen_missed}

    def check(self, limits: dict) -> list[dict]:
        out = []
        for s, text, report in self.kept.items:
            got = {
                "state": parse_state(text),
                "ev": [report["explained_variance"][str(c)] for c in range(1, self.A + 1)],
                **{cv + "_rmse": report[cv + "_rmse"] for cv in ("loo", "lso")},
                **{cv + "_choice": report[cv + "_optimal_components"] for cv in ("loo", "lso")},
            }
            out.append(self._compare(got, self._reference(s, ref.F64), limits["margins"]))
        return out

    def control(self, limits: dict) -> dict:
        """The readings of the reference in float32 with TF32 products in the
        program's place, on the first calibration's partitions."""
        s = int(self.seeds[0])
        low = self._reference(s, ref.TF32)
        got = {"state": low["state"], "ev": low["ev"]}
        for cv in ("loo", "lso"):
            got[cv + "_rmse"] = ref.rmse(low[cv])
            got[cv + "_choice"] = [min(a) for a in ref.admissible_counts(low[cv], self.alpha)]
        return self._compare(got, self._reference(s, ref.F64), limits["margins"])
