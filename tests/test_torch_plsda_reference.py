"""PLS-DA of the port (`PLSDAClassifier(device="cpu")`) against the
benchmark's plain PyTorch reference (`portbench/reference/plsda.py`, float64)
on seeded mass spectra (`portbench/spectra.py`, the peak model of the
`maldi-plsda-20k-6k-10` configuration at small sizes), on the CPU.

Cases: fewer bins than spectra and more (K < N, K > N), 2, 4 and 10
species, float32 and float64 X.  Compared: B at every truncation (in the
classifier's z-scored space), the scores T column by column up to sign
(an eigenvector's sign is arbitrary), the held-out decision values, and
the held-out classes wherever the reference's top two decision values lie
more than `MARGIN` apart.  The reference's TF32 control (float32 with
every product's operands rounded to TF32) fails the float32 tolerances.
The reference and the generator import nothing of the port, of the JAX
package or of JAX.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pls_tpu_torch.models import predict
from pls_tpu_torch.models.plsda import PLSDAClassifier
from portbench import spectra
from portbench.common import rel, rel_columns
from portbench.reference import pls as ref
from portbench.reference import plsda as ref_plsda

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "portbench/configs/maldi-plsda-20k-6k-10.json").read_text())
SIZES = {"k_below_n": (160, 64), "k_above_n": (64, 256)}
A = 6
HELD_OUT = 40
# (coef, scores, decision) relative tolerances.  float32: the largest of 8
# seeds at each size and class count read 2.1e-5, 1.2e-5 and 1.5e-6, about
# 2**-24 (float32's rounding) amplified by X's conditioning; the TF32
# control's smallest (8 seeds, K > N, 10 classes) read 2.4e-4, 1.9e-4 and
# 1.1e-4.  float64: the same algorithm in the same precision, apart only in
# summation order (read at most 1.4e-14).
TOL = {torch.float32: (1e-4, 1e-4, 2e-5), torch.float64: (1e-10, 1e-10, 1e-10)}
# a class is compared only where the reference's choice is clear: its top
# two decision values more than this apart (decision values are of order 1)
MARGIN = 1e-3


def _spectra(N: int, K: int, M: int, seed: int):
    cfg = {**CONFIG, "N": N, "K": K, "M": M}
    return spectra.library(cfg, HELD_OUT, seed, "cpu")


def _readings(B, T, decision, classes, want: ref_plsda.Model, X_new) -> tuple:
    """(coef, scores, decision) relative gaps and the clear classes missed."""
    ref_d = want.decision(X_new)
    top2 = torch.topk(ref_d, 2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > MARGIN
    missed = int(((torch.as_tensor(classes) != want.predict(X_new)) & clear).sum())
    coef = max(rel(B[c], want.B[c]) for c in range(A))
    return coef, rel_columns(T, want.fit.T), rel(decision, ref_d), missed


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("M", [2, 4, 10])
@pytest.mark.parametrize("size", list(SIZES))
def test_the_classifier_matches_the_plain_reference(size, M, dtype):
    N, K = SIZES[size]
    X, y, X_new, _ = _spectra(N, K, M, seed=1000 * M + N)
    X, X_new = X.to(dtype), X_new.to(dtype)
    clf = PLSDAClassifier(n_components=A, device="cpu").fit(X, y.numpy())
    B = [predict.coefficients(clf._fit, c) for c in range(1, A + 1)]
    got = _readings(B, clf._fit.T, clf.decision_function(X_new), clf.predict(X_new),
                    ref_plsda.fit(X, y, A), X_new)
    coef, scores, decision = TOL[dtype]
    assert got[0] <= coef and got[1] <= scores and got[2] <= decision, got
    assert got[3] == 0, got
    assert list(clf.classes_) == list(range(M))


def test_the_tf32_control_fails_the_float32_tolerances():
    N, K = SIZES["k_above_n"]
    X, y, X_new, _ = _spectra(N, K, 10, seed=7)
    low = ref_plsda.fit(X, y, A, ref.TF32)
    want = ref_plsda.fit(X, y, A)
    got = _readings(low.B, low.fit.T, low.decision(X_new, ref.TF32),
                    low.predict(X_new, ref.TF32), want, X_new)
    assert any(g > t for g, t in zip(got, TOL[torch.float32])), got


def test_the_reference_and_the_generator_import_nothing_of_the_port_or_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import spectra\n"
        "from portbench.reference import plsda\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    ) % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "torch" in loaded
    assert not loaded & {"pls_tpu_torch", "pls_tpu", "jax", "jaxlib"}, loaded


def test_held_out_species_are_told_apart_at_the_cut():
    # the CPU cut of the cell's configuration: the species are separable
    X, y, X_new, y_new = _spectra(96, 1536, 4, seed=3)
    clf = PLSDAClassifier(n_components=5, device="cpu").fit(X, y.numpy())
    assert np.mean(clf.predict(X_new) == y_new.numpy()) >= 0.9
