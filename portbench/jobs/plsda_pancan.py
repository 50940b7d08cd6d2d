"""Job `plsda_pancan`: the `plsda` job (`jobs/plsda.py`) on tumours' gene
expression: `PLSDAClassifier(n_components=A, device=card).fit(X, types)`
on the training library, with the tumour types a host numpy array, then
`decision_function(X_new)` on the held-out batch.  The inputs come from
`portbench/expression.py` in place of `spectra.py`; the work, the
comparisons (`coef_rel`, `scores_rel`, `decision_rel`, `class_missed`,
`eigengap_min`) and the control are the `plsda` job's own code.
"""

from __future__ import annotations

from portbench import expression, harness

_plsda = harness.load_module(harness.BENCH / "jobs" / "plsda.py")
_plsda.spectra = expression  # this copy of the module draws its inputs from expression.py

Job = _plsda.Job
