"""The port's spans (`pls_tpu_torch.utils.profiling.span`, `SPANS`) on the
CPU: each case runs under `torch.profiler.profile(activities=[CPU])`, and
the exported Chrome trace's `user_annotation` ranges are read back.

- each local entry into the one component loop (`fit` of kernel types 1
  and 2, `fit_folds`, `fit_from_stats`, `fit_from_stats_downdated`,
  `fit_from_stats_blockdowndated`, `cv_kfold_onepass`): one `pls.fit`, a
  `pls.fit.component` a component nested in it, and one `pls.fit.eigh` in
  each component (M = 3);
- `run_pipeline` on the bundled nir/octane CSVs (LOO and LSO, the
  default): each stage once inside `pls.pipeline`, the partitions once, a
  fold batch for each CV;
- `cv_kfold_downdate` at k = 10: the statistics once and two fold batches
  (8 folds and 2);
- `PLSDAClassifier.fit` then `decision_function`: one `pls.plsda.fit`
  holding one `pls.estimator.scale` and one `pls.fit` with a
  `pls.fit.component` a component, then one `pls.plsda.decision`; the
  traced classifier equals an untraced one bit for bit;
- every name emitted, and every name the package's source gives `span`,
  is in `SPANS`;
- with no profiler collecting, a fit calls no `record_function`, and its
  state is bit-identical to a traced fit's;
- the CLI's `--trace DIR` writes DIR/trace.json with the spans and prints
  the same report.
"""

import contextlib
import io
import json
import re
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pls_tpu_torch import cli
from pls_tpu_torch.config import PLSRunConfig, run_pipeline
from pls_tpu_torch.cv.kfold import cv_kfold_downdate, cv_kfold_onepass
from pls_tpu_torch.models.kernel_pls import (
    fit,
    fit_folds,
    fit_from_stats,
    fit_from_stats_blockdowndated,
    fit_from_stats_downdated,
)
from pls_tpu_torch.models.plsda import PLSDAClassifier
from pls_tpu_torch.models.streaming import FoldStatsAccumulator
from pls_tpu_torch.types import METHOD
from pls_tpu_torch.utils import profiling

PKG = Path(profiling.__file__).resolve().parents[1]
DATA = PKG / "data"
CPU = torch.device("cpu")


def _traced(fn, tmp_path: Path):
    """(fn(), the trace's spans as (name, start µs, end µs)) of one run of
    fn under the CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return out, spans


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(child, parent) -> bool:
    # the trace prints µs with three decimals: allow their rounding
    return parent[1] - 1e-2 <= child[1] and child[2] <= parent[2] + 1e-2


def _data(n=64, k=12, m=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, k, generator=g), torch.randn(n, m, generator=g)


def _masks(n, k=3):
    """(k, n) masks, fold f leaving out the rows i with i % k == f."""
    return (torch.arange(k)[:, None] != torch.arange(n) % k).double()


def _fold_stats(X, Y, k=4):
    acc = FoldStatsAccumulator(X.shape[1], Y.shape[1], k, X.dtype, device="cpu")
    return acc.update(X, Y, (torch.arange(X.shape[0]) % k).numpy())


# each entry into kernel_pls._components, as a function of (X, Y, A)
LOOP_ENTRIES = {
    "fit-type1": lambda X, Y, A: fit(X, Y, A),
    "fit-type2": lambda X, Y, A: fit(X, Y, A, METHOD.KERNEL_TYPE2),
    "fit_folds": lambda X, Y, A: fit_folds(X, Y, _masks(X.shape[0]), A),
    "fit_from_stats": lambda X, Y, A: fit_from_stats(X.T @ X, X.T @ Y, A),
    "fit_from_stats_downdated":
        lambda X, Y, A: fit_from_stats_downdated(X.T @ X, X.T @ Y, X[0], Y[0], A),
    "fit_from_stats_blockdowndated":
        lambda X, Y, A: fit_from_stats_blockdowndated(X.T @ X, X.T @ Y, X[:8], Y[:8], A),
    "cv_kfold_onepass": lambda X, Y, A: cv_kfold_onepass(_fold_stats(X, Y), A),
}


@pytest.mark.parametrize("entry", sorted(LOOP_ENTRIES))
def test_a_fit_gives_one_span_a_component_and_an_eigh_in_each(entry, tmp_path):
    X, Y = _data()
    _, spans = _traced(lambda: LOOP_ENTRIES[entry](X, Y, 5), tmp_path)
    (whole,) = _named(spans, "pls.fit")
    comps = _named(spans, "pls.fit.component")
    eighs = _named(spans, "pls.fit.eigh")
    assert len(comps) == 5 and len(eighs) == 5
    assert all(_inside(c, whole) for c in comps)
    assert all(sum(_inside(e, c) for c in comps) == 1 for e in eighs)
    assert all(any(_inside(e, c) for e in eighs) for c in comps)
    assert {s[0] for s in spans} <= set(profiling.SPANS)


def test_the_pipeline_gives_each_stage_once_inside_its_span(tmp_path):
    cfg = PLSRunConfig(str(DATA / "nir.csv"), str(DATA / "octane.csv"), 10, lso_trials=60)
    _, spans = _traced(lambda: run_pipeline(cfg, file=io.StringIO(), device=CPU), tmp_path)
    (whole,) = _named(spans, "pls.pipeline")
    stages = {s[0]: s for s in spans if s[0].startswith("pls.pipeline.")}
    for stage in ("read", "zscore", "fit", "report", "loo", "lso"):
        (one,) = _named(spans, f"pls.pipeline.{stage}")
        assert _inside(one, whole)
    assert "pls.pipeline.kfold" not in stages
    selects = _named(spans, "pls.pipeline.select")
    assert len(selects) == 2 and all(_inside(s, whole) for s in selects)
    (parts,) = _named(spans, "pls.lso.partitions")
    assert _inside(parts, stages["pls.pipeline.lso"])
    batches = _named(spans, "pls.cv.fold_batch")
    assert [sum(_inside(b, stages[f"pls.pipeline.{cv}"]) for b in batches)
            for cv in ("loo", "lso")] == [1, 1]
    assert len(batches) == 2
    assert {s[0] for s in spans} <= set(profiling.SPANS)


def test_kfold_from_the_statistics_gives_one_stats_span_and_two_batches(tmp_path):
    X, Y = _data(n=100, k=12, m=3, seed=1)
    res, spans = _traced(lambda: cv_kfold_downdate(X, Y, 4, k=10), tmp_path)
    assert res.errors.shape == (3, 100, 4)
    assert len(_named(spans, "pls.cv.global_stats")) == 1
    assert len(_named(spans, "pls.cv.assign")) == 1
    batches = _named(spans, "pls.cv.fold_batch")
    assert len(batches) == 2  # folds 0-7, then 8-9
    fits = _named(spans, "pls.fit")
    assert [sum(_inside(f, b) for f in fits) for b in batches] == [1, 1]
    assert {s[0] for s in spans} <= set(profiling.SPANS)


def test_a_plsda_fit_and_its_decision_give_their_spans(tmp_path):
    X, _ = _data(n=60, k=12, seed=3)
    labels = (torch.arange(60) % 3).numpy()

    def run():
        clf = PLSDAClassifier(n_components=4, device="cpu").fit(X, labels)
        return clf, clf.decision_function(X[:7])

    plain, plain_d = run()
    (traced, traced_d), spans = _traced(run, tmp_path)
    (whole,) = _named(spans, "pls.plsda.fit")
    (scale,) = _named(spans, "pls.estimator.scale")
    (fitted,) = _named(spans, "pls.fit")
    comps = _named(spans, "pls.fit.component")
    (decision,) = _named(spans, "pls.plsda.decision")
    assert _inside(scale, whole) and _inside(fitted, whole) and scale[2] <= fitted[1]
    assert len(comps) == 4 and all(_inside(c, fitted) for c in comps)
    assert decision[1] >= whole[2]
    assert {"pls.plsda.fit", "pls.plsda.decision", "pls.estimator.scale"} <= set(profiling.SPANS)
    assert {s[0] for s in spans} <= set(profiling.SPANS)
    assert (traced_d == plain_d).all()
    for name in ("W", "P", "Q", "R", "T"):
        assert torch.equal(getattr(plain._fit, name), getattr(traced._fit, name)), name


def test_spans_lists_exactly_the_names_the_package_gives_span():
    used = set()
    for path in PKG.rglob("*.py"):
        used |= set(re.findall(r'\bspan\("([^"]+)"\)', path.read_text()))
    assert used == set(profiling.SPANS)
    assert len(set(profiling.SPANS)) == len(profiling.SPANS)
    assert all(n.startswith("pls.") for n in profiling.SPANS)


def test_without_a_profiler_a_fit_calls_no_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler collecting")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert profiling.span("pls.fit") is profiling.span("pls.fit.eigh")
    X, Y = _data()
    f = fit(X, Y, 5)
    assert f.W.shape == (12, 5)


def test_a_traced_fit_equals_an_untraced_one_bit_for_bit(tmp_path):
    X, Y = _data(seed=2)
    plain = fit(X, Y, 5)
    traced, spans = _traced(lambda: fit(X, Y, 5), tmp_path)
    assert spans
    for name in ("W", "P", "Q", "R", "T"):
        assert torch.equal(getattr(plain, name), getattr(traced, name)), name


def test_the_cli_trace_flag_writes_the_spans_and_the_same_report(tmp_path):
    args = [str(DATA / "toyX.csv"), str(DATA / "toyY.csv"), "2", "--device", "cpu"]
    outs = []
    for extra in ([], ["--trace", str(tmp_path / "tr")]):
        err, out = io.StringIO(), io.StringIO()
        with contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
            assert cli.main(args + extra) == 0
        outs.append((out.getvalue(), err.getvalue()))
    assert outs[0] == outs[1] and outs[0][0] == "" and "Validation" in outs[0][1]
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events if e.get("cat") == "user_annotation"}
    assert "pls.pipeline" in names and names <= set(profiling.SPANS)
