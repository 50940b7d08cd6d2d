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
- `OPLSDAClassifier.fit` then `decision_function` (n_ortho 3, the OPLS-DA
  cell's CPU cut): one `pls.oplsda.fit` holding `pls.estimator.scale`,
  `pls.opls.filter` with a `pls.opls.filter.component` an orthogonal
  component, each with its `pls.fit.eigh`, the predictive `pls.fit`, and
  `pls.oplsda.splot` with its `pls.opls.correct`; then one
  `pls.oplsda.decision` with its own `pls.opls.correct`;
  `models.opls.x_elements` counts what its docstring says, and as much
  as the X-sized tensors of the operations dispatched inside the filter
  and `correct` (on the CPU; on the card too, as a `gpu` case);
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
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

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
from pls_tpu_torch.models import opls
from pls_tpu_torch.models.oplsda import OPLSDAClassifier
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


N_ORTHO = 3  # the OPLS-DA cell's CPU cut (portbench/tests/cuts/)


def _oplsda_run(X, labels, Xn):
    clf = OPLSDAClassifier(n_components=2, n_ortho=N_ORTHO, device="cpu").fit(X, labels)
    return clf, clf.decision_function(Xn)


def test_an_oplsda_fit_and_its_decision_give_their_spans(tmp_path):
    X, _ = _data(n=60, k=12, seed=4)
    labels = (torch.arange(60) % 3).numpy()
    plain, plain_d = _oplsda_run(X, labels, X[:7])
    (traced, traced_d), spans = _traced(lambda: _oplsda_run(X, labels, X[:7]), tmp_path)
    (whole,) = _named(spans, "pls.oplsda.fit")
    (scale,) = _named(spans, "pls.estimator.scale")
    (filt,) = _named(spans, "pls.opls.filter")
    (fitted,) = _named(spans, "pls.fit")
    (splot,) = _named(spans, "pls.oplsda.splot")
    (decision,) = _named(spans, "pls.oplsda.decision")
    for s in (scale, filt, fitted, splot):
        assert _inside(s, whole), s
    assert scale[2] <= filt[1] and filt[2] <= fitted[1] and fitted[2] <= splot[1]
    comps = _named(spans, "pls.opls.filter.component")
    eighs = _named(spans, "pls.fit.eigh")
    assert len(comps) == N_ORTHO and all(_inside(c, filt) for c in comps)
    assert [sum(_inside(e, c) for e in eighs) for c in comps] == [1] * N_ORTHO
    assert len(_named(spans, "pls.fit.component")) == 2
    assert len(eighs) == N_ORTHO + 2  # the filter's, then the predictive fit's
    corrects = _named(spans, "pls.opls.correct")
    assert len(corrects) == 2
    assert [_inside(c, splot) for c in corrects] == [True, False]
    assert _inside(corrects[1], decision) and decision[1] >= whole[2]
    assert {s[0] for s in spans} <= set(profiling.SPANS)
    assert (traced_d == plain_d).all()
    for name in ("W_o", "P_o", "T_o"):
        assert torch.equal(getattr(plain._fit, name), getattr(traced._fit, name)), name


class _XTraffic(TorchDispatchMode):
    """The elements of X-sized tensors ((rows, K) for any of `rows`, or
    the transpose) that the operations PyTorch dispatches read and write,
    by the step of the filter (`op`) they run in: an operation reads each
    of its distinct X-sized inputs once and writes each X-sized output
    once; a view moves nothing.  A kernel launched past the dispatcher
    (through ctypes, as the port's CUDA kernels are) is not seen."""

    def __init__(self, rows, K):
        super().__init__()
        self.shapes = {(n, K) for n in rows} | {(K, n) for n in rows}
        self.op, self.elements = None, {"filter": 0, "correct": 0}

    def _sized(self, t) -> bool:
        return isinstance(t, torch.Tensor) and tuple(t.shape) in self.shapes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.op and not func.is_view:
            ins = {id(a): a for a in tree_flatten((args, kwargs))[0] if self._sized(a)}
            outs = [o for o in tree_flatten(out)[0] if self._sized(o)]
            self.elements[self.op] += sum(t.numel() for t in [*ins.values(), *outs])
        return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_x_elements_counts_the_x_sized_reads_and_writes_of_the_filter(device, dtype, monkeypatch):
    """The counter grows by what its docstring says, and by as much as the
    X-sized traffic of the operations dispatched inside `pls.opls.filter`
    and `pls.opls.correct`: no X-sized temporary there goes uncounted and
    no count lacks its operation."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the filter as the card runs it")
    n, k, n_new = (60, 12, 7) if device == "cpu" else (1200, 2049, 300)
    X, _ = _data(n=n, k=k, seed=5)
    X = X.to(device=device, dtype=dtype)
    labels = (torch.arange(n) % 3).numpy()
    mode = _XTraffic((n, n_new), k)
    span, steps = opls.span, {"pls.opls.filter": "filter", "pls.opls.correct": "correct"}

    @contextlib.contextmanager
    def counted(name):
        with span(name):
            outer, mode.op = mode.op, steps.get(name, mode.op)
            try:
                yield
            finally:
                mode.op = outer

    monkeypatch.setattr(opls, "span", counted)
    before = dict(opls.x_elements)

    def grown():
        return {op: opls.x_elements[op] - before[op] for op in before}

    with mode:
        clf = OPLSDAClassifier(n_components=2, n_ortho=N_ORTHO, device=device).fit(X, labels)
        # the filter: ‖X‖² three, then a component's five products, the
        # outer product's write and the subtraction's three; the S-plot's
        # correct of the training X: a component's product and its four
        filt = (9 * N_ORTHO + 3) * n * k
        assert grown() == mode.elements == {"filter": filt, "correct": 5 * N_ORTHO * n * k}
        clf.decision_function(X[:n_new])
    assert grown() == mode.elements == {"filter": filt, "correct": 5 * N_ORTHO * (n + n_new) * k}


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
