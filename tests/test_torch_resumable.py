"""The port's resumable CV sweeps (pls_tpu_torch.cv.resumable) against the JAX package's.

`run_lso` and `run_loo` (masked refits and rank-1 downdates) equal the
port's one-shot `cv_lso`/`cv_loo` and the JAX package's `ResumableCV` on
the same partitions, in float64 on the CPU; a sweep stopped between ranges
resumes from the first missing range; an orphaned `.tmp.npz` is ignored,
then cleaned; and a directory half-filled by either package is completed
by the other, to the errors of one uninterrupted run.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pls_tpu as pt
from pls_tpu.cv import resumable as jres
from pls_tpu_torch import KERNEL_TYPE1, KERNEL_TYPE2, cv_loo, cv_lso
from pls_tpu_torch.cv import resumable
from pls_tpu_torch.cv.resumable import ResumableCV
from pls_tpu_torch.utils.gcc_rng import GccRng


@pytest.fixture(scope="module")
def xy(toy):
    return tuple(torch.from_numpy(v) for v in toy)


def _np(r):
    return np.asarray(r.errors)


def test_lso_ranges_equal_one_run_and_jax(xy, tmp_path):
    X, Y = xy
    parts = GccRng().lso_partitions(10, 20)
    res = ResumableCV(str(tmp_path / "port")).run_lso(X, Y, 2, 0.3, 20, partitions=parts,
                                                       range_size=8)
    assert res.method == "LSO" and res.errors.device == X.device
    np.testing.assert_allclose(res.errors.numpy(), cv_lso(X, Y, 2, 0.3, 20, partitions=parts)
                               .errors.numpy(), atol=1e-12)
    ref = jres.ResumableCV(str(tmp_path / "jax")).run_lso(
        jnp.asarray(X.numpy()), jnp.asarray(Y.numpy()), 2, 0.3, 20, partitions=parts, range_size=8)
    np.testing.assert_allclose(res.errors.numpy(), _np(ref), atol=1e-10)
    assert ResumableCV(str(tmp_path / "port")).completed_ranges("lso") == [(0, 8), (8, 16), (16, 20)]


@pytest.mark.parametrize("downdate", [False, True])
def test_loo_ranges_equal_one_run_and_jax(xy, tmp_path, downdate):
    X, Y = xy
    method = KERNEL_TYPE2 if downdate else KERNEL_TYPE1
    res = ResumableCV(str(tmp_path / "port")).run_loo(X, Y, 2, range_size=4, method=method,
                                                      downdate=downdate, batch_size=3)
    assert res.method == "LOO" and tuple(res.errors.shape) == (2, 10, 2)
    np.testing.assert_allclose(res.errors.numpy(), cv_loo(X, Y, 2, method).errors.numpy(),
                               atol=1e-10)
    ref = jres.ResumableCV(str(tmp_path / "jax")).run_loo(
        jnp.asarray(X.numpy()), jnp.asarray(Y.numpy()), 2, range_size=4,
        method=pt.METHOD(method.value), downdate=downdate)
    np.testing.assert_allclose(res.errors.numpy(), _np(ref), atol=1e-10)


def test_stopped_sweep_resumes_from_first_missing_range(xy, tmp_path, monkeypatch):
    X, Y = xy
    parts = GccRng().lso_partitions(10, 24)
    calls = []
    real = resumable.cv_lso

    def stops_after_one(*a, **kw):
        if calls:
            raise KeyboardInterrupt  # the sweep is killed during its second range
        calls.append(kw["partitions"])
        return real(*a, **kw)

    runner = ResumableCV(str(tmp_path / "s"))
    monkeypatch.setattr(resumable, "cv_lso", stops_after_one)
    with pytest.raises(KeyboardInterrupt):
        runner.run_lso(X, Y, 2, 0.3, 24, partitions=parts, range_size=8)
    assert runner.completed_ranges("lso") == [(0, 8)]

    def counted(*a, **kw):
        calls.append(kw["partitions"])
        return real(*a, **kw)

    calls.clear()
    monkeypatch.setattr(resumable, "cv_lso", counted)
    res = runner.run_lso(X, Y, 2, 0.3, 24, partitions=parts, range_size=8)
    assert [tuple(p.shape) for p in calls] == [(8, 10), (8, 10)]  # ranges 8-16 and 16-24 only
    assert torch.equal(calls[0], torch.as_tensor(parts[8:16]))
    np.testing.assert_allclose(res.errors.numpy(), real(X, Y, 2, 0.3, 24, partitions=parts)
                               .errors.numpy(), atol=1e-12)


def test_completed_ranges_are_trusted(xy, tmp_path):
    X, Y = xy
    parts = GccRng().lso_partitions(10, 16)
    runner = ResumableCV(str(tmp_path / "s"))
    runner.run_lso(X, Y, 2, 0.3, 16, partitions=parts, range_size=8)
    sentinel = np.full((2, 8 * 3, 2), 7.0)
    np.savez(runner._range_path("lso", 0, 8), errors=sentinel)
    res = runner.run_lso(X, Y, 2, 0.3, 16, partitions=parts, range_size=8)
    np.testing.assert_array_equal(res.errors.numpy()[:, :24], sentinel)


def test_orphan_tmp_files_ignored_and_cleaned(xy, tmp_path):
    X, Y = xy
    runner = ResumableCV(str(tmp_path / "s"))
    runner.run_lso(X, Y, 2, 0.3, 8, partitions=GccRng().lso_partitions(10, 8), range_size=8)
    orphan = runner.dir / "lso_00000008_00000016.tmp.npz"
    np.savez(orphan, errors=np.zeros((2, 1, 2)))
    assert runner.completed_ranges("lso") == [(0, 8)]
    assert runner.clean_orphans() == 1
    assert not orphan.exists()
    assert runner.completed_ranges("lso") == [(0, 8)]


def _runner(package, directory):
    return (jres if package == "jax" else resumable).ResumableCV(directory)


def _sweep(package, kind, runner, X, Y, parts):
    if package == "jax":
        X, Y = jnp.asarray(X.numpy()), jnp.asarray(Y.numpy())
    if kind == "lso":
        return runner.run_lso(X, Y, 2, 0.3, 24, partitions=parts, range_size=8)
    return runner.run_loo(X, Y, 2, range_size=4)


@pytest.mark.parametrize("kind", ["lso", "loo"])
@pytest.mark.parametrize("started_by,finished_by", [("jax", "port"), ("port", "jax")])
def test_sweep_started_by_one_package_finished_by_the_other(xy, tmp_path, kind, started_by,
                                                            finished_by):
    """The range files are the same in both packages: a sweep whose last
    range is missing (its process killed) is completed by the other
    package, which reads the first ranges as they are."""
    X, Y = xy
    parts = GccRng().lso_partitions(10, 24)
    d = str(tmp_path / "s")
    full = _np(_sweep(started_by, kind, _runner(started_by, d), X, Y, parts))
    first = _runner(started_by, d)
    ranges = first.completed_ranges(kind)
    assert len(ranges) == 3
    first._range_path(kind, *ranges[-1]).unlink()
    done = _sweep(finished_by, kind, _runner(finished_by, d), X, Y, parts)
    np.testing.assert_allclose(_np(done), full, atol=1e-10)
    assert _runner(started_by, d).completed_ranges(kind) == ranges
