"""The port's parallel package (pls_tpu_torch.parallel) against the JAX package's.

Each world size, 1, 2 and 4, is one spawned run of gloo ranks on the CPU
(tests/torch_parallel_worker.py; a `file://` store, a collective timeout,
killed after 120 s) that calls every function on its ranks' shares and
writes the replicated outputs.  Each function and world size is a case
held against the same JAX function on a mesh of the same shape over
conftest's virtual CPU devices (`make_pls_mesh(..., devices=jax.devices()[:n])`):
float64 at 1e-10 (tests/test_distributed.py's bound; the sums over ranks
run in another order), bf16 storage at that file's 2e-2 and, against the
JAX fit on its Pallas kernel's arithmetic, at 1e-5, the local pass
on the kernel's twin against `use_pallas=True` in interpret mode.  Every
rank's outputs must equal rank 0's bit for bit.  The data is
tests/test_distributed.py's.  The error paths and `initialize_distributed`
run in this process, with torch.distributed's calls replaced.
"""

import functools
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import pls_tpu as pt
import pls_tpu.ops.deflate as jax_deflate
import pls_tpu.parallel as jpar
from pls_tpu_torch.parallel import cv_lso_sharded, cv_loo_sharded
from pls_tpu_torch.parallel.launch import spawn_ranks
from pls_tpu_torch.parallel.mesh import PLSMesh, initialize_distributed, make_pls_mesh, rank_device
from pls_tpu_torch.parallel.sharded import shard_cols, shard_rows

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
from torch_parallel_worker import folds_mesh_shape  # noqa: E402

WORLD_SIZES = (1, 2, 4)
SPAWN_TIMEOUT_SEC = 120
A = 4
TRAIN = 48
BF16_SAME_ARITH = 1e-5  # of the coefficients' scale: bf16 storage, the kernel's arithmetic


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    rng = np.random.default_rng(7)  # tests/test_distributed.py:29-36
    N, K, M = 64, 24, 3
    X = rng.normal(size=(N, K))
    B = rng.normal(size=(K, M))
    Y = rng.normal(size=(N, M)) * 0.1 + rng.normal(size=(N, K)) @ B * 0
    Y = X @ B + rng.normal(size=(N, M)) * 0.1
    r = np.random.default_rng(3)
    d = {
        "X": X, "Y": Y,
        "parts_lso": np.stack([r.permutation(N) for _ in range(16)]),
        "parts_row": np.stack([r.permutation(N) for _ in range(6)]),
        "parts_step": np.stack([r.permutation(N) for _ in range(8)]),
    }
    root = tmp_path_factory.mktemp("parallel")
    np.savez(root / "inputs.npz", **d)
    return root, d


@pytest.fixture(scope="module")
def runs(data):
    """n -> the ranks' outputs of the spawned run at world size n."""
    root, _ = data
    done = {}

    def get(n):
        if n not in done:
            run_dir = root / f"n{n}"
            run_dir.mkdir()
            shutil.copy(root / "inputs.npz", run_dir)
            spawn_ranks([sys.executable, str(HERE / "torch_parallel_worker.py"), str(run_dir)], n,
                        timeout_sec=SPAWN_TIMEOUT_SEC)
            done[n] = []
            for r in range(n):
                with np.load(run_dir / f"rank{r}.npz") as z:
                    done[n].append(dict(z))
        return done[n]

    return get


def _mesh(n, rows, folds):
    return jpar.make_pls_mesh(rows=rows, folds=folds, devices=jax.devices()[:n])


def _coef(f):
    return np.asarray(pt.coefficients(f))


def _jax_cases(d, n):
    """{case: [(port output key, JAX value, rtol, atol)]}, computed lazily."""
    X, Y = jnp.asarray(d["X"]), jnp.asarray(d["Y"])
    X32, Y32 = X.astype(jnp.float32), Y.astype(jnp.float32)
    rows = _mesh(n, n, 1)
    both = _mesh(n, *folds_mesh_shape(n))
    exact = (0.0, 1e-10)

    def fit_sharded():
        f = jpar.fit_sharded(X, Y, A, mesh=rows)
        return [("fit_sharded", _coef(f), *exact), ("fit_sharded_T_shape", np.array([0, A]), 0, 0)]

    def fit_sharded_bf16():
        ref = _coef(pt.fit(X32, Y32, A))
        sh = _coef(jpar.fit_sharded(X32, Y32, A, mesh=rows, x_storage="bf16"))
        # relative to the coefficients' scale, as tests/test_distributed.py:63
        scale = np.abs(ref).max()
        # The port's pass keeps t = X r in float32, as the JAX package's
        # Pallas kernel does; its XLA pass, which the GSPMD fit traces,
        # rounds r and t to bf16, 2e-3 of the scale away here.  Against the
        # kernel's arithmetic (its one-device bf16 fit, interpret mode) the
        # port sits within BF16_SAME_ARITH of the scale (2.5e-7 measured at
        # one rank), where an f32 fit is 2.0e-3 away.
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_deflate, "deflate_pass",
                       functools.partial(jax_deflate.deflate_pass, interpret=True))
            kernel = _coef(pt.fit(X32, Y32, A, x_storage="bf16", use_pallas="unroll"))
        return [("fit_sharded_bf16", ref, 0, 2e-2 * scale), ("fit_sharded_bf16", sh, 0, 2e-2 * scale),
                ("fit_sharded_bf16", kernel, 0, BF16_SAME_ARITH * scale),
                ("fit_sharded_bf16_dtype_f32", np.array(True), 0, 0)]

    def shardmap_type1():
        f = jpar.fit_rowsharded_shardmap(X, Y, A, type1=True, mesh=rows)
        return [("shardmap_True", _coef(f), *exact), ("shardmap_True_T", np.asarray(f.T), *exact)]

    def shardmap_type2():
        f = jpar.fit_rowsharded_shardmap(X, Y, A, type1=False, mesh=rows)
        return [("shardmap_False", _coef(f), *exact), ("shardmap_False_T", np.zeros((0, A)), 0, 0)]

    def shardmap_kernel():
        # tests/test_distributed.py:82-107: the local pass on the Pallas kernel
        f = jpar.fit_rowsharded_shardmap(X32, Y32, 3, mesh=rows, use_pallas=True,
                                         pallas_interpret=True)
        return [("shardmap_kernel_W", np.asarray(f.W), 1e-5, 1e-6),
                ("shardmap_kernel_T", np.asarray(f.T), 1e-5, 1e-5),
                ("shardmap_kernel", _coef(f), 1e-5, 1e-5)]

    def colsharded():
        return [(f"colsharded_{m.value}", _coef(jpar.fit_colsharded(X, Y, A, m, mesh=rows)), *exact)
                for m in (pt.KERNEL_TYPE1, pt.KERNEL_TYPE2)]

    def lso_rowsharded():
        r = jpar.cv_lso_rowsharded(X, Y, A, d["parts_row"], TRAIN, mesh=rows, trial_batch=2)
        return [("lso_rowsharded", np.asarray(r.errors), *exact)]

    def fit_sharded_uneven():  # JAX shards only even blocks: its one-device fit
        return [("fit_sharded_uneven", _coef(pt.fit(X[:63], Y[:63], A)), *exact)]

    def lso_sharded():
        r = jpar.cv_lso_sharded(X, Y, A, d["parts_lso"], TRAIN, mesh=_mesh(n, 1, n))
        return [("lso_sharded", np.asarray(r.errors), *exact)]

    def lso_sharded_2axes():
        r = jpar.cv_lso_sharded(X, Y, A, d["parts_lso"], TRAIN, mesh=both)
        return [("lso_sharded_2axes", np.asarray(r.errors), *exact)]

    def loo_sharded():
        r = jpar.cv_loo_sharded(X, Y, A, mesh=_mesh(n, 1, n))
        return [("loo_sharded", np.asarray(r.errors), *exact)]

    def train_step():
        f, press = jpar.train_step(X, Y, A, d["parts_step"], TRAIN, mesh=both)
        return [("train_step", _coef(f), *exact), ("train_step_press", np.asarray(press), *exact)]

    return {f.__name__: f for f in (
        fit_sharded, fit_sharded_bf16, shardmap_type1, shardmap_type2, shardmap_kernel,
        colsharded, lso_rowsharded, fit_sharded_uneven, lso_sharded, lso_sharded_2axes,
        loo_sharded, train_step)}


CASES = ("fit_sharded", "fit_sharded_bf16", "shardmap_type1", "shardmap_type2", "shardmap_kernel",
         "colsharded", "lso_rowsharded", "fit_sharded_uneven", "lso_sharded", "lso_sharded_2axes",
         "loo_sharded", "train_step")


@pytest.mark.parametrize("n", WORLD_SIZES)
@pytest.mark.parametrize("case", CASES)
def test_matches_jax(case, n, data, runs):
    _, d = data
    port = runs(n)[0]
    for key, ref, rtol, atol in _jax_cases(d, n)[case]():
        np.testing.assert_allclose(port[key], ref, rtol=rtol, atol=atol, err_msg=key)


@pytest.mark.parametrize("n", WORLD_SIZES[1:])
def test_outputs_replicated_on_every_rank(n, runs):
    first, *others = runs(n)
    for out in others:
        assert out.keys() == first.keys()
        for key in first:
            np.testing.assert_array_equal(out[key], first[key], err_msg=key)


# ---------- in this process: layout, error paths, bring-up ----------
def _fake_mesh(rows, folds, rank=0):
    """A mesh without process groups: enough for what raises before any
    collective, and for the block layout."""
    return PLSMesh(rows, folds, rank, torch.device("cpu"), {})


@pytest.mark.parametrize("n", (2, 4, 8))
def test_shard_blocks_are_named_sharding_blocks(n):
    from jax.sharding import NamedSharding, PartitionSpec as P

    X = np.arange(16 * 24, dtype=np.float64).reshape(16, 24)
    jmesh = _mesh(n, n, 1)
    rows = jax.device_put(X, NamedSharding(jmesh, P("rows", None)))
    cols = jax.device_put(X, NamedSharding(jmesh, P(None, "rows")))
    by_dev = {s.device: s for s in rows.addressable_shards}
    by_dev_c = {s.device: s for s in cols.addressable_shards}
    for rank, dev in enumerate(jmesh.devices.reshape(-1)):
        m = _fake_mesh(n, 1, rank)
        np.testing.assert_array_equal(shard_rows(X, m), np.asarray(by_dev[dev].data))
        np.testing.assert_array_equal(shard_cols(X, m), np.asarray(by_dev_c[dev].data))


def test_uneven_blocks_are_ceil_sized():
    X = np.arange(10)[:, None]
    assert [len(shard_rows(X, _fake_mesh(4, 1, r))) for r in range(4)] == [3, 3, 3, 1]
    assert [len(shard_rows(X, _fake_mesh(8, 1, r))) for r in range(8)] == [2] * 5 + [0] * 3
    # the rank's coordinate on 'rows' of a (2, 2) mesh: rank = row·folds + fold
    assert [shard_rows(X, _fake_mesh(2, 2, r))[0, 0] for r in range(4)] == [0, 0, 5, 5]


def _jax_error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_indivisible_trials_and_rows_raise_the_jax_errors(data):
    _, d = data
    X, Y = d["X"], d["Y"]
    jmesh = _mesh(8, 1, 8)
    parts = d["parts_lso"][:12]  # 12 trials over 8
    msg = _jax_error(lambda: jpar.cv_lso_sharded(X, Y, A, parts, TRAIN, mesh=jmesh))
    with pytest.raises(ValueError) as e:
        cv_lso_sharded(X, Y, A, parts, TRAIN, mesh=_fake_mesh(1, 8))
    assert str(e.value) == msg
    msg = _jax_error(lambda: jpar.cv_loo_sharded(X[:60], Y[:60], A, mesh=jmesh))  # 60 rows over 8
    with pytest.raises(ValueError) as e:
        cv_loo_sharded(X[:60], Y[:60], A, mesh=_fake_mesh(1, 8))
    assert str(e.value) == msg


@pytest.mark.parametrize("rows,folds", [(None, 3), (3, 2), (16, 1)])
def test_bad_mesh_shape_raises_the_jax_error(monkeypatch, rows, folds):
    msg = _jax_error(lambda: jpar.make_pls_mesh(rows=rows, folds=folds, devices=jax.devices()[:8]))
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 8)
    with pytest.raises(ValueError) as e:
        make_pls_mesh(rows=rows, folds=folds, device="cpu")
    assert str(e.value) == msg


def test_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        make_pls_mesh(device="cpu")


class TestInitializeDistributed:
    """tests/test_distributed.py:393-464, on torch.distributed."""

    def test_already_initialized_is_noop(self, monkeypatch):
        def boom(*a, **kw):  # pragma: no cover - must not be reached
            raise AssertionError("init_process_group should not be called")

        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "init_process_group", boom)
        initialize_distributed("127.0.0.1:1", 1, 0)  # no raise, no card needed

    def test_retries_then_raises(self, monkeypatch):
        calls = []

        def boom(*a, **kw):
            calls.append(1)
            raise RuntimeError("connection refused")

        monkeypatch.setattr(dist, "init_process_group", boom)
        with pytest.raises(RuntimeError, match="after 3 attempts") as e:
            initialize_distributed("127.0.0.1:1", 2, 0, retries=2, retry_delay_sec=0.0,
                                   device="cpu")
        assert len(calls) == 3
        assert "connection refused" in str(e.value.__cause__)
        assert not dist.is_initialized()

    def test_succeeds_after_transient_failure(self, monkeypatch):
        calls = []

        def flaky(backend, **kw):
            calls.append((backend, kw))
            if len(calls) < 2:
                raise RuntimeError("coordinator not up yet")

        monkeypatch.setattr(dist, "init_process_group", flaky)
        initialize_distributed("127.0.0.1:1", 2, 1, retries=3, retry_delay_sec=0.0,
                               device="cpu", timeout_sec=7)
        assert len(calls) == 2
        backend, kw = calls[-1]
        assert backend == "gloo"
        assert kw["init_method"] == "tcp://127.0.0.1:1"
        assert (kw["world_size"], kw["rank"]) == (2, 1)
        assert kw["timeout"].total_seconds() == 7

    def test_url_and_environment_pass_through(self, monkeypatch):
        calls = []
        monkeypatch.setattr(dist, "init_process_group", lambda b, **kw: calls.append(kw))
        initialize_distributed("file:///tmp/store", device="cpu")
        initialize_distributed(device="cpu")
        assert calls[0]["init_method"] == "file:///tmp/store"
        assert calls[1]["init_method"] is None
        assert "world_size" not in calls[1] and "rank" not in calls[1]

    def test_no_card_raises_unless_cpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        monkeypatch.setattr(dist, "init_process_group",
                            lambda *a, **kw: pytest.fail("reached init_process_group"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            initialize_distributed("127.0.0.1:1", 1, 0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rank_device(0)


def test_sharded_entry_points_raise_without_a_card(monkeypatch):
    """make_pls_mesh's default device is the rank's card: no fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 1)
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    monkeypatch.setattr(dist, "new_group", lambda ranks: object())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_pls_mesh()
    assert make_pls_mesh(device="cpu").device == torch.device("cpu")


def test_each_rank_takes_its_own_card(monkeypatch):
    """Without `device`, rank r's process group and current device are
    `cuda:<r mod cards>`: two ranks on one host never share a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    chosen, backends = [], []
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    monkeypatch.setattr(dist, "init_process_group", lambda b, **kw: backends.append(b))
    for rank in (0, 1, 5):
        initialize_distributed("127.0.0.1:1", 8, rank)
    monkeypatch.setenv("RANK", "3")
    initialize_distributed()
    assert chosen == [torch.device("cuda", r) for r in (0, 1, 1, 3)]
    assert backends == ["nccl"] * 4
