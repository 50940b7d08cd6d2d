"""The pan-cancer cell's own pieces on the CPU: the expression generator
(`portbench/expression.py`) at the configuration's cut, the job's inputs,
and the readers of the traced run in this cell."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench import expression, harness, roofline
from portbench.tests import tiny

CONFIG = json.loads((harness.ROOT / "portbench/configs/tcga-pancan-plsda-10k-20k-33.json")
                    .read_text())
SMALL = {**CONFIG, "N": 200, "K": 1537}
CELL = "pancan.plsda-f32"


def test_types_take_geometric_shares_by_rank():
    counts = expression.type_counts(10_267, 33, 0.9)
    assert sum(counts) == 10_267 and counts == sorted(counts, reverse=True)
    # TCGA-BRCA's roughly 1 100 tumours down to TCGA-CHOL's few dozen
    assert counts[0] / 10_267 == pytest.approx(0.103, abs=1e-3)
    assert counts[-1] / 10_267 == pytest.approx(0.0036, abs=1e-4)
    assert expression.type_counts(34, 33, 0.9) == [2] + [1] * 32
    with pytest.raises(ValueError):
        expression.type_counts(32, 33, 0.9)


def test_the_library_is_the_seed_s():
    X, y, Xn, yn = expression.library(SMALL, 48, 11, "cpu")
    X2, y2, Xn2, yn2 = expression.library(SMALL, 48, 11, "cpu")
    assert torch.equal(X, X2) and torch.equal(y, y2) and torch.equal(Xn, Xn2)
    assert torch.equal(yn, yn2)
    other = expression.library(SMALL, 48, 12, "cpu")
    assert not torch.equal(X, other[0]) and not torch.equal(Xn, other[2])
    assert X.shape == (200, 1537) and Xn.shape == (48, 1537) and X.dtype == torch.float32
    # a seed past 32 signed bits
    assert expression.library(SMALL, 48, 2**31 + 12_345, "cpu")[0].shape == (200, 1537)


def test_class_counts_follow_the_stated_shares():
    _, y, _, yn = expression.library(SMALL, 48, 13, "cpu")
    ratio = CONFIG["assumed"]["type_share_ratio"]
    assert torch.bincount(y, minlength=33).tolist() == expression.type_counts(200, 33, ratio)
    assert torch.bincount(yn, minlength=33).tolist() == expression.type_counts(48, 33, ratio)
    assert int(torch.bincount(y, minlength=33).min()) >= 1


def test_the_unexpressed_genes_are_constant_zero():
    X, _, Xn, _ = expression.library(SMALL, 48, 14, "cpu")
    const = (X == 0).all(0)
    assert int(const.sum()) == round(CONFIG["assumed"]["unexpressed_share"] * 1537)
    assert bool((Xn[:, const] == 0).all())  # the same genes in the held-out draw
    # every other gene varies, on the log scale's floor or above it
    assert bool((X[:, ~const].std(0) > 0).all()) and float(X.min()) >= 0.0


def test_the_held_out_draw_shares_no_row_with_the_library():
    X, _, Xn, _ = expression.library(SMALL, 48, 15, "cpu")
    assert float(torch.cdist(Xn, X).min()) > 1.0


def test_the_type_effects_decay_with_rank():
    gm = expression.genes(SMALL, torch.Generator().manual_seed(16), "cpu")
    a = CONFIG["assumed"]
    assert ((gm.effects != 0).sum(1) == a["markers"]).all()
    size = gm.effects.abs().sum(1)
    # effect_decay to the rank, on a mean-one factor of each marker
    want = a["marker_effect"] * a["markers"] * a["effect_decay"] ** torch.arange(33.0)
    assert torch.allclose(size, want, rtol=0.25)
    assert gm.loadings.shape == (a["modules"], 1537)


def test_the_generator_imports_nothing_of_the_program_or_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench import expression\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n") % str(harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "torch" in loaded
    assert not loaded & {"pls_tpu_torch", "pls_tpu", "jax", "jaxlib"}, loaded


def test_the_job_counts_each_job_s_passes_by_path(tmp_path):
    # the job is the plsda job's on expression.py's inputs: A passes a job
    # (`passes`), each of one pass's bytes at the cell's shape; on the CPU
    # the traced slice holds no kernel, so deflate_roofline reads nothing
    r, m, (correct, _, _) = tiny.run(CELL, tmp_path, trace=True, seconds=0.05)
    assert correct
    N, K, A = (r.cell.config[k] for k in ("N", "K", "A"))
    assert r.job.passes == A and r.job.pass_work == (roofline.pass_bytes(N, K, 4),
                                                      roofline.pass_flops(N, K))
    assert "deflate_roofline" not in m


def test_the_job_needs_no_counter_of_the_program(tmp_path, monkeypatch):
    # a program without ops.deflate.path_calls (the parent of the counter)
    # runs the cell all the same: the job reads no counter of the program
    import types

    import pls_tpu_torch.ops

    monkeypatch.setattr(pls_tpu_torch.ops, "deflate", types.SimpleNamespace())
    r, m, (correct, _, _) = tiny.run(CELL, tmp_path, trace=True, seconds=0.05)
    assert correct and not hasattr(r.job, "deflate_calls")
    assert "deflate_roofline" not in m


def _trace(device, host, jobs=1):
    return harness.Trace(device, host, jobs, 0.0, 1.0)


def test_deflate_roofline_reads_the_cluster_kernels_of_the_cell():
    # every pass of the cell takes the cluster path: deflate_cluster and the
    # fixed-order sums of its partial p and of tt are deflate_roofline's
    # PATTERN, A passes a traced job
    reader = harness.load_module(harness.BENCH / "metrics" / "deflate_roofline.py")

    class Job:
        passes = 2
        pass_work = (3.35e9, 0.0)  # 1 ms at the bandwidth's peak

    run = harness.Run(tiny.cell(CELL), 1, 1.0, torch.device("cpu"))
    run.job, run.latencies = Job(), [0.1]
    run.trace = _trace([("void deflate_cluster<float, 1>(...)", 0.0, 0.003, "kernel"),
                        ("reduce_partials", 0.003, 0.004, "kernel"),
                        ("tree_sum", 0.004, 0.005, "kernel"),
                        ("Memcpy DtoH", 0.5, 0.6, "gpu_memcpy")], [], jobs=2)
    assert reader.read(run) == pytest.approx(100 * 4 * 1e-3 / 5e-3)


def test_eigh_idle_ms_is_the_idle_inside_the_eigh_spans_over_their_count():
    reader = harness.load_module(harness.BENCH / "metrics" / "eigh_idle_ms.py")
    run = harness.Run(tiny.cell(CELL), 1, 1.0, torch.device("cpu"))
    run.trace = _trace([("k", 0.0, 0.1, "kernel"), ("k", 0.15, 0.3, "kernel")],
                       [("pls.fit.eigh", 0.05, 0.2), ("pls.fit.eigh", 0.25, 0.4),
                        ("pls.fit.component", 0.0, 0.5)])
    assert reader.read(run) == pytest.approx(1e3 * (0.05 + 0.1) / 2)
    run.trace = _trace([("k", 0.0, 0.1, "kernel")], [("pls.fit.component", 0.0, 0.5)])
    assert reader.read(run) is None
