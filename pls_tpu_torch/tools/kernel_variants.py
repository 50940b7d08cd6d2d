"""Sweep of the fused deflation pass's kernel variants on one CUDA card.

    python -m pls_tpu_torch.tools.kernel_variants [--n 65536] [--k 2048] [--iters 40]
    KV_BF16=1 python -m pls_tpu_torch.tools.kernel_variants [...]

The port of tools/kernel_variants.py, the sweep that chose the JAX
package's shipped kernel, with its CLI.  X (N, K) and r (K,) are drawn
from a generator on the card seeded with `sweep`'s seed (0 from the
command line; float32; with KV_BF16 set, X is then rounded to
bfloat16), and f64 truth t, p, tt is computed on the card from the float32
X, as the JAX tool does.  One line per row:

- `copy`: the card's device-to-device copy of X, the bandwidth ceiling
  (its GB/s counts the read and the write);
- `shipped_f32` / `shipped_bf16`: the shipped kernel (K1 / K2,
  `ops.deflate.deflate_pass_cuda`; on bf16 the column-owning design where
  it takes the shape), and with KV_BF16 `shipped_bf16_staged`, K2's
  earlier row-staged design (`ops.deflate.staged_plan_for`) on the same X;
- `plain_f32` / `plain_bf16`: the two-product form (`deflate_pass_plain`);
- the variants (`default_variants`): K3 `vpu_1k_*` and K4
  `mxu_{prec}_r8_s{slots}` (its ring of 8-row slots) on float32 X, or
  K5 with KV_BF16: the row-staged `vpu_bf16_*` and the column-owning
  `cols_bf16_w{warps}[x{blocks}]_s{stages}`;
- at a K where the shipped kernel takes the cluster path (past one staged
  row), the rows after the plain form are instead the two-pass form it
  replaces (`two_pass_{dtype}`, `ops.deflate.staged_plan_for`) and every
  plan of the cluster kernel the card can hold
  (`cluster_c{C}_r{R}_s{slots}_g{G}`: each plan of
  `ops.deflate.cluster_plans` with 2 slots and up, at 2, 3 and the most
  slots that fit): the data behind `cluster_plan`'s choice.  The variants
  take narrower K.

Each row gives ms per component and one-pass GB/s (N·K·itemsize over the
time), err_p = max|p − p₆₄| / max|p₆₄| and err_tt = |tt − tt₆₄| / tt₆₄, the
route (`cuda` for a kernel written here, `torch` for the plain form) and,
for a variant, its plan: R rows per tile, G blocks, blocks per SM.  Time is
the slope of a dependency chain, r ← p·rsqrt(p·p) feeding the next pass:
(chain of 5 + iters − chain of 5) / iters, each chain the best of 3, timed
with CUDA events.  The kernels' build+load seconds are printed first (the
JAX tool's compile=).

Without a CUDA device the tool exits 1 (the JAX tool returns 0 there), so
that a run on the wrong machine is not taken for a sweep.  A variant that
fails prints FAILED and the tool then exits 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

import torch

from pls_tpu_torch.ops import deflate, deflate_variants as dv

# the default sweep; chip_smoke.py holds every one of these against its
# plain version
F32_ROWS = (1, 2, 4, 8)
STAGES = (1, 2)
SMEM_KB = (None, 110)  # the block's reservation: 1 block per SM, or 2
MXU_STAGES = (2, 3)  # K4's ring slots of 8 rows: 2 or 3 fit at K = 2048
BF16_ROWS = (2, 4, 8)
COLS_STAGES = (2, 3, 4)  # ring slots of each cols_bf16 configuration
WARMUP_CHAIN, REPS = 5, 3


def default_variants(bf16: bool) -> list[dv.Variant | dv.ColsVariant]:
    """The sweep's variants: K5 with `bf16`, else K3 and K4."""
    if bf16:
        return ([dv.make_vpu_bf16(tn, kb) for tn in BF16_ROWS for kb in SMEM_KB]
                + [dv.make_cols_bf16(w, st, b) for w, b in dv.COLS_CONFIGS for st in COLS_STAGES])
    out = [dv.make_vpu_1k(tn, False, kb, st) for tn in F32_ROWS for st in STAGES
           for kb in SMEM_KB]
    out.append(dv.make_vpu_1k(4, True))
    out += [dv.make_mxu(dv.MXU_ROWS, prec, stages=st) for prec in dv.PRECISIONS
            for st in MXU_STAGES]
    return out


def _shipped_staged(X: torch.Tensor, r: torch.Tensor):
    """The row-staged design's plan, launched on the same X: K2's earlier
    design, or the two-pass form where the shipped kernel plans "cluster"."""
    return deflate._launch(X, r, deflate.staged_plan_for)


def cluster_steps(X: torch.Tensor, r: torch.Tensor) -> list[tuple]:
    """(name, step) of every cluster plan the card can hold for X: each
    plan of `cluster_plans` with at least 2 ring slots, at 2, 3 and its
    most slots."""
    N, K = X.shape
    code = deflate._CODES[X.dtype][0]
    steps = []
    for plan in deflate.cluster_plans(X.dtype, N, K, X.data_ptr() % 16 == 0,
                                      lambda vec: deflate._limits(X.device.index, code, vec), 2):
        for stages in sorted({2, 3, plan.stages} & set(range(2, plan.stages + 1))):
            alt = dataclasses.replace(plan, stages=stages)
            steps.append((f"cluster_c{alt.C}_r{alt.R}_s{stages}_g{alt.G}",
                          lambda X, r, alt=alt: deflate._launch(X, r, lambda *_: alt)))
    return steps


def _event_ms(fn) -> float:
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1)


def chain_ms(step, X: torch.Tensor, r0: torch.Tensor, iters: int) -> float:
    """ms per pass of `step`, the slope of a dependency-chained run."""

    def run(n: int):
        r = r0
        for _ in range(n):
            _, tt, p = step(X, r)
            r = p * torch.rsqrt(p @ p)
        return tt

    run(WARMUP_CHAIN)
    best = {n: min(_event_ms(lambda: run(n)) for _ in range(REPS))
            for n in (WARMUP_CHAIN, WARMUP_CHAIN + iters)}
    return max((best[WARMUP_CHAIN + iters] - best[WARMUP_CHAIN]) / iters, 1e-9)


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
        return proc.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name()}, power limit not read"


def sweep(n: int, k: int, iters: int, bf16: bool, seed: int = 0) -> list[dict]:
    """Time and check every row on the current CUDA device; print one line
    per row and return them as dicts (a failed row has an "error")."""
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(dev).manual_seed(seed)
    X = torch.randn((n, k), generator=g, device=dev)
    r0 = torch.randn(k, generator=g, device=dev)
    Xd, rd = X.double(), r0.double()
    td = Xd @ rd
    pd = Xd.T @ td
    ttd = float(td @ td)
    del Xd, td
    if bf16:
        X = X.to(torch.bfloat16)
    nbytes = n * k * X.element_size()
    dname = "bf16" if bf16 else "f32"
    print(f"# {n}x{k} {dname}, iters {iters}, seed {seed}: {card()}", flush=True)

    dst = torch.empty_like(X)
    dst.copy_(X)
    copy_ms = sorted(_event_ms(lambda: dst.copy_(X)) for _ in range(10))[5]
    del dst
    rows = [{"name": "copy", "ms": copy_ms, "gbs": 2 * nbytes / copy_ms / 1e6, "route": "torch"}]
    print(f"{'copy':24s} {copy_ms:8.4f} ms      {rows[0]['gbs']:8.1f} GB/s (read+write)  torch",
          flush=True)
    steps = [(f"shipped_{dname}", deflate.deflate_pass_cuda, "cuda", None)]
    cluster = deflate.plan_for(X, r0).path == "cluster"
    if bf16 and not cluster:
        steps.append(("shipped_bf16_staged", _shipped_staged, "cuda", None))
    steps.append((f"plain_{dname}", deflate.deflate_pass_plain, "torch", None))
    if cluster:
        steps.append((f"two_pass_{dname}", _shipped_staged, "cuda", None))
        steps += [(name, step, "cuda", None) for name, step in cluster_steps(X, r0)]
    else:
        steps += [(v.name, v.cuda, "cuda", v) for v in default_variants(bf16)]
    for name, step, route, variant in steps:
        try:
            t, tt, p = step(X, r0)
            err_p = float((p.double() - pd).abs().max() / pd.abs().max())
            err_tt = abs(float(tt) - ttd) / ttd
            del t, tt, p
            ms = chain_ms(step, X, r0, iters)
        except (RuntimeError, ValueError) as e:
            print(f"{name:24s} FAILED: {type(e).__name__}: {e}", flush=True)
            rows.append({"name": name, "error": f"{type(e).__name__}: {e}"})
            continue
        row = {"name": name, "ms": ms, "gbs": nbytes / ms / 1e6, "err_p": err_p,
               "err_tt": err_tt, "route": route}
        plan = ""
        if variant is not None:
            row["G"], row["R"], row["per_sm"] = variant.plan(X, r0)
            plan = f"  R={row['R']} G={row['G']} blocks/SM={row['per_sm']}"
        elif cluster and step is deflate.deflate_pass_cuda:
            sp = deflate.plan_for(X, r0)
            plan = f"  cluster_c{sp.C}_r{sp.R}_s{sp.stages}_g{sp.G}"
        rows.append(row)
        print(f"{name:24s} {ms:8.4f} ms/comp {row['gbs']:8.1f} GB/s  "
              f"err_p={err_p:.2e} err_tt={err_tt:.2e}  {route}{plan}", flush=True)
    return rows


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--k", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=40)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device; the sweep times kernels on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    deflate.build()
    dv.build()
    print(f"build+load {time.perf_counter() - t0:.2f} s", flush=True)
    rows = sweep(args.n, args.k, args.iters, bool(os.environ.get("KV_BF16")))
    return 1 if any("error" in row for row in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
