"""Start the ranks of a multi-process run on one host.

`spawn_ranks` runs one command as n processes, each told its rank, the
world size and a fresh `file://` store to meet at (no port to pick), and
waits for all of them.  The port's scaling tool, the smoke run's two-rank
check and the parallel tests start their ranks through it; each rank then
calls `initialize_distributed(init_method, world_size, rank, ...)`.
"""

from __future__ import annotations

import subprocess
import tempfile
import time
from pathlib import Path


def spawn_ranks(cmd: list[str], world_size: int, *, timeout_sec: float, cwd=None,
                env=None) -> list[str]:
    """Run `cmd --rank r --world-size n --init-method file://…` for r in
    0..n-1 and return their standard outputs, in rank order.

    Raises RuntimeError, with the tail of its standard error, as soon as a
    rank exits non-zero (the others, who would wait on it in a collective,
    are killed), and when the run outlasts `timeout_sec` (all are killed)."""
    with tempfile.TemporaryDirectory(prefix="pls_ranks_") as tmp:
        logs = [(Path(tmp) / f"rank{r}.out", Path(tmp) / f"rank{r}.err") for r in range(world_size)]
        procs, failed = [], []
        try:
            for r, (out, err) in enumerate(logs):
                with open(out, "w") as fo, open(err, "w") as fe:
                    procs.append(subprocess.Popen(
                        [*cmd, "--rank", str(r), "--world-size", str(world_size),
                         "--init-method", f"file://{tmp}/store"],
                        stdout=fo, stderr=fe, cwd=cwd, env=env,
                    ))
            deadline = time.monotonic() + timeout_sec
            while not failed and any(p.poll() is None for p in procs):
                failed = [r for r, p in enumerate(procs) if p.returncode not in (None, 0)]
                if time.monotonic() > deadline:
                    raise RuntimeError(f"{world_size} ranks of {cmd} outlasted {timeout_sec} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        failed = failed or [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            r = failed[0]
            raise RuntimeError(f"rank {r} of {world_size} exited {procs[r].returncode}:\n"
                               f"{logs[r][1].read_text()[-3000:]}")
        return [out.read_text() for out, _ in logs]
