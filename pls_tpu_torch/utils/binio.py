"""Binary (.npy) ingest: disk → host → device, overlapped.

Counterpart of `pls_tpu/utils/binio.py`.  Standard .npy files are streamed
in row chunks by

  1. a reader thread issuing `os.pread` into preallocated buffers (the
     syscall releases the GIL, so disk reads overlap the consumer), with
     O_DIRECT reads into page-aligned pool slots where the filesystem
     allows it;
  2. `device_stream`: each chunk's host→device copy is issued on a side
     CUDA stream from pinned memory while the consumer computes on the
     previous chunk, and handed over through a CUDA event.

The accumulation itself is models/streaming.py.  bfloat16 on disk is the
2-byte void descr `|V2`, the JAX package's convention; it is read as
int16 and viewed as torch.bfloat16, with no extra numpy dtype package.
Chunks are yielded as CPU tensors of the file's dtype.
"""

from __future__ import annotations

import itertools
import os
import queue
import struct
import threading

import numpy as np
import torch

from pls_tpu_torch.config import resolve_device

# Rotating-pool size for stream_npy(reuse_buffers=True).  The reader leads
# the newest yielded chunk by at most 3 (2 queued + 1 being read), so a
# 6-slot pool keeps a yielded chunk intact until two more have been
# yielded; device_stream needs one (its copy in flight).
_POOL_SLOTS = 6
# O_DIRECT alignment of offsets, lengths and buffers
_DIRECT_ALIGN = 4096

_TORCH_OF = {
    np.dtype(np.float64): torch.float64, np.dtype(np.float32): torch.float32,
    np.dtype(np.float16): torch.float16, np.dtype(np.int64): torch.int64,
    np.dtype(np.int32): torch.int32, np.dtype(np.int16): torch.int16,
    np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8,
}


def _npy_layout(path: str):
    """(shape, torch dtype, numpy dtype to read, data offset, fortran_order)
    from the .npy header (numpy's public header readers);
    `pls_tpu/utils/binio.py:47-69`."""
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        if version == (1, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
        elif version == (2, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
        else:
            raise ValueError(
                f"{path}: unsupported .npy format version {version} "
                "(streamable ingest supports 1.0 and 2.0)"
            )
        if dtype.kind == "V" and dtype.itemsize == 2 and dtype.names is None:
            return shape, torch.bfloat16, np.dtype(np.int16), f.tell(), fortran
        if dtype not in _TORCH_OF:
            raise ValueError(f"{path}: unsupported dtype {dtype}")
        return shape, _TORCH_OF[dtype], dtype, f.tell(), fortran


def npy_shape(path: str) -> tuple[tuple[int, ...], torch.dtype]:
    """(shape, torch dtype) of a .npy file from its header alone
    (`pls_tpu/utils/binio.py:72-75`)."""
    shape, dtype, *_ = _npy_layout(path)
    return shape, dtype


def _host_array(chunk, dtype) -> np.ndarray:
    """A C-contiguous numpy array of the bytes to write; bfloat16 as int16."""
    t = chunk if isinstance(chunk, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(chunk))
    if dtype is not None:
        t = t.to(dtype)
    t = t.detach().cpu().contiguous()
    if t.ndim < 2:
        t = t.reshape(t.shape[0], 1)
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def write_npy_chunked(path: str, chunks, *, dtype: torch.dtype | None = None) -> tuple[int, int]:
    """Write an iterable of (rows, K) blocks (numpy arrays or tensors, on
    any device) as one .npy file without holding the whole matrix;
    counterpart of `pls_tpu/utils/binio.py:78-147`.  bfloat16 is written as
    the `|V2` descr.  The header is written with a 16-digit placeholder
    row count and patched at the end without moving the data offset.
    Returns (N, K)."""
    it = iter(chunks)
    try:
        first = next(it)
    except StopIteration:
        raise ValueError("write_npy_chunked: empty chunk iterable") from None
    bf16 = (dtype == torch.bfloat16) or (
        dtype is None and isinstance(first, torch.Tensor) and first.dtype == torch.bfloat16
    )
    first = _host_array(first, dtype)
    K = first.shape[1]
    descr = "|V2" if bf16 else np.lib.format.dtype_to_descr(first.dtype)
    header = {"descr": descr, "fortran_order": False, "shape": (10**15, K)}
    n = 0
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, header)
        data_off = f.tell()
        for i, chunk in enumerate(itertools.chain([first], it)):
            arr = chunk if i == 0 else _host_array(chunk, dtype)
            if arr.dtype != first.dtype or arr.shape[1] != K:
                raise ValueError(
                    f"chunk {i}: {arr.dtype} {arr.shape} does not match {first.dtype} (·, {K})"
                )
            f.flush()
            arr.tofile(f)
            n += arr.shape[0]
    with open(path, "r+b") as f:
        header["shape"] = (n, K)
        np.lib.format.write_array_header_1_0(f, header)
        pos = f.tell()
        if pos > data_off:
            raise ValueError("npy header grew while patching the row count — file corrupt")
        if pos < data_off:  # re-pad to the original data offset (v1.0 header)
            f.seek(8)
            f.write(struct.pack("<H", data_off - 10))
            f.seek(pos - 1)
            f.write(b" " * (data_off - pos) + b"\n")
    return n, K


def _pool_slot(nbytes: int, pin: bool) -> torch.Tensor:
    """A page-aligned uint8 CPU buffer of `nbytes`: pinned (for CUDA
    copies) or anonymous mmap memory.  O_DIRECT reads need the alignment."""
    if pin:
        base = torch.empty(nbytes + _DIRECT_ALIGN, dtype=torch.uint8, pin_memory=True)
        off = -base.data_ptr() % _DIRECT_ALIGN
        slot = base[off : off + nbytes]
    else:
        import mmap

        slot = torch.from_numpy(np.frombuffer(mmap.mmap(-1, nbytes), np.uint8))
    if slot.data_ptr() % _DIRECT_ALIGN:
        raise RuntimeError("pool slot is not 4096-byte aligned")
    return slot


def stream_npy(
    path: str, chunk_rows: int, *, threaded: bool = True,
    reuse_buffers: bool = False, direct: bool | None = None, pin_memory: bool = False,
):
    """Yield (rows ≤ chunk_rows, K) CPU tensors of a 2-D .npy in order (a
    1-D file streams as (N, 1)); counterpart of
    `pls_tpu/utils/binio.py:155-311`.

    threaded=True: a reader thread preads the next chunks (at most 2 queued)
    while the caller consumes the current one.

    reuse_buffers=True: chunks live in a rotating pool of `_POOL_SLOTS`
    preallocated page-aligned buffers (pinned with pin_memory=True, for
    CUDA copies).  A yielded chunk stays intact until two more chunks have
    been yielded, and may be overwritten after the third: consumers that
    keep chunks longer must copy them.

    direct=None uses O_DIRECT reads into the pool slots when the filesystem
    accepts them (the span is widened to 4096-byte bounds and the file's
    last partial block read buffered); True requires it; False disables.
    """
    shape, tdtype, ndtype, off, fortran = _npy_layout(path)
    if len(shape) == 1:
        shape = (shape[0], 1)
    if len(shape) != 2:
        raise ValueError(f"{path}: expected 1-D or 2-D array, got shape {shape}")
    if fortran:
        raise ValueError(f"{path}: fortran-order arrays are not streamable")
    if chunk_rows <= 0:
        raise ValueError("chunk_rows must be positive")
    if direct and not reuse_buffers:
        raise ValueError(
            "direct=True requires reuse_buffers=True (O_DIRECT reads into the "
            "page-aligned buffer pool)"
        )
    N, K = shape
    row_bytes = K * ndtype.itemsize
    fsize = os.path.getsize(path)
    fd_direct = -1
    if reuse_buffers and direct is not False:
        try:
            fd_direct = os.open(path, os.O_RDONLY | os.O_DIRECT)
        except OSError:
            if direct:
                raise
    pool = None
    if reuse_buffers:
        slot_bytes = chunk_rows * row_bytes + 2 * _DIRECT_ALIGN
        pool = [_pool_slot(slot_bytes, pin_memory) for _ in range(_POOL_SLOTS)]

    def as_chunk(buf: np.ndarray, rows: int) -> torch.Tensor:
        t = torch.from_numpy(buf.view(ndtype)).reshape(rows, K)
        return t.view(torch.bfloat16) if tdtype == torch.bfloat16 else t

    def read_chunk(fd: int, idx: int, start: int) -> torch.Tensor:
        rows = min(chunk_rows, N - start)
        nbytes = rows * row_bytes
        pos = off + start * row_bytes
        if pool is None:
            buf = np.empty(nbytes, np.uint8)
            _pread_into(fd, memoryview(buf), pos)
            return as_chunk(buf, rows)
        slot = pool[idx % _POOL_SLOTS].numpy()
        if fd_direct < 0:
            _pread_into(fd, memoryview(slot)[:nbytes], pos)
            return as_chunk(slot[:nbytes], rows)
        astart = pos - pos % _DIRECT_ALIGN
        want_end = pos + nbytes
        aend = max(astart, min(-(-want_end // _DIRECT_ALIGN) * _DIRECT_ALIGN,
                               fsize - fsize % _DIRECT_ALIGN))
        mv = memoryview(slot)
        if aend > astart:
            _pread_into(fd_direct, mv[: aend - astart], astart)
        if aend < want_end:  # the file's tail past its last full block
            _pread_into(fd, mv[aend - astart : want_end - astart], aend)
        return as_chunk(slot[pos - astart : want_end - astart], rows)

    def close_direct():
        if fd_direct >= 0:
            os.close(fd_direct)

    if not threaded:
        fd = os.open(path, os.O_RDONLY)
        try:
            for idx, start in enumerate(range(0, N, chunk_rows)):
                yield read_chunk(fd, idx, start)
        finally:
            os.close(fd)
            close_direct()
        return

    q: queue.Queue = queue.Queue(maxsize=2)
    stop = threading.Event()

    def reader():
        fd = os.open(path, os.O_RDONLY)
        try:
            for idx, start in enumerate(range(0, N, chunk_rows)):
                if stop.is_set():
                    return
                q.put(read_chunk(fd, idx, start))
            q.put(None)
        except BaseException as e:  # surface IO errors on the consumer side
            q.put(e)
        finally:
            os.close(fd)
            close_direct()

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while not q.empty():  # wake a producer blocked in put()
            q.get_nowait()


def _pread_into(fd: int, mv: memoryview, offset: int) -> None:
    """pread into an existing buffer until it is full."""
    pos, total = 0, len(mv)
    while pos < total:
        got = os.preadv(fd, [mv[pos:]], offset + pos)
        if got <= 0:
            raise IOError("unexpected EOF")
        pos += got


def device_stream(chunks, *, device=None, cast: torch.dtype | None = None):
    """Iterate chunks on `device`, with one host→device copy in flight
    ahead of the consumer (counterpart of `pls_tpu/utils/binio.py:338-382`).

    On CUDA, chunk i+1's copy is issued on a side stream before chunk i is
    yielded.  Before chunk i is yielded its copy's event is waited on by
    the host, which frees the host buffer behind it (so a reused
    `stream_npy` pool slot may be refilled) and by the compute stream;
    the tensor is recorded on the compute stream for the allocator.
    `cast` converts on the host first (into three rotating pinned
    buffers), e.g. torch.bfloat16 to halve the copy.  On the CPU each
    chunk is copied, since it would otherwise alias a reused pool slot."""
    device = resolve_device(device)
    if device.type != "cuda":
        for c in chunks:
            yield c.to(cast) if cast is not None and c.dtype != cast else c.clone()
        return
    side = torch.cuda.Stream(device)
    compute = torch.cuda.current_stream(device)
    cast_pool: list = [None, None, None]

    def hand_over(d: torch.Tensor, ev: torch.cuda.Event) -> torch.Tensor:
        ev.synchronize()
        compute.wait_event(ev)
        d.record_stream(compute)
        return d

    prev = None
    for i, c in enumerate(chunks):
        if cast is not None and c.dtype != cast:
            buf = cast_pool[i % 3]
            if buf is None or buf.shape != c.shape:
                buf = cast_pool[i % 3] = torch.empty(c.shape, dtype=cast, pin_memory=True)
            c = buf.copy_(c)
        with torch.cuda.stream(side):
            d = c.to(device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(side)
        if prev is not None:
            yield hand_over(*prev)
        prev = (d, ev)
    if prev is not None:
        yield hand_over(*prev)


def npy_chunks(x_path: str, y_path: str, chunk_rows: int, *, threaded=True,
               reuse_buffers: bool = False):
    """Aligned (X_chunk, Y_chunk) CPU tensors of two .npy files; raises on
    a row-count mismatch (the binary counterpart of streaming.csv_chunks;
    `pls_tpu/utils/binio.py:385-405`)."""
    (nx, _), _ = npy_shape(x_path)
    shape_y, _ = npy_shape(y_path)
    if shape_y[0] != nx:
        raise ValueError(f"{x_path} and {y_path} have different numbers of rows")
    xs = stream_npy(x_path, chunk_rows, threaded=threaded, reuse_buffers=reuse_buffers)
    ys = stream_npy(y_path, chunk_rows, threaded=False)
    yield from zip(xs, ys)


def auto_chunk_rows(x_dtype) -> int:
    """Default rows per chunk: 32768 for 2-byte X, 16384 for wider X.  These
    are the JAX package's defaults (`pls_tpu/utils/binio.py:408-414`),
    chosen on a TPU; they have not been measured on the H100."""
    return 32768 if x_dtype.itemsize < 4 else 16384


def _resolve_ingest(x_path: str, y_path: str, chunk_rows, x_storage, compensated: bool = False):
    """((N, K), M, chunk_rows, cast, x_storage) for an ingest
    (`pls_tpu/utils/binio.py:511-547`): X must be 2-D and Y must have its
    rows.  Only bfloat16 on disk selects the narrow
    path by itself; other 2-byte dtypes are widened to float32 on the host
    unless x_storage="bf16" asks for narrowing."""
    shape_x, x_dtype = npy_shape(x_path)
    if len(shape_x) != 2:
        raise ValueError(f"{x_path}: X must be 2-D, got shape {shape_x}")
    N, K = shape_x
    shape_y, _ = npy_shape(y_path)
    M = shape_y[1] if len(shape_y) == 2 else 1
    if shape_y[0] != N:
        raise ValueError(
            f"row-count mismatch: {x_path} has {N} rows but {y_path} has {shape_y[0]}"
        )
    if chunk_rows is None:
        chunk_rows = auto_chunk_rows(x_dtype)
    cast = torch.bfloat16 if x_storage else None
    if x_dtype == torch.bfloat16:
        cast = None
        if x_storage is None and not compensated:
            x_storage = "bf16"
    elif x_dtype.itemsize < 4 and cast is None:
        cast = torch.float32
    return (N, K), M, chunk_rows, cast, x_storage


def _ingest(x_path, y_path, chunk_rows, cast, device, y_cast):
    """(X_chunk, Y_chunk) pairs on `device`: X through the pooled, threaded
    (O_DIRECT where possible) reader, Y through a plain one."""
    xs = stream_npy(x_path, chunk_rows, threaded=True, reuse_buffers=True,
                    pin_memory=device.type == "cuda")
    ys = stream_npy(y_path, chunk_rows, threaded=False)
    return zip(device_stream(xs, device=device, cast=cast),
               device_stream(ys, device=device, cast=y_cast))


def fit_streaming_npy(x_path: str, y_path: str, A: int, *, chunk_rows: int | None = None,
                      x_storage: str | None = None, dtype=None, device=None, **kw):
    """Out-of-core fit from .npy files: `stats_from_npy` then
    `StatsAccumulator.fit(A, **kw)` (zscore=True fits the z-scored model
    from the raw statistics); `pls_tpu/utils/binio.py:417-443`."""
    acc = stats_from_npy(x_path, y_path, chunk_rows=chunk_rows, x_storage=x_storage,
                         dtype=dtype, device=device)
    return acc.fit(A, **kw)


def stats_from_npy(
    x_path: str,
    y_path: str,
    *,
    chunk_rows: int | None = None,
    x_storage: str | None = None,
    dtype=None,
    compensated: bool = False,
    stats_precision: str | None = None,
    device=None,
):
    """One streaming pass over .npy files → a StatsAccumulator holding XᵀX /
    XᵀY on `device` (default: CUDA device 0; the CPU only when passed);
    counterpart of `pls_tpu/utils/binio.py:446-508`.  chunk_rows=None takes
    `auto_chunk_rows`; `stats_precision` is the accumulation's matmul
    setting ("highest": float32 without TF32; None: PyTorch's current
    settings)."""
    from pls_tpu_torch.models.streaming import StatsAccumulator

    (N, K), M, chunk_rows, cast, x_storage = _resolve_ingest(
        x_path, y_path, chunk_rows, x_storage, compensated
    )
    device = resolve_device(device)
    acc = StatsAccumulator(K, M, dtype or torch.float32, compensated=compensated,
                           x_storage=x_storage, precision=stats_precision, device=device)
    for Xc, Yc in _ingest(x_path, y_path, chunk_rows, cast, device, cast):
        acc.update(Xc, Yc)
    return acc


def fold_stats_from_npy(
    x_path: str,
    y_path: str,
    assignments,
    k: int,
    *,
    chunk_rows: int | None = None,
    x_storage: str | None = None,
    dtype=None,
    stats_precision: str | None = None,
    device=None,
):
    """One streaming pass → a FoldStatsAccumulator (per-fold statistics; the
    data pass of the one-pass k-fold CV), with `stats_from_npy`'s ingest;
    counterpart of `pls_tpu/utils/binio.py:550-602`.  `assignments` is the
    (N,) fold label of every row."""
    from pls_tpu_torch.cv.kfold import _check_assignments
    from pls_tpu_torch.models.streaming import FoldStatsAccumulator

    (N, K), M, chunk_rows, cast, x_storage = _resolve_ingest(x_path, y_path, chunk_rows, x_storage)
    assignments = _check_assignments(assignments, k)
    if assignments.shape != (N,):
        raise ValueError(f"assignments shape {assignments.shape} != ({N},)")
    device = resolve_device(device)
    acc = FoldStatsAccumulator(K, M, k, dtype or torch.float32, x_storage=x_storage,
                               precision=stats_precision, device=device)
    start = 0
    for Xc, Yc in _ingest(x_path, y_path, chunk_rows, cast, device, cast):
        rows = Xc.shape[0]
        acc.update(Xc, Yc, assignments[start : start + rows])
        start += rows
    return acc


def cv_kfold_npy(
    x_path: str,
    y_path: str,
    A: int,
    k: int = 10,
    *,
    key=0,
    assignments=None,
    chunk_rows: int | None = None,
    x_storage: str | None = None,
    residual_pass: bool = True,
    zscore: bool = False,
    power_iters: int | None = None,
    precision: str | None = "highest",
    stats_precision: str | None = None,
    dtype=None,
    device=None,
):
    """K-fold CV from .npy files in two passes over X (counterpart of
    `pls_tpu/utils/binio.py:605-722`):

      pass 1: per-fold statistics (`fold_stats_from_npy`), then PRESS, MSE
              and RMSE in closed form (cv/kfold.cv_kfold_onepass);
      pass 2 (residual_pass=True): each row's residuals under its own
              fold's model (cv/kfold.fold_residual_chunk), for the Wilcoxon
              selector.

    Returns (KFoldOnePass, Residual | None).  The Residual's (M, N, A)
    errors stay on `device`, so the selector reads them there.
    zscore=True: the files hold raw data; the fold statistics of the
    globally z-scored data follow in closed form (models/streaming.
    zscore_fold_stats) and residual-pass chunks are standardised on the
    device.  `precision` governs the closed form, `stats_precision` the
    data pass, `dtype` the statistics (default float32)."""
    from pls_tpu_torch.cv.kfold import cv_kfold_onepass, fold_residual_chunk, kfold_assignments
    from pls_tpu_torch.types import Residual

    (N, K), _, chunk_rows, cast, _ = _resolve_ingest(x_path, y_path, chunk_rows, x_storage)
    if assignments is None:
        assignments = kfold_assignments(N, k, key)
    assignments = (assignments.cpu().numpy() if isinstance(assignments, torch.Tensor)
                   else np.asarray(assignments)).astype(np.int64)
    device = resolve_device(device)
    facc = fold_stats_from_npy(
        x_path, y_path, assignments, k, chunk_rows=chunk_rows, x_storage=x_storage,
        dtype=dtype, stats_precision=stats_precision, device=device,
    )
    scale = None
    if zscore:
        facc = facc.zscored()
        scale = (facc.mx, facc.sdx, facc.my, facc.sdy)
    summary = cv_kfold_onepass(facc, A, power_iters=power_iters, precision=precision)
    del facc
    if not residual_pass:
        return summary, None
    B = summary.B  # (k, A, K, M)
    errs = torch.empty((N, A, B.shape[3]), dtype=B.dtype, device=device)
    assign_dev = torch.from_numpy(assignments).to(device)
    start = 0
    for Xc, Yc in _ingest(x_path, y_path, chunk_rows, cast, device, None):
        rows = Xc.shape[0]
        if scale is not None:
            mx, sdx, my, sdy = scale
            Xc = (Xc.to(mx.dtype) - mx[None, :]) / sdx[None, :]
            Yc = (Yc.to(my.dtype) - my[None, :]) / sdy[None, :]
        errs[start : start + rows] = fold_residual_chunk(
            B, Xc, Yc, assign_dev[start : start + rows]
        )
        start += rows
    return summary, Residual(errors=errs.permute(2, 0, 1).contiguous(), method=f"{k}-FOLD")


def cv_repeated_kfold_npy(
    x_path: str,
    y_path: str,
    A: int,
    k: int = 10,
    repeats: int = 5,
    *,
    key=0,
    residual_pass: bool = False,
    **kw,
):
    """Repeated k-fold from disk: `repeats` partitions keyed
    `jax.random.fold_in(key, r)` as the JAX package does
    (`pls_tpu/utils/binio.py:725-769`), one `cv_kfold_npy` each.  Returns
    (press_mean, rmse_mean, runs): (M, A) float64 PRESS and RMSE averaged
    over repeats, and the per-repeat (KFoldOnePass, Residual | None)."""
    from pls_tpu_torch.utils.jax_prng import fold_in
    from pls_tpu_torch.utils.jax_prng import key as jax_key

    if repeats < 1:
        raise ValueError("repeats must be >= 1")
    base = jax_key(key) if isinstance(key, (int, np.integer)) else key
    runs = []
    for r in range(repeats):
        runs.append(cv_kfold_npy(x_path, y_path, A, k=k, key=fold_in(base, r),
                                 residual_pass=residual_pass, **kw))
    press_mean = sum(s.press for s, _ in runs) / repeats
    return press_mean, np.sqrt(press_mean / float(runs[0][0].nf.sum())), runs
