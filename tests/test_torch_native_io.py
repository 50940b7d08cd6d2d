"""The port's host runtime (`csrc/native_io.cpp` via `utils/native.py`)
against the JAX package's `pls_tpu._native` (built by tests/conftest.py).

- CSV values: `pls_tpu_torch.utils.io.read_matrix_file` and
  `stream_matrix_file` give the same float64 bytes as
  `pls_tpu.utils.io`'s (on its native path) on seeded matrices with `,`,
  `;` and tab separators, `%.17g`, `%.6g` and integer fields, -0.0,
  subnormals and CRLF endings; so does the port's plain twin
  (`_read_matrix_python`).
- strtod's reading where Python's float() differs (`1_000`, hex floats,
  blanks, nan/inf, an empty line, a trailing separator): the same values
  or the same exception type and message as the JAX native loader.
- Errors: the same type and message, for the whole-file and the chunked
  reader, natively and in the plain twins (against the JAX package's
  twins of the same names); a ragged row keeps row/got/expected, counted
  across chunks, after the complete chunks before it.
- Chunks at chunk_rows = 1, 7, N and N+1 join to the whole matrix, chunk
  for chunk as the JAX reader splits it.
- Threads: a reader dropped after one chunk, one whose worker errs, an
  abandoned generator and `csv_chunks` failing on unequal row counts all
  end with every reader's thread joined (`native.live_readers`), each
  within its own time limit.
- No fallback: a missing or failing compiler makes the loader raise.
- The RNG traces equal tests/golden's libstdc++ draws and pls_tpu._native's;
  `GccRng`'s native engine equals its own trace, the plain twin
  (MT19937 + gcc_shuffle) and the JAX package's GccRng, carries its state
  across interleaved calls as the twin does, forks under copy, and serves
  the LSO of `cv_LSO` and of the pipeline (`native_draws`).
"""

from __future__ import annotations

import gc
import os
import stat
import threading
from pathlib import Path

import numpy as np
import pytest

import pls_tpu.utils.io as jio
from pls_tpu import _native as jax_native
from pls_tpu.models.streaming import csv_chunks as jax_csv_chunks
from pls_tpu.utils.gcc_rng import GccRng as JaxGccRng
from pls_tpu_torch.models.streaming import csv_chunks
from pls_tpu_torch.utils import cxx, gcc_rng, native
from pls_tpu_torch.utils import io as tio

REPO = Path(__file__).resolve().parent.parent
THREAD_LIMIT = 60  # seconds a reader scenario may take before it counts as hung


def _kind(e: Exception) -> tuple:
    """An exception's type, by name and built-in base: each package has
    its own RaggedMatrixError (a ValueError)."""
    return type(e).__name__, next(c for c in type(e).__mro__ if c.__module__ == "builtins")


def _outcome(fn):
    """("ok", float64 bytes, shape) or (exception type, message)."""
    try:
        a = fn()
    except Exception as e:  # noqa: BLE001 - the exception is the result compared
        return _kind(e), str(e)
    return "ok", np.ascontiguousarray(a).tobytes(), a.shape


def _stream_outcome(stream):
    """The chunks' shapes and bytes until the end or an error, and the error."""
    got = []
    try:
        for c in stream:
            got.append((c.shape, c.tobytes()))
    except Exception as e:  # noqa: BLE001
        return got, (_kind(e), str(e), getattr(e, "row", None), getattr(e, "got", None),
                     getattr(e, "expected", None))
    return got, None


def _write_matrix(path: Path, A: np.ndarray, fmt: str, sep: str, crlf: bool) -> None:
    end = "\r\n" if crlf else "\n"
    path.write_bytes("".join(sep.join(fmt % v for v in row) + end for row in A).encode())


def _matrix(kind: str, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "%d":
        return rng.integers(-10**6, 10**6, size=(37, 11)).astype(np.float64)
    A = rng.standard_normal((37, 11)) * 10.0 ** rng.integers(-8, 8, size=(37, 11))
    A[0, 0], A[1, 1], A[2, 2] = -0.0, 5e-324, 2.2250738585072014e-308 / 3  # -0 and subnormals
    return A


@pytest.mark.parametrize("crlf", [False, True], ids=["lf", "crlf"])
@pytest.mark.parametrize("fmt", ["%.17g", "%.6g", "%d"])
@pytest.mark.parametrize("sep", [",", ";", "\t"], ids=["comma", "semicolon", "tab"])
def test_values_bit_equal_jax_native(tmp_path, sep, fmt, crlf):
    p = tmp_path / "m.csv"
    _write_matrix(p, _matrix(fmt), fmt, sep, crlf)
    if sep == "\t":  # the JAX extension refuses a tab separator: its Python parser's values
        ref = _outcome(lambda: jio._read_matrix_python(str(p), sep))
    else:
        ref = _outcome(lambda: jio.read_matrix_file(str(p), sep))
    assert ref[0] == "ok" and ref[2] == (37, 11)
    before = dict(tio.native_reads)
    assert _outcome(lambda: tio.read_matrix_file(str(p), sep)) == ref
    assert _outcome(lambda: tio._read_matrix_python(str(p), sep)) == ref
    assert _outcome(lambda: np.concatenate(list(tio.stream_matrix_file(str(p), 7, sep)))) == ref
    assert tio.native_reads["read_matrix"] == before["read_matrix"] + 1
    assert tio.native_reads["chunks"] == before["chunks"] + 6


# (file text, separator): where strtod reads otherwise than Python's float()
STRTOD_CASES = {
    "underscore": ("1_000,2\n", ","),
    "hex_float": ("0x1p-2,0X1.8P3\n", ","),
    "leading_blanks": (" 1,  2\n\t3,4\n", ","),
    "blanks_after_field": ("1 ,2\t\n3,4 \n", ","),
    "nan_inf": ("nan,inf\n-inf,-nan\nNaN,Infinity\n", ","),
    "signs_and_points": ("+5,.5\n5.,-.25e-1\n", ","),
    "empty_line_in_middle": ("1,2\n\n3,4\n", ","),
    "blank_line": ("1,2\n   \n", ","),
    "trailing_separator": ("1,2,\n3,4,\n", ","),
    "leading_separator": (",1,2\n", ","),
    "exponent_without_digits": ("1e,2\n", ","),
    "double_sign": ("--1,2\n", ","),
    "cr_inside_line": ("1,\r2\n", ","),
    "no_final_newline": ("1,2\n3,4", ","),
    "only_newline": ("\n", ","),
    "tab_between_fields_comma_sep": ("1\t2\n", ","),
    "one_field_tab_separator": ("1\n2 \n", "\t"),
}


@pytest.mark.parametrize("case", sorted(STRTOD_CASES))
def test_strtod_reading_matches_jax_native(tmp_path, case):
    text, sep = STRTOD_CASES[case]
    p = tmp_path / f"{case}.csv"
    p.write_bytes(text.encode())
    ref = _outcome(lambda: jio.read_matrix_file(str(p), sep))
    mine = _outcome(lambda: tio.read_matrix_file(str(p), sep))
    assert mine == ref
    for rows in (1, 2):
        assert (_stream_outcome(tio.stream_matrix_file(str(p), rows, sep))
                == _stream_outcome(jio.stream_matrix_file(str(p), rows, sep)))


@pytest.mark.parametrize("sep", ["\t", " "], ids=["tab", "space"])
def test_blank_separator_reads_as_the_jax_python_parser(tmp_path, sep):
    """A deliberate difference: the JAX extension skips blanks after a field
    before it looks for the separator, so a tab or space separator fails
    on every row of two fields; the port stops at the separator and reads
    the file as the JAX package's Python parser does."""
    A = _matrix("%.17g", seed=5)
    p = tmp_path / "m.csv"
    _write_matrix(p, A, "%.17g", sep, False)
    with pytest.raises(ValueError, match="unexpected character"):
        jio.read_matrix_file(str(p), sep)
    ref = _outcome(lambda: jio._read_matrix_python(str(p), sep))
    assert ref[0] == "ok"
    assert _outcome(lambda: tio.read_matrix_file(str(p), sep)) == ref
    assert _outcome(lambda: np.concatenate(list(tio.stream_matrix_file(str(p), 5, sep)))) == ref


# (file text or None for a missing file, separator, the chunk reader's chunk_rows)
ERROR_CASES = {
    "ragged": ("1,2,3\n4,5,6\n7,8\n", ",", 2),
    "ragged_across_chunks": ("".join(f"{i},{i}\n" for i in range(10)) + "1,2,3\n", ",", 4),
    "non_numeric": ("1,2\n3,x\n", ",", 1),
    "trailing_separator": ("1,2\n3,4,\n", ",", 5),
    "empty_line": ("1,2\n\n3,4\n", ",", 1),
    "empty_file": ("", ",", 3),
    "missing_file": (None, ",", 3),
    "multi_character_separator": ("1;;2\n", ";;", 3),
}


def _error_file(tmp_path: Path, case: str) -> str:
    text = ERROR_CASES[case][0]
    p = tmp_path / f"{case}.csv"
    if text is not None:
        p.write_text(text)
    return str(p)


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_errors_match_jax_native(tmp_path, case):
    path = _error_file(tmp_path, case)
    _, sep, rows = ERROR_CASES[case]
    ref = _stream_outcome(jio.stream_matrix_file(path, rows, sep))
    assert ref[1] is not None
    assert _stream_outcome(tio.stream_matrix_file(path, rows, sep)) == ref
    try:
        jio.read_matrix_file(path, sep)
    except Exception as e:  # noqa: BLE001
        ref_err = e
    with pytest.raises(Exception) as mine:
        tio.read_matrix_file(path, sep)
    assert _kind(mine.value) == _kind(ref_err) and str(mine.value) == str(ref_err)
    if case.startswith("ragged"):
        assert isinstance(mine.value, tio.RaggedMatrixError) and mine.value.exit_code == 1
        assert (mine.value.row, mine.value.got, mine.value.expected) == (
            ref_err.row, ref_err.got, ref_err.expected)


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_plain_twin_errors_match_jax_twin(tmp_path, case):
    path = _error_file(tmp_path, case)
    _, sep, rows = ERROR_CASES[case]
    assert (_outcome(lambda: tio._read_matrix_python(path, sep))
            == _outcome(lambda: jio._read_matrix_python(path, sep)))
    assert (_stream_outcome(tio._stream_matrix_python(path, rows, sep))
            == _stream_outcome(jio._stream_matrix_python(path, rows, sep)))


def test_ragged_row_counted_across_chunks(tmp_path):
    path = _error_file(tmp_path, "ragged_across_chunks")
    chunks, err = _stream_outcome(tio.stream_matrix_file(path, 4))
    assert [shape for shape, _ in chunks] == [(4, 2), (4, 2)]  # the partial chunk is dropped
    assert err[0] == ("RaggedMatrixError", ValueError) and err[2:] == (10, 3, 2)


@pytest.mark.parametrize("chunk_rows", ["1", "7", "N", "N+1"])
def test_chunks_join_to_the_matrix(tmp_path, chunk_rows):
    A = _matrix("%.17g", seed=3)
    p = tmp_path / "m.csv"
    _write_matrix(p, A, "%.17g", ",", False)
    rows = {"1": 1, "7": 7, "N": len(A), "N+1": len(A) + 1}[chunk_rows]
    mine = list(tio.stream_matrix_file(str(p), rows))
    ref = list(jio.stream_matrix_file(str(p), rows))
    assert [c.shape for c in mine] == [c.shape for c in ref]
    assert all(c.shape[0] <= rows for c in mine)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(mine, ref))
    np.testing.assert_array_equal(np.concatenate(mine), A)


def test_csv_chunks_pairs_match_jax(tmp_path):
    A = _matrix("%.17g", seed=4)
    xp, yp = tmp_path / "x.csv", tmp_path / "y.csv"
    _write_matrix(xp, A, "%.17g", ",", False)
    _write_matrix(yp, A[:, :2], "%.17g", ",", False)
    mine = list(csv_chunks(str(xp), str(yp), 10))
    ref = list(jax_csv_chunks(str(xp), str(yp), 10))
    assert len(mine) == len(ref) == 4
    for (x, y), (jx, jy) in zip(mine, ref):
        assert x.tobytes() == np.asarray(jx).tobytes() and y.tobytes() == np.asarray(jy).tobytes()


def _big_csv(tmp_path: Path, rows: int = 4000, bad_row: int | None = None) -> str:
    p = tmp_path / "big.csv"
    lines = ["1.5,2.5,3.5,4.5"] * rows
    if bad_row is not None:
        lines[bad_row] = "1,2"
    p.write_text("\n".join(lines) + "\n")
    return str(p)


def _reader_dropped_after_one_chunk(tmp_path):
    reader = native.ChunkReader(_big_csv(tmp_path), 16)
    assert next(reader).shape == (16, 4)
    del reader  # its worker is parsing ahead, or waiting to hand over the next chunk


def _worker_errs(tmp_path):
    reader = native.ChunkReader(_big_csv(tmp_path, bad_row=3000), 1000)
    got = [next(reader).shape for _ in range(3)]
    assert got == [(1000, 4)] * 3
    with pytest.raises(ValueError, match="row 3000 has 2 columns"):
        next(reader)
    with pytest.raises(ValueError, match="row 3000 has 2 columns"):  # and again
        next(reader)
    reader.close()


def _generator_abandoned(tmp_path):
    gen = tio.stream_matrix_file(_big_csv(tmp_path), 8)
    next(gen)
    del gen


def _csv_chunks_unequal_rows(tmp_path):
    xp = _big_csv(tmp_path)
    yp = tmp_path / "short.csv"
    yp.write_text("1\n" * 100)
    with pytest.raises(ValueError, match="different numbers of rows"):
        list(csv_chunks(xp, str(yp), 64))  # X's reader still has rows to parse


@pytest.mark.parametrize("scenario", [_reader_dropped_after_one_chunk, _worker_errs,
                                      _generator_abandoned, _csv_chunks_unequal_rows],
                         ids=lambda f: f.__name__.strip("_"))
def test_reader_threads_are_joined(tmp_path, scenario):
    gc.collect()
    live = native.live_readers()
    errors = []

    def run():
        try:
            scenario(tmp_path)
        except BaseException as e:  # noqa: BLE001 - reported to the test below
            errors.append(e)

    t = threading.Thread(target=run, daemon=True)  # a hang fails this test, not the suite
    t.start()
    t.join(THREAD_LIMIT)
    assert not t.is_alive(), f"{scenario.__name__} still running after {THREAD_LIMIT} s"
    if errors:
        raise errors[0]
    assert native.live_readers() == live


@pytest.fixture
def fresh_library(monkeypatch):
    """Forget the loaded library for the test, and again after it."""
    native.library.cache_clear()
    cxx.load_library.cache_clear()
    yield monkeypatch
    monkeypatch.undo()
    native.library.cache_clear()
    cxx.load_library.cache_clear()


def _failing_compiler(tmp_path: Path) -> str:
    script = tmp_path / "broken-c++"
    script.write_text("#!/bin/sh\necho 'broken-c++: internal error on purpose' >&2\nexit 3\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script)


@pytest.mark.parametrize("compiler", ["missing", "failing"])
def test_failed_build_raises_without_fallback(tmp_path, fresh_library, compiler):
    if compiler == "missing":
        cxx_name, needle = str(tmp_path / "no-such-c++"), "not found"
    else:
        cxx_name, needle = _failing_compiler(tmp_path), "internal error on purpose"
    fresh_library.setenv("CXX", cxx_name)
    assert not cxx.library_path(native.SOURCE).exists()  # a fresh build key
    with pytest.raises(RuntimeError, match=needle) as e:
        cxx.build(native.SOURCE)
    assert cxx_name in str(e.value)
    toy = str(REPO / "pls_tpu_torch" / "data" / "toyX.csv")
    before = dict(tio.native_reads)
    for call in (lambda: tio.read_matrix_file(toy), lambda: next(tio.stream_matrix_file(toy, 4)),
                 lambda: gcc_rng.mt19937_raw(5489, 4)):
        with pytest.raises(RuntimeError, match=needle):
            call()
    assert tio.native_reads == before


def test_library_built_by_the_host_compiler(monkeypatch):
    monkeypatch.delenv("CXX", raising=False)
    path = cxx.library_path(native.SOURCE)
    assert path.parent == cxx.nvcc.BUILD_DIR and path.name.startswith("native_io-")
    monkeypatch.setenv("CXX", "clang++")
    assert cxx.library_path(native.SOURCE) != path  # the compiler is part of the key
    monkeypatch.delenv("CXX")
    assert cxx.build(native.SOURCE) == path and path.exists()


@pytest.mark.parametrize("family", ["calibration", "magnitudes", "dyadic_ties", "integers",
                                    "special"])
def test_phase12_writer_prints_g9(family):
    """chip_smoke.py's phase 12 writes its CSV files with a vectorised
    formatter: byte for byte what "%.9g" prints."""
    from chip_smoke import format_g9

    rng = np.random.default_rng(8)
    X = {
        "calibration": lambda: rng.standard_normal((50, 40)) * 8 + 5,
        "magnitudes": lambda: rng.standard_normal((50, 40)) * 10.0 ** rng.integers(-7, 11, (50, 40)),
        "dyadic_ties": lambda: rng.integers(1, 2**20, (50, 40)) / 256.0,
        "integers": lambda: rng.integers(-10**8, 10**8, (50, 40)),
        "special": lambda: np.array([[0.0, -0.0, 1e-4, 9.9999999e-5, 999999999.5, 1e9, np.inf,
                                      -np.inf, np.nan, 1e-45, 3.4e38, 1.0]]),
    }[family]().astype(np.float32)
    ref = "".join(",".join("%.9g" % v for v in row) + "\n" for row in X.astype(np.float64))
    assert format_g9(X) == ref.encode()


def test_mt19937_raw_equals_golden(golden):
    gold = golden("mt19937_raw").ravel().astype(np.uint32)
    np.testing.assert_array_equal(gcc_rng.mt19937_raw(5489, len(gold)), gold)


@pytest.mark.parametrize("n", [7, 10, 60, 128])
def test_shuffle_trace_equals_golden(golden, n):
    gold = golden(f"shuffle{n}").astype(np.int64)
    np.testing.assert_array_equal(gcc_rng.gcc_shuffle_trace(5489, n, gold.shape[0]), gold)


def _twin_partitions(mt, n, reps):
    """GccRng.lso_partitions on the plain twin (MT19937 + gcc_shuffle)."""
    v, out = list(range(n)), np.empty((reps, n), np.int64)
    for r in range(reps):
        gcc_rng.gcc_shuffle(v, mt)
        out[r] = v
    return out


@pytest.mark.parametrize("seed,n,reps", [(5489, 60, 600), (7, 13, 50), (3, 10, 4), (0, 1, 3),
                                         (2**32 + 5, 10, 4), (123, 65537, 2)])
def test_traces_equal_jax_native_and_the_emulator(seed, n, reps):
    trace = gcc_rng.gcc_shuffle_trace(seed, n, reps)
    np.testing.assert_array_equal(trace, jax_native.gcc_shuffle_trace(seed, n, reps))
    np.testing.assert_array_equal(gcc_rng.mt19937_raw(seed, 1000),
                                  jax_native.mt19937_raw(seed, 1000))
    parts = gcc_rng.GccRng(seed).lso_partitions(n, reps)
    assert parts.dtype == np.int64 and parts.shape == (reps, n)
    np.testing.assert_array_equal(parts, trace)
    np.testing.assert_array_equal(parts, _twin_partitions(gcc_rng.MT19937(seed), n, reps))
    np.testing.assert_array_equal(parts, JaxGccRng(seed).lso_partitions(n, reps))


def test_engine_state_carries_as_the_twin():
    """One GccRng through raw, shuffle, partitions and raw again draws the
    twin's stream: the native engine's state carries across calls."""
    rng, mt = gcc_rng.GccRng(11), gcc_rng.MT19937(11)
    assert rng.raw() == mt()
    words, twin_words = list("abcdefghijklm"), list("abcdefghijklm")
    rng.shuffle(words)
    gcc_rng.gcc_shuffle(twin_words, mt)
    assert words == twin_words != list("abcdefghijklm")
    for _ in range(2):
        np.testing.assert_array_equal(rng.lso_partitions(10, 30), _twin_partitions(mt, 10, 30))
    assert rng.raw() == mt()


def test_engine_copies_fork_the_stream():
    import copy
    import pickle

    rng = gcc_rng.GccRng(2024)
    rng.lso_partitions(17, 5)
    forks = [copy.deepcopy(rng), copy.copy(rng)]
    first = rng.lso_partitions(17, 40)
    for fork in forks:
        np.testing.assert_array_equal(fork.lso_partitions(17, 40), first)
    # independent: drawing from one leaves the others where they were
    forks[0].raw()
    assert rng.raw() == forks[1].raw() != forks[0].raw()
    del rng, forks
    gc.collect()
    with pytest.raises(TypeError, match="cannot be pickled"):
        pickle.dumps(gcc_rng.GccRng())


@pytest.mark.parametrize("n,reps", [(0, 4), (1, 4), (9, 0)])
def test_engine_edge_sizes_as_the_jax_package(n, reps):
    rng, jrng = gcc_rng.GccRng(5), JaxGccRng(5)
    parts = rng.lso_partitions(n, reps)
    assert parts.dtype == np.int64 and parts.shape == (reps, n)
    np.testing.assert_array_equal(parts, jrng.lso_partitions(n, reps))
    assert rng.raw() == jrng.raw()  # no draw taken


@pytest.mark.parametrize("route", ["cv_LSO", "pipeline_gcc", "pipeline_jax"])
def test_native_engine_serves_the_lso(route):
    """`native_draws` counts the partitions the engine drew: one set for
    cv_LSO with a GccRng and for the pipeline's default route, none for
    the JAX-key route."""
    import io

    import torch

    from pls_tpu_torch import GccRng, PLSModel
    from pls_tpu_torch.config import PLSRunConfig, run_pipeline
    from pls_tpu_torch.types import KERNEL_TYPE1

    x_file, y_file = (str(REPO / "pls_tpu" / "data" / f) for f in ("toyX.csv", "toyY.csv"))
    before = dict(gcc_rng.native_draws)
    if route == "cv_LSO":
        X, Y = (torch.from_numpy(tio.read_matrix_file(f)) for f in (x_file, y_file))
        PLSModel(X, Y, KERNEL_TYPE1, 2).cv_LSO(0.3, 20, GccRng())
    else:
        cfg = PLSRunConfig(x_file, y_file, 2, cv=("lso",), rng=route.removeprefix("pipeline_"))
        run_pipeline(cfg, file=io.StringIO(), device=torch.device("cpu"))
    drew = route != "pipeline_jax"
    assert gcc_rng.native_draws == {**before, "lso_partitions": before["lso_partitions"] + drew}


def test_trace_arguments_checked():
    with pytest.raises(ValueError, match="n and reps must be positive"):
        gcc_rng.gcc_shuffle_trace(1, 0, 3)
    with pytest.raises(ValueError, match="n and reps must be positive"):
        jax_native.gcc_shuffle_trace(1, 0, 3)
    with pytest.raises(ValueError, match="chunk_rows must be positive"):
        native.ChunkReader(os.devnull, 0)
