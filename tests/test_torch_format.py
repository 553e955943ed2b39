"""The printed top-1 list (``recsys_tpu_torch/io/writers.py``): the native
pass (``csrc/recsys_format.c``) and its numpy twin byte for byte against
the JAX package's writer; the ``format_native`` count in a traced job; and
the loader's rules for the second source: a library older than it is
rebuilt, and a library without its entry leaves only the list to numpy."""

import os
import shutil
import subprocess

import numpy as np
import pytest

from helpers import FIXTURES
from recsys_tpu.io import writers as jax_writers
from recsys_tpu_torch.config import RunConfig
from recsys_tpu_torch.engine import trainer
from recsys_tpu_torch.io import _native, parser, writers
from recsys_tpu_torch.utils import timing


def _ml100k_every_50th_skipped():
    spec = parser.load_problem(str(FIXTURES / "instML100k.in"))
    counts = spec.rated_counts()
    counts[::50] = spec.items
    top1 = np.random.default_rng(0).integers(0, spec.items, spec.users).astype(np.int32)
    return top1, counts, spec.items


def _random(users: int, items: int, dtype=np.int32, seed: int = 1):
    rng = np.random.default_rng(seed)
    top1 = rng.integers(0, items, users).astype(dtype)
    counts = rng.integers(0, items + 1, users).astype(dtype)
    return top1, counts, items


def _item_zero():
    top1, counts, items = _random(500, 40)
    return np.zeros_like(top1), counts, items


def _every_user_skipped():
    top1, _, items = _random(300, 25)
    return top1, np.full(300, 25, np.int32), items


def _non_contiguous():
    top1, counts, items = _random(2000, 1234)
    return top1[::2], counts[::2], items


def _inst1e6_shape():
    """1,000,000 users with items < 100 and 1-3 rated a user."""
    rng = np.random.default_rng(6)
    return rng.integers(0, 100, 1_000_000).astype(np.int32), rng.integers(1, 4, 1_000_000).astype(np.int32), 100


CASES = {
    "instML100k_every_50th_skipped": _ml100k_every_50th_skipped,
    **{f"items_{n}": (lambda n=n: _random(700, n)) for n in (1, 9, 10, 11, 99, 100, 101, 1000, 1_234_567, 100_000_001, 2**31 - 1)},
    "item_zero_for_all": _item_zero,
    "every_user_skipped": _every_user_skipped,
    "zero_users": lambda: (np.zeros(0, np.int32), np.zeros(0, np.int32), 10),
    "int32": lambda: _random(900, 5000, np.int32),
    "int64": lambda: _random(900, 5000, np.int64),
    "non_contiguous_slice": _non_contiguous,
    "inst1e6_shape": _inst1e6_shape,
}


@pytest.mark.parametrize("how", ["native", "numpy"])
@pytest.mark.parametrize("case", list(CASES))
def test_format_recommendations_matches_the_jax_writer(case, how, monkeypatch):
    top1, counts, items = CASES[case]()
    want = jax_writers.format_recommendations(top1, counts, items)
    if how == "numpy":
        monkeypatch.setattr(_native, "_load", lambda: None)
    else:
        assert _native.available() and _native._format is not None
    phases: dict = {}
    with timing.collect_phases(phases):
        got = writers.format_recommendations(top1, counts, items)
    assert got == want
    assert timing.record_of(phases).counts == {"format_native": int(how == "native")}
    if case == "every_user_skipped" or case == "zero_users":
        assert got == ""


@pytest.mark.parametrize("top1,native", [([-1, 0, 7], 1), ([-(2**31), 2**31 - 1, -12345], 1),
                                         ([-(2**63), 2**63 - 1, -12345], 0)])
def test_negative_and_extreme_items_match_the_jax_writer(top1, native, monkeypatch):
    # The C pass takes int32; an item int32 does not hold goes to the twin.
    top1 = np.array(top1, np.int64)
    counts = np.zeros(top1.size, np.int32)
    want = jax_writers.format_recommendations(top1, counts, 5)
    phases: dict = {}
    with timing.collect_phases(phases):
        assert writers.format_recommendations(top1, counts, 5) == want
    assert timing.record_of(phases).counts == {"format_native": native}
    monkeypatch.setattr(_native, "_load", lambda: None)
    assert writers.format_recommendations(top1, counts, 5) == want


def _format_counts() -> tuple[str, dict]:
    """A traced CPU job's payload and its ``format`` span's counts."""
    spec = parser.load_problem(str(FIXTURES / "inst0.in"))
    phases: dict = {}
    with timing.collect_phases(phases):
        payload, _ = trainer.run(spec, RunConfig(), "cpu")
    job = timing.record_of(phases)
    fmt = [s for s in job.spans if s.name == "format"]
    assert len(fmt) == 1 and fmt[0].parent is None
    return payload, fmt[0].counts


def test_the_format_span_counts_the_native_pass(monkeypatch):
    payload, counts = _format_counts()
    assert counts == {"format_native": 1}
    assert payload == (FIXTURES / "inst0.out").read_text()
    monkeypatch.setattr(_native, "_load", lambda: None)
    fallback, counts = _format_counts()
    assert counts == {"format_native": 0}
    assert fallback == payload


def _cc(out: str, *sources: str) -> None:
    cc = shutil.which("cc") or shutil.which("gcc") or shutil.which("clang")
    assert cc, "no C compiler"
    subprocess.run([cc, "-O1", "-shared", "-fPIC", "-o", out, *sources, "-lm"], check=True,
                   capture_output=True, timeout=120)


@pytest.fixture
def private_library(tmp_path, monkeypatch):
    """The loader pointed at a library under ``tmp_path``, nothing loaded."""
    so = str(tmp_path / "librecsys_native.so")
    monkeypatch.setattr(_native, "_SO", so)
    monkeypatch.setattr(_native, "_HOSTSIG", so + ".host")
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_failed", False)
    monkeypatch.setattr(_native, "_format", None)
    with open(so + ".host", "w") as f:
        f.write(_native._host_signature())
    return so


def test_a_library_older_than_the_format_source_is_rebuilt(private_library, tmp_path, monkeypatch):
    src = str(tmp_path / "recsys_native.c")
    fmt = str(tmp_path / "recsys_format.c")
    shutil.copy(_native._SRC, src)
    shutil.copy(_native._FORMAT_SRC, fmt)
    monkeypatch.setattr(_native, "_SRC", src)
    monkeypatch.setattr(_native, "_FORMAT_SRC", fmt)
    _cc(private_library, src)  # the cached library: no rs_format_top1
    t = os.path.getmtime(fmt)
    os.utime(src, (t - 200, t - 200))
    os.utime(private_library, (t - 100, t - 100))
    assert _native.available()
    assert os.path.getmtime(private_library) > t - 100
    assert _native._format is not None
    top1, counts, items = _random(400, 37)
    phases: dict = {}
    with timing.collect_phases(phases):
        got = writers.format_recommendations(top1, counts, items)
    assert timing.record_of(phases).counts == {"format_native": 1}
    assert got == jax_writers.format_recommendations(top1, counts, items)


def test_a_library_without_the_format_entry_still_parses_natively(private_library):
    _cc(private_library, _native._SRC)
    t = max(os.path.getmtime(_native._SRC), os.path.getmtime(_native._FORMAT_SRC)) + 100
    os.utime(private_library, (t, t))
    assert _native.available() and not _native._failed
    assert _native._format is None
    path = str(FIXTURES / "instML100k.in")
    spec = _native.load_problem(path)
    assert spec is not None
    want = parser.load_problem(path)
    np.testing.assert_array_equal(spec.rows, want.rows)
    np.testing.assert_array_equal(spec.vals, want.vals)
    assert os.path.getmtime(private_library) == t  # not rebuilt
    top1 = np.random.default_rng(2).integers(0, spec.items, spec.users).astype(np.int32)
    phases: dict = {}
    with timing.collect_phases(phases):
        got = writers.format_recommendations(top1, spec.rated_counts(), spec.items)
    assert timing.record_of(phases).counts == {"format_native": 0}
    assert got == jax_writers.format_recommendations(top1, spec.rated_counts(), spec.items)
