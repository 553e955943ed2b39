"""The port's own copies of the JAX package's host modules
(recsys_tpu_torch/config.py, io/, models/mf.py, engine/oracle.py,
utils/hostmem.py) against their originals, on the same inputs.

Each copy must give the original's result exactly: these modules decide
the glibc draw order, the parse and the stdout bytes, so any difference
would show as a golden mismatch.
"""

import dataclasses
import os
import time

import numpy as np
import pytest

from helpers import FIXTURES
from recsys_tpu import config as jax_config
from recsys_tpu.engine import oracle as jax_oracle
from recsys_tpu.io import _native as jax_native
from recsys_tpu.io import generator as jax_generator
from recsys_tpu.io import glibc_random as jax_glibc
from recsys_tpu.io import parser as jax_parser
from recsys_tpu.io import writers as jax_writers
from recsys_tpu.models import mf as jax_mf
from recsys_tpu_torch import config
from recsys_tpu_torch.engine import oracle
from recsys_tpu_torch.io import _native, generator, glibc_random, parser, writers
from recsys_tpu_torch.models import mf
from recsys_tpu_torch.utils import hostmem


def _spec_fields(spec):
    return {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}


def _assert_specs_equal(got, want):
    assert type(got) is config.ProblemSpec
    g, w = _spec_fields(got), _spec_fields(want)
    assert g.keys() == w.keys()
    for name in g:
        if isinstance(w[name], np.ndarray):
            assert g[name].dtype == w[name].dtype, name
            np.testing.assert_array_equal(g[name], w[name], err_msg=name)
        else:
            assert g[name] == w[name], name


@pytest.mark.parametrize("users,items,k", [(3, 4, 2), (50, 70, 7), (943, 1682, 30)])
def test_init_factors_bit_equal(users, items, k):
    got, want = mf.init_factors(users, items, k), jax_mf.init_factors(users, items, k)
    assert got.L.dtype == want.L.dtype == np.float64
    np.testing.assert_array_equal(got.L, want.L)
    np.testing.assert_array_equal(got.R, want.R)


def test_glibc_stream_equal():
    np.testing.assert_array_equal(glibc_random.GlibcRandom(7).rand01(1000),
                                  jax_glibc.GlibcRandom(7).rand01(1000))
    np.testing.assert_array_equal(glibc_random.rand01_sequence(5000, seed=0),
                                  jax_glibc.rand01_sequence(5000, seed=0))


@pytest.mark.parametrize("name", ["inst0", "instML100k"])
@pytest.mark.parametrize("how", ["load_problem", "parse_in_bytes"])
def test_parse_equal(name, how):
    path = str(FIXTURES / f"{name}.in")
    if how == "load_problem":
        got, want = parser.load_problem(path), jax_parser.load_problem(path)
    else:
        data = open(path, "rb").read()
        got, want = parser.parse_in_bytes(data), jax_parser.parse_in_bytes(data)
    _assert_specs_equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(users=30, items=40, features=5, min_nz_row=1, max_nz_row=6, iters=7, alpha=0.01, seed=3),
    dict(users=12, items=20, features=4, min_nz_row=11, max_nz_row=15, iters=3, alpha=0.002, seed=9),
])
def test_generate_instance_equal(kw):
    _assert_specs_equal(generator.generate_instance(**kw), jax_generator.generate_instance(**kw))


def test_gen_specs_equal():
    assert generator.GEN_SPECS == jax_generator.GEN_SPECS


def test_format_recommendations_byte_equal():
    spec = parser.load_problem(str(FIXTURES / "instML100k.in"))
    rng = np.random.default_rng(0)
    top1 = rng.integers(0, spec.items, size=spec.users).astype(np.int32)
    counts = spec.rated_counts()
    counts[::50] = spec.items  # users with every item rated are skipped
    got = writers.format_recommendations(top1, counts, spec.items)
    assert got == jax_writers.format_recommendations(top1, counts, spec.items)
    mat = rng.standard_normal((3, 4))
    assert writers.format_mats_block("Matrix L", mat) == jax_writers.format_mats_block("Matrix L", mat)


def _jax_serial_gd(spec, L, R, attempts=5, wait_s=1.0):
    """``recsys_tpu.io._native.serial_gd``, retried while its library is
    being built.  That loader compiles ``native/librecsys_native.so`` in
    place, so under several test workers one process can load another's
    half-written file: the load fails, the module sets ``_failed`` and
    ``serial_gd`` returns None for the rest of the process.  Each retry
    waits, clears the module's cached outcome and loads again; the result
    stays None only if every attempt failed."""
    for _ in range(attempts):
        out = jax_native.serial_gd(spec, L.copy(), R.copy())
        if out is not None:
            return out
        time.sleep(wait_s)
        with jax_native._lock:
            jax_native._lib, jax_native._failed = None, False
    return None


def test_serial_gd_bit_equal():
    spec = parser.load_problem(str(FIXTURES / "inst0.in"))
    st = mf.init_factors(spec.users, spec.items, spec.features)
    got = _native.serial_gd(spec, st.L.copy(), st.R.copy())
    want = _jax_serial_gd(spec, st.L, st.R)
    assert got is not None and want is not None
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_oracle_and_top1_equal():
    spec = generator.generate_instance(25, 30, 6, 2, 8, iters=15, alpha=0.01, seed=4)
    got, _ = oracle.factorize_numpy(spec)
    want, _ = jax_oracle.factorize_numpy(spec)
    np.testing.assert_array_equal(got.L, want.L)
    np.testing.assert_array_equal(oracle.top1_numpy(got.L, got.R, spec), jax_oracle.top1_numpy(want.L, want.R, spec))
    assert oracle.run_oracle(spec) == jax_oracle.run_oracle(spec)
    assert oracle.dump_mats(spec, record=2) == jax_oracle.dump_mats(spec, record=2)


def test_native_library_builds_inside_the_port():
    # The port builds its own copy of the C source into build/, never into native/.
    assert _native.available()
    assert _native._SRC.endswith(os.path.join("recsys_tpu_torch", "csrc", "recsys_native.c"))
    assert os.path.join("build", "recsys_tpu_torch") in _native._SO
    assert os.path.exists(_native._SO)
    with open(_native._SRC, "rb") as f, open(FIXTURES.parent.parent / "native" / "recsys_native.c", "rb") as g:
        ours, theirs = f.read(), g.read()
    assert theirs.split(b"*/", 1)[1] == ours.split(b"*/", 1)[1]  # same code below the header


def test_every_cuda_entry_has_one_signature():
    # ctypes calls each C entry of csrc/*.cu with the arguments that
    # ops/_build.SIGNATURES declares.  Nothing builds on the CPU, so an entry
    # the sources lost, or a signature whose arguments went stale, would
    # first show on a card.
    import re

    from recsys_tpu_torch.ops import _build

    entries = {}
    for src in _build.sources():
        with open(src) as f:
            for name, params in re.findall(r'extern "C" int (rs_\w+)\(([^)]*)\)\s*\{', f.read()):
                entries.setdefault(name, []).append(len(params.split(",")))
    assert {name: len(n) for name, n in entries.items() if len(n) != 1} == {}
    assert sorted(entries) == sorted(_build.SIGNATURES)
    assert {name: n[0] for name, n in entries.items()} == {name: len(a) for name, a in _build.SIGNATURES.items()}


def test_hostmem_buffers():
    a = hostmem.hugepage_zeros((1024, 2048), np.float32)  # pooled THP path (8 MB)
    assert a.shape == (1024, 2048) and not a.any()
    src = np.arange(12.0).reshape(6, 2)
    out = np.empty((3, 2), np.float32)
    np.testing.assert_array_equal(hostmem.take_cast(src, np.array([5, 0, 2]), out, chunk=2),
                                  src[[5, 0, 2]].astype(np.float32))


def test_run_config_defaults_equal():
    assert dataclasses.asdict(config.RunConfig()) == dataclasses.asdict(jax_config.RunConfig())


@pytest.mark.parametrize("module", ["ops/coo.py", "ops/device_rng.py", "ops/lane.py", "ops/stream_v2.py",
                                    "probes/gather.py", "probes/stream_v2.py", "engine/trainer.py", "ops/bell.py",
                                    "parallel/mesh.py", "parallel/sharding.py", "parallel/step.py",
                                    "parallel/engine.py", "parallel/multihost.py", "parallel/launch.py", "cli.py"])
def test_new_modules_import_neither_jax_nor_the_jax_package(module):
    import ast

    path = FIXTURES.parent.parent / "recsys_tpu_torch" / module
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    top = {n.split(".")[0] for n in names}
    assert not top & {"jax", "jaxlib", "recsys_tpu"}, top
