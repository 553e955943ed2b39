"""The check at the shape of the reference's cluster instance
``inst1e6-100-700-1-3`` (1,000,000 users x 100 items, 1-3 ratings a user,
k = 700, 10 iterations, alpha = 1e-5), on the card:

* the reference's glibc stream (``glibc.py``) word for word against the
  program's device stream over all 700,070,000 words, and its float64
  draws at three far offsets against numpy's quotient;
* a whole run of a throwaway cell at that shape (an instance made with
  numpy, the float32 ``bell`` route, which draws its initial factors on
  the card): the reference and the judge of 5 captures within 120 s and
  16 GB of peak host RSS (the process's peak, window and all), a finite
  ``factor_gap``, and a planted 0-step fault reading above it.

Run with ``python -m pytest perfbench/tests -q -m cuda -s`` on a card; the
readings are printed.
"""

import contextlib
import io
import json
import os
import re
import time

import numpy as np
import pytest

from perfbench import faults, glibc, registry, run
from perfbench.taps import Sink
from perfbench.tests.pb_helpers import tiny_root

USERS, ITEMS, K, ITERS, ALPHA = 1_000_000, 100, 700, 10, 1e-5
SEED = 0  # the recipe's count of ratings varies with the seed; the configuration states seed 0's
WINDOW_S = 20.0  # about 15 jobs of 1.4 s: the 4 sampled and the last are judged
CHECK_S = 120.0
HOST_RSS_BYTES = 16 * 10**9

RECIPE = """
import numpy as np

from perfbench.datagen import Instance, rng_for, sorted_row_major


def make(cfg, seed, root, device="cpu"):
    # 1-3 distinct items a user, uniform; values 1-5
    rng = rng_for(seed)
    users, items = cfg["users"], cfg["items"]
    a = rng.integers(0, items, users)
    b = rng.integers(0, items - 1, users)
    b += b >= a
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    c = rng.integers(0, items - 2, users)
    c += c >= lo
    c += c >= hi
    keep = np.arange(3)[None, :] < rng.integers(1, 4, users)[:, None]
    rows = np.repeat(np.arange(users, dtype=np.int64)[:, None], 3, axis=1)[keep]
    cols = np.stack([a, b, c], axis=1)[keep]
    vals = rng.integers(1, 6, rows.size).astype(np.float64)
    rows, cols, vals = sorted_row_major(items, rows, cols, vals)
    return Instance(cfg["iters"], cfg["alpha"], cfg["features"], users, items, rows, cols, vals)
"""


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch


@pytest.mark.cuda
def test_the_stream_equals_the_programs_device_stream(card):
    from recsys_tpu_torch.ops.device_rng import DeviceGlibcStream

    torch = card
    n = (USERS + ITEMS) * K
    ours = glibc.words(n, 0, "cuda")
    assert bool(torch.equal(ours, DeviceGlibcStream(0, device="cuda").raw32(n) >> 1))
    L, R = glibc.initial_factors(USERS, ITEMS, K, device="cuda")
    draws = {0: L.reshape(-1)[:1000], 350_000_000 - 500: L.reshape(-1)[350_000_000 - 500:350_000_000 + 500],
             n - 1000: R.T.reshape(-1)[-1000:]}
    for start, got in draws.items():
        w = ours[start:start + got.numel()].cpu().numpy()
        assert np.array_equal(got.cpu().numpy(), w / glibc.RAND_MAX / K), start
    print(f"stream: {n} words equal the program's; draws equal at offsets {sorted(draws)}")


def _write(path: str, text: str) -> None:
    with open(path, "w") as f:
        f.write(text)


@pytest.fixture(scope="module")
def big_root(tmp_path_factory):
    """A benchmark root with the cell ``big.bell32``: the instance above on
    the float32 ``bell`` route (the throwaway limits are ``ml100k.f32``'s;
    this test reads the values, not ``correct``)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = tiny_root(str(tmp_path_factory.mktemp("pb")))
    pb = os.path.join(root, "perfbench")
    _write(os.path.join(pb, "recipes", "uniform_rows.py"), RECIPE)
    cfg = {"name": "big", "users": USERS, "items": ITEMS, "ratings": 0, "features": K, "iters": ITERS,
           "alpha": ALPHA, "data": {"recipe": "uniform_rows"}, "reduced": [], "assumed": []}
    cfg["ratings"] = registry.recipe("uniform_rows", root)(cfg, SEED, root).nnz
    _write(os.path.join(pb, "configs", "big.json"), json.dumps(cfg))
    mix = registry.load_json(os.path.join(pb, "traffic", "f32.json"))
    mix["path"] = "bell"
    _write(os.path.join(pb, "traffic", "bell32.json"), json.dumps(mix))
    _write(os.path.join(pb, "limits", "big.bell32.json"),
           open(os.path.join(pb, "limits", "ml100k.f32.json")).read())
    bench = registry.benchmark(root)
    bench["configs"].append({"name": "big", "source": "https://example.org/big", "file": "perfbench/configs/big.json",
                             "reduced": [], "why": "a card test"})
    bench["workloads"].append({"name": "big.bell32", "config": "big", "traffic": "bell32", "chips": 1,
                               "why": "a card test"})
    _write(os.path.join(root, "BENCHMARK.json"), json.dumps(bench))
    return root


def _five_captures(sink) -> list:
    """The 4 sampled jobs' captures and the last job's, the last judged
    again where the sample holds it: 5 whatever the draw."""
    return list(sink.kept.values()) + ([sink.last] if sink.last is not None else [])


def _run(root: str, seconds: float) -> tuple[dict, str]:
    err = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stderr(err):
        mp.setattr(Sink, "captures", _five_captures)
        r = run.run_cell(registry.cell("big.bell32", root), SEED, seconds, False, device="cuda", root=root,
                         t0=time.perf_counter())
    return r, err.getvalue()


@pytest.fixture(scope="module")
def sound(big_root):
    return _run(big_root, WINDOW_S)


@pytest.mark.cuda
def test_a_1m_user_run_is_judged_in_time_and_memory(sound):
    r, err = sound
    judged = int(re.search(r"check: factors of (\d+) job", err).group(1))
    m = re.search(r"reference_s ([^,]+), judge_s (\S+) .*host RSS peak (\d+) B", err)
    ref_s, judge_s, rss = float(m.group(1)), float(m.group(2)), int(m.group(3))
    print(f"inst1e6 shape: {r['attempted']} job(s), {judged} judged; reference_s {ref_s!r}, judge_s {judge_s!r}, "
          f"host RSS peak {rss} B; memory_peak_bytes {r['device']['memory_peak_bytes']}; checks {r['checks']}")
    assert r["attempted"] >= 5 and r["failed"] == 0 and judged == 5
    assert r["checks"]["factor_gap"]["value"] < 1e300 and r["checks"]["top1_gap"]["value"] < 1e300
    assert ref_s + judge_s <= CHECK_S and rss <= HOST_RSS_BYTES


@pytest.mark.cuda
def test_a_0_step_fault_reads_above_the_sound_run(big_root, sound):
    undo = faults.plant("unchanged")
    try:
        r, _ = _run(big_root, 1.0)
    finally:
        undo()
    got, sound_gap = r["checks"]["factor_gap"]["value"], sound[0]["checks"]["factor_gap"]["value"]
    print(f"inst1e6 shape: factor_gap sound {sound_gap!r}, 0 steps {got!r}")
    assert got > sound_gap
