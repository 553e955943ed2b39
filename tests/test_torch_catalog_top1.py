"""The top-1 over a wide catalog, on the CPU: a small copy of the
benchmark configuration ``inst1000-1e6`` (the reference's instance
``inst1000-1e6-1000-1-3``: few users, a million items, k = 1000) run
through the CLI on the f32 ``bell`` route and judged against the cell's
limits; the ``rated`` and ``scan`` spans and the ``scan_blocks`` count of
``trainer.recommend``; the configuration's route at its full shape; and
the readers ``scan_s`` and ``scan_roofline``."""

import contextlib
import io
import types

import numpy as np
import pytest
import torch

from perfbench import datagen, judge, reference, registry
from recsys_tpu_torch import cli
from recsys_tpu_torch.config import ProblemSpec, RunConfig
from recsys_tpu_torch.engine import trainer
from recsys_tpu_torch.models.mf import MFState
from recsys_tpu_torch.utils import timing

CELL = "inst1000-1e6.f32"
USERS, ITEMS, K = 8, 40_000, 64
BLOCKS = (4096, 128)  # the CLI's default block, and one that cuts the catalog into 313 blocks


def _wide_instance(seed: int = 26) -> datagen.Instance:
    """8 users x 40,000 items, 1-3 distinct uniform items a user, values
    1-5, 10 iterations at alpha 1e-5, k = 64."""
    rng = np.random.default_rng(seed)
    per = rng.integers(1, 4, USERS)
    rows = np.repeat(np.arange(USERS, dtype=np.int64), per)
    cols = np.concatenate([rng.choice(ITEMS, n, replace=False) for n in per]).astype(np.int64)
    vals = rng.integers(1, 6, rows.size).astype(np.float64)
    rows, cols, vals = datagen.sorted_row_major(ITEMS, rows, cols, vals)
    return datagen.Instance(10, 1e-5, K, USERS, ITEMS, rows, cols, vals)


def _spec_of(inst) -> ProblemSpec:
    return ProblemSpec(iters=inst.iters, alpha=inst.alpha, features=inst.features, users=inst.users,
                       items=inst.items, rows=inst.rows.astype(np.int32), cols=inst.cols.astype(np.int32),
                       vals=inst.vals.copy())


def _cli_run(path: str, block: int, traced: bool):
    """(stdout, the factors handed to ``recommend``, the job's record or
    None) of one f32 ``bell`` CLI job on the CPU, the initial factors drawn
    by the device init's twin as on the card."""
    got = {}
    recommend = trainer.recommend

    def tapped(state, *args, **kwargs):
        got["L"], got["R"] = state.L.clone(), state.R.clone()
        return recommend(state, *args, **kwargs)

    argv = ["run", path, "--device", "cpu", "--dtype", "float32", "--path", "bell", "--no-time",
            "--block-items", str(block)]
    phases: dict = {}
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer, "recommend", tapped)
        mp.setattr(trainer, "DEVICE_INIT_MIN_DRAWS", 0)
        collect = timing.collect_phases(phases) if traced else contextlib.nullcontext()
        with collect, contextlib.redirect_stdout(buf):
            assert cli.main(argv) == 0
    return buf.getvalue(), (got["L"], got["R"]), timing.record_of(phases) if traced else None


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    """The instance, its reference (L, R) and scores, and a traced and an
    untraced job at each block size."""
    inst = _wide_instance()
    path = str(tmp_path_factory.mktemp("wide") / "wide.in")
    with open(path, "w") as f:
        f.write(datagen.format_in(inst))
    ref = reference.solve(inst, device="cpu", dtype=torch.float64)
    runs = {b: (_cli_run(path, b, True), _cli_run(path, b, False)) for b in BLOCKS}
    return inst, ref, reference.scores(*ref, inst), runs


@pytest.mark.parametrize("block", BLOCKS)
def test_the_wide_instance_is_inside_the_cells_limits(wide, block):
    inst, ref, B, runs = wide
    (out, (L, R), _), _ = runs[block]
    values = {"factor_gap": judge.factor_gap([("rows", L, R)], ref, inst),
              "top1_gap": judge.top1_gap([out], B, inst), "failed_jobs": 0.0}
    ok, checked = judge.checks(values, judge.load_limits(registry.ROOT, CELL))
    assert ok, checked


@pytest.mark.parametrize("block", BLOCKS)
def test_rated_and_scan_sit_inside_top1_and_count_the_blocks(wide, block):
    inst, _, _, runs = wide
    (_, _, job), _ = runs[block]
    top1 = [i for i, s in enumerate(job.spans) if s.name == "top1"]
    assert len(top1) == 1
    by_name = {s.name: s for s in job.spans if s.name in ("rated", "scan")}
    assert set(by_name) == {"rated", "scan"} and all(s.parent == top1[0] for s in by_name.values())
    rated, scan = by_name["rated"], by_name["scan"]
    assert rated.start < rated.end <= scan.start < scan.end
    step = trainer._top1_block(_spec_of(inst), block)
    blocks = -(-ITEMS // step)
    assert scan.counts == {"scan_blocks": blocks} and job.counts["scan_blocks"] == blocks
    assert blocks == (313 if block == 128 else 10)


@pytest.mark.parametrize("block", BLOCKS)
def test_the_top1_is_the_same_traced_and_untraced(wide, block):
    _, _, _, runs = wide
    (out_t, (Lt, Rt), _), (out_u, (Lu, Ru), job) = runs[block]
    assert job is None and out_t == out_u
    for a, b in ((Lt, Lu), (Rt, Ru)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_no_span_opens_outside_a_collector(monkeypatch):
    inst = _wide_instance(7)
    opened = []
    init = timing._Range.__init__

    def counted(self, *args):
        opened.append(args[0])
        init(self, *args)

    monkeypatch.setattr(timing._Range, "__init__", counted)
    n = len(timing._LOG)
    spec = _spec_of(inst)
    state = MFState(L=np.ones((USERS, K), np.float32), R=np.ones((ITEMS, K), np.float32))
    trainer.recommend(state, spec, RunConfig(dtype="float32"), "cpu")
    assert opened == [] and len(timing._LOG) == n


@pytest.mark.parametrize("users_rated", [(), (127,), (127, 128)])
def test_a_tie_across_a_block_edge_goes_to_the_lower_item(users_rated):
    """Items 127 and 128 score the same, highest (integer factors, exact
    products); 128 opens the second block of 128."""
    items, k = 300, 4
    L = np.ones((1, k), np.float32)
    R = np.ones((items, k), np.float32)
    R[127] = R[128] = 10.0
    cols = np.array(users_rated, np.int32)
    spec = ProblemSpec(iters=1, alpha=1e-5, features=k, users=1, items=items, rows=np.zeros(cols.size, np.int32),
                       cols=cols, vals=np.ones(cols.size))
    got = trainer.recommend(MFState(L=L, R=R), spec, RunConfig(dtype="float32", block_items=128), "cpu")
    want = {(): 127, (127,): 128, (127, 128): 0}[users_rated]
    assert got.tolist() == [want]


def _config() -> dict:
    return registry.load_json(f"{registry.ROOT}/perfbench/configs/inst1000-1e6.json")


@pytest.mark.parametrize("seed", [0, 1])
def test_the_configuration_keeps_every_rating(seed):
    cfg = _config()
    inst = datagen.make(cfg, seed, registry.ROOT)
    src = datagen.make(cfg, 0, registry.ROOT)
    assert (inst.users, inst.items, inst.features, inst.iters, inst.nnz) == (1000, 1_000_000, 1000, 10, 2014)
    assert inst.alpha == 1e-5 and cfg["reduced"] == []
    assert np.array_equal(np.sort(inst.vals), np.sort(src.vals))
    for a, b, n in ((inst.rows, src.rows, inst.users), (inst.cols, src.cols, inst.items)):
        assert np.array_equal(np.sort(np.bincount(a, minlength=n)), np.sort(np.bincount(b, minlength=n)))
    assert np.all(np.diff(inst.rows * inst.items + inst.cols) > 0)  # row-major, no cell twice
    assert (np.count_nonzero(np.bincount(inst.rows)), np.count_nonzero(np.bincount(inst.cols))) == (822, 2013)


def test_the_full_configuration_takes_bell_with_the_device_init():
    spec = _spec_of(datagen.make(_config(), 1, registry.ROOT))
    run = RunConfig(dtype="float32", precision="highest", path="auto")  # the f32 mix
    assert trainer.choose_path(spec, run, torch.device("cuda")) == "bell"
    assert trainer._device_init(spec, run, None)
    assert (spec.users + spec.items) * spec.features == 1_001_000_000
    assert trainer._top1_block(spec, RunConfig.block_items) == 4096  # 245 blocks over the catalog


def _span(name, start, end):
    return types.SimpleNamespace(name=name, start=start, end=end, parent=None, counts=None)


def _readings(monkeypatch, spans: list) -> dict:
    jobs = [{"wall": 1.0, "ok": True, "phases": {"top1": 0.2}} for _ in spans]
    by_id = {id(j["phases"]): types.SimpleNamespace(phases=j["phases"], spans=s, counts={})
             for j, s in zip(jobs, spans)}
    monkeypatch.setattr(timing, "record_of", lambda out: by_id.get(id(out)))
    return {"jobs": jobs, "dtype": "float32",
            "instance": {"users": 1000, "items": 1_000_000, "features": 1000}}


@pytest.mark.parametrize("name", ["scan_s", "scan_roofline"])
def test_the_readers_read_none_without_the_span(monkeypatch, name):
    readings = _readings(monkeypatch, [[_span("top1", 0.0, 0.2), _span("rated", 0.0, 0.01)]])
    assert registry.reader(name)(readings) is None


def test_the_readers_over_known_spans(monkeypatch):
    spans = [[_span("rated", 0.0, 0.01), _span("scan", 0.01, 0.01 + t)] for t in (0.10, 0.15, 0.30)]
    readings = _readings(monkeypatch, spans)
    assert registry.reader("scan_s")(readings) == pytest.approx(0.15)
    floor = 2 * 1000 * 1000 * 1e6 / 67e12  # operations over the f32 peak: 29.9 ms, above R's 4 GB read once
    assert floor > 4 * 1e6 * 1000 / 3.35e12
    assert registry.reader("scan_roofline")(readings) == pytest.approx(100 * floor / 0.15)
