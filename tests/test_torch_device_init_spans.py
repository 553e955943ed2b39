"""The device init's spans: ``init`` and ``permute`` inside ``upload``,
recorded only where the f32 and bf16 BELL routes draw the initial factors
on the device, with the factors' bits unchanged; the route of the benchmark
configuration ``inst1e6`` (the reference's 1M-user instance), a small copy
of it judged against the cell's limits, and the readers ``init_s`` and
``init_roofline`` over the spans."""

import numpy as np
import pytest
import torch

from perfbench import datagen, judge, reference, registry
from recsys_tpu_torch.config import ProblemSpec, RunConfig
from recsys_tpu_torch.engine import trainer
from recsys_tpu_torch.utils import timing

F32_BELL = RunConfig(dtype="float32", path="bell")
BF16_BELL = RunConfig(dtype="bfloat16", path="bell")


def _spec(users: int, items: int = 100, features: int = 700, seed: int = 21) -> ProblemSpec:
    """The shape of the reference's 1M-user instance at ``users`` rows: 1-3
    distinct uniform items a user, values 1-5, sorted row-major, 10
    iterations at alpha 1e-5."""
    rng = np.random.default_rng(seed)
    per = rng.integers(1, 4, users)
    first = rng.integers(0, items, users)
    steps = rng.integers(1, items // 3, (users, 2)).cumsum(axis=1)
    table = np.concatenate([first[:, None], first[:, None] + steps], axis=1) % items
    keep = np.arange(3)[None, :] < per[:, None]
    cols = np.sort(np.where(keep, table, items), axis=1)[keep]
    rows = np.repeat(np.arange(users), per)
    return ProblemSpec(iters=10, alpha=1e-5, features=features, users=users, items=items,
                       rows=rows.astype(np.int32), cols=cols.astype(np.int32),
                       vals=rng.integers(1, 6, rows.size).astype(np.float64))


def _run(spec, traced: bool, cfg: RunConfig = F32_BELL):
    """(payload, the factors handed to ``recommend``, the job's record)."""
    got = {}
    recommend = trainer.recommend

    def tapped(state, *args, **kwargs):
        got["L"], got["R"] = state.L.clone(), state.R.clone()
        return recommend(state, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer, "recommend", tapped)
        phases: dict = {}
        if traced:
            with timing.collect_phases(phases):
                payload, _ = trainer.run(spec, cfg, "cpu")
        else:
            payload, _ = trainer.run(spec, cfg, "cpu")
    return payload, (got["L"], got["R"]), timing.record_of(phases) if traced else None


@pytest.fixture(scope="module")
def small():
    return _spec(300)


@pytest.fixture(scope="module")
def on_device(small):
    """Traced and untraced f32 runs with the device init taken at any size."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer, "DEVICE_INIT_MIN_DRAWS", 0)
        assert trainer._device_init(small, F32_BELL, None)
        return _run(small, True), _run(small, False)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}[t.dtype])


def test_the_device_init_records_init_and_permute_inside_upload(on_device):
    (_, _, job), _ = on_device
    names = [s.name for s in job.spans]
    upload = names.index("upload")
    by_name = {s.name: s for s in job.spans}
    for name in ("init", "permute"):
        assert names.count(name) == 1 and by_name[name].parent == upload
    init, permute = by_name["init"], by_name["permute"]
    assert init.start < init.end <= permute.start < permute.end <= job.spans[upload].end
    assert set(job.phases) == {"prep", "upload", "train", "top1"}


def test_the_init_span_counts_the_stream_kernels_launches(on_device):
    # On the CPU the twin draws, and the count says no kernel ran.
    (_, _, job), _ = on_device
    init = next(s for s in job.spans if s.name == "init")
    assert init.counts == {"init_launches": 0} and job.counts["init_launches"] == 0


def test_the_spans_leave_the_factors_bits(on_device):
    (out_t, (Lt, Rt), _), (out_u, (Lu, Ru), _) = on_device
    assert out_t == out_u
    for a, b in ((Lt, Lu), (Rt, Ru)):
        assert a.dtype == torch.float32 and torch.equal(_bits(a), _bits(b))


def test_the_spans_open_profiler_ranges(small):
    """Under ``torch.profiler`` the two spans are ``phase:`` ranges, which
    name the device's idle gaps in a traced run."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer, "DEVICE_INIT_MIN_DRAWS", 0)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            trainer.run(small, F32_BELL, "cpu")
    names = {e.key for e in prof.key_averages()}
    assert {"phase:upload", "phase:init", "phase:permute"} <= names


def test_the_host_init_records_no_init(small):
    assert not trainer._device_init(small, F32_BELL, None)
    _, _, job = _run(small, True)
    names = {s.name for s in job.spans}
    assert "upload" in names and not names & {"init", "permute"}


def test_bf16_device_init_records_the_spans_and_keeps_its_bits(small):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer, "DEVICE_INIT_MIN_DRAWS", 0)
        out_t, (Lt, Rt), job = _run(small, True, BF16_BELL)
        out_u, (Lu, Ru), _ = _run(small, False, BF16_BELL)
    names = [s.name for s in job.spans]
    assert names.count("init") == 1 and names.count("permute") == 1
    assert out_t == out_u
    for a, b in ((Lt, Lu), (Rt, Ru)):
        assert a.dtype == torch.bfloat16 and torch.equal(_bits(a), _bits(b))


def _config(**small) -> dict:
    cfg = registry.load_json(f"{registry.ROOT}/perfbench/configs/inst1e6.json")
    cfg.update(small)
    return cfg


def _spec_of(inst) -> ProblemSpec:
    return ProblemSpec(iters=inst.iters, alpha=inst.alpha, features=inst.features, users=inst.users,
                       items=inst.items, rows=inst.rows.astype(np.int32), cols=inst.cols.astype(np.int32),
                       vals=inst.vals.copy())


def test_the_full_configuration_takes_bell_with_the_device_init():
    spec = _spec_of(datagen.make(_config(), 5, registry.ROOT))
    assert (spec.users, spec.items, spec.features, spec.nnz) == (1_000_000, 100, 700, 2_000_000)
    run = RunConfig(dtype="float32", precision="highest", path="auto")  # the f32 mix
    assert trainer.choose_path(spec, run, torch.device("cuda")) == "bell"
    assert (spec.users + spec.items) * spec.features >= trainer.DEVICE_INIT_MIN_DRAWS
    assert trainer._device_init(spec, run, None)
    assert not trainer._device_init(spec, RunConfig(dtype="float64"), None)


@pytest.fixture(scope="module")
def small_cell():
    """A small copy of the configuration (300 x 100, 600 ratings, k = 700,
    its 10 iterations and alpha), its instance, and a traced f32 run of it
    with the device init taken at any size."""
    inst = datagen.make(_config(users=300, ratings=600), 2**33 + 21, registry.ROOT)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer, "DEVICE_INIT_MIN_DRAWS", 0)
        return inst, _run(_spec_of(inst), True)


def test_the_device_init_run_is_inside_the_cells_limits(small_cell):
    inst, (payload, (L, R), _) = small_cell
    ref_L, ref_R = reference.solve(inst, device="cpu", dtype=torch.float64)
    values = {"factor_gap": judge.factor_gap([("rows", L, R)], (ref_L, ref_R), inst),
              "top1_gap": judge.top1_gap([payload], reference.scores(ref_L, ref_R, inst), inst),
              "failed_jobs": 0.0}
    ok, checked = judge.checks(values, judge.load_limits(registry.ROOT, "inst1e6.f32"))
    assert ok, checked


def _readings(records: list, inst) -> dict:
    return {"jobs": [{"wall": 1.0, "ok": True, "phases": r.phases} for r in records],
            "instance": {"users": inst.users, "items": inst.items, "features": inst.features}}


def test_the_readers_read_none_without_the_span_and_a_share_with_it(small_cell):
    inst, (_, _, job) = small_cell
    init_s, init_roofline = registry.reader("init_s"), registry.reader("init_roofline")
    _, _, host_job = _run(_spec_of(inst), True)
    without = _readings([host_job], inst)
    assert init_s(without) is None and init_roofline(without) is None
    seconds = init_s(_readings([job], inst))
    init = next(s for s in job.spans if s.name == "init")
    assert seconds == init.end - init.start > 0
    share = init_roofline(_readings([job], inst))
    floor = 4 * (inst.users + inst.items) * inst.features / 3.35e12
    assert 0 < share < 100 and share == pytest.approx(100 * floor / seconds)
