"""B4's tiled form against the dense form it replaced on the card: the same
bits, and which is faster.

    python -m recsys_tpu_torch.probes.top1_tiled

Run from the root of a checkout on a machine with a CUDA card.  At the
small spec (k = 10, 40 and 256: G = 1, 2 and 8), at instML100k and at
gen-instML1M's shape (built in memory from ``GEN_SPECS``), in every
precision and A storage, it trains the factors ``testing.FACTOR_ITERS``
steps (B3, the stream plan's steps) and holds ``dense_stream.stream_top1``'s
tiled form (the engine's) equal to its dense form in raw bits: each user's
index and best score (``stream_top1_scores``).  Then the all-ones tie case
in both forms.  Then it times, at gen-instML1M in `highest`, the tiled form
against the dense form, in turns in one window: each call replayed
``CALLS`` times from a CUDA graph (``timing.graphed``), so the time is the
device's alone, both launches of a form (pass and merge) included.  A
replay launches kernels without calling the wrappers, so the launch counts
of a probe run are those of its bit checks (``bits``).  Beside
them it logs one reference composition, ``torch.mm`` in true f32, then
``where`` and ``argmax``: no single PyTorch call computes the function.
"""

from __future__ import annotations

import subprocess
import sys

import torch

from recsys_tpu_torch import testing as checks
from recsys_tpu_torch.ops import dense_fused, dense_stream
from recsys_tpu_torch.probes import resident_sparse
from recsys_tpu_torch.utils.timing import alternating_ms, graphed

MODES = ("highest", "bf16x3", "default")
STORAGES = (torch.int8, torch.bfloat16, torch.float32)
# Calls of a form replayed from one CUDA graph in a timed window.
CALLS = 20


def shapes() -> dict:
    """The specs of the bit checks, by name."""
    return {f"small k{k}": resident_sparse.small_spec(k) for k in (10, 40, 256)} | {
        "instML100k": resident_sparse.ml100k_spec(), "gen-instML1M": resident_sparse.ml1m_spec()}


def trained(spec, device, precision, a_dtype=torch.int8):
    """(Lt, Rt, At): the padded glibc factors after ``FACTOR_ITERS`` steps
    of B3 in ``precision``, and A^T in ``a_dtype``."""
    Lt, Rt, (U, I, _) = dense_fused.pad_factors_for_pallas(spec)
    At = dense_fused.device_dense_AT(spec, U, I, a_dtype, device)
    Lt, Rt = torch.from_numpy(Lt).to(device), torch.from_numpy(Rt).to(device)
    Lt, Rt = dense_stream.stream_train(Lt, Rt, At, iters=checks.FACTOR_ITERS, alpha2=2.0 * spec.alpha,
                                       precision=precision)
    return Lt, Rt, At


def same_forms(Lt, Rt, At, precision, items_true):
    """(tiled = dense in raw bits, indices equal the plain twin's, the tiled
    form's (top1, best))."""
    kw = dict(precision=precision, items_true=items_true)
    tiled = dense_stream.stream_top1_scores(Lt, Rt, At, form="tiled", **kw)
    dense = dense_stream.stream_top1_scores(Lt, Rt, At, form="dense", **kw)
    twin = dense_stream.stream_top1_plain(Lt, Rt, At, **kw)
    torch.cuda.synchronize()
    same = torch.equal(tiled[0], dense[0]) and checks.same_bits(tiled[1], dense[1])
    return same, torch.equal(tiled[0], twin), tiled


def check(name, spec, device) -> dict:
    """Both forms in every precision x A storage: {(precision, storage):
    (= dense in raw bits, = twin)}.  Raises on a failure."""
    out, failed = {}, []
    for precision in MODES:
        for a_dtype in STORAGES:
            Lt, Rt, At = trained(spec, device, precision, a_dtype)
            same, twin, _ = same_forms(Lt, Rt, At, precision, spec.items)
            storage = str(a_dtype).split(".")[-1]
            print(f"[probe] B4 tiled vs dense {name} ({Lt.shape[1]}x{At.shape[0]} K={Lt.shape[0]}, A {storage}) "
                  f"{precision:7s}: index and best score = dense in raw bits {same} | index = twin {twin} "
                  f"{'ok' if same else 'FAIL'}", flush=True)
            out[precision, storage] = (same, twin)
            if not same:
                failed.append(f"{precision} {storage}")
    if failed:
        raise AssertionError(f"B4 tiled vs dense {name}: {failed}")
    return out


def tie_case(device) -> bool:
    """All-ones factors and no rating: every score ties, item 0 must win."""
    K, U = 8, 128
    ones, zeros = torch.ones((K, U), device=device), torch.zeros((U, U), device=device)
    same, _, (top, _) = same_forms(ones, ones, zeros, "highest", U)
    ok = same and bool((top == 0).all())
    print(f"[probe] B4 all-ones tie case: both forms -> all zeros, bits alike {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("B4 tie case: the lowest index must win in both forms")
    return ok


def timings(spec, device, rounds: int = 5) -> dict:
    """{form: ms a call} at ``spec``'s shape in `highest`, in turns: the
    dense form, the tiled form (the engine's) and the reference
    composition, logged."""
    Lt, Rt, At = trained(spec, device, "highest")
    U, I = Lt.shape[1], Rt.shape[1]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    kw = dict(precision="highest", items_true=spec.items)
    calls = {"dense": lambda: dense_stream.stream_top1_dense(Lt, Rt, At, **kw),
             "tiled": lambda: dense_stream.stream_top1(Lt, Rt, At, **kw)}
    a = dense_fused.load_at(At)
    item = torch.arange(I, device=device)[:, None]

    def composition():
        with dense_fused.exact_f32(device):
            b = torch.mm(Rt.T, Lt)
        return torch.argmax(torch.where((a != 0) | (item >= spec.items), -torch.inf, b), dim=0)

    calls["torch.mm + where + argmax"] = composition
    ms = alternating_ms({name: graphed(fn, CALLS) for name, fn in calls.items()}, rounds)
    out = {name: t / CALLS for name, t in ms.items()}
    engine = dense_fused.top1_split(U, I, sms)
    for name, t in out.items():
        print(f"[probe] B4 {name} at gen-instML1M (highest): {t!r} ms a call (graph of {CALLS}, in turns)"
              + (f" | engine split {engine}" if name == "tiled" else ""), flush=True)
    print(f"[probe] B4 dense / tiled: {out['dense'] / out['tiled']!r}x", flush=True)
    return out


def bits(device) -> dict:
    """The checks at every shape and the tie case: {shape: readings}."""
    readings = {name: check(name, spec, device) for name, spec in shapes().items()}
    tie_case(device)
    return readings


def run(device) -> tuple[dict, dict]:
    """``bits``, then the timings; returns ({shape: readings}, {form: ms a
    call})."""
    return bits(device), timings(resident_sparse.ml1m_spec(), device)


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("top1_tiled: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[probe] {smi}", flush=True)
    run(torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
