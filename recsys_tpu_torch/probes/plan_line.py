"""The resident/stream line on the card: B2's steps (the resident plan)
against B3's (the stream plan) at the two shapes either side of
``engine/trainer.py::RESIDENT_A_MAX_BYTES``, the size of A^T at which the
plan turns from one to the other.

    python -m recsys_tpu_torch.probes.plan_line

Run from the root of a checkout on a machine with a CUDA card.  At
instML100k (the resident side) and gen-instML1M (the stream side, built in
memory from ``GEN_SPECS``), in `highest`, it times ``resident_train`` and
``stream_train``, each with its walk built ahead as the engine builds it,
in turns in one window (CUDA events, medians) at 3 * n and n steps, and
prints each slope in us per step.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

from recsys_tpu_torch.ops import dense_fused, dense_stream
from recsys_tpu_torch.utils.timing import alternating_ms

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ML100K = os.path.join(ROOT, "tests", "fixtures", "instML100k.in")
# Steps of the slopes: a plan's time at 3 * n minus at n, over 2 * n.
ML100K_STEPS, ML1M_STEPS = 1000, 200


def ml100k_spec():
    from recsys_tpu_torch.io.parser import load_problem

    return load_problem(ML100K)


def ml1m_spec():
    from recsys_tpu_torch.io.generator import GEN_SPECS, generate_instance

    return generate_instance(**GEN_SPECS["gen-instML1M"])


def inputs(spec, device, a_dtype=torch.int8):
    """(Lt, Rt, At) of the resident plan on ``device``: the glibc factors, padded."""
    Lt, Rt, (U, I, _) = dense_fused.pad_factors_for_pallas(spec)
    At = dense_fused.device_dense_AT(spec, U, I, a_dtype, device)
    return torch.from_numpy(Lt).to(device), torch.from_numpy(Rt).to(device), At


def plan_slopes(name, spec, device, n: int, rounds: int = 5) -> dict:
    """{plan: {"ms": ms at 3n steps, "ms_n": ms at n, "us_per_step": slope}}
    of the resident plan (B2's steps) and B3's ``stream_train`` at
    ``spec``'s shape in `highest`, each with its walk built ahead as the
    engine builds it, in turns."""
    Lt, Rt, At = inputs(spec, device)
    K = Lt.shape[0]
    rw, sw = dense_fused.resident_walk(At, K), dense_stream.stream_walk(At, K)
    a2 = 2.0 * spec.alpha
    fns = {"resident": lambda m: dense_fused.resident_train(Lt, Rt, At, iters=m, alpha2=a2, walk=rw),
           "stream": lambda m: dense_stream.stream_train(Lt, Rt, At, iters=m, alpha2=a2, walk=sw)}
    calls = {(plan, m): (lambda f=f, m=m: f(m)) for plan, f in fns.items() for m in (3 * n, n)}
    ms = alternating_ms(calls, rounds)
    out = {plan: {"ms": ms[plan, 3 * n], "ms_n": ms[plan, n],
                  "us_per_step": (ms[plan, 3 * n] - ms[plan, n]) / (2 * n) * 1e3} for plan in fns}
    for plan, r in out.items():
        print(f"[probe] {name} {plan} plan: {r['ms']!r} ms for {3 * n} steps, {r['ms_n']!r} ms "
              f"for {n}; slope {r['us_per_step']!r} us/step", flush=True)
    return out


def run(device) -> dict:
    """{shape: ``plan_slopes``} at instML100k and gen-instML1M."""
    return {"instML100k": plan_slopes("instML100k", ml100k_spec(), device, ML100K_STEPS),
            "gen-instML1M": plan_slopes("gen-instML1M", ml1m_spec(), device, ML1M_STEPS)}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("plan_line: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[probe] {smi}", flush=True)
    run(torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
