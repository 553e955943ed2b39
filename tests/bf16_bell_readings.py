"""bf16 on the BELL route, the port against the JAX package, on the CPU.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/bf16_bell_readings.py [--steps N] instance ...

For each fixture instance (``tests/fixtures/<instance>.in`` and ``.out``)
it runs the JAX package's bf16 ``run`` and the port's bf16 ``run`` on the
bell route for the instance's full iteration count, and prints each one's
argmax agreement with the golden output, the share of users on which the
two answers agree, and the share of factor values equal in raw bits.
With ``--steps N`` it then walks N steps from the JAX package's state,
one step of each at a time, and prints the first step whose factors
differ in any bit, the count of values that differ and the largest
distance in bf16 ulps.  Not a test: pytest does not collect it.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"


def _agreement(out: str, golden: list[str]) -> float:
    return sum(a == b for a, b in zip(out.splitlines(), golden)) / len(golden)


def full_run(name: str) -> None:
    from recsys_tpu.config import RunConfig as JaxRunConfig
    from recsys_tpu.engine import trainer as jax_trainer
    from recsys_tpu_torch.config import RunConfig
    from recsys_tpu_torch.engine import trainer
    from recsys_tpu_torch.io.parser import load_problem
    from recsys_tpu_torch.io.writers import format_recommendations

    spec = load_problem(str(FIXTURES / f"{name}.in"))
    golden = (FIXTURES / f"{name}.out").read_text().splitlines()
    jcfg, cfg = JaxRunConfig(dtype="bfloat16", path="bell"), RunConfig(dtype="bfloat16", path="bell")
    t0 = time.perf_counter()
    jax_out, _ = jax_trainer.run(spec, jcfg)
    js = jax_trainer.factorize(spec, jcfg)
    t1 = time.perf_counter()
    st = trainer.factorize(spec, cfg, "cpu")
    out = format_recommendations(trainer.recommend(st, spec, cfg, "cpu"), spec.rated_counts(), spec.items)
    t2 = time.perf_counter()
    same = np.mean(np.concatenate([(np.asarray(j).astype(np.float32) == p).reshape(-1)
                                   for j, p in ((js.L, st.L), (js.R, st.R))]))
    print(f"{name}: {spec.users}x{spec.items} k={spec.features} nnz={spec.nnz} iters={spec.iters} | agreement "
          f"JAX {_agreement(jax_out, golden)!r} port {_agreement(out, golden)!r} | answers equal on "
          f"{_agreement(out, jax_out.splitlines())!r} of users | factor values equal in bits {float(same)!r} | "
          f"s JAX (run and factorize) {t1 - t0:.1f}, port (factorize and recommend) {t2 - t1:.1f}", flush=True)


def first_divergence(name: str, steps: int) -> None:
    import jax
    import jax.numpy as jnp
    import torch

    from recsys_tpu.engine import trainer as jax_trainer
    from recsys_tpu.ops import bell as jax_bell
    from recsys_tpu_torch import testing as checks
    from recsys_tpu_torch.io.parser import load_problem
    from recsys_tpu_torch.models.mf import init_factors
    from recsys_tpu_torch.ops import bell

    spec = load_problem(str(FIXTURES / f"{name}.in"))
    data = bell.make_bell_inputs(spec, np.float32)
    init = init_factors(spec.users, spec.items, spec.features)
    L, R = (torch.from_numpy(x).bfloat16() for x in bell.pad_factors_for_bell(init, data, np.float32))
    jd = jax_bell.make_bell_inputs(spec, jnp.bfloat16)
    jt = jax.tree.map(jnp.asarray, jd.tables)
    t = bell.device_tables(data.tables, "cpu", torch.bfloat16)
    a2 = jnp.asarray(2.0 * spec.alpha, jnp.bfloat16)

    def to_torch(x):
        return torch.from_numpy(np.asarray(x).astype(np.float32)).bfloat16()

    def to_jax(x):
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)

    for step in range(steps):
        want = tuple(to_torch(x) for x in jax_trainer._train_bell(to_jax(L), to_jax(R), jt, a2, 1, jd.meta))
        got = bell.bell_train(L, R, t, 2.0 * spec.alpha, data.meta, 1)
        if not checks.same_bits(got, want):
            n = sum(int((g.view(torch.int16) != w.view(torch.int16)).sum()) for g, w in zip(got, want))
            print(f"{name}: first step that differs: {step + 1} (from the same state), {n} of "
                  f"{L.numel() + R.numel()} values, at most {checks.bf16_ulps(got, want)} bf16 ulps", flush=True)
            return
        L, R = want
    print(f"{name}: {steps} steps equal in bits", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("instances", nargs="+")
    ap.add_argument("--steps", type=int, default=0)
    args = ap.parse_args(argv)
    for name in args.instances:
        full_run(name)
        if args.steps:
            first_divergence(name, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
