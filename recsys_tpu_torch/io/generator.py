"""Instance generator — fixture tooling.  A copy of
``recsys_tpu/io/generator.py``, kept in the port so that it imports
nothing of the JAX package.

The reference ships 13 ``.in`` instances named
``inst<users>-<items>-<k>-<min_nz_per_row>-<max_nz_per_row>`` but five
large ones were dropped from the snapshot (``.MISSING_LARGE_BLOBS``).
This regenerates instances matching the naming convention so the
missing scales can be exercised and benchmarked. Values are MovieLens-
style ratings in {1..5}; entries are emitted row-major sorted, matching
the format invariant. Generation uses numpy's PRNG (the glibc contract
only governs factor init, not instance data).
"""

from __future__ import annotations

import numpy as np

from recsys_tpu_torch.config import ProblemSpec


def generate_instance(
    users: int,
    items: int,
    features: int,
    min_nz_row: int,
    max_nz_row: int,
    iters: int = 100,
    alpha: float = 0.0001,
    seed: int = 42,
) -> ProblemSpec:
    rng = np.random.default_rng(seed)
    counts = rng.integers(min_nz_row, max_nz_row + 1, size=users)
    counts = np.minimum(counts, items)
    nnz = int(counts.sum())
    rows = np.repeat(np.arange(users, dtype=np.int64), counts)
    cols = np.empty(nnz, dtype=np.int64)
    off = 0
    for u in range(users):
        c = int(counts[u])
        if c > items // 2:
            cols[off : off + c] = np.sort(rng.choice(items, size=c, replace=False))
        else:
            # rejection sampling is far faster than choice for sparse rows
            picked = np.unique(rng.integers(0, items, size=2 * c + 8))
            while picked.size < c:
                picked = np.unique(
                    np.concatenate([picked, rng.integers(0, items, size=2 * c)])
                )
            cols[off : off + c] = np.sort(rng.permutation(picked)[:c])
        off += c
    vals = rng.integers(1, 6, size=nnz).astype(np.float64)
    return ProblemSpec(
        iters=iters,
        alpha=alpha,
        features=features,
        users=users,
        items=items,
        rows=rows.astype(np.int32),
        cols=cols.astype(np.int32),
        vals=vals,
    )


# Canonical parameters of the committed gen-* fixtures (scale analogues
# of the five .in blobs missing upstream, tests/fixtures/README.md).
# Their .in files are regenerable from this table BYTE-exactly (verified
# by diff), so only the .out goldens — produced by the reference's own C
# binary via scripts/crossval_reference.py — live in git.  Two round-1
# fixtures predate this table's generator version and are committed
# as files instead (see tests/fixtures/.gitignore).
GEN_SPECS: dict[str, dict] = {
    # ML1M's shape/nnz/hyperparameters (6040x3952, ~1M ratings, k=30).
    "gen-instML1M": dict(
        users=6040, items=3952, features=30, min_nz_row=20, max_nz_row=311,
        iters=3000, alpha=1e-4, seed=1000209,
    ),
    # The 1M-user cluster instance (report-mpi.pdf Table 1, MPI-16 87.42 s);
    # iters/alpha follow the surviving inst1000-1e6 fixture's header.
    "gen-inst1e6-100-700-1-3": dict(
        users=1_000_000, items=100, features=700, min_nz_row=1, max_nz_row=3,
        iters=10, alpha=1e-5, seed=42,
    ),
    # The remaining orphan-golden shapes (outputs survive upstream, inputs
    # do not; published MPI times in report-mpi.pdf Tables 1-3).  Their
    # iteration counts are set from the published MPI-1 Ryzen walls and
    # the ML100k serial updates/s anchor (SURVEY §6.5 derivation), rounded
    # UP so the comparison never flatters this framework.
    "gen-inst1000-80000-20-10-1000": dict(
        users=1000, items=80_000, features=20, min_nz_row=10, max_nz_row=1000,
        iters=3000, alpha=1e-4, seed=42,
    ),
    "gen-inst20000-10000-40-2-50": dict(
        users=20_000, items=10_000, features=40, min_nz_row=2, max_nz_row=50,
        iters=1000, alpha=1e-4, seed=42,
    ),
    "gen-inst60000-2000-200-10-20": dict(
        users=60_000, items=2_000, features=200, min_nz_row=10, max_nz_row=20,
        iters=200, alpha=1e-4, seed=42,
    ),
}


def materialize_gen_fixture(name: str, fixtures_dir) -> str:
    """Write ``<fixtures_dir>/<name>.in`` from GEN_SPECS if absent;
    returns the path.  KeyError for unknown names."""
    import os

    from recsys_tpu_torch.io.parser import save_problem

    path = os.path.join(str(fixtures_dir), f"{name}.in")
    if not os.path.exists(path):
        spec = generate_instance(**GEN_SPECS[name])
        save_problem(spec, path)
    return path


def ensure_fixture(name: str, fixtures_dir) -> str:
    """Path to ``<fixtures_dir>/<name>.in``, materializing a regenerable
    gen-* fixture on first use.  Unlike ``materialize_gen_fixture`` this
    accepts ANY instance name: non-gen names just resolve to their path
    (which the caller may find absent).  The one helper behind every
    "load this fixture, generating it if needed" site (sweep render,
    scaling sections, ceiling calibration)."""
    import os

    path = os.path.join(str(fixtures_dir), f"{name}.in")
    if not os.path.exists(path) and name in GEN_SPECS:
        materialize_gen_fixture(name, fixtures_dir)
    return path


def parse_instance_name(name: str):
    """'inst<u>-<i>-<k>-<min>-<max>' -> dims tuple (ValueError otherwise)."""
    if not name.startswith("inst"):
        raise ValueError(name)
    parts = name[4:].split("-")
    if len(parts) != 5:
        raise ValueError(name)

    def num(tok: str) -> int:
        return int(float(tok))  # handles '1e6'

    return tuple(num(p) for p in parts)
