"""Scaling of the port's sharded engine: the volume its exchange moves, a
projection over NVLink, and shards sharing one card (port of
``recsys_tpu/bench/scaling.py``).

1. **Exchange volume.**  The port's axis sum is not a ring all-reduce.  On a
   multi-process mesh each block's partials are gathered over the process
   group of the block's mesh row (ΔL) or column (ΔR) and added in shard
   order (``parallel/step.py``, ``_gathered``/``_exchange``; no
   ``all_reduce(SUM)``).  With one shard a rank, a rank in a group of p
   receives the p − 1 other partials of its block, so per iteration

       bytes/rank = (pi − 1)·u_rows·cols·es + (pu − 1)·i_rows·cols·es

   where a partial is (u_rows, cols) on the u side and (i_rows, cols) on the
   i side as the sharded route makes them (``exchange_shape``): the padded
   blocks on ``dense``/``coo``/``coo_seg``, B5's 128-row blocks and 32-wide
   K on ``tiled`` (f32), a side's rows with at least one rating on the
   checkerboard ``bell``.  A rank holding several shards of one group sends
   them as one stack padded to the group's largest count; the law is
   written for one shard a rank.
2. **Projected efficiency.**  Per-rank compute from the roofline
   (``bench/roofline.py``) against the exchange at NVLink's data-sheet rate,
   as two bounds: no overlap and full overlap.
3. **Measured: shards sharing one card** (``measure_mesh``): the sharded
   engine's wall per mesh shape with every shard on one device.  A mesh on
   one card is host-bound (each launch's host work exceeds its kernel,
   PERF.md §5 bottleneck 6), so the table shows that every shape runs and
   what its launches cost, not speed across cards.

Usage:
    python -m recsys_tpu_torch.bench.scaling [--instance instML100k] [--iters 50] [--device cuda]
    python -m recsys_tpu_torch.bench.scaling --all --out docs/SCALING_TORCH.md
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import sys
import time

# NVIDIA H100 SXM data sheet: NVLink 900 GB/s a GPU, both directions
# together, so a rank receives at most 450 GB/s.  Not measured: the chip
# machine has one card.
NVLINK_BYTES_S = 450e9

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float64": 8}


def comm_volume_bytes(u_rows: int, i_rows: int, cols: int, pu: int, pi: int, itemsize: int) -> float:
    """Bytes one rank receives per iteration on a (pu, pi) mesh of one shard
    a rank: the pi − 1 other ΔL partials of its mesh row, (u_rows, cols)
    each, and the pu − 1 other ΔR partials of its column, (i_rows, cols)."""
    return float(((pi - 1) * u_rows + (pu - 1) * i_rows) * cols * itemsize)


def _mesh(pu: int, pi: int, device):
    """A one-process (pu, pi) mesh on ``device``, built without a card check:
    the route and the block shapes it implies, not a run."""
    import torch

    from recsys_tpu_torch.parallel.mesh import Mesh

    d = torch.device(device)
    return Mesh(((d,) * pi,) * pu, ((0,) * pi,) * pu)


def exchange_shape(spec, cfg, pu: int, pi: int, device="cuda") -> tuple[int, int, int, int]:
    """(u_rows, i_rows, cols, itemsize) of one ΔL and one ΔR partial on the
    route the sharded engine takes for ``spec`` on a (pu, pi) mesh on
    ``device`` (``parallel.engine.sharded_route``)."""
    from recsys_tpu_torch.ops import bell
    from recsys_tpu_torch.parallel import engine
    from recsys_tpu_torch.parallel.sharding import pad_up

    route = engine.sharded_route(spec, cfg, _mesh(pu, pi, device))
    if route == "tiled":
        _, u_blk, _, i_blk, K = engine.tiled_dims(spec, pu, pi)
        return u_blk, i_blk, K, 4
    es = _ITEMSIZE[cfg.dtype]
    if route == "bell":
        meta = bell.make_sharded_bell(spec, pu, pi).meta
        return meta.user.n_nz, meta.item.n_nz, spec.features, es
    return pad_up(spec.users, pu) // pu, pad_up(spec.items, pi) // pi, spec.features, es


def projected_efficiency(spec, cfg, path: str, pu: int, pi: int, device="cuda"):
    """(compute_s, comm_s, eff_no_overlap, eff_full_overlap) per iteration
    and rank on a mesh of pu·pi cards, from the roofline compute floor
    shared evenly and the exchange at ``NVLINK_BYTES_S``.  The two
    efficiencies bound the real one: no overlap (compute then exchange, as
    ``parallel/step.py`` runs them) and full overlap (the exchange hidden
    behind compute).  None where no compute model applies."""
    from recsys_tpu_torch.bench.roofline import train_cost_model

    model, per_iter = train_cost_model(spec, cfg, path)
    if model is None:
        return None
    compute = per_iter / (pu * pi)
    u_rows, i_rows, cols, es = exchange_shape(spec, cfg, pu, pi, device)
    comm = comm_volume_bytes(u_rows, i_rows, cols, pu, pi, es) / NVLINK_BYTES_S
    serial = compute / (compute + comm) if compute + comm else 1.0
    overlap = compute / max(compute, comm) if max(compute, comm) else 1.0
    return compute, comm, serial, overlap


def mesh_shapes(n: int) -> list[tuple[int, int]]:
    return [(pu, n // pu) for pu in range(1, n + 1) if n % pu == 0]


def measure_mesh(spec, cfg, shapes, device, warmup: int = 1, repeats: int = 3):
    """Wall of ``parallel.engine.factorize_sharded`` per mesh shape, every
    shard on ``device`` (the card in a chip run, the CPU in tests).  Rows of
    (pu, pi, min_wall_s, spread, route), ``spread`` = max/min − 1 over the
    repeats: the row's own noise band."""
    import torch

    from recsys_tpu_torch.parallel import engine
    from recsys_tpu_torch.parallel.mesh import make_mesh
    from recsys_tpu_torch.utils.timing import device_sync

    rows = []
    for pu, pi in shapes:
        mesh = make_mesh(spec.users, spec.items, (pu, pi), device=device)
        route = engine.sharded_route(spec, cfg, mesh)
        for _ in range(warmup):
            engine.factorize_sharded(spec, cfg, mesh=mesh)
        walls = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            st, _ = engine.factorize_sharded(spec, cfg, mesh=mesh)
            device_sync((st.L, st.R))
            walls.append(time.perf_counter() - t0)
        rows.append((pu, pi, min(walls), max(walls) / min(walls) - 1.0, route))
        del st
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return rows


def render_markdown(spec, cfg, path, name, rows, where: str, chips=(1, 2, 4, 8, 16), device="cuda"):
    """One instance's section: the exchange law per chip count on the
    balanced grid, and the measured rows (``where`` names their device)."""
    from recsys_tpu_torch.parallel.mesh import balanced_grid

    k = spec.features
    lines = [
        f"## {name} ({spec.users}x{spec.items}, k={k}, nnz={spec.nnz}), {cfg.dtype}, path {path}",
        "",
        "### Per-iteration exchange per rank (gather of a block's partials, one shard a rank)",
        "",
        "| chips | mesh (u x i) | partial rows (u, i) x cols | bytes/rank/iter | projected compute (us) | "
        "projected exchange (us) | eff (no overlap) | eff (full overlap) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for n in chips:
        pu, pi = balanced_grid(n, spec.users, spec.items)
        u_rows, i_rows, cols, es = exchange_shape(spec, cfg, pu, pi, device)
        vol = comm_volume_bytes(u_rows, i_rows, cols, pu, pi, es)
        proj = projected_efficiency(spec, cfg, path, pu, pi, device)
        if proj is None:
            comp = comm = eff = effo = "-"
        else:
            comp, comm = f"{proj[0] * 1e6:.2f}", f"{proj[1] * 1e6:.2f}"
            eff, effo = f"{100 * proj[2]:.0f}%", f"{100 * proj[3]:.0f}%"
        lines.append(f"| {n} | {pu}x{pi} | ({u_rows}, {i_rows}) x {cols} | {vol:,.0f} | {comp} | {comm} | {eff} | "
                     f"{effo} |")
    lines += [
        "",
        "Projection (bench/roofline.py, bench/scaling.py): compute at the roofline",
        "floor (6·k FLOP a rating, data-sheet peaks) shared evenly across cards;",
        f"the exchange at {NVLINK_BYTES_S / 1e9:.0f} GB/s a rank (H100 SXM data sheet, NVLink",
        "900 GB/s both directions; not measured: the chip machine has one card).",
        "The two columns bound the real efficiency: 'no overlap' is the order",
        "parallel/step.py runs (every partial, then the exchange), 'full overlap'",
        "the best any schedule could do.",
        "",
        f"### Measured: shards sharing one device ({where}), full training program",
        "",
        "HOST-BOUND: every shard's launches run from one process onto one device,",
        "and a launch's host work exceeds its kernel (PERF.md §5, bottleneck 6).",
        "The table shows that every mesh shape runs the route and what its",
        "launches cost, not speed across cards.",
        "",
        "| mesh (u x i) | route | wall (s) | spread (max/min-1) | vs 1x1 |",
        "|---|---|---|---|---|",
    ]
    base = next((w for pu, pi, w, _, _ in rows if pu * pi == 1), None)
    for pu, pi, w, spread, route in rows:
        rel = f"{base / w:.2f}x" if base else "-"
        lines.append(f"| {pu}x{pi} | {route} | {w:.4f} | ±{100 * spread:.0f}% | {rel} |")
    lines.append("")
    return "\n".join(lines)


def weak_scaling_section(device, where: str, chips=(1, 2, 4, 8, 16)):
    """Per-chip work fixed (users grow with the mesh, per-user degree
    constant), mesh (n, 1), BELL: ΔR's exchange over the 'u' axis grows
    with n − 1 while each rank's ΔL exchange is empty, so the projected
    efficiency falls as ranks are added.  Then the walls of the meshes of
    at most 8 shards, every shard on ``device`` (``where`` names it)."""
    from recsys_tpu_torch.config import RunConfig
    from recsys_tpu_torch.io.generator import generate_instance

    base_users, items, k = 1250, 2500, 32
    cfg = RunConfig(dtype="float32", path="bell")
    lines = [
        "## Weak scaling (fixed per-chip work: users grow with the mesh)",
        "",
        f"Block: {base_users} users x {items} items per chip, k={k}, ~14 nz/user,",
        "mesh (n x 1), BELL path.  Model columns as above (bounds).",
        "",
        "| chips | users | bytes/rank/iter | compute/rank (us) | exchange (us) | eff (no overlap) | "
        "eff (full overlap) |",
        "|---|---|---|---|---|---|---|",
    ]
    specs = {}
    for n in chips:
        spec = generate_instance(base_users * n, items, k, 8, 20, iters=30, alpha=1e-4, seed=23)
        specs[n] = spec
        proj = projected_efficiency(spec, cfg, "bell", n, 1, device)
        u_rows, i_rows, cols, es = exchange_shape(spec, cfg, n, 1, device)
        vol = comm_volume_bytes(u_rows, i_rows, cols, n, 1, es)
        lines.append(f"| {n} | {spec.users} | {vol:,.0f} | {proj[0] * 1e6:.2f} | {proj[1] * 1e6:.2f} | "
                     f"{100 * proj[2]:.0f}% | {100 * proj[3]:.0f}% |")
    lines += [
        "",
        f"Measured, shards sharing one device ({where}; host-bound, see above):",
        "per-chip work fixed, so on one device the wall grows with the shard",
        "count. min over 3 repeats.",
        "",
        "| shards | route | wall (s) | spread (max/min-1) |",
        "|---|---|---|---|",
    ]
    for n in chips:
        if n > 8:
            continue
        (_, _, w, spread, route), = measure_mesh(specs[n], cfg, [(n, 1)], device)
        lines.append(f"| {n} | {route} | {w:.4f} | ±{100 * spread:.0f}% |")
    lines.append("")
    return "\n".join(lines)


def where_80_section(fixture_dir: str, chips=(2, 4, 8, 16, 32), device="cuda"):
    """Which instance/scale regimes the projection puts at >= 80% linear
    (SURVEY §7.4's target), by the port's exchange law."""
    from recsys_tpu_torch.bench.sweep import load_instance
    from recsys_tpu_torch.config import RunConfig
    from recsys_tpu_torch.engine import trainer
    from recsys_tpu_torch.parallel.mesh import balanced_grid

    cases = []
    for name, mutate in [
        ("instML100k", None),
        ("gen-instML1M", None),
        ("gen-instML1M @ k=128", lambda s: dataclasses.replace(s, features=128)),
        ("inst50000-5000-100-2-5", None),
    ]:
        spec = load_instance(name.split(" @")[0], fixture_dir)
        if mutate:
            spec = mutate(spec)
        cfg = RunConfig(dtype="float32")
        cases.append((name, spec, cfg, trainer.choose_path(spec, cfg, device, allow_host=False)))
    lines = [
        "## Where the >=80% target holds (projection)",
        "",
        "Projected efficiency bounds per instance and chip count (balanced",
        "grid per count; '>=80' marks configs whose FULL-OVERLAP bound meets",
        "the target, '>=80!' those where even the NO-OVERLAP lower bound does):",
        "",
        "| instance | path | " + " | ".join(f"{n} chips" for n in chips) + " |",
        "|---|---|" + "---|" * len(chips),
    ]
    for name, spec, cfg, path in cases:
        cells = []
        for n in chips:
            pu, pi = balanced_grid(n, spec.users, spec.items)
            proj = projected_efficiency(spec, cfg, path, pu, pi, device)
            if proj is None:
                cells.append("-")
                continue
            lo, hi = 100 * proj[2], 100 * proj[3]
            mark = " >=80!" if lo >= 80 else (" >=80" if hi >= 80 else "")
            cells.append(f"{lo:.0f}-{hi:.0f}%{mark}")
        lines.append(f"| {name} | {path} | " + " | ".join(cells) + " |")
    lines += [
        "",
        "Reading: every rank receives the other partials of its blocks whole, so",
        "its exchange does not shrink as the mesh grows along that axis (a ring",
        "all-reduce's would); the floor of the compute does. The projection is",
        "therefore kindest to work-heavy shapes at few cards, and no measurement",
        "across cards stands behind it yet (one card on the chip machine).",
        "",
    ]
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="recsys-tpu-torch-scaling")
    ap.add_argument("--instance", default="instML100k")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--device", default="cuda", help="the device every shard sits on (cpu only on request)")
    ap.add_argument("--iters", type=int, default=50, help="iterations of the measured runs")
    ap.add_argument("--out", default=None, help="write the markdown section here")
    ap.add_argument("--all", action="store_true",
                    help="write the whole docs/SCALING_TORCH.md (instML100k and gen-instML1M, weak scaling, "
                         "the >=80%% projection)")
    args = ap.parse_args(argv)

    import torch

    from recsys_tpu_torch.bench.sweep import _fixture_dir, device_label, load_instance
    from recsys_tpu_torch.config import RunConfig
    from recsys_tpu_torch.engine import trainer

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but torch.cuda.is_available() is False (pass --device cpu)", file=sys.stderr)
        return 2
    where = device_label(device)
    fixtures = _fixture_dir()

    def one_section(name):
        spec = load_instance(name, fixtures)
        cfg = RunConfig(dtype=args.dtype)
        path = trainer.choose_path(spec, cfg, device, allow_host=False)
        shapes = sorted({s for n in (1, 2, 4, 8) for s in mesh_shapes(n)}, key=lambda s: (s[0] * s[1], s[0]))
        rows = measure_mesh(dataclasses.replace(spec, iters=args.iters), cfg, shapes, device)
        return render_markdown(spec, cfg, path, name, rows, f"{where}, {args.iters} iterations", device=device)

    if args.all:
        md = (
            "# Scaling of the PyTorch/CUDA port (exchange law + shards sharing one card)\n"
            "\n"
            "Generated by `python -m recsys_tpu_torch.bench.scaling --all --out docs/SCALING_TORCH.md`.\n"
            "The JAX package's section is docs/SCALING.md (a TPU ring all-reduce); this one\n"
            "models what the port moves: each block's partials gathered over its mesh row's\n"
            "or column's process group and added in shard order. Leg 1 is that exchange\n"
            "law, leg 2 a projection over NVLink's data-sheet rate, leg 3 the sharded\n"
            "engine's measured wall per mesh shape with every shard on one device\n"
            f"({where}), leg 4 a weak-scaling table and leg 5 where the projection meets\n"
            "80%.\n"
            "\n"
        )
        for name in ("instML100k", "gen-instML1M"):
            md += one_section(name) + "\n"
        md += weak_scaling_section(device, where) + "\n"
        md += where_80_section(fixtures, device=device)
    else:
        md = one_section(args.instance)
    if args.out:
        with open(args.out, "w") as f:
            f.write(md)
    else:
        print(md)
    return 0


if __name__ == "__main__":
    sys.exit(main())
