"""Multi-process execution layer (port of ``recsys_tpu/parallel/multihost.py``).

The reference's multi-node story is MPI: mpirun launches P ranks, rank 0
streams COO chunks to owners (``matFact-mpi.c:220-457``), factor blocks
are scattered in RNG order (``matFact-mpi.c:459-515``) and every
iteration ends in two Allreduces over row/col communicators
(``matFact-mpi.c:207-209``).  The JAX package runs one process a host over
``jax.distributed``; the port runs one process a card over
``torch.distributed``:

* ``initialize`` replaces ``MPI_Init`` (JAX: ``jax.distributed.initialize``):
  ``init_process_group`` over ``tcp://<coordinator>``, NCCL where the
  rank's device is CUDA, gloo on the CPU, with a finite timeout, so that a
  lost rank fails a collective rather than hangs it.  A caller may ask for
  gloo on CUDA, which carries CUDA tensors through host memory: several
  ranks can then share one card (NCCL refuses two ranks on one GPU).
  Nothing switches backends on failure or moves a rank to the CPU.
* The global 2-D ('u', 'i') mesh spans every rank's shards
  (``mesh.make_mesh(world=...)``): shards go to ranks in row-major
  contiguous runs, and the same steps of ``parallel/step.py`` run on every
  rank over its own shards.  The psum of JAX's ``shard_map`` (MPI's
  Allreduce over a row or column communicator) is ``step.axis_sum`` after a
  gather over that row's or column's process group, the partials added in
  ascending shard order on every rank: the single process's bits.
* Ingest is per process: every rank parses the input and builds the host
  tables, then uploads only its shards' blocks (JAX's ``_local_block_array``
  ``putter``).  No root-streams-to-workers phase, and so no empty-rank
  protocol (``matFact-mpi.c:377-405``).
* Factors are drawn on every rank in the serial glibc order (identical
  bits, SURVEY §0), on the host or, for f32/bf16 ``bell`` at scale, on the
  rank's card; each rank lays out only its blocks.
* Output: after training every rank gets the whole factors (one gather a
  table, each block from the lowest rank that holds it: JAX's global
  arrays); the sharded top-1 gathers each shard's best over the row group
  and hands each u-block's indices to every rank (``process_allgather``;
  the reference's Gatherv to root, ``matFact-mpi.c:105-144``).

Single process is the degenerate case: ``initialize()`` is a no-op that
opens no socket, and the mesh is ``cfg.mesh_shape``'s shards all on
``device``, and no collective runs: the one-process engine itself.  The
one-rank-a-card NCCL layout on several cards is written but not verified:
the machine it was measured on has one card.
"""

from __future__ import annotations

import numpy as np
import torch

from recsys_tpu_torch.config import ProblemSpec, RunConfig
from recsys_tpu_torch.models.mf import MFState
from recsys_tpu_torch.parallel.mesh import COLLECTIVE_TIMEOUT, Mesh, make_mesh
from recsys_tpu_torch.utils.timing import phase


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None, *, device="cuda") -> None:
    """``MPI_Init`` analogue.  No-op without arguments (single process);
    otherwise joins this process, rank ``process_id`` of ``num_processes``,
    to the group whose rank 0 listens at ``coordinator_address``
    (``host:port``).  ``backend`` defaults to ``nccl`` on a CUDA ``device``
    and ``gloo`` on the CPU; ``nccl`` on the CPU, or without CUDA, raises.
    A collective that waits ``mesh.COLLECTIVE_TIMEOUT`` for a lost rank fails."""
    if num_processes is None and coordinator_address is None:
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("give the coordinator's address, the number of processes and this process's id")
    import torch.distributed as dist

    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the nccl backend carries CUDA tensors only; the rank's device is {device}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
        if device.index is not None:
            torch.cuda.set_device(device)
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("the nccl backend is not available in this torch build")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                            rank=process_id, timeout=COLLECTIVE_TIMEOUT)


def shutdown() -> None:
    """Leave the process group ``initialize`` joined (no-op without one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def world_mesh(spec: ProblemSpec, cfg: RunConfig, device="cuda") -> Mesh:
    """The global mesh: ``cfg.mesh_shape``'s shards over the world's ranks,
    or without a shape ``balanced_grid`` over one shard a rank (JAX:
    ``make_mesh`` over every process's devices), this rank's on ``device``.
    In a single process, the one-process mesh of ``cfg.mesh_shape`` (1x1
    without one)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return make_mesh(spec.users, spec.items, shape=cfg.mesh_shape or (1, 1), device=device)
    ranks = dist.get_world_size()
    shape = cfg.mesh_shape
    if shape is not None and (shape[0] * shape[1]) % ranks:
        raise ValueError(f"mesh {tuple(shape)} does not split over {ranks} ranks")
    per_rank = 1 if shape is None else shape[0] * shape[1] // ranks
    return make_mesh(spec.users, spec.items, shape=shape, device=device, world=(ranks, per_rank))


def factorize_multihost(spec: ProblemSpec, cfg: RunConfig = RunConfig(), mesh: Mesh | None = None,
                        device="cuda") -> tuple[MFState, Mesh]:
    """Training over the global mesh (default ``world_mesh``) on every route
    of the sharded engine: this rank uploads and trains its shards' blocks,
    and every rank gets the whole padded factors."""
    from recsys_tpu_torch.parallel.engine import factorize_sharded

    if mesh is None:
        mesh = world_mesh(spec, cfg, device)
    return factorize_sharded(spec, cfg, mesh=mesh)


def recommend_multihost(state: MFState, spec: ProblemSpec, mesh: Mesh) -> np.ndarray:
    """Distributed top-1 of the whole padded factors ``state``, gathered to
    every rank (Gatherv analogue): int32 (users,) on the host."""
    from recsys_tpu_torch.parallel.engine import recommend_sharded

    return recommend_sharded(state, spec, mesh)


def run(spec: ProblemSpec, cfg: RunConfig = RunConfig(), device="cuda") -> tuple[str, np.ndarray]:
    """``factorize_multihost`` then ``recommend_multihost`` (the ``top1``
    phase); every rank returns the same (stdout payload, top1)."""
    from recsys_tpu_torch.io.writers import format_recommendations

    state, mesh = factorize_multihost(spec, cfg, device=device)
    with phase("top1"):
        top1 = recommend_multihost(state, spec, mesh)
    return format_recommendations(top1, spec.rated_counts(), spec.items), top1
