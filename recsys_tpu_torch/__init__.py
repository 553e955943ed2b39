"""recsys_tpu_torch — the PyTorch + CUDA port of ``recsys_tpu``.

The JAX package stays the reference; this package runs the same main
path (parse -> glibc init -> full-batch GD -> masked top-1 -> stdout)
on an NVIDIA Hopper card, with the TPU kernels rewritten by hand in
CUDA C++ (``csrc/``).  It imports ``torch`` and nothing of ``jax`` or of
``recsys_tpu``: the host modules it needs (config, io, models.mf,
engine.oracle, utils.hostmem) are its own copies, each naming its source.

Layout:
  config.py  ProblemSpec, RunConfig
  io/        .in parser, glibc random, native C fast paths, writers, generator
  models/    MFState and the glibc initial factors
  ops/       precision helpers; the dense kernels' wrappers and plain twins
             (dense_fused: B1 resident_train_top1, B2 resident_train;
             dense_stream: B3 stream_train, B4 stream_top1, B6
             stream_train_top1); the blocked top-1 of recommend(); the build
  csrc/      CUDA C++ sources (built at first use into build/) and the
             native host C source
  engine/    path selection, the Hopper plan, run(), factorize(),
             recommend(); the f64 numpy oracle
  utils/     phase timing with CUDA synchronisation, checkpoints, host buffers
  probes/    measurements on the card beside chip_smoke.py
  convert.py factor tables between the JAX layouts, checkpoints and the
             port's tensors
  cli.py     ``python -m recsys_tpu_torch.cli run <file.in> --device cuda``
"""

__version__ = "0.1.0"
