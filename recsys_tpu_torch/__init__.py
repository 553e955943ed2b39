"""recsys_tpu_torch — the PyTorch + CUDA port of ``recsys_tpu``.

The JAX package stays the reference; this package runs the same main
path (parse -> glibc init -> full-batch GD -> masked top-1 -> stdout)
on an NVIDIA Hopper card, with the TPU kernels rewritten by hand in
CUDA C++ (``csrc/``).  It imports ``torch`` and never ``jax``; the
jax-free host modules of ``recsys_tpu`` (config, io, models.mf,
engine.oracle, utils.hostmem) are reused as they are.

Layout:
  ops/       precision helpers, the fused dense GD + top-1 kernel wrapper
             and its plain twin, the nvcc build
  csrc/      CUDA C++ sources (built at first use into build/)
  engine/    path selection and the end-to-end ``run``
  utils/     phase timing with CUDA synchronisation
  convert.py factor tables between the JAX layout and the port's tensors
  cli.py     ``python -m recsys_tpu_torch.cli run <file.in> --device cuda``
"""

__version__ = "0.1.0"
