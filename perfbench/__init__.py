"""The benchmark of ``recsys_tpu_torch`` (the PyTorch/CUDA port).

Run one cell with ``python3 -m perfbench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout; see README.md.
Nothing here imports ``jax``, ``jaxlib`` or ``recsys_tpu`` (the JAX
package), and the reference (``reference.py``, ``glibc.py``) imports
nothing of ``recsys_tpu_torch`` either.
"""
