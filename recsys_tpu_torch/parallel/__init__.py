"""The sharded engine on a 2-D mesh of torch devices (port of ``recsys_tpu/parallel``)."""
