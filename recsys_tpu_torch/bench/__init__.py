"""The port's bench harness (port of ``recsys_tpu/bench``): the golden sweep,
the H100 roofline, the scaling model of the port's exchange and the bf16
policy built from the card's rows."""
