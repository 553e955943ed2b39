"""setup_s (host clock): from the harness's first line to the first timed
job: imports, the card's context, the kernels' build or load, the data,
the instance file and one warm job."""


def read(readings):
    return readings["setup_s"]
