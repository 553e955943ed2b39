"""train_roofline (program span): the floor of the job's iterations
(``roofline.iteration_work`` x iters, the larger of FLOP over the dtype's
peak and bytes over HBM) over the median ``train`` phase, in percent."""

from perfbench import roofline
from perfbench.metrics._common import phase_median


def read(readings):
    train = phase_median(readings, "train")
    if not train:
        return None
    i = readings["instance"]
    flops, nbytes = roofline.iteration_work(i["nnz"], i["features"], i["rated_users"], i["rated_items"],
                                            readings["dtype"])
    floor, _ = roofline.floor_seconds(flops, nbytes, readings["dtype"])
    return 100.0 * floor * i["iters"] / train
