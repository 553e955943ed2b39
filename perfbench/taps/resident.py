"""The ``resident`` plan: B1 ``dense_fused.resident_train_top1`` returns
(Lt, Rt, top1), the factors K-major and padded."""


def install(sink):
    from recsys_tpu_torch.ops import dense_fused

    from perfbench.taps import wrap

    return wrap(dense_fused, "resident_train_top1", sink, "kmajor", lambda out: (out[0], out[1]))
