"""The ``stream`` plan: B3 ``dense_stream.stream_train`` returns (Lt, Rt),
K-major and padded."""


def install(sink):
    from recsys_tpu_torch.ops import dense_stream

    from perfbench.taps import wrap

    return wrap(dense_stream, "stream_train", sink, "kmajor", lambda out: (out[0], out[1]))
