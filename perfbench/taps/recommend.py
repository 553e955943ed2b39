"""The ``bell``, ``dense``, ``coo`` routes and the ``tiled`` plan:
``trainer.run`` hands the trained state to ``trainer.recommend`` as (L, R)
in (rows, k) order."""


def install(sink):
    from recsys_tpu_torch.engine import trainer

    from perfbench.taps import replace

    fn = getattr(trainer, "recommend", None)
    if fn is None:
        return None

    def tapped(state, *args, **kwargs):
        sink.put("rows", state[0], state[1])
        return fn(state, *args, **kwargs)

    return replace(trainer, "recommend", fn, tapped)
