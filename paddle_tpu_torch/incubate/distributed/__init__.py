"""``paddle.incubate.distributed`` is not ported yet: its MoE layers
build on ``distributed.spmd`` and ``distributed.topology``, which come
with ``distributed/`` (ROADMAP queue A.12). Any name read from it
raises."""


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    raise NotImplementedError(
        f"paddle.incubate.distributed.{name} is not ported: the MoE layers "
        "need distributed/ (ROADMAP A.12)")
