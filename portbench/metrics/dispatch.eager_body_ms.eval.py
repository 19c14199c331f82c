"""dispatch.eager_body_ms.eval: the mean host time of one batched step's
eager body (the program span ``fastb.eager``; one per batched step that
takes no kernel 1) over the traced slice, in ms."""

from portbench.lib import program_spans


def read(r):
    us = program_spans.mean_us("fastb.eager")
    return None if us is None else us / 1e3
