"""dispatch.kernel_step_share.eval: the share of the traced slice's
batched steps that went through kernel 1, counted by the program's
spans: ``step_mono.launch`` over that plus ``fastb.eager``, in %."""

from portbench.lib import program_spans


def read(r):
    k = program_spans.count("step_mono.launch")
    e = program_spans.count("fastb.eager")
    return 100.0 * k / (k + e) if k + e else None
