"""dispatch.step_mono_host_us.train: the mean host time of one launch of
kernel 1 through its wrapper (the program span ``step_mono.launch``:
checks, allocations, constants, launch, outputs) over the traced slice,
in us.  None without a card."""

from portbench.lib import program_spans


def read(r):
    return program_spans.mean_us("step_mono.launch")
