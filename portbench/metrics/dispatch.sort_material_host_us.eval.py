"""dispatch.sort_material_host_us.eval: the mean host time of one launch
of kernel 2 through its wrapper (the program span
``sort_material.launch``) over the traced slice, in us.  None without a
card."""

from portbench.lib import program_spans


def read(r):
    return program_spans.mean_us("sort_material.launch")
