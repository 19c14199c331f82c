"""dp.all_gather_us.train_dp4: the mean host time of one all-gather over
the dp ranks (the program span ``dp.all_gather``: widening, the
collective's enqueue, the concatenation) in rank 0's traced slice, in
us."""

from portbench.lib import program_spans


def read(r):
    return program_spans.mean_us("dp.all_gather")
