"""dp.gather_share.train_dp4: the share of rank 0's ``learner.iteration``
time, in its traced slice, spent inside ``dp.all_gather`` spans (the
per-step obs gathers and the rollout gather), in %."""

from portbench.lib import program_spans


def read(r):
    it = program_spans.summary().get("learner.iteration")
    if not it or not program_spans.count("dp.all_gather"):
        return None
    inside = program_spans.total_us_within("dp.all_gather",
                                           ("learner.iteration",))
    return 100.0 * inside / (it["count"] * it["mean_us"])
