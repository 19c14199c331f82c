"""learner.update_optim_us: the mean host time of a minibatch's
optimizer step (the program span ``update.optim``: the gradient ``cat``,
``ClipAdam.update``, the parameters' ``add_``) over the traced slice, in
us."""

from portbench.lib import program_spans


def read(r):
    return program_spans.mean_us("update.optim")
