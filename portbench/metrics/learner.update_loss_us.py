"""learner.update_loss_us: the mean host time of a minibatch's gather and
loss (the program span ``update.loss``) over the traced slice, in us."""

from portbench.lib import program_spans


def read(r):
    return program_spans.mean_us("update.loss")
