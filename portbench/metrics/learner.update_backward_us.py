"""learner.update_backward_us: the mean host time of a minibatch's
``torch.autograd.grad`` (the program span ``update.backward``) over the
traced slice, in us."""

from portbench.lib import program_spans


def read(r):
    return program_spans.mean_us("update.backward")
