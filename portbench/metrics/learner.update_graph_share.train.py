"""learner.update_graph_share.train: the share of the traced slice's
update minibatches replayed from the update's CUDA graph, counted by the
program's spans: ``update.graph`` over that plus the eager minibatches'
``update.loss``, in %."""

from portbench.lib import program_spans


def read(r):
    g = program_spans.count("update.graph")
    e = program_spans.count("update.loss")
    return 100.0 * g / (g + e) if g + e else None
