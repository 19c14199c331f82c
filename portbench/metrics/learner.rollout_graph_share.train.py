"""learner.rollout_graph_share.train: the share of the traced slice's
rollout steps replayed from the rollout's CUDA graph, counted by the
program's spans: ``rollout.graph`` over that plus the eager steps'
``rollout.policy``, in %."""

from portbench.lib import program_spans


def read(r):
    g = program_spans.count("rollout.graph")
    e = program_spans.count("rollout.policy")
    return 100.0 * g / (g + e) if g + e else None
