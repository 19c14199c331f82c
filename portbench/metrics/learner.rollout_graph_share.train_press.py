"""learner.rollout_graph_share.train_press: the share of the traced
slice's rollout steps replayed from a rollout graph that carries the frozen
sort agent, counted by the program's spans: ``rollout.graph`` spans with
``agents`` 1 over every ``rollout.graph`` and ``rollout.policy`` span, in
%.  None on a program whose graph spans carry no ``agents``."""

from portbench.lib import program_spans


def read(r):
    recs = [x for x in program_spans.records()
            if x.name in ("rollout.graph", "rollout.policy")]
    graphed = [x for x in recs if x.name == "rollout.graph"]
    if not recs or (graphed and not any("agents" in x.attrs
                                        for x in graphed)):
        return None
    agent = sum(x.attrs.get("agents") == 1 for x in graphed)
    return 100.0 * agent / len(recs)
