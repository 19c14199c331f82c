"""learner.eager_reset_share.train_press: the share of the traced slice's
replayed rollout steps whose captured step resets the whole batch eagerly
(``with_autoreset``) rather than in kernel 1: ``rollout.graph`` spans with
``reset`` "eager" over every ``rollout.graph`` span, in %.  None without
graph spans, or on a program whose graph spans carry no ``reset``."""

from portbench.lib import program_spans


def read(r):
    graphed = [x for x in program_spans.records()
               if x.name == "rollout.graph"]
    if not any("reset" in x.attrs for x in graphed):
        return None
    eager = sum(x.attrs.get("reset") == "eager" for x in graphed)
    return 100.0 * eager / len(graphed)
