"""The port's one CUDA-graph seam (``ops/graphs.py``): the cache, its key
and lifetime rule, the launch accounting of a replay, the eligibility rule,
and the evaluation's use of it (``fastb.graphed_step``).

On the CPU, with a stand-in for ``graphs.capture`` (the one hook) that runs
the step once, as the real warm-up does, and whose replay runs it again.
The graphed paths themselves are held to the eager loops on the card by
``tests/test_torch_graphed_eval.py`` and ``test_torch_graphed_rollout.py``.
"""

from __future__ import annotations

import gc
import weakref
from types import SimpleNamespace

import pytest
import torch

from marl_sortingenv_tpu_torch.config.config import load_config
from marl_sortingenv_tpu_torch.core import fastb as FB
from marl_sortingenv_tpu_torch.models import mlp
from marl_sortingenv_tpu_torch.ops import graphs, mvhg_cuda, sort_cuda, \
    step_cuda

# one thread: these tensors are tiny, and the suite's workers share the CPU
torch.set_num_threads(1)

LAUNCHES = [2, 1, 0]      # the stand-in capture's record: kernels 1, 2, 3


@pytest.fixture
def rerun(monkeypatch):
    """``graphs.capture`` without a card."""
    def capture(device, run):
        return SimpleNamespace(replay=run), run(), list(LAUNCHES)
    monkeypatch.setattr(graphs, "capture", capture)


def _step(x):
    """A step function of its own (each call makes a new one)."""
    def step():
        x.add_(1)
        return x
    return step


def _agent(seed=0):
    return mlp.ActorCritic(4, 3, device="cpu",
                           generator=torch.Generator().manual_seed(seed))


def _entry(fn, key, buffers, made):
    """``fn``'s entry; the graph is of a step of its own, as a real capture
    keeps no Python object of the step it records."""
    def make():
        made.append(1)
        return graphs.Graph(buffers[0].device, _step(buffers[0]))
    return graphs.cached(fn, key, buffers, make)


def test_second_request_is_the_cached_entry(rerun):
    x = torch.zeros(3)
    fn, made = _step(x), []
    g = _entry(fn, ("cfg", True), (x,), made)
    assert _entry(fn, ("cfg", True), (x,), made) is g
    assert made == [1]


@pytest.mark.parametrize("change", ["step", "key", "layout", "dtype",
                                    "agent", "tf32"])
def test_each_part_of_the_key_keys_a_new_entry(rerun, change, monkeypatch):
    """Another step function (a patched step), configuration, buffer
    layout, agent or TF32 setting is captured anew; the first entry stays
    and is handed out again for its own key."""
    x, agent = torch.zeros(3), _agent()
    fn, made = _step(x), []
    g = _entry(fn, ("cfg", agent), (x,), made)
    other = {"step": (_step(x), ("cfg", agent), (x,)),
             "key": (fn, ("cfg2", agent), (x,)),
             "layout": (fn, ("cfg", agent), (torch.zeros(4),)),
             "dtype": (fn, ("cfg", agent),
                       (torch.zeros(3, dtype=torch.int32),)),
             "agent": (fn, ("cfg", _agent(1)), (x,)),
             "tf32": (fn, ("cfg", agent), (x,))}[change]
    if change == "tf32":
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                            not torch.backends.cuda.matmul.allow_tf32)
    h = _entry(*other, made)
    assert h is not g and made == [1, 1]
    monkeypatch.undo()
    monkeypatch.setattr(graphs, "capture", lambda device, run: (
        SimpleNamespace(replay=run), run(), list(LAUNCHES)))
    assert _entry(fn, ("cfg", agent), (x,), made) is g
    assert made == [1, 1]


def test_agents_key_by_their_parameters_storages(rerun):
    """An agent keys by where its parameters lie: the same agent with its
    parameters replaced keys a new entry, a copy into them does not."""
    x, agent = torch.zeros(3), _agent()
    fn, made = _step(x), []
    g = _entry(fn, (agent,), (x,), made)
    with torch.no_grad():
        for p in agent.parameters():
            p.add_(1.0)
    assert _entry(fn, (agent,), (x,), made) is g
    agent.action_net.weight = torch.nn.Parameter(
        agent.action_net.weight.clone())
    assert _entry(fn, (agent,), (x,), made) is not g


def test_replay_counts_its_capture_launches(rerun):
    """The capture counts one capture and no replay; each replay runs the
    step (here: the stand-in) and adds the capture's launches."""
    x = torch.zeros(3)
    before = (graphs.CAPTURES, graphs.REPLAYS, step_cuda.LAUNCHES,
              sort_cuda.LAUNCHES, mvhg_cuda.LAUNCHES)
    g = graphs.Graph(x.device, _step(x))
    assert x.tolist() == [1.0] * 3 and g.out is x
    assert (graphs.CAPTURES, graphs.REPLAYS) == (before[0] + 1, before[1])
    for _ in range(3):
        g.replay()
    assert x.tolist() == [4.0] * 3
    assert (graphs.CAPTURES, graphs.REPLAYS) == (before[0] + 1,
                                                 before[1] + 3)
    assert (step_cuda.LAUNCHES, sort_cuda.LAUNCHES, mvhg_cuda.LAUNCHES) == (
        before[2] + 6, before[3] + 3, before[4])


@pytest.mark.parametrize("drop", ["step", "agent"])
def test_an_entry_goes_with_its_step_or_its_agents(rerun, drop):
    """An entry lives while its step function and every agent of its key
    live; it holds the agents only through their parameters."""
    x, agent = torch.zeros(3), _agent()
    fn, made = _step(x), []
    g = weakref.ref(_entry(fn, ("cfg", agent, None), (x,), made))
    a = weakref.ref(agent)
    gc.collect()
    assert g() is not None
    if drop == "step":
        del fn
    else:
        del agent
        assert a() is None
    gc.collect()
    assert g() is None


@pytest.mark.parametrize("engine,device,mesh,want", [
    ("fastb", "cuda", None, True), ("fastb", "cuda:1", None, True),
    ("fastb", "cpu", None, False), ("fast", "cuda", None, False),
    ("parity", "cuda", None, False), ("fastb", "cuda", object(), False),
    (None, "cuda", None, True), (None, "cuda:1", None, True),
    (None, "cpu", None, False)])
def test_eligibility(engine, device, mesh, want):
    """Steps replay on CUDA, on ``fastb``, without a mesh, and nowhere
    else; work that holds no env step (a PPO update) replays on CUDA."""
    assert graphs.eligible(engine, device, mesh) is want


def test_eval_graphs_only_its_eager_bodies(rerun, monkeypatch):
    """``fastb.graphed_step`` graphs the public steps that are eager bodies
    (named by their spans' body), gives None for the kernel-1 steps and
    while a stepper is in use, and captures a patched step anew under the
    body of its name."""
    cfg = load_config(max_steps=20)
    st = FB.reset_batch(cfg, 3, 4, device="cpu")
    assert FB.graphed_step(cfg, "step_mono_rule", (), st) is None
    assert FB.graphed_step(cfg, "step_mono_external", (), st) is None
    g = FB.graphed_step(cfg, "step_mono_random", (True,), st)
    assert g.body == "random"
    assert FB.graphed_step(cfg, "step_mono_random", (True,), st) is g
    with g.loaded(st):
        assert FB.graphed_step(cfg, "step_mono_random", (True,), st) is None
    assert FB.graphed_step(cfg, "step_mono_model", (None, None, True),
                           st).body == "model"
    real = FB.step_mono_random
    monkeypatch.setattr(FB, "step_mono_random",
                        lambda *a, **kw: real(*a, **kw))
    h = FB.graphed_step(cfg, "step_mono_random", (True,), st)
    assert h is not g and h.body == "random"
