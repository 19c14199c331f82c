"""The port's integer-exact engine on the CPU against the golden files the
JAX package wrote (``artifacts/exact_cpu_*.npz``; the TPU's
``exact_tpu_*.npz`` hold the same bits), and against the port's own
parity engine at noise 0, with no tolerance.

The golden files reproduce with today's JAX package (its artifact scripts
in ``cpu`` mode give the same arrays).  Each scenario
(``eval/exact_scenarios.py``, built as the artifact scripts build it)
runs its first 50 steps here, and the trajectory file's 100 steps with
its final state; the card runs them all in chip_smoke.py phase 18.  The
f32 agents' actions on the exact engine (``model_actions``) are held so
too, but at near-ties of their f32 logits, which may round apart.
"""
import numpy as np
import pytest
import torch

from marl_sortingenv_tpu_torch.config.config import load_config
from marl_sortingenv_tpu_torch.core import exact_dynamics as XD
from marl_sortingenv_tpu_torch.core import state as S
from marl_sortingenv_tpu_torch.core import step as ST
from marl_sortingenv_tpu_torch.eval import exact_scenarios as XS

torch.set_num_threads(1)

GOLDEN = ["bench"] + [n for n in XS.NAMES
                      if n.startswith(("variants:", "noise:"))]


@pytest.mark.parametrize("name", GOLDEN)
def test_golden_first_50_steps(name):
    got = XS.run(name, "cpu", steps=50)
    got.pop("_stats")
    want = XS.golden(name)
    assert set(got) <= set(want) and got
    assert XS.compare(got, want, steps=50) == []
    # the TPU's file holds the same bits
    assert XS.compare(got, XS.golden(name, tpu=True), steps=50) == []


def test_golden_trajectory_whole():
    got = XS.run("traj", "cpu")
    got.pop("_stats")
    want = XS.golden("traj")
    assert sorted(got) == sorted(want)
    assert XS.compare(got, want) == []
    assert XS.compare(got, XS.golden("traj", tpu=True)) == []


def test_model_actions_first_50_steps():
    """The f32 agents of ``artifacts/models_tuned`` on the exact engine
    (closed-loop monolith, the sort and press agents on the rule-based obs
    streams) take the JAX package's actions, in the CPU file and the
    TPU's, but at counted near-ties of their f32 logits."""
    got = XS.run("model_actions", "cpu", steps=50)
    got.pop("_stats")
    near = got.pop("_near")
    want = XS.golden("model_actions")
    assert sorted(got) == sorted(want) and len(got) == 30
    assert all(v.shape == (50,) for v in got.values())
    for w in (want, XS.golden("model_actions", tpu=True)):
        bad, ties = XS.compare_actions(got, w, near)
        assert bad == [], bad
        assert all(near[k][t] for k, t, _, _ in ties)


def test_compare_actions_allows_only_near_ties():
    """``compare_actions``: a split at a step not marked near is refused;
    one at a near step is counted, and a closed-loop stream is compared
    only up to its first split."""
    want = {"mono_closed_1": np.asarray([0, 1, 2, 3], np.int32),
            "modular_sort_1": np.asarray([0, 1, 0, 1], np.int64)}
    near = {"mono_closed_1": np.asarray([0, 1, 0, 0], bool),
            "modular_sort_1": np.asarray([0, 0, 1, 0], bool)}
    got = {"mono_closed_1": np.asarray([0, 5, 9, 9], np.int32),
           "modular_sort_1": np.asarray([0, 1, 1, 1], np.int64)}
    assert XS.compare_actions(got, want, near) == (
        [], [("modular_sort_1", 2, 1, 0), ("mono_closed_1", 1, 5, 1)])
    got["modular_sort_1"] = np.asarray([1, 1, 0, 1], np.int64)
    assert XS.compare_actions(got, want, near)[0] == ["modular_sort_1"]
    got["modular_sort_1"] = want["modular_sort_1"].astype(np.int32)
    assert XS.compare_actions(got, want, near)[0] == ["modular_sort_1"]


def test_model_scenarios_run():
    """The integer-policy scenarios (no file: the card holds them to the
    CPU) keep the artifact script's keys and agents."""
    got = XS.run("model:modular", "cpu", steps=5)
    assert got.pop("_stats")["steps"] == 5
    assert sorted(got) == ["modular_actions", "modular_bale_cnt",
                           "modular_cont_true", "modular_obs_bits",
                           "modular_reward_bits"]
    assert got["modular_reward_bits"].dtype == np.uint64


CFG = load_config(max_steps=200, noise_sorting=0.0, balesize=200)
SEEDS = np.asarray([42, 7, 123])


def _bits(x):
    return x.numpy().view(np.uint64 if x.dtype == torch.float64
                          else np.uint32)


@pytest.mark.parametrize("kind", ["rule", "external", "sort", "press"])
def test_exact_equals_parity_at_noise0(kind):
    """At noise 0 the exact engine's trajectory is the parity engine's:
    obs and reward bits, actions, logs, integer state, the RNG streams,
    purity and quality in cents (as the JAX package requires of its
    own engines)."""
    rng = np.random.default_rng(11)
    n_act = {"rule": 1, "external": 22, "sort": 2, "press": 11}[kind]
    acts = torch.from_numpy(rng.integers(0, n_act, (40, len(SEEDS)))
                            .astype(np.int32))
    fx = {"rule": lambda s, a: XD.step_mono_rule_exact(CFG, s),
          "external": lambda s, a: XD.step_mono_external_exact(CFG, s, a,
                                                               False),
          "sort": lambda s, a: XD.step_sort_exact(CFG, s, a),
          "press": lambda s, a: XD.step_press_exact(CFG, s, a, False)}[kind]
    fp = {"rule": lambda s, a: ST.step_mono_rule(CFG, s),
          "external": lambda s, a: ST.step_mono_external(CFG, s, a, False),
          "sort": lambda s, a: ST.step_sort(CFG, s, a),
          "press": lambda s, a: ST.step_press(CFG, s, a, None, False)}[kind]
    sx = S.reset(CFG, SEEDS, device="cpu")
    sp = S.reset(CFG, SEEDS, device="cpu")
    for t in range(40):
        sx, ox = fx(sx, acts[t])
        sp, op = fp(sp, acts[t])
        assert np.array_equal(_bits(ox["obs"]), _bits(op.obs)), t
        assert np.array_equal(ox["reward_bits"].numpy().view(np.uint64),
                              _bits(op.reward)), t
        assert torch.equal(ox["action"], op.action)
        assert torch.equal(ox["press_log"], op.press_log)
        assert torch.equal(ox["purity_cents"],
                           torch.round(op.purity * 100).to(torch.int32))
        if kind in ("rule", "external"):
            assert np.array_equal(
                ox["sort_reward_bits"].numpy().view(np.uint64),
                _bits(op.sort_reward))
    for f in ("cont_true", "cont_false", "press_timer", "press_n",
              "bale_size", "bale_qual", "bale_cnt", "current_step"):
        assert torch.equal(getattr(sx, f), getattr(sp, f)), f
    assert torch.equal(sx.press_q, torch.round(sp.press_q * 100))
    for g in ("rng", "rng_noise", "rng_input", "rng_pressing", "gen_rng"):
        for a, b in zip(getattr(sx, g), getattr(sp, g)):
            assert torch.equal(a, b), g


def test_rollout_return_is_the_left_to_right_sum():
    """``rollout_rule_exact``'s soft-float return equals the reference's
    Python-float sum of the parity engine's rewards, and its outputs the
    stepwise ones."""
    st = S.reset(CFG, SEEDS, device="cpu")
    _, outs, cum = XD.rollout_rule_exact(CFG, st, 30)
    sp = S.reset(CFG, SEEDS, device="cpu")
    acc = [0.0] * len(SEEDS)
    for t in range(30):
        sp, op = ST.step_mono_rule(CFG, sp)
        assert np.array_equal(outs["reward_bits"][t].numpy().view(np.uint64),
                              _bits(op.reward))
        acc = [a + float(r) for a, r in zip(acc, op.reward.tolist())]
    assert cum.numpy().view(np.float64).tolist() == acc
    assert "reward_sfs" not in outs and outs["obs"].shape == (30, 3, 29)


def test_exact_press_reward_refuses_other_configs():
    """The exact press reward holds for the reference's max_state_reward
    0.5 and ordered negative penalties only, as in the JAX package."""
    with pytest.raises(ValueError, match="max_state_reward"):
        XD._press_tab_exact(load_config(max_state_reward=0.25))
    with pytest.raises(ValueError, match="penalties"):
        XD._press_tab_exact(load_config(overflow_penalty_mild=0.5))
