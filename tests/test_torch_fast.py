"""The port's per-env ``fast`` engine (marl_sortingenv_tpu_torch/core/fast.py,
a batch-first view over ``fastb`` in full-bale mode) against the JAX
package's ``fast`` engine under ``vmap``, on the CPU: 64 envs x 42 autoreset
steps at max_steps=36 (across an episode's end), press times 1 and 2 and
bales of 16, every variant; every state leaf and output bitwise, the
sorting reward's tanh to 4 ulp.  The random and model steps draw with
``categorical``: near-ties are handled as in test_torch_fastb_model, and
the JAX engine runs with x64 off, as there.

Also: the view equals ``fastb`` in full mode bit for bit, whatever
``bale_mode`` the config names (JAX's ``fast`` ignores it); the reset of
one key is a batch of one; and the view's functions reach no kernel on the
CPU.
"""
import numpy as np
import pytest
import torch

from marl_sortingenv_tpu_torch.config.config import load_config
from marl_sortingenv_tpu_torch.core import fast as FE
from marl_sortingenv_tpu_torch.core import fastb as TB
from marl_sortingenv_tpu_torch.core import threefry as TF
from marl_sortingenv_tpu_torch.ops import sort_cuda, step_cuda
from test_torch_fastb_model import DrawLog, agent, jax_agent, lockstep, no_x64

# one thread: these tensors are tiny, and the suite's workers share the CPU
torch.set_num_threads(1)

N, STEPS = 64, 42
KW = dict(max_steps=36, press_time_1=1, press_time_2=2, balesize=16)
N_ACT = {"rule": 22, "external": 22, "sort": 2, "press": 11}


def _steps(mod, variant, masked, sort_agent=None, press_agent=None):
    """(cfg, st, action) -> (st, out) of ``variant`` in ``mod``."""
    return {
        "rule": lambda c, s, a: mod.step_mono_rule(c, s),
        "external": lambda c, s, a: mod.step_mono_external(c, s, a, masked),
        "sort": lambda c, s, a: mod.step_sort(c, s, a),
        "press": lambda c, s, a: mod.step_press(c, s, a, sort_agent, masked),
        "model": lambda c, s, a: mod.step_mono_model(
            c, s, sort_agent, press_agent, masked),
        "random": lambda c, s, a: mod.step_mono_random(c, s, masked),
    }[variant]


def _assert_fast_equal(st_j, st_t, tag):
    for nm, a, b in zip(FE.FastEnvState._fields, st_j, st_t):
        a = np.asarray(a)
        if nm == "key":
            a = a.view(np.int32)
        np.testing.assert_array_equal(a.astype(b.numpy().dtype), b.numpy(),
                                      err_msg=f"{tag} state.{nm}")


def _jax_to_fast(st_j):
    return FE.FastEnvState(*(
        torch.from_numpy(np.array(np.asarray(x).view(np.int32)
                                  if nm == "key" else np.asarray(x)))
        for nm, x in zip(FE.FastEnvState._fields, st_j)))


@pytest.mark.parametrize("variant,masked,agents", [
    ("rule", True, ()), ("external", True, ()), ("external", False, ()),
    ("sort", True, ()), ("press", True, ()), ("press", False, ("sort",)),
    ("random", True, ()), ("model", False, ("sort", "press")),
    ("model", True, (None, "press"))])
def test_fast_matches_jax_vmapped(monkeypatch, variant, masked, agents):
    import jax
    import jax.numpy as jnp
    from marl_sortingenv_tpu.config.config import load_config as jload
    from marl_sortingenv_tpu.core import fast as JFE
    from test_torch_fastb import assert_out_equal

    cfg_j, cfg_t = jload(**KW), load_config(**KW)
    names = list(agents) + [None] * (2 - len(agents))
    fj = _steps(JFE, variant, masked,
                *[jax_agent(a) if a else None for a in names])
    ft = _steps(FE, variant, masked, *[agent(a) if a else None
                                       for a in names])
    step_j = no_x64(jax.jit(jax.vmap(JFE.with_autoreset(cfg_j, fj))))
    step_t = FE.with_autoreset(cfg_t, ft)
    rng = np.random.default_rng(4)
    acts = rng.integers(0, N_ACT.get(variant, 22), (STEPS, N)).astype(
        np.int32)
    t_now = [0]             # the step both engines take next

    def a_step_j(s):
        return step_j(s, jnp.asarray(acts[t_now[0]]))

    def a_step_t(s):
        a = acts[t_now[0]]
        t_now[0] += 1
        return step_t(s, torch.from_numpy(a))

    def compare(st_j, out_j, st_t, out_t, t):
        _assert_fast_equal(st_j, st_t, f"step {t}")
        assert_out_equal(out_j, out_t, f"step {t}")

    st_j = no_x64(JFE.reset_batch)(cfg_j, jax.random.PRNGKey(4), N)
    st_t = FE.reset_batch(cfg_t, 4, N, device="cpu")
    _assert_fast_equal(st_j, st_t, "reset")
    launches = (step_cuda.LAUNCHES, sort_cuda.LAUNCHES)
    st_t, _, crossed = lockstep(a_step_j, a_step_t, st_j, st_t, STEPS,
                                DrawLog(monkeypatch), _jax_to_fast, compare)
    assert crossed, "no env crossed an episode boundary"
    assert (step_cuda.LAUNCHES, sort_cuda.LAUNCHES) == launches
    if variant in ("rule", "press"):
        assert int(st_t.bale_cnt.max()) > 0, "no bale was made"


@pytest.mark.parametrize("bale_mode", ["events", "full", "auto"])
def test_fast_view_equals_fastb_full(bale_mode):
    """The view is ``fastb`` in full mode, whatever the config says: 40
    masked external autoreset steps at 32 envs, every leaf and output."""
    cfg = load_config(bale_mode=bale_mode, **KW)
    cfg_full = load_config(bale_mode="full", **KW)
    st_f = FE.reset_batch(cfg, 2, 32, device="cpu")
    st_b = TB.reset_batch(cfg_full, 2, 32, device="cpu")
    step_f = FE.with_autoreset(cfg, _steps(FE, "external", True))
    step_b = TB.mono_autoreset_step(cfg_full, "external", True)
    rng = np.random.default_rng(2)
    for t in range(40):
        m = FE.monolith_action_masks(cfg, st_f).numpy()
        a = torch.from_numpy(np.array(
            [np.flatnonzero(r)[rng.integers(0, r.sum())] for r in m],
            np.int32))
        st_f, o_f = step_f(st_f, a)
        st_b, o_b = step_b(st_b, a)
        for nm, x, y in zip(FE.FastEnvState._fields, st_f,
                            TB.to_batch_first(st_b)):
            assert torch.equal(x, y), (t, nm)
        for x, y in zip(o_f, o_b):
            assert torch.equal(x, y), t


def test_reset_of_one_key_is_a_batch_of_one():
    cfg = load_config(**KW)
    keys = TF.split(TF.prng_key(9)[None], 3)[0]
    three = FE.reset(cfg, keys)
    one = FE.reset(cfg, keys[1])
    for nm, a, b in zip(FE.FastEnvState._fields, three, one):
        assert b.shape[0] == 1 and torch.equal(a[1:2], b), nm
    obs = FE.get_mono_obs(cfg, one)
    assert tuple(obs.shape) == (1, 29)
    assert tuple(FE.monolith_action_masks(cfg, one).shape) == (1, 22)
    with pytest.raises(ValueError, match="support bound"):
        FE.reset(cfg.with_(input_batch_size=300,
                           baseline_accuracy=(0.1,) * 4), keys)
