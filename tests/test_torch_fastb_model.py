"""The port's ``fastb.step_mono_model`` and ``step_mono_random`` (the engine
benchmark's Random, Sort-Only and Modular policies) against the JAX
engine's on the CPU: 128 envs x 42 autoreset steps at max_steps=36 (across
an episode's end), masked and unmasked, with and without each tuned agent
of ``artifacts/models_tuned``; every state leaf and output as in
test_torch_fastb (bitwise, the sorting reward's tanh to 4 ulp).

The random draws are ``vmap(jax.random.categorical)``: the gumbel words are
bitwise, but torch's and XLA's f32 ``log`` may differ in the last bit, so
the drawn index can differ where two perturbed logits (gumbel + logit) of
an env nearly tie.  ``lockstep`` counts the envs whose action differs and
accepts one only where the two largest perturbed logits of one of that
step's draws lie within 4 ulp; it then carries on from the JAX state.  Any
other difference fails.  An agent's argmax that splits between the
packages fails too (the policy is held to rtol 1e-5, not bitwise).

The JAX engine runs with ``jax_enable_x64`` off (``no_x64``), as in
production: its masked draws take the logits ``jnp.where(mask, 0.0,
-jnp.inf)``, which are f64 under x64 (the suite's default), and an f64
categorical draws other bits.  The port draws in f32.

On the card (marker ``cuda``; this module imports JAX only inside the CPU
tests): the steps with their sorting core on kernel 2 equal the plain
steps (no launch) bitwise, and the CPU path up to near-ties.
"""
import os

import numpy as np
import pytest
import torch

from marl_sortingenv_tpu_torch.config.config import load_config
from marl_sortingenv_tpu_torch.core import fastb as TB
from marl_sortingenv_tpu_torch.core import threefry as TF
from marl_sortingenv_tpu_torch.models import mlp
from marl_sortingenv_tpu_torch.ops import sort_cuda, step_cuda

# one thread: these tensors are tiny, and the suite's workers share the CPU
torch.set_num_threads(1)

N, STEPS = 128, 42
KW = dict(bale_mode="events", max_steps=36)
MODELS = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                      "models_tuned")
NPZ = {"sort": "PPO_Sorting_Tuned_100000.npz",
       "press": "PPO_Pressing_Tuned_100000.npz",
       "mono": "PPO_Monolith_Tuned_100000.npz"}
DIMS = {"sort": (13, 2), "press": (16, 11), "mono": (29, 22)}
TIE_ULPS = 4


def agent(name, device="cpu"):
    return mlp.load_npz(os.path.join(MODELS, NPZ[name]),
                        device=device).requires_grad_(False)


def jax_agent(name):
    import jax
    from marl_sortingenv_tpu.models import mlp as jmlp
    from marl_sortingenv_tpu.utils.checkpoint import load_model

    return (jmlp.policy_logits, load_model(
        os.path.join(MODELS, NPZ[name]),
        jmlp.init_params(jax.random.PRNGKey(0), *DIMS[name])))


def no_x64(fn):
    """``fn`` called with ``jax_enable_x64`` off."""
    import jax

    def call(*args, **kw):
        with jax.enable_x64(False):
            return fn(*args, **kw)
    return call


class DrawLog:
    """Records the (keys, logits) of every categorical draw of a step (a
    wrapper around ``fastb._vcategorical``)."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = TB._vcategorical

        def draw(keys, logits):
            self.calls.append((keys, logits))
            return real(keys, logits)
        monkeypatch.setattr(TB, "_vcategorical", draw)

    def near_tie(self, env: int) -> bool:
        """Whether one of the logged draws has, at ``env``, two largest
        perturbed logits within TIE_ULPS ulp."""
        for keys, logits in self.calls:
            p = TF.vperturbed(keys[env:env + 1], logits[env:env + 1])[0]
            top = torch.topk(p.cpu(), 2).values.numpy().astype(np.float32)
            if np.isfinite(top).all() and abs(
                    int(top[0].view(np.int32)) - int(top[1].view(np.int32))
            ) <= TIE_ULPS:
                return True
        return False


def lockstep(step_a, step_b, st_a, st_b, steps, log, resync, compare):
    """Step two engines side by side.  ``compare(st_a, out_a, st_b, out_b,
    t)`` asserts equality; where the actions differ each differing env must
    be a near-tie of this step's draws (``log``), and ``resync(st_a)``
    gives the state to carry on from.  Returns (state b, number of
    near-ties, whether an episode ended)."""
    ties, crossed = 0, False
    for t in range(steps):
        log.calls.clear()
        st_a, out_a = step_a(st_a)
        st_b, out_b = step_b(st_b)
        a_a = np.asarray(out_a.action).astype(np.int64)
        a_b = out_b.action.cpu().numpy().astype(np.int64)
        split = np.flatnonzero(a_a != a_b)
        if split.size:
            for env in split:
                assert log.near_tie(int(env)), (
                    f"step {t}: env {env} drew {a_b[env]}, the reference "
                    f"{a_a[env]}, with no near-tie")
            ties += split.size
            st_b = resync(st_a)
        else:
            compare(st_a, out_a, st_b, out_b, t)
        crossed |= bool(np.asarray(out_a.terminated).any())
    return st_b, ties, crossed


def jax_to_torch(st_j):
    kw = {}
    for nm, x in zip(TB.BState._fields, st_j):
        if x is None:
            kw[nm] = None
            continue
        a = np.asarray(x)
        kw[nm] = torch.from_numpy(np.array(a.view(np.int32) if nm == "key"
                                           else a))
    return TB.BState(**kw)


CASES = ([pytest.param("random", None, None, m, id=f"random-masked{m}")
          for m in (True, False)]
         + [pytest.param("model", s, p, m,
                         id=f"model-{s or 'nosort'}-{p or 'nopress'}-"
                            f"masked{m}")
            for s in (None, "sort") for p in (None, "press")
            for m in (True, False)])


@pytest.mark.parametrize("kind,sort_name,press_name,masked", CASES)
def test_model_random_match_jax(monkeypatch, kind, sort_name, press_name,
                                masked):
    import jax
    from marl_sortingenv_tpu.config.config import load_config as jload
    from marl_sortingenv_tpu.core import fastb as FB
    from test_torch_fastb import assert_out_equal, assert_state_equal

    cfg_j, cfg_t = jload(**KW), load_config(**KW)
    if kind == "random":
        fj = lambda c, s, a: FB.step_mono_random(c, s, masked)  # noqa: E731
        ft = lambda c, s, a: TB.step_mono_random(c, s, masked)  # noqa: E731
    else:
        sj = jax_agent(sort_name) if sort_name else None
        pj = jax_agent(press_name) if press_name else None
        st_ = agent(sort_name) if sort_name else None
        pt_ = agent(press_name) if press_name else None
        fj = lambda c, s, a: FB.step_mono_model(  # noqa: E731
            c, s, sj, pj, masked)
        ft = lambda c, s, a: TB.step_mono_model(  # noqa: E731
            c, s, st_, pt_, masked)
    step_j = no_x64(jax.jit(lambda s: FB.with_autoreset(cfg_j, fj)(s, None)))
    step_t = lambda s: TB.with_autoreset(cfg_t, ft)(s, None)  # noqa: E731
    log = DrawLog(monkeypatch)

    def compare(st_j, out_j, st_t, out_t, t):
        assert_state_equal(st_j, st_t, f"step {t}")
        assert_out_equal(out_j, out_t, f"step {t}")

    launches = (step_cuda.LAUNCHES, sort_cuda.LAUNCHES)
    st_t, ties, crossed = lockstep(
        step_j, step_t,
        no_x64(FB.reset_batch)(cfg_j, jax.random.PRNGKey(5), N),
        TB.reset_batch(cfg_t, 5, N, device="cpu"), STEPS, log, jax_to_torch,
        compare)
    assert crossed, "no env crossed an episode boundary"
    assert (step_cuda.LAUNCHES, sort_cuda.LAUNCHES) == launches
    print(f"near-ties: {ties}")


def test_masked_draws_are_valid():
    """Every masked random action is one the mask allows."""
    cfg = load_config(**KW)
    st = TB.reset_batch(cfg, 3, 64, device="cpu")
    for _ in range(30):
        mask = TB.monolith_action_masks(cfg, st)
        st, out = TB.step_mono_random(cfg, st, True)
        assert mask[torch.arange(64), out.action.long()].all()
        mask = TB.monolith_action_masks(cfg, st)
        st, out = TB.step_mono_model(cfg, st, None, None, True)
        assert mask[torch.arange(64), out.action.long()].all()


def test_vcategorical_matches_jax():
    """Per-env draws (``vmap(jax.random.categorical)``), masked logits over
    22 actions at 4096 keys: equal but at near-ties of the perturbed
    logits."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    n = 4096
    logits = np.where(rng.random((n, 22)) < 0.5, 0.0, -np.inf)
    logits[:, 0] = 0.0
    logits = (logits + rng.normal(size=(n, 22))).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    ref = np.asarray(no_x64(jax.vmap(jax.random.categorical))(
        keys, jnp.asarray(logits)))
    kt = torch.from_numpy(np.asarray(keys).view(np.int32).copy())
    lt = torch.from_numpy(logits)
    got = TF.vcategorical(kt, lt).numpy()
    for env in np.flatnonzero(got != ref):
        top = torch.topk(TF.vperturbed(kt[env:env + 1], lt[env:env + 1])[0],
                         2).values.numpy()
        assert abs(int(top[0].view(np.int32)) - int(top[1].view(np.int32))
                   ) <= TIE_ULPS, env
    assert np.isfinite(logits[np.arange(n), got]).all()


# ---------------------------------------------------------------------------
# CUDA: the model and random steps on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sort kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind,sort_name,press_name,masked", CASES)
def test_cuda_model_random_match_plain_and_cpu(monkeypatch, cuda, kind,
                                               sort_name, press_name,
                                               masked):
    """512 envs x 42 autoreset steps: kernel 2 once per step, kernel 1
    never; equal to the plain steps bitwise and to the CPU path but at
    near-ties (the sorting reward's tanh to 4 ulp of 1)."""
    from test_torch_fastb_full import _same, outs_match

    cfg = load_config(**KW)
    sa = {d: (agent(sort_name, d) if sort_name else None,
              agent(press_name, d) if press_name else None)
          for d in ("cpu", cuda)}
    variant = "random" if kind == "random" else "model"

    def stepper(dev, plain):
        pols = () if kind == "random" else sa[dev]
        body = (TB.eager_step(variant, masked, *pols) if plain else
                (lambda c, s, a: TB.step_mono_random(c, s, masked))
                if kind == "random" else
                (lambda c, s, a: TB.step_mono_model(c, s, *pols, masked)))
        return lambda s: TB.with_autoreset(cfg, body)(s, None)

    n = 512
    st_k = st_p = TB.reset_batch(cfg, 6, n, device=cuda)
    step_k, step_p = stepper(cuda, False), stepper(cuda, True)
    for t in range(STEPS):
        k1, k2 = step_cuda.LAUNCHES, sort_cuda.LAUNCHES
        st_k, o_k = step_k(st_k)
        assert (step_cuda.LAUNCHES - k1, sort_cuda.LAUNCHES - k2) == (0, 1)
        st_p, o_p = step_p(st_p)
        assert sort_cuda.LAUNCHES - k2 == 1
        _same(st_k, st_p, f"plain step {t}")
        outs_match(o_k, o_p, f"plain step {t}")
    log = DrawLog(monkeypatch)

    def compare(st_c, out_c, st_g, out_g, t):
        _same(st_g, st_c, f"CPU step {t}")
        outs_match(out_g, out_c, f"CPU step {t}", tanh_ulps=4)

    lockstep(stepper("cpu", False), step_k,
             TB.reset_batch(cfg, 6, n, device="cpu"),
             TB.reset_batch(cfg, 6, n, device=cuda), STEPS, log,
             lambda st_c: TB.BState(*(None if x is None else x.to(cuda)
                                      for x in st_c)), compare)
