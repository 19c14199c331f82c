"""The integer-exact engine's reference scenarios, as the JAX package's
artifact scripts build them, in the layout of their ``.npz`` files.

Each scenario runs the port's integer-exact engine
(``core/exact_dynamics.py``) on a device and returns numpy arrays under
the keys of the matching file, so that a run can be held bit for bit to
``artifacts/exact_cpu_*.npz`` (the JAX package on the CPU), to the TPU's
``artifacts/exact_tpu_*.npz`` and to the same scenario on another device:

* ``bench``: the Rule-Based scenario of the 5-policy benchmark, seeds 1-10
  x 200 steps, the per-step reward bits and the cumulative return summed
  in soft-float (``artifacts/exact_tpu_benchmark.py``);
* ``variants:<case>``: the sort, press (masked, unmasked) and external
  monolith (masked, unmasked) steps, seed 42 x 100 steps, actions from
  ``default_rng(99)`` (``artifacts/exact_tpu_variants.py``);
* ``noise:<case>``: the rule, unmasked external and sort steps at the
  reference's default noise 0.05, with the accuracies' IEEE bits
  (``artifacts/exact_tpu_noise.py``);
* ``traj``: the rule-based monolith, seed 42 x 100 steps, every obs,
  action and purity and the final state (``exact_*_traj.npz``);
* ``model:<case>``: the integer-policy paths with the agents of
  ``artifacts/models_masked`` (``artifacts/mlp_exact_tpu.py``; that
  script keeps its output outside the repo, so these have no file);
* ``model_actions``: the f32 actor-critics of ``artifacts/models_tuned``
  on the exact engine, seeds 1-10 x 200 steps: the monolith agent in
  closed loop (its masked argmax fed to the external step), and the sort
  and press agents' argmax on the rule-based episode's obs streams
  (``artifacts/exact_tpu_model_actions.py``).  The policy's f32 products
  round apart across devices, so an action may split where the two
  largest logits lie within ``ARGMAX_RTOL``: ``run`` returns those steps
  under ``_near`` and ``compare_actions`` holds the actions to them;
* ``wide``: the rule step at 4096 envs x 20 steps (no file).

The common configuration is max_steps 200, balesize 200, noise 0 (but
``noise``).  ``steps`` cuts a scenario's episode; the keys that only the
whole episode defines (the cumulative return, the final state) are then
left out.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..config.config import load_config
from ..core import dynamics as D
from ..core import exact_dynamics as XD
from ..core import rng as R
from ..core import state as S

ARTIFACTS = Path(__file__).resolve().parents[2] / "artifacts"
MODELS = ARTIFACTS / "models_masked"
TUNED = ARTIFACTS / "models_tuned"
ARGMAX_RTOL = 1e-5      # an argmax near-tie: top two within this of the top

VARIANTS = ("sort", "press_masked", "press_unmasked", "mono_ext_masked",
            "mono_ext_unmasked")
NOISE = ("mono_rule", "mono_ext_unmasked", "sort")
MODEL = ("press", "modular", "sortonly", "mono")
NAMES = (("bench", "traj", "wide") + tuple(f"variants:{c}" for c in VARIANTS)
         + tuple(f"noise:{c}" for c in NOISE)
         + tuple(f"model:{c}" for c in MODEL) + ("model_actions",))
# the golden file of each scenario family (the TPU's variants are split in
# two files)
GOLDEN = {"bench": "exact_cpu_bench.npz", "traj": "exact_cpu_traj.npz",
          "variants": "exact_cpu_variants.npz", "noise": "exact_cpu_noise.npz",
          "model_actions": "exact_cpu_model_actions.npz"}
GOLDEN_TPU = {"bench": ("exact_tpu_bench.npz",),
              "model_actions": ("exact_tpu_model_actions.npz",),
              "traj": ("exact_tpu_traj.npz",),
              "variants": ("exact_tpu_variants1.npz",
                           "exact_tpu_variants2.npz"),
              "noise": ("exact_tpu_noise.npz",)}


def config(noise: float = 0.0):
    return load_config(max_steps=200, noise_sorting=noise, balesize=200)


def _actions():
    """The artifact scripts' action streams, drawn in their order."""
    rng = np.random.default_rng(99)
    var = {"sort": rng.integers(0, 2, 100),
           "press_masked": np.zeros(100, np.int64),
           "press_unmasked": rng.integers(0, 11, 100),
           "mono_ext_masked": np.zeros(100, np.int64),
           "mono_ext_unmasked": rng.integers(0, 22, 100)}
    rng = np.random.default_rng(99)
    noise = {"mono_rule": np.zeros(100, np.int64),
             "mono_ext_unmasked": rng.integers(0, 22, 100),
             "sort": rng.integers(0, 2, 100)}
    return var, noise


def _step_fn(case: str, cfg):
    return {
        "sort": lambda s, a: XD.step_sort_exact(cfg, s, a),
        "press_masked": lambda s, a: XD.step_press_exact(cfg, s, a, True),
        "press_unmasked": lambda s, a: XD.step_press_exact(cfg, s, a, False),
        "mono_ext_masked": lambda s, a: XD.step_mono_external_exact(
            cfg, s, a, True),
        "mono_ext_unmasked": lambda s, a: XD.step_mono_external_exact(
            cfg, s, a, False),
        "mono_rule": lambda s, a: XD.step_mono_rule_exact(cfg, s),
    }[case]


def agents(device):
    """The integer policies of ``artifacts/models_masked`` (sort, press,
    mono), quantized on the host."""
    from ..models import mlp, mlp_exact as MX
    return tuple(
        MX.quantize_policy(mlp.load_npz(str(MODELS / f), "cpu"), device)
        for f in ("PPO_Sorting_Masked_100000.npz",
                  "PPO_Pressing_Masked_100000.npz",
                  "PPO_Monolith_Masked_100000.npz"))


def tuned_agents(device):
    """The f32 actor-critics of ``artifacts/models_tuned`` (sort, press,
    mono)."""
    from ..models import mlp
    return tuple(mlp.load_npz(str(TUNED / f), device).requires_grad_(False)
                 for f in ("PPO_Sorting_Tuned_100000.npz",
                           "PPO_Pressing_Tuned_100000.npz",
                           "PPO_Monolith_Tuned_100000.npz"))


def _argmax(logits: torch.Tensor):
    """(the first maximal index as int32, whether the two largest logits
    lie within ARGMAX_RTOL of the larger) along the last axis."""
    top = torch.topk(logits, 2, dim=-1).values
    near = (top[..., 0] - top[..., 1]) <= ARGMAX_RTOL * top[
        ..., 0].abs().clamp(min=1.0)
    return torch.argmax(logits, dim=-1).to(torch.int32), near


@torch.no_grad()
def _model_actions(cfg, dev, steps: int) -> tuple:
    """The ``model_actions`` scenario: (arrays, near-ties), keyed as the
    artifact file, one [steps] array per seed and stream."""
    from ..models import mlp
    sp, pp, mono = tuned_agents(dev)
    seeds = np.arange(1, 11)
    st = S.reset(cfg, seeds, device=dev)
    acts, near = [], []
    for _ in range(steps):
        obs = XD.get_mono_obs_exact(cfg, st)
        a, n = _argmax(mlp.masked_logits(mono.policy_logits(obs),
                                         D.monolith_action_masks(cfg, st)))
        acts.append(a)
        near.append(n)
        st, _ = XD.step_mono_external_exact(cfg, st, a, True)
    streams = {"mono_closed": (torch.stack(acts), torch.stack(near))}
    st = S.reset(cfg, seeds, device=dev)
    so, po, pm = [], [], []
    for _ in range(steps):
        so.append(XD.get_sort_obs_exact(cfg, st))
        po.append(XD.get_press_obs_exact(cfg, st))
        pm.append(D.press_action_masks(cfg, st))
        st, _ = XD.step_mono_rule_exact(cfg, st)
    so, po, pm = torch.stack(so), torch.stack(po), torch.stack(pm)
    # one seed's stream per product, [steps, d], as the script multiplies
    sort = [_argmax(sp.policy_logits(so[:, i].contiguous()))
            for i in range(len(seeds))]
    press = [_argmax(mlp.masked_logits(pp.policy_logits(
        po[:, i].contiguous()), pm[:, i])) for i in range(len(seeds))]
    for name, res in (("modular_sort", sort), ("modular_press", press)):
        streams[name] = tuple(torch.stack([r[k] for r in res], 1)
                              for k in (0, 1))
    out, ties = {}, {}
    for name, (a, n) in streams.items():
        a, n = a.cpu().numpy(), n.cpu().numpy()
        if name != "mono_closed":       # the file's int64 argmax
            a = a.astype(np.int64)
        for i, seed in enumerate(seeds):
            out[f"{name}_{seed}"] = a[:, i]
            ties[f"{name}_{seed}"] = n[:, i]
    return out, ties


def _bits(x: torch.Tensor) -> np.ndarray:
    """A step output as the artifact files store it: f32 as its u32
    bits, IEEE-bit int64 as uint64."""
    a = x.detach().cpu().numpy()
    if a.dtype == np.float32:
        return a.view(np.uint32)
    return a


def run(name: str, device="cuda", steps: int | None = None) -> dict:
    """The scenario ``name`` (one of ``NAMES``) on ``device``; returns its
    arrays and ``_stats`` (seconds, steps, envs, host syncs); for
    ``model_actions`` also ``_near``, the near-tie steps of each array."""
    dev = resolve_device(device)
    fam, _, case = name.partition(":")
    var_acts, noise_acts = _actions()
    out = {}
    syncs, t0 = R.HOST_SYNCS, time.perf_counter()

    if fam == "bench":
        cfg, steps = config(), steps or 200
        st = S.reset(cfg, np.arange(1, 11), device=dev)
        st, outs, cum = XD.rollout_rule_exact(cfg, st, steps)
        out["reward_bits"] = _bits(outs["reward_bits"]).T.view(np.uint64)
        if steps == 200:
            out["cum_bits"] = _bits(cum).view(np.uint64)
        n_env = 10
    elif fam in ("variants", "noise", "traj", "wide"):
        if fam in ("traj", "wide"):
            case = "mono_rule"
        cfg = config(0.05 if fam == "noise" else 0.0)
        full = 20 if fam == "wide" else 100
        steps = steps or full
        acts = (var_acts if fam == "variants" else noise_acts).get(case)
        seeds = np.arange(4096) if fam == "wide" else np.asarray([42])
        n_env = len(seeds)
        st = S.reset(cfg, seeds, device=dev)
        step = _step_fn(case, cfg)
        rec = {"obs": [], "rew": [], "acc": [], "act": [], "pur": []}
        for t in range(steps):
            a = None if acts is None else torch.full(
                (n_env,), int(acts[t]), dtype=torch.int32, device=dev)
            st, o = step(st, a)
            rec["obs"].append(o["obs"])
            rec["rew"].append(o["reward_bits"])
            rec["acc"].append(st.acc_belt_bits)
            rec["act"].append(o["action"])
            rec["pur"].append(o["purity_cents"])
        rec = {k: _bits(torch.stack(v)) for k, v in rec.items()}
        if fam in ("variants", "noise"):
            out[f"{case}_obs"] = rec["obs"][:, 0]
            out[f"{case}_rew"] = rec["rew"][:, 0].view(np.uint64)
            if fam == "noise":
                out[f"{case}_acc"] = rec["acc"][:, 0].view(np.uint64)
        elif fam == "traj":
            out["obs"] = rec["obs"][:, 0].view(np.float32)
            out["act"] = rec["act"][:, 0]
            out["pur"] = rec["pur"][:, 0]
            if steps == full:
                v = XD.to_parity_view(S.env_at(st, 0))
                out.update(cont_true=v["cont_true"],
                           cont_false=v["cont_false"],
                           bale_size=v["bale_size"], bale_cnt=v["bale_cnt"],
                           press_q=v["press_q_cents"],
                           rng_lo=st.rng.state_lo[0].cpu().numpy().view(
                               np.uint64))
        else:
            out.update(obs=rec["obs"], reward_bits=rec["rew"].view(np.uint64),
                       action=rec["act"], purity_cents=rec["pur"])
            out.update({f"final_{k}": v for k, v in
                        XD.to_parity_view(st).items()})
    elif fam == "model_actions":
        steps = steps or 200
        out, out["_near"] = _model_actions(config(), dev, steps)
        n_env = 10
    elif fam == "model":
        cfg, steps = config(), steps or 200
        q_sort, q_press, q_mono = agents(dev)
        seed = {"press": 42, "modular": 7, "sortonly": 7, "mono": 5}[case]
        st = S.reset(cfg, [seed], device=dev)
        step = {
            "press": lambda s: XD.step_press_model_exact(cfg, s, 0, q_sort,
                                                         True),
            "modular": lambda s: XD.step_mono_model_exact(cfg, s, q_sort,
                                                          q_press, True),
            "sortonly": lambda s: XD.step_mono_model_exact(cfg, s, q_sort,
                                                           None, True),
            "mono": lambda s: XD.step_mono_policy_exact(cfg, s, q_mono, True),
        }[case]
        rec = {"actions": [], "obs_bits": [], "reward_bits": [],
               "press_log": []}
        for _ in range(steps):
            st, o = step(st)
            rec["actions"].append(o["sort_mode"] if case == "press"
                                  else o["action"])
            rec["obs_bits"].append(o["obs"])
            rec["reward_bits"].append(o["reward_bits"])
            rec["press_log"].append(o["press_log"])
        for k, v in rec.items():
            if k == "press_log":
                if case == "press":
                    out["press_log"] = _bits(torch.stack(v))[:, 0]
                continue
            a = _bits(torch.stack(v))[:, 0]
            out[f"{case}_{k}"] = a.view(np.uint64) if k == "reward_bits" \
                else a
        out[f"{case}_cont_true"] = st.cont_true[0].cpu().numpy()
        if case in ("modular", "sortonly"):
            out[f"{case}_bale_cnt"] = st.bale_cnt[0].cpu().numpy()
        n_env = 1
    else:
        raise ValueError(f"unknown scenario {name!r}")

    if dev.type == "cuda":
        torch.cuda.synchronize()
    out["_stats"] = {"seconds": time.perf_counter() - t0, "steps": steps,
                     "envs": n_env, "host_syncs": R.HOST_SYNCS - syncs}
    return out


def golden(name: str, tpu: bool = False) -> dict:
    """The committed arrays of the scenario's family (the JAX package's CPU
    run, or the TPU's), cut to the keys of ``name``'s case; {} for a
    scenario with no file."""
    fam, _, case = name.partition(":")
    files = GOLDEN_TPU.get(fam, ()) if tpu else (
        (GOLDEN[fam],) if fam in GOLDEN else ())
    out = {}
    for f in files:
        with np.load(ARTIFACTS / f) as d:
            out.update({k: d[k] for k in d.files
                        if not case or k.startswith(case + "_")})
    return out


def compare_actions(got: dict, want: dict, near: dict) -> tuple:
    """Hold the ``model_actions`` arrays ``got`` to ``want`` (cut to
    ``got``'s steps): an action may differ only at a step that ``near``
    marks as a near-tie, and a closed-loop stream (``mono_closed_*``) is
    compared only up to its first such split, after which its episode
    runs on another trajectory.  Returns (the keys that differ elsewhere,
    the splits as (key, step, got, want))."""
    bad, ties = [], []
    for k, g in sorted(got.items()):
        w = want[k][:len(g)]
        if g.dtype != w.dtype or g.shape != w.shape:
            bad.append(k)
            continue
        for t in np.flatnonzero(g != w):
            if not near[k][t]:
                bad.append(k)
                break
            ties.append((k, int(t), int(g[t]), int(w[t])))
            if k.startswith("mono_closed"):
                break
    return bad, ties


def compare(got: dict, want: dict, steps: int | None = None) -> list:
    """The keys of ``want`` that ``got`` holds and that differ (cutting the
    per-step arrays of ``want`` to ``steps``): [] when bit for bit equal.
    A key of ``want`` that ``got`` lacks is one that only a whole episode
    defines."""
    bad = []
    for k, w in want.items():
        if k not in got:
            continue
        g = got[k]
        if steps is not None and w.ndim >= 1 and k != "cum_bits":
            w = w[..., :steps] if k == "reward_bits" else w[:steps]
        if g.dtype != w.dtype or g.shape != w.shape or not np.array_equal(
                g, w):
            bad.append(k)
    return bad
