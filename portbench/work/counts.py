"""The frozen yardstick of work: an H100's peaks, the least work of the
port's two main-path kernels, and the policy's FLOPs, all from the
configuration and the shapes, never from the program's tensors.

The kernels' bounds follow what the env step must do, whatever computes
it: the bytes of the state it reads once and writes once, the threefry
blocks and the sampler's points.  The operations left out (rules, press
phase, rewards, observations) make the operation times lower bounds.
"""

from __future__ import annotations

# One NVIDIA H100 SXM (data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12                  # float32 outside the tensor cores
# 32-bit integer lanes: 64 per SM (half the f32 lanes), 132 SMs, 1.98 GHz
INT32_OP_PER_S = 132 * 64 * 1.98e9

# threefry2x32 block: 20 rounds of add, rotate, xor plus 5 key injections
# of 2 adds (the rotate one funnel shift) = 70 int ops
TF_BLOCK_OPS = 70


def hg_draw_f32_ops(support: int) -> int:
    """One hypergeometric draw at support S: per lane 4 subtractions, 3
    adds, 2 multiplies, 1 division (10 ops, the IEEE sequence), then
    log2(S) doubling steps of products and of sums over S lanes, and S
    compares."""
    steps = max(1, (support - 1).bit_length())
    return support * 19 + 2 * support * steps + support


def support_for(sim: dict) -> int:
    """The sampler's support (the largest false count of a station, padded
    to 8), from the plant's batch size, accuracy and noise."""
    bs = int(sim.get("input_batch_size", 100))
    acc = sim.get("baseline_accuracy", (0.75, 0.75, 0.75, 0.75))
    noise = float(sim.get("noise_sorting", 0.0))
    max_target = int(0.40 * bs) + 4
    min_acc = max(0.0, min(acc) - noise)
    max_false = int(max_target * (1.0 - min_acc) + 0.5) + 1
    return max(8, -(-(max_false + 2) // 8) * 8)


def press_events(sim: dict) -> int:
    """Rows of the per-env press-event log: every press that can finish in
    an episode, plus 4."""
    t = int(sim.get("max_steps", 200))
    return (t // int(sim.get("press_time_1", 12))
            + t // int(sim.get("press_time_2", 15)) + 4)


OBS_DIM = {"sort": 13, "press": 16, "mono": 29}


def step_bytes_per_env(sim: dict, variant: str) -> int:
    """Bytes one env step must move through kernel 1: the state it reads
    and the action, the state it writes, the outputs.  Per env, with E the
    press-event log's rows: i32 and f32 are 4 bytes, the event log int16,
    the press flag one byte."""
    e = press_events(sim)
    # read: input and belt counts, belt accuracy (4 each), input
    # occupancy, containers (5 true, 4 false), two presses' timer,
    # material, count and quality, the event log (3 x E int16) and its
    # count, the press flag and amount, the generator's pattern, index and
    # counter, the step, the input units, the key (2 words)
    read = 4 * (4 + 4 + 4 + 1 + 5 + 4 + 2 * 4) + 3 * 2 * e + 4 + 1 \
        + 4 * (1 + 3 + 1 + 1) + 4 * 2
    if variant != "rule":
        read += 4                                     # the action
    # written: the state above plus sort counts, sorter accuracy, sensor
    # setting and belt occupancy
    written = read - (4 if variant != "rule" else 0) + 4 * (4 + 4 + 1 + 1)
    # outputs: obs (f32), terminated (1 byte), action, purity, the raw
    # sorting-reward argument and the press reward
    out = 4 * OBS_DIM.get(variant, 29) + 1 + 4 + 4 + 4 + 4
    return read + written + out


SORT_BYTES_PER_ENV = (4 + 4 + 2) * 4 + (3 * 4 + 2) * 4   # in 40, out 56


def step_ops(sim: dict, variant: str, n: int) -> tuple:
    """(int ops, f32 ops) of one kernel-1 step over n envs."""
    blocks = 2 + 1 + 4                  # input split, randint split, 4 words
    blocks += 2 + (4 if float(sim.get("noise_sorting", 0.0)) > 0 else 0)
    blocks += 4 * (2 + 3 + 3)           # per station: split2, split3, 3 words
    blocks += 3 if variant == "sort" else 0
    return (blocks * n * TF_BLOCK_OPS,
            12 * hg_draw_f32_ops(support_for(sim)) * n)


def sort_ops(sim: dict, n: int) -> tuple:
    """(int ops, f32 ops) of the sorting core (kernel 2) over n envs: per
    station split2, split3 and 3 words (8 threefry blocks), and 12 sampler
    draws."""
    return (4 * 8 * TF_BLOCK_OPS * n,
            12 * hg_draw_f32_ops(support_for(sim)) * n)


def bound_s(n_bytes: int, int_ops: int, f32_ops: int) -> float:
    """The least time the card could take: bytes, integer and f32 work on
    separate units at once, so the largest of the three."""
    return max(n_bytes / HBM_BYTES_PER_S, int_ops / INT32_OP_PER_S,
               f32_ops / F32_FLOP_PER_S)


def kernel_bound_s(sim: dict, kernel: str, variant: str, n: int) -> float:
    """The bound of one launch of ``kernel`` ("step_mono" or
    "sort_material") over n envs."""
    if kernel == "step_mono":
        return bound_s(step_bytes_per_env(sim, variant) * n,
                       *step_ops(sim, variant, n))
    if kernel == "sort_material":
        return bound_s(SORT_BYTES_PER_ENV * n, *sort_ops(sim, n))
    raise ValueError(f"no bound for kernel {kernel!r}")


# ---- the policy: SB3's MlpPolicy, separate pi and vf towers -------------

N_ACTIONS = {"sort": 2, "press": 11, "mono": 22}
HIDDEN = (32, 32)


def _dense_flops(d_in: int, widths) -> int:
    flops = 0
    for d_out in widths:
        flops += 2 * d_in * d_out
        d_in = d_out
    return flops


def pi_flops(agent: str) -> int:
    """FLOPs of one sample's action logits: the pi tower and the head."""
    return _dense_flops(OBS_DIM[agent], (*HIDDEN, N_ACTIONS[agent]))


def vf_flops(agent: str) -> int:
    """FLOPs of one sample's value: the vf tower and the value head."""
    return _dense_flops(OBS_DIM[agent], (*HIDDEN, 1))


def train_iteration_flops(variant: str, n: int, n_steps: int,
                          n_epochs: int, frozen_sort: bool) -> int:
    """Model FLOPs of one PPO iteration: the rollout's forwards of both
    towers (and of the frozen sort agent's pi in the press env), the last
    values, and forward plus backward (three forwards) of every sample in
    every epoch of the update."""
    fwd = pi_flops(variant) + vf_flops(variant)
    samples = n * n_steps
    rollout = samples * fwd + n * vf_flops(variant)
    if frozen_sort:
        rollout += samples * pi_flops("sort")
    return rollout + n_epochs * samples * 3 * fwd


POLICY_AGENTS = {"Random": (), "Rule-Based": (), "PPO Sort-Only": ("sort",),
                 "PPO Modular": ("sort", "press"), "PPO Monolith": ("mono",)}


def eval_step_flops(policy: str, n: int) -> int:
    """Model FLOPs of one lockstep step of ``policy`` over n episodes."""
    return n * sum(pi_flops(a) for a in POLICY_AGENTS[policy])
