"""Analysis figures — reference ``utils/plot_env_analysis.py`` (accuracy
sweep :15-89, reward-vs-deviation :95-212, ``run_env_analysis`` :218-236)
and ``utils/reward_plot.py`` (standalone reward-shape figures :14-39).

The port's copy of ``marl_sortingenv_tpu.viz.analysis``: NumPy and
matplotlib (imported inside the functions); every curve takes its
numbers from the ``SimConfig`` it is given."""

from __future__ import annotations

import os

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_material_accuracies(cfg, out_path="./img/figures/accuracies.png"):
    """Accuracy per material under both sorting modes, with the noise band
    (reference sweep plot)."""
    plt = _plt()
    mats = ["A", "B", "C", "D"]
    base = np.asarray(cfg.baseline_accuracy)
    n = cfg.effective_noise
    fig, axes = plt.subplots(1, 2, figsize=(10, 4), sharey=True)
    for mode, ax in zip((0, 1), axes):
        boost = np.zeros(4)
        boost[[0, 2] if mode == 0 else [1, 3]] = cfg.boost
        acc = np.clip(base + boost, 0, 1)
        ax.bar(mats, acc, color=["#4C72B0", "#C44E52", "#55A868", "#8172B2"])
        if n > 0:
            ax.errorbar(mats, acc, yerr=n, fmt="none", c="black", capsize=4)
        ax.set_ylim(0, 1.1)
        ax.set_title(f"Mode {mode} (boost {'A/C' if mode == 0 else 'B/D'})")
    fig.suptitle("Sorting accuracies by mode")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_accuracy_occupancy_sweep(
        cfg, sorting_mode=0, distribution=None, seed=0,
        out_path="./img/figures/accuracy_occupancy_sweep.png"):
    """Accuracy-vs-occupancy sweep (reference plot_env_analysis.py:15-89):
    per-material accuracy (%) over occupation levels 0..100 with the
    uniform noise draw per level, plus the input-composition pie inset.

    The reference's accuracy physics is occupancy-independent
    (``occupancy_reduction_factor`` is a dead config key, SURVEY.md §2.1),
    so the sweep renders flat noise bands — exactly what the reference
    figure shows; the sweep exists to demonstrate that."""
    plt = _plt()
    from matplotlib.colors import to_rgba

    mats = ["A", "B", "C", "D"]
    if distribution is None:
        # reference default_distribution (plot_env_analysis.py:25-31)
        distribution = {"A": 0.15, "B": 0.25, "C": 0.30, "D": 0.15,
                        "E": 0.15}
    elif not np.isclose(sum(distribution.values()), 1.0):
        raise ValueError("The sum of the distribution must be 1 (100%).")

    base = np.asarray(cfg.baseline_accuracy, np.float64)
    boost = np.zeros(4)
    boost[[0, 2] if sorting_mode == 0 else [1, 3]] = cfg.boost
    noise = cfg.effective_noise
    levels = np.arange(0, 101)
    rng = np.random.default_rng(seed)
    acc = np.clip(
        base + boost + rng.uniform(-noise, noise, (levels.size, 4)),
        0.0, 1.0) * 100.0

    fig, ax = plt.subplots(figsize=(12, 8))
    colors = ["blue", "green", "red", "orange", "purple"]
    for i, m in enumerate(mats):
        ax.plot(levels, acc[:, i], color=colors[i], lw=1.5,
                label=f"{m} (Mode {sorting_mode})")
    ax.set_title(
        f"Accuracies per Material vs. Occupation Level "
        f"(Sorting Mode {sorting_mode}, Noise {noise * 100}%)")
    ax.set_xlabel("Occupation Level (%)")
    ax.set_ylabel("Accuracy (%)")
    ax.set_xlim(0, 100)
    ax.set_ylim(0, 105)
    ax.grid(True)
    ax.legend(title="Materials", loc="upper left",
              bbox_to_anchor=(1.0, 1.0))
    # input-composition pie inset (lower-left, as the reference)
    ax_inset = fig.add_axes([0.15, 0.15, 0.22, 0.22])
    pie_labels = list(distribution.keys())
    sizes = [v * 100 for v in distribution.values()]
    pie_colors = [to_rgba(c, alpha=0.6) for c in colors[:len(pie_labels)]]
    ax_inset.pie(sizes, labels=pie_labels, colors=pie_colors,
                 autopct="%1.0f%%", startangle=90)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_sorting_rewards_vs_purity_deviation(
        cfg, num_samples=10, seed=0,
        out_path="./img/figures/reward_vs_deviation.png"):
    """Reward-vs-deviation sample figure (reference
    plot_env_analysis.py:95-212): per-container purity deviations drawn
    98%-positive in [0, 0.25] (else negative in [-0.25, 0]), negatives
    weighted x5, summed to a per-sample total + running cumulative; twin
    y-axes with symmetric limits.  Note this figure uses the *legacy*
    linear penalty-factor reward, not the env's tanh reward — preserved
    as the reference renders it."""
    plt = _plt()
    mats = ["A", "B", "C", "D", "E"]
    rng = np.random.default_rng(seed)
    samples = np.arange(1, num_samples + 1)
    devs = {m: [] for m in mats}
    totals, cums = [], []
    cum = 0.0
    for _ in samples:
        adjusted = []
        for m in mats:
            if rng.uniform(0, 1) < 0.98:
                d = rng.uniform(0, 0.25)
            else:
                d = rng.uniform(-0.25, 0)
            devs[m].append(d)
            adjusted.append(d * 5 if d < 0 else d)
        total = sum(adjusted)
        totals.append(total)
        cum += total
        cums.append(cum)

    fig, ax1 = plt.subplots(figsize=(20, 10))
    colors = ["blue", "green", "red", "orange", "purple"]
    for i, m in enumerate(mats):
        ax1.plot(samples, devs[m], "-", color=colors[i], alpha=0.5,
                 label=f"{m} Deviation")
    ax1.axhline(0, color="gray", ls="--", lw=2)
    ax1.set_xlabel("Sample", fontsize=19)
    ax1.set_ylabel("Purity Deviation", fontsize=19)
    ax1.grid(True, ls="--", lw=0.5)

    ax2 = ax1.twinx()
    ax2.plot(samples, totals, "-", color="black", lw=6,
             label="Current Total Reward")
    ax2.plot(samples, cums, "-", color="grey", lw=6,
             label="Cumulative Reward")
    ax2.set_ylabel("Reward", fontsize=19)

    for ax in (ax1, ax2):
        lo, hi = ax.get_ylim()
        m = max(abs(lo), abs(hi))
        ax.set_ylim(-m, m)
    l1, lab1 = ax1.get_legend_handles_labels()
    l2, lab2 = ax2.get_legend_handles_labels()
    ax1.legend(l1 + l2, lab1 + lab2, loc="center left",
               bbox_to_anchor=(1.1, 0.5), fontsize=17)
    ax1.set_title(
        f"Sorting Reward vs. Purity Deviation (Samples 1-{num_samples})",
        fontsize=22)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    fig.savefig(out_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_sorting_reward_curve(
        cfg, out_path="./img/figures/sorting_reward.png"):
    """The sorting reward shape: tanh(mean(purity - theta) * 2 / 0.5)
    (reference reward_plot.py:14-25; env_super.py:963-1003)."""
    plt = _plt()
    purity = np.linspace(0.0, 1.0, 500)
    score = purity - cfg.purity_threshold_theta
    reward = np.tanh(score * cfg.purity_scaling_factor
                     / cfg.tanh_temperature)
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(purity, reward, lw=2)
    ax.axvline(cfg.purity_threshold_theta, ls="--", c="gray")
    ax.axhline(0, ls=":", c="gray")
    ax.set_xlabel("mean container purity")
    ax.set_ylabel("sorting reward")
    ax.set_title(r"Sorting reward: $\tanh((\bar p - \theta) \cdot 2 / 0.5)$")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_press_reward_curves(cfg, out_path="./img/figures/press_reward.png"):
    """Press action reward vs pressed amount: triangular efficiency wave +
    multi-bale bonus peaks (reference reward_plot.py:27-39;
    env_super.py:1052-1071)."""
    plt = _plt()
    bs = cfg.effective_balesize
    amount = np.arange(0, 4 * bs + 1)
    rem = amount % bs
    dist = np.minimum(rem, bs - rem)
    bef = cfg.bale_efficiency_factor
    eff = (1.0 - 4.0 * dist / bs) * bef
    peaks = np.array([0.0, 1 / 3, 2 / 3, 1.0])
    idx = np.minimum(amount // bs, 3)
    bonus = peaks[idx] - bef
    r = np.clip(eff + bonus, -1, 1)
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.plot(amount, r, lw=1.5)
    for k in range(1, 5):
        ax.axvline(k * bs, ls="--", c="gray", lw=0.8)
    ax.set_xlabel("amount pressed (units)")
    ax.set_ylabel("action reward")
    ax.set_title("Press action reward vs pressed amount")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out_path


def run_env_analysis(cfg, out_dir="./img/figures"):
    """Reference run_env_analysis (plot_env_analysis.py:218-236) plus the
    reward_plot.py shape figures: occupancy sweep, reward-vs-deviation
    samples, per-mode accuracy bars, and both reward-shape curves."""
    return [
        plot_accuracy_occupancy_sweep(
            cfg, out_path=os.path.join(
                out_dir, "accuracy_occupancy_sweep.png")),
        plot_sorting_rewards_vs_purity_deviation(
            cfg, out_path=os.path.join(out_dir, "reward_vs_deviation.png")),
        plot_material_accuracies(
            cfg, os.path.join(out_dir, "accuracies.png")),
        plot_sorting_reward_curve(
            cfg, os.path.join(out_dir, "sorting_reward.png")),
        plot_press_reward_curves(
            cfg, os.path.join(out_dir, "press_reward.png")),
    ]
