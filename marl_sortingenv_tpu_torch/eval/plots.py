"""Benchmark result plotting — reference ``utils/benchmark_models.py``
:49-117 (publication bar chart) and :198-230 (auto-numbered result dirs),
plus ``utils/benchmark_plot_summary.py`` (published-results dumbbell).

The port's copy of ``marl_sortingenv_tpu.eval.plots``; matplotlib is
imported inside the functions."""

from __future__ import annotations

import os
import re
from typing import Dict

import numpy as np

# Published reference results (utils/benchmark_plot_summary.py:5-18;
# BASELINE.md) — cumulative reward over 200-step monolith episodes,
# mean ± std over 10 seeds.
PUBLISHED = {
    "no_masking": {
        "Random": (-109.36, 6.29),
        "Rule-Based": (43.20, 1.07),
        "PPO Sort-Only": (-83.52, 10.14),
        "PPO Modular": (-64.98, 7.92),
        "PPO Monolith": (-100.31, 1.02),
    },
    "masked": {
        "Random": (-84.28, 22.29),
        "Rule-Based": (44.03, 1.10),
        "PPO Sort-Only": (-70.22, 10.56),
        "PPO Modular": (30.61, 0.87),
        "PPO Monolith": (32.77, 1.12),
    },
}

LABELS = {
    "Random": "Random",
    "Rule-Based": "Rule-Based",
    "PPO Sort-Only": "Sort Agent",
    "PPO Modular": "Sort + Press Agents",
    "PPO Monolith": "Combined Agent",
}


def make_benchmark_dir(base="./img/benchmarks",
                       prefix="benchmark_results") -> str:
    """Auto-numbered '<k>_<prefix>' directory (benchmark_models.py:198-230)."""
    os.makedirs(base, exist_ok=True)
    existing = [d for d in os.listdir(base)
                if os.path.isdir(os.path.join(base, d))]
    nums = []
    for d in existing:
        m = re.match(r"^([0-9]+)_" + re.escape(prefix) + r"$", d)
        if m:
            nums.append(int(m.group(1)))
        elif d == prefix:
            nums.append(0)
    k = max(nums, default=0) + 1
    new_dir = os.path.join(base, f"{k}_{prefix}")
    while os.path.exists(new_dir):
        k += 1
        new_dir = os.path.join(base, f"{k}_{prefix}")
    os.makedirs(new_dir, exist_ok=False)
    return new_dir


def plot_benchmark(summary: Dict[str, Dict[str, float]], out_dir: str,
                   use_action_masking: bool = True, num_seeds: int = 10,
                   show: bool = False) -> str:
    """Grayscale publication bar chart (benchmark_models.py:49-117)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    keys = [k for k in LABELS if k in summary]
    labels = [LABELS[k] for k in keys]
    means = [summary[k]["mean"] for k in keys]
    stds = [summary[k]["std"] for k in keys]

    plt.rcParams["font.family"] = "serif"
    x = np.arange(len(labels))
    fig, ax = plt.subplots(figsize=(10, 6))
    cmap = plt.get_cmap("Greys")
    colors = cmap(np.linspace(0.35, 0.85, len(labels)))
    bars = ax.bar(x, means, yerr=stds, align="center", alpha=0.95,
                  capsize=6, color=colors, edgecolor="black", linewidth=0.8)
    ax.set_ylabel("Cumulative Reward", fontsize=12)
    ax.set_xticks(x)
    ax.set_xticklabels(labels, rotation=0, ha="center", fontsize=10)
    suffix = "with Action Masking" if use_action_masking else \
        "without Action Masking"
    ax.set_title(f"Agent Performance Comparison ({num_seeds} Seeds)\n"
                 f"{suffix}", fontsize=14, fontweight="bold")
    ax.yaxis.grid(True, linestyle="--", alpha=0.6)
    ax.set_axisbelow(True)
    for bar, m in zip(bars, means):
        y = m / 2.0 if abs(m) > 1e-6 else 0.1
        ax.text(bar.get_x() + bar.get_width() / 2.0, y, f"{m:.1f}",
                ha="center", va="center", fontsize=9, weight="bold")
    plt.tight_layout(pad=1.0)
    name = f"Model_Benchmark_{'Masked' if use_action_masking else 'NoMask'}"
    for ext in ("png", "svg", "pdf"):
        fig.savefig(os.path.join(out_dir, f"{name}.{ext}"),
                    dpi=300, bbox_inches="tight")
    if show:
        plt.show()
    plt.close(fig)
    return os.path.join(out_dir, f"{name}.png")


def plot_published_summary(out_path="./img/benchmarks/summary_dumbbell.png",
                           ours: Dict | None = None) -> str:
    """Dumbbell comparison of published masked vs no-masking results
    (benchmark_plot_summary.py), optionally overlaying our results."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    keys = list(LABELS)
    y = np.arange(len(keys))[::-1]
    nm = [PUBLISHED["no_masking"][k][0] for k in keys]
    mk = [PUBLISHED["masked"][k][0] for k in keys]
    fig, ax = plt.subplots(figsize=(9, 5))
    for yi, a, b in zip(y, nm, mk):
        ax.plot([a, b], [yi, yi], c="gray", lw=2, zorder=1)
    ax.scatter(nm, y, s=70, c="#C44E52", label="no masking", zorder=2)
    ax.scatter(mk, y, s=70, c="#55A868", label="masked", zorder=2)
    if ours:
        vals = [ours.get(k, {}).get("mean", np.nan) for k in keys]
        ax.scatter(vals, y, s=70, marker="D", c="#4C72B0",
                   label="ours", zorder=3)
    ax.set_yticks(y)
    ax.set_yticklabels([LABELS[k] for k in keys])
    ax.set_xlabel("Cumulative Reward (200 steps, mean over seeds)")
    ax.legend()
    ax.set_title("Published reference results vs this build")
    ax.xaxis.grid(True, linestyle="--", alpha=0.5)
    plt.tight_layout()
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    fig.savefig(out_path, dpi=200, bbox_inches="tight")
    plt.close(fig)
    return out_path
