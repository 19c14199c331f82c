"""11-panel episode dashboard + video writer — functional equivalent of
reference ``utils/plotting.py`` (``plot_env`` :28-692, ``create_video``
:721-750), rendering host-side from device-gathered episode series.

The port's copy of ``marl_sortingenv_tpu.viz.dashboard``.  ``state`` is
the state of one env without the env axis (``core.state.env_at``); its
leaves are read through ``eval.episode_log.host``, which copies a tensor
on the card to the host.  matplotlib and cv2 are imported inside the
functions, so the module imports without them.

Panels (matching the reference's layout intent):
  1 input composition (pie)         2 belt contents (bars)
  3 sorting-machine contents (bars) 4 sorting accuracies
  5 belt proportions + mode strip   6 per-step rewards
  7 container fill levels + press-action strip
  8 container contents (true/false stacked)
  9 press timers (pies)            10 bale stacks per material
 11 cumulative rewards

Also prints the console checksum fingerprint (plotting.py:663-678) via
``eval.episode_log.print_checksum``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..eval.episode_log import host, print_checksum

MATERIALS = ["A", "B", "C", "D"]
MAT_COLORS = {"A": "#4C72B0", "B": "#C44E52", "C": "#55A868", "D": "#8172B2",
              "E": "#CCB974"}
X_LIMIT = 200  # reference plotting.py:21


def plot_env(cfg, series, state, save=False, show=False,
             log_dir="./img/log", filename="plot", title="",
             fmt="svg", checksum=True, seed=None):
    """Render the dashboard.

    ``series``: dict of stacked per-step arrays with keys
      sort_reward, press_reward, purity, setting, belt_occupancy,
      belt_counts [T,4], cont_true [T,5], cont_false [T,4],
      press_timer [T,2], press_log [T]
    ``state``: final env state (for pies/bales/checksum).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    T = len(series["sort_reward"])
    t = np.arange(1, T + 1)
    fig, axes = plt.subplots(4, 3, figsize=(18, 16))
    fig.suptitle(f"Sorting plant episode {title}", fontsize=14,
                 fontweight="bold")
    (ax1, ax2, ax3), (ax4, ax5, ax6), (ax7, ax8, ax9), (ax10, ax11, ax12) = axes

    # 1: input composition (final input stage)
    inp = host(state.input_counts)
    if inp.sum() > 0:
        ax1.pie(inp, labels=MATERIALS,
                colors=[MAT_COLORS[m] for m in MATERIALS],
                autopct="%1.0f%%")
    ax1.set_title("Input composition")

    # 2: belt contents
    belt = host(state.belt_counts)
    ax2.bar(MATERIALS, belt, color=[MAT_COLORS[m] for m in MATERIALS])
    ax2.set_title("Belt contents")
    ax2.set_ylim(0, 100)

    # 3: sorting machine contents
    sortc = host(state.sort_counts)
    ax3.bar(MATERIALS, sortc, color=[MAT_COLORS[m] for m in MATERIALS])
    ax3.set_title("Sorting machine contents")
    ax3.set_ylim(0, 100)

    # 4: sorting accuracies
    acc = host(state.acc_belt)
    ax4.bar(MATERIALS, acc, color=[MAT_COLORS[m] for m in MATERIALS])
    ax4.axhline(float(np.asarray(cfg.baseline_accuracy).mean()), ls="--",
                c="gray", lw=1)
    ax4.set_ylim(0, 1.05)
    ax4.set_title("Sorting accuracies")

    # 5: belt proportions over time + sort-mode strip
    bc = np.asarray(series["belt_counts"], np.float64)  # [T, 4]
    tot = np.maximum(bc.sum(1, keepdims=True), 1)
    props = bc / tot
    w = slice(max(0, T - X_LIMIT), T)
    for i, m in enumerate(MATERIALS):
        ax5.plot(t[w], props[w, i], color=MAT_COLORS[m], label=m, lw=1)
    setting = np.asarray(series["setting"])
    ax5.fill_between(t[w], 0, 1, where=setting[w] == 0, alpha=0.08,
                     color=MAT_COLORS["A"], step="mid")
    ax5.fill_between(t[w], 0, 1, where=setting[w] == 1, alpha=0.08,
                     color=MAT_COLORS["B"], step="mid")
    ax5.legend(fontsize=7, ncol=4)
    ax5.set_title("Belt proportions + sort mode")
    ax5.set_ylim(0, 1)

    # 6: per-step rewards
    ax6.plot(t[w], np.asarray(series["sort_reward"])[w], label="sort", lw=1)
    ax6.plot(t[w], np.asarray(series["press_reward"])[w], label="press", lw=1)
    ax6.legend(fontsize=8)
    ax6.set_title("Per-step rewards")

    # 7: container fill levels over time + press-action strip
    ct = np.asarray(series["cont_true"], np.float64)   # [T, 5]
    cf = np.asarray(series["cont_false"], np.float64)  # [T, 4]
    lv = np.concatenate([ct[:, :4] + cf, ct[:, 4:5]], axis=1)
    for i, m in enumerate(MATERIALS + ["E"]):
        ax7.plot(t[w], lv[w, i], color=MAT_COLORS[m], label=m, lw=1)
    ax7.axhline(cfg.container_capacity, ls="--", c="red", lw=1)
    pl = np.asarray(series["press_log"])
    bad = np.isin(pl, (111, 222))
    good = (pl > 0) & ~bad
    ax7.scatter(t[w][good[w]], np.full(good[w].sum(), -20), marker="|",
                c="green", s=12)
    ax7.scatter(t[w][bad[w]], np.full(bad[w].sum(), -20), marker="x",
                c="red", s=12)
    ax7.legend(fontsize=7, ncol=5)
    ax7.set_title("Container fill levels + press actions")

    # 8: container contents (true/false stacked, final)
    true_f = host(state.cont_true)[:4]
    false_f = host(state.cont_false)
    ax8.bar(MATERIALS, true_f, color=[MAT_COLORS[m] for m in MATERIALS],
            label="true")
    ax8.bar(MATERIALS, false_f, bottom=true_f, color="lightgray",
            label="false")
    ax8.bar(["E"], [host(state.cont_true)[4]],
            color=MAT_COLORS["E"])
    ax8.axhline(cfg.container_capacity, ls="--", c="red", lw=1)
    ax8.legend(fontsize=8)
    ax8.set_title("Container contents (final)")

    # 9: press timers (pies)
    timers = host(state.press_timer)
    times = [cfg.press_time_1, cfg.press_time_2]
    ax9.set_title("Press timers")
    ax9.axis("off")
    for p in range(2):
        sub = fig.add_axes([0.68 + p * 0.12, 0.30, 0.10, 0.10])
        rem = int(timers[p])
        done = times[p] - rem
        sub.pie([max(done, 0), max(rem, 0)] if rem > 0 else [1, 0],
                colors=["#55A868", "#DDDDDD"], startangle=90)
        sub.set_title(f"P{p+1}: {rem}", fontsize=8)

    # 10: bale stacks per material (colored by size deviation)
    cnts = host(state.bale_cnt)
    sizes = host(state.bale_size)
    for i, m in enumerate(MATERIALS + ["E"]):
        n = int(cnts[i])
        for b in range(n):
            dev = abs(int(sizes[i, b]) - cfg.effective_balesize) \
                / max(cfg.effective_balesize, 1)
            color = "#55A868" if dev < 0.05 else ("#CCB974" if dev < 0.3
                                                  else "#C44E52")
            ax10.bar([i], [1], bottom=[b], color=color, edgecolor="white",
                     width=0.6)
    ax10.set_xticks(range(5))
    ax10.set_xticklabels(MATERIALS + ["E"])
    ax10.set_title("Bales produced (color = size deviation)")

    # 11: cumulative rewards
    cum_s = np.cumsum(np.asarray(series["sort_reward"]))
    cum_p = np.cumsum(np.asarray(series["press_reward"]))
    ax11.plot(t, cum_s + cum_p, label="total", lw=1.5)
    ax11.plot(t, cum_s, label="sort", lw=1)
    ax11.plot(t, cum_p, label="press", lw=1)
    ax11.legend(fontsize=8)
    final_total = round(float((cum_s + cum_p)[-1]), 2) if T else 0
    ax11.text(0.02, 0.85, f"Final Cumulative Total: {final_total}",
              transform=ax11.transAxes, fontweight="bold", fontsize=10,
              bbox=dict(facecolor="white", alpha=0.8, edgecolor="none"))
    ax11.set_title("Cumulative rewards")

    # 12: purity over time
    ax12.plot(t[w], np.asarray(series["purity"])[w], lw=1, c="black")
    ax12.set_title("Step sorting purity")
    ax12.set_ylim(0, 1)

    if checksum:
        print_checksum(state, seed=seed)

    if save:
        os.makedirs(log_dir, exist_ok=True)
        fig.savefig(os.path.join(log_dir, f"{filename}.{fmt}"), format=fmt,
                    dpi=150, bbox_inches="tight")
    if show:
        import matplotlib.pyplot as plt
        plt.show()
    import matplotlib.pyplot as plt
    plt.close(fig)
    return fig


def create_video(img_dir: str, out_path: str, fps: int = 4,
                 pattern: str = ".png") -> Optional[str]:
    """MP4 from saved frames (reference plotting.py:721-750 uses cv2; we
    gate on availability)."""
    try:
        import cv2
    except ImportError:
        print("create_video: cv2 not available; skipping")
        return None
    frames = sorted(
        f for f in os.listdir(img_dir) if f.endswith(pattern))
    if not frames:
        return None
    first = cv2.imread(os.path.join(img_dir, frames[0]))
    h, w = first.shape[:2]
    vw = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                         (w, h))
    for f in frames:
        vw.write(cv2.imread(os.path.join(img_dir, f)))
    vw.release()
    return out_path
