"""The port's host modules on the CPU: ``eval/episode_log.py`` against the
JAX package's (``first_inputs`` at 3 seeds x 2 batch sizes; ``checksum``
and the ``print_checksum`` lines of a seeded 200-step rule episode, byte
for byte), the figures of ``eval/plots.py``, ``viz/analysis.py`` and
``viz/dashboard.py`` (each written; a figure is not a number to compare),
the env wrapper's ``render`` series against
``harness.run_episode(collect_series=True)``, ``main.run_sim
--env-analysis`` (its dashboards) and ``utils/profiling.py``.
"""
import contextlib
import io
import os

import numpy as np
import pytest
import torch

from marl_sortingenv_tpu.config.config import load_config as jload
from marl_sortingenv_tpu.core import state as JS
from marl_sortingenv_tpu.core import step as JST
from marl_sortingenv_tpu.eval import episode_log as JEL
from marl_sortingenv_tpu_torch import main as M
from marl_sortingenv_tpu_torch.config.config import load_config
from marl_sortingenv_tpu_torch.core import state as S
from marl_sortingenv_tpu_torch.envs import Env_3_Monolith
from marl_sortingenv_tpu_torch.eval import episode_log as EL
from marl_sortingenv_tpu_torch.eval import harness, plots
from marl_sortingenv_tpu_torch.utils import profiling
from marl_sortingenv_tpu_torch.viz import analysis, dashboard
from test_torch_cli import args

# one thread: these tensors are tiny, and the suite's workers share the CPU
torch.set_num_threads(1)


@pytest.mark.parametrize("bs", [100, 80])
def test_first_inputs_equal_jax(bs):
    for seed in (0, 7, 42):
        assert (EL.first_inputs(load_config(input_batch_size=bs), seed)
                == JEL.first_inputs(jload(input_batch_size=bs), seed))


def _printed(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kw)
    return buf.getvalue().encode()


def test_checksum_lines_byte_equal_jax():
    kw = dict(max_steps=200, noise_sorting=0.0, balesize=200)
    seed, steps = 42, 200
    cfg_j = jload(**kw)
    st_j = JS.reset(cfg_j, seed)
    for _ in range(steps):
        st_j, _ = JST.step_mono_rule(cfg_j, st_j)
    cfg = load_config(**kw)
    res = harness.run_episode(cfg, seed, steps, "rule_based", device="cpu")
    st = S.env_at(res.final_state)
    assert EL.checksum(st) == JEL.checksum(st_j)
    assert EL.checksum(st)["bales"] > 0
    ours = _printed(EL.print_checksum, st, seed=seed, cfg=cfg)
    assert ours == _printed(JEL.print_checksum, st_j, seed=seed, cfg=cfg_j)
    assert len(ours.splitlines()) == 3
    # a leaf given as a (CPU) tensor and the same leaf as numpy read alike
    assert EL.checksum(st) == EL.checksum(type(st)(
        *(x if isinstance(x, tuple) else x.numpy() for x in st)))


def test_make_benchmark_dir_numbering(tmp_path):
    base = str(tmp_path / "benchmarks")
    d1 = plots.make_benchmark_dir(base, "benchmark_x")
    d2 = plots.make_benchmark_dir(base, "benchmark_x")
    os.makedirs(os.path.join(base, "7_benchmark_x"))
    d3 = plots.make_benchmark_dir(base, "benchmark_x")
    assert d1.endswith("1_benchmark_x") and d2.endswith("2_benchmark_x")
    assert d3.endswith("8_benchmark_x")


def test_benchmark_figures_written(tmp_path):
    summary = {k: {"mean": float(i * 10 - 20), "std": 1.0}
               for i, k in enumerate(plots.LABELS)}
    out = plots.plot_benchmark(summary, str(tmp_path), True, 3)
    assert os.path.basename(out) == "Model_Benchmark_Masked.png"
    for ext in ("png", "svg", "pdf"):
        assert os.path.getsize(out[:-3] + ext) > 0
    out2 = plots.plot_published_summary(str(tmp_path / "d" / "dumbbell.png"),
                                        ours=summary)
    assert os.path.getsize(out2) > 0


def test_analysis_figures_written(tmp_path):
    paths = analysis.run_env_analysis(load_config(), str(tmp_path))
    assert [os.path.basename(p) for p in paths] == [
        "accuracy_occupancy_sweep.png", "reward_vs_deviation.png",
        "accuracies.png", "sorting_reward.png", "press_reward.png"]
    assert all(os.path.getsize(p) > 0 for p in paths)


def test_run_episode_render_writes_dashboard(tmp_path, capsys):
    cfg = load_config(max_steps=200)
    res = harness.run_episode(
        cfg, 3, 25, "rule_based", render=True, device="cpu",
        render_kwargs={"save": True, "log_dir": str(tmp_path),
                       "filename": "dash", "fmt": "png"})
    assert os.path.getsize(tmp_path / "dash.png") > 0
    assert res.series is not None and len(res.series["purity"]) == 25
    assert "Checksum (Seed=3)" in capsys.readouterr().out


def test_cli_env_analysis(tmp_path):
    """``run_sim --env-analysis``: the random and rule-based episodes,
    masked and unmasked, and the rule episodes' dashboards."""
    out = M.run_sim(args(tmp_path, "--env-analysis"))
    vals = out["env_analysis"]
    assert sorted(vals) == ["random/Masking", "random/No Masking",
                            "rule_based/Masking", "rule_based/No Masking"]
    assert all(np.isfinite(v) for v in vals.values())
    assert sorted(os.listdir(tmp_path / "t")) == [
        "t_rule_based_mask.png", "t_rule_based_nomask.png"]


def test_wrapper_render_series_equal_harness(tmp_path, monkeypatch):
    """The env's render() draws the same per-step series as the harness's
    collect_series run of the same seed (press timers and raw belt counts
    included), and writes its figure."""
    cfg = load_config(max_steps=200)
    steps, seed = 25, 7
    res = harness.run_episode(cfg, seed, steps, "rule_based",
                              collect_series=True, device="cpu")
    env = Env_3_Monolith(max_steps=200, seed=seed, noise_sorting=0.0,
                         device="cpu")
    env.reset(seed=seed)
    for _ in range(steps):
        env.step(mode="rule_based")
    drawn = {}
    real = dashboard.plot_env

    def spy(cfg, series, state, **kw):
        drawn.update(series)
        return real(cfg, series, state, **kw)
    monkeypatch.setattr(dashboard, "plot_env", spy)
    env.render(save=True, show=False, log_dir=str(tmp_path),
               filename="series", format="png", checksum=False)
    assert set(drawn) == set(res.series)
    for key, ours in drawn.items():
        np.testing.assert_array_equal(
            np.asarray(ours, np.float64),
            np.asarray(res.series[key], np.float64), err_msg=key)
    assert os.path.getsize(tmp_path / "series.png") > 0


def test_profiling_on_cpu(tmp_path):
    tp = profiling.Throughput()
    assert tp.rate() == 0.0
    tp.start()
    x = torch.ones(8)
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("span_under_test"):
            for _ in range(5):
                x = x * 2
                tp.tick(8, sync=x)
    assert tp.rate() > 0 and tp._steps == 40
    traces = os.listdir(tmp_path)
    assert len(traces) == 1 and traces[0].endswith(".json")
    text = (tmp_path / traces[0]).read_text()
    assert "span_under_test" in text
    tp.reset()
    assert tp.rate() == 0.0
