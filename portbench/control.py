"""The readings that the check's limits are set from, on the card.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--faults half_batch,altered] [--out <file.json>]

For each seed, at the cell's own size:

* ``control``: the reference against itself computed in the precision
  below the configuration's (TF32 products for the float32 fastb engine,
  its agents and its learner; float32 for the float64 parity engine);
* each named fault of ``faults.FAULTS``, planted in the program, against
  the reference (the training cells' numbers are held against these too).

It prints one JSON line per reading and writes them all to ``--out``.
The benchmark's own runs never run this.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _ctx(cell, seed):
    from portbench.lib.cell import Context
    return Context(cell=cell, seed=seed, device="cuda", trace=False)


def train_readings(cell, seed, faults):
    from portbench import faults as F
    from portbench.traffic import train
    drv = train.Driver(_ctx(cell, seed))
    ref, lim = drv.reference_record(), cell.traffic["limits"]
    out = {"control": train.compare(drv.reference_record(tf32=True), ref,
                                    lim)}
    for name in faults:
        with F.FAULTS["train"][name]():
            out[name] = train.compare(drv.program_record()[1], ref, lim)
    return out


def eval_readings(cell, seed, faults):
    """The control over one pass: every policy's first steps, and the
    totals of the ``check_totals`` policies; the step outputs also policy
    by policy (Random and Rule-Based run no product, so TF32 leaves them
    as they are)."""
    from portbench.lib.cell import Check
    from portbench.traffic import eval_protocol as E
    drv = E.Driver(_ctx(cell, seed))
    drv.rows = drv._rows()
    ref_outs, ref_totals = drv.reference_pass(drv.base)
    ctl_outs, ctl_totals = drv.reference_pass(drv.base, tf32=True)
    out = {"control": E.compare(ctl_outs, ctl_totals, ref_outs, ref_totals,
                                cell.traffic)}
    for policy in ref_outs:
        out[f"control.{policy}"] = [Check("steps_apart", float(
            E.steps_apart(ctl_outs[policy], ref_outs[policy])), 0.0)]
    return out


def gym_readings(cell, seed, faults, seconds=8.0):
    """The program's loop for ``seconds`` (some 450 steps), its episodes
    replayed on the float32 reference and on the reference as stated."""
    from portbench.lib.cell import Check
    from portbench.traffic import gym_loop
    drv = gym_loop.Driver(_ctx(cell, seed))
    drv.setup()
    drv.window(seconds)
    eps = drv.episodes
    return {"control": [Check("steps_apart", float(sum(
        drv.replay(e, float64=False) for e in eps)), 0.0)],
        "sound": [Check("steps_apart", float(sum(
            drv.replay(e) for e in eps)), 0.0)]}


READINGS = {"train": train_readings, "eval_protocol": eval_readings,
            "gym_loop": gym_readings}


def main(argv):
    import argparse

    import torch

    from portbench.lib import bench
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("control.py runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    cell = bench.load_cell(ROOT, args.workload)
    faults = [f for f in args.faults.split(",") if f]
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        got = READINGS[cell.traffic["driver"]](cell, seed, faults)
        for what, checks in got.items():
            row = {"workload": args.workload, "seed": seed, "reading": what,
                   **{c.name: c.value for c in checks},
                   "seconds": time.perf_counter() - t0}
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
