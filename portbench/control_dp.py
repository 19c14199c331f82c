"""The readings of the data-parallel training cells' limits, on the cards:
``control.py``'s readings, for the ``train_dp`` driver.

    python3 portbench/control_dp.py --workload train_mono_dp4.plant_paper \
        --seeds 1,2,3 [--faults one_rank_altered] [--out <file.json>]

For each seed: the control (the unsharded reference at the global batch
against itself computed with TF32 products) and each named fault of
``FAULTS``, planted in one rank other than 0 of a sound set-up (the ranks
started, the first iterations recorded, the ranks stopped), against the
reference.  The benchmark's own runs never run this.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import control  # noqa: E402

# rank 1's rewards are off by one at rollout step 5 of the first iteration
FAULTS = {"one_rank_altered": (1, 5)}


def dp_readings(cell, seed, faults):
    from portbench.traffic import train, train_dp
    drv = train_dp.Driver(control._ctx(cell, seed))
    ref, lim = drv.reference_record(), cell.traffic["limits"]
    out = {"control": train.compare(drv.reference_record(tf32=True), ref,
                                    lim)}
    for name in faults:
        planted = train_dp.Driver(control._ctx(cell, seed))
        planted.plant = FAULTS[name]
        planted.setup()
        planted.release()
        out[name] = train.compare(planted.prog, ref, lim)
    return out


control.READINGS["train_dp"] = dp_readings

if __name__ == "__main__":
    sys.exit(control.main(sys.argv[1:]))
