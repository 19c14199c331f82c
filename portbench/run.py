"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the port
(``marl_sortingenv_tpu_torch``), on a machine with the cell's CUDA cards.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number that decided ``correct``
with its limit (also the last lines of standard error).  Without a card,
or without the program, it exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every cache the program or torch keeps stays at a fixed path in the
# checkout, so that only a checkout's first run builds
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / sub)
sys.path.insert(0, str(ROOT))

from portbench.lib.cell import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START, ROOT))
