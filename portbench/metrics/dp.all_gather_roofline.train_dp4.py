"""dp.all_gather_roofline.train_dp4: the all-gathers' share of their
roofline in rank 0's traced slice, in %: the bytes rank 0 received
(``mesh.GATHER_BYTES`` over the slice) over the per-direction peak of the
cards' links (``portbench/work/links.py``), divided by the profiler's
device time of the NCCL all-gather kernels on rank 0.

Those kernels also wait on the device for the other ranks to reach the
same collective, so their time holds more than the transfer and the share
is a lower bound on what the link itself reached."""

from portbench.work import links


def read(r):
    moved = r.window.get("slice_gather_bytes")
    dev_s = r.slice.device_seconds("AllGather")
    if not moved or dev_s <= 0:
        return None
    return 100.0 * moved / links.peak_bytes_per_s() / dev_s
