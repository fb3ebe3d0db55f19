"""The control of ``correct``: the plain reference put in the program's
place, computed in the precision just below the one the configuration
states (reference/knn.py ``control_search``). A run with it has to come out
not correct. The benchmark's own runs never use it; tools/readings.py and
the tests do."""

import numpy as np
import torch

from portbench import spec
from portbench.reference import knn


class ControlIndex:
    """Answers each batch by the exact search over the same base, with its
    operands rounded down a precision."""

    def __init__(self, base, precision):
        self.base = base
        self.precision = precision

    def search_submit(self, x, k):
        q = torch.from_numpy(np.ascontiguousarray(x)).to(self.base.device)
        return knn.control_search(q, self.base, k, self.precision)

    def search_collect(self, handle):
        D, I = handle
        return D.cpu().numpy(), I.cpu().numpy()


def control_fault(cell, seed, device):
    """A ``fault`` for run.run_cell that puts the control in the index's
    place: the base is drawn again from the seed, as the harness drew it."""
    from portbench.run import draw_rows

    def fault(index):
        dev = torch.device(device)
        cfg = cell.config
        sampler = spec.generator(cfg["data"]["generator"]).make(cfg["data"], cfg["d"], dev)
        gb = torch.Generator(device=dev)
        gb.manual_seed(spec.stream_seed(seed, "base"))
        base = draw_rows(sampler, cfg["nb"], gb)
        return ControlIndex(base, cfg["guarantees"]["store_precision"])

    return fault
