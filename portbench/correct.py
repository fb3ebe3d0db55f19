"""The comparison that decides ``correct``, run once the window has closed
and the program's state is freed.

Every answer of the window is held to what an L2 search over the
configuration's store guarantees:
  - ``bad_rows``: rows with an id outside the base, a distance that is not
    finite, distances out of ascending order or an id twice (limit 0);
  - ``dist_err``: the widest gap between a returned distance and the
    reference's float64 |q - x|^2 to the returned row as the store holds it
    (fp16-rounded under a float16 store), over |q|^2 + |x|^2; under a
    pre-transform the program's distances are in its output space, which an
    orthonormal rotation leaves as they are;
  - ``recall1_at_10``: on a sample of rows of each batch drawn from the
    seed, the share whose exact nearest neighbour is among the first 10
    returned, at least the floor that the configuration states.
The same sample gives ``recall_at_k``, k-recall@k against the reference's
exact neighbours (an end-to-end metric, not a check)."""

import numpy as np
import torch

from .reference import knn


def check_answers(answers, regen, base, precision, sample, k):
    """``answers``: (j, D [n, k], I [n, k]) host arrays of every answered
    batch; ``regen(j)``: batch j's queries on ``base``'s device, as the
    program was given them; ``base``: the base rows [nb, d] float32;
    ``sample(j, n)``: the rows of batch j (of n) sampled for recall. Returns
    the readings (bad_rows, dist_err, recall1_at_10, recall_at_k, rows)."""
    nb = base.shape[0]
    bad, err_max, rows = 0, 0.0, 0
    sample_q, sample_i = [], []
    for j, D, I in answers:
        q = regen(j)
        It = torch.from_numpy(np.ascontiguousarray(I)).to(base.device).long()
        Dt = torch.from_numpy(np.ascontiguousarray(D)).to(base.device)
        valid = (It >= 0) & (It < nb) & torch.isfinite(Dt)
        ordered = (Dt[:, 1:] >= Dt[:, :-1]).all(1)
        s = It.sort(1).values
        distinct = (s[:, 1:] != s[:, :-1]).all(1)
        bad += int((~(valid.all(1) & ordered & distinct)).sum())
        x = knn.store_rows(base[It.clamp(0, nb - 1)], precision)
        d64 = knn.dist64(q, x)
        scale = q.double().square().sum(1)[:, None] + x.square().sum(-1)
        err = ((Dt.double() - d64).abs() / scale)[valid]
        if err.numel():
            err_max = max(err_max, float(err.max()))
        rows += len(I)
        keep = torch.as_tensor(sample(j, len(I)), dtype=torch.long, device=base.device)
        sample_q.append(q[keep])
        sample_i.append(It[keep])
    r1 = rk = float("nan")
    if sample_q:
        sq, si = torch.cat(sample_q), torch.cat(sample_i)
        _, gt = knn.exact_knn(sq, base, k)
        hits = (si[:, :, None] == gt[:, None, :]).any(1)  # [S, k]: gt found
        rk = float(hits.float().mean())
        r1 = float((si[:, :10] == gt[:, :1]).any(1).float().mean())
    return {"bad_rows": bad, "dist_err": err_max, "recall1_at_10": r1,
            "recall_at_k": rk, "rows": rows}


def checks(readings, limits, floor):
    """Each compared number with its limit, in the order printed."""
    return {
        "bad_rows": {"value": readings["bad_rows"], "limit": 0, "holds": "<="},
        "dist_err": {"value": readings["dist_err"], "limit": limits["dist_err_max"],
                     "holds": "<="},
        "recall1_at_10": {"value": readings["recall1_at_10"], "limit": floor,
                          "holds": ">="},
    }


def holds(c):
    v, lim = c["value"], c["limit"]
    if v != v:  # nan: nothing was compared
        return False
    return v <= lim if c["holds"] == "<=" else v >= lim
