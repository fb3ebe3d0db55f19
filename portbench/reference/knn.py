"""The plain reference of an L2 k-NN search: exact neighbours and distances
in plain PyTorch, with TF32 off, worked out again from the inputs that the
harness hands to both sides. It imports nothing of the program.

``lower`` and ``control_search`` are the control: the same exact search with
its operands rounded to the precision just below the one a configuration
states (bfloat16 under a float16 store, TF32 under float32)."""

from contextlib import contextmanager

import torch


@contextmanager
def tf32_off():
    """Float32 products in float32: TF32 off for the block, then as before."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def store_rows(xb, precision):
    """The rows as a store of ``precision`` holds them, in float64."""
    if precision == "float16":
        return xb.half().double()
    if precision == "float32":
        return xb.double()
    raise ValueError(f"unknown store precision {precision!r}")


def dist64(q, rows):
    """|q - row|^2 in float64: q [n, d], rows [n, k, d]."""
    return (rows - q.double()[:, None, :]).square().sum(-1)


def exact_knn(xq, xb, k, qblock=2048, bblock=1 << 19):
    """The k nearest rows of ``xb`` [nb, d] to each of ``xq`` [nq, d] by L2:
    float32 products (TF32 off), blocks of queries and rows, torch.topk
    then a merge. Returns (D [nq, k] float32, I [nq, k] int64)."""
    nq = xq.shape[0]
    D = torch.empty(nq, k, device=xq.device)
    I = torch.empty(nq, k, dtype=torch.int64, device=xq.device)
    with tf32_off():
        for q0 in range(0, nq, qblock):
            q = xq[q0:q0 + qblock].float()
            qn2 = q.square().sum(1, keepdim=True)
            best_d = best_i = None
            for b0 in range(0, xb.shape[0], bblock):
                y = xb[b0:b0 + bblock].float()
                d = qn2 + y.square().sum(1)[None, :] - 2.0 * (q @ y.T)
                v, p = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False)
                p = p + b0
                if best_d is not None:
                    v, p = torch.cat([best_d, v], 1), torch.cat([best_i, p], 1)
                    v, sel = torch.topk(v, k, dim=1, largest=False)
                    p = p.gather(1, sel)
                best_d, best_i = v, p
            D[q0:q0 + qblock], I[q0:q0 + qblock] = best_d, best_i
    return D, I


def _round_mantissa(x, bits):
    """float32 values rounded to nearest on ``bits`` mantissa bits."""
    drop = 23 - bits
    u = x.float().contiguous().view(torch.int32)
    u = (u + (1 << (drop - 1))) & ~((1 << drop) - 1)
    return u.view(torch.float32)


def lower(x, precision):
    """``x`` rounded to the precision just below a store of ``precision``:
    bfloat16 (8 significant bits against float16's 11) below float16, TF32
    (10 mantissa bits) below float32."""
    if precision == "float16":
        return x.to(torch.bfloat16).float()
    if precision == "float32":
        return _round_mantissa(x, 10)
    raise ValueError(f"unknown store precision {precision!r}")


def control_search(xq, xb, k, precision):
    """The control: the exact search over operands rounded by ``lower``."""
    return exact_knn(lower(xq, precision), lower(xb, precision), k)
