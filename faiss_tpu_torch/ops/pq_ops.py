"""Product-quantizer encode and decode (counterpart of
faiss_tpu/ops/pq_ops.py :31 and :67)."""

from __future__ import annotations

import torch


def pq_encode(
    x: torch.Tensor,  # [n, d] float32
    codebooks: torch.Tensor,  # [M, ksub, dsub] float32
    chunk: int = 1 << 15,
) -> torch.Tensor:
    """Nearest codeword per subspace -> codes [n, M] int64
    (ProductQuantizer::compute_codes as a batched GEMM + argmin)."""
    n, d = x.shape
    M, ksub, dsub = codebooks.shape
    if d != M * dsub:
        raise ValueError(f"d={d} != M*dsub={M * dsub}")
    c_norms = codebooks.square().sum(-1)  # [M, ksub]
    out = []
    for s in range(0, n, chunk):
        xc = x[s : s + chunk].float().reshape(-1, M, dsub)
        ip = torch.einsum("cmd,mkd->cmk", xc, codebooks)
        out.append((c_norms[None] - 2.0 * ip).argmin(dim=-1))
    if not out:
        return torch.zeros(0, M, dtype=torch.int64, device=x.device)
    return torch.cat(out)


def pq_decode(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """codes [n, M] -> vectors [n, d] float32 by codeword gather."""
    M, ksub, dsub = codebooks.shape
    m = torch.arange(M, device=codes.device)
    return codebooks[m[None, :], codes.long()].reshape(codes.shape[0], M * dsub)


def pq_ip_tables(xq: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Inner-product ADC tables [nq, M, ksub] (faiss_tpu/ops/pq_ops.py:100,
    compute_inner_prod_tables)."""
    nq = xq.shape[0]
    M, ksub, dsub = codebooks.shape
    return torch.einsum(
        "qmd,mkd->qmk", xq.float().reshape(nq, M, dsub), codebooks
    )


def pq_blockdiag_codebook(codebooks: torch.Tensor) -> torch.Tensor:
    """[M, ksub, dsub] codebooks -> the [d, M*ksub] block-diagonal matrix
    whose product with the queries is the flattened IP tables,
    ``xq @ cbt == pq_ip_tables(xq, codebooks).reshape(nq, -1)``, in one
    matrix product (faiss_tpu/ops/pq_ops.py:114)."""
    return torch.block_diag(*(cb.T for cb in codebooks.float()))
