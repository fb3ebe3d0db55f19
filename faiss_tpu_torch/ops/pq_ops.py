"""Product-quantizer encode, decode, ADC tables and the exhaustive IVF-PQ
ADC scan (counterpart of faiss_tpu/ops/pq_ops.py)."""

from __future__ import annotations

import torch

from .topk import merge_topk


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


def pq_distance_tables(xq: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Squared-L2 ADC tables [nq, M, ksub] (faiss_tpu/ops/pq_ops.py:79,
    compute_distance_tables): ||x_m||^2 + ||c_mk||^2 - 2 x_m . c_mk."""
    nq = xq.shape[0]
    M, ksub, dsub = codebooks.shape
    xs = xq.float().reshape(nq, M, dsub)
    ip = torch.einsum("qmd,mkd->qmk", xs, codebooks)
    return xs.square().sum(-1)[:, :, None] + codebooks.square().sum(-1)[None] - 2.0 * ip


def adc_scores_gather(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """ADC scores by table gather (faiss_tpu/ops/pq_ops.py:134): ``luts``
    [nq, M, ksub], ``codes`` [..., M] -> [nq, ...] float32, the M entries
    summed in order of m."""
    nq, M, ksub = luts.shape
    acc = torch.zeros((nq,) + tuple(codes.shape[:-1]), device=luts.device)
    for m in range(M):
        acc = acc + luts[:, m, :][:, codes[..., m].long()]
    return acc


def codes_onehot(codes: torch.Tensor, ksub: int, dtype=torch.bfloat16) -> torch.Tensor:
    """[..., M] codes -> [..., M * ksub] one-hot (faiss_tpu/ops/pq_ops.py:153)."""
    oh = torch.nn.functional.one_hot(codes.long(), ksub).to(dtype)
    return oh.reshape(*codes.shape[:-1], codes.shape[-1] * ksub)


def ivfpq_brute_adc_knn(
    luts: torch.Tensor,  # [nq, M, ksub] float32: -2 q . y_mk
    coarse_ip: torch.Tensor,  # [nq, nlist] float32: q . c_l
    qn2: torch.Tensor,  # [nq] float32: ||q||^2
    codes: torch.Tensor,  # [nb, M] uint8 PQ codes, input-slot order
    listnos: torch.Tensor,  # [nb] coarse list of every slot
    n2: torch.Tensor,  # [nb] float32: ||c_l + pq(code)||^2
    k: int,
    db_chunk: int = 1 << 16,
):
    """Exhaustive IVF-PQ ADC over every code (faiss_tpu/ops/pq_ops.py:271,
    the XLA big-batch scan): per chunk of ``db_chunk`` slots

        d = ||q||^2 + n2 - 2 q.c_l + sum_m lut_bf16[m, code_m]

    with the LUTs rounded to bf16 as faiss_tpu hands them to its one-hot
    product, summed in float32: as the product of the LUTs with a one-hot of
    the codes for ksub <= 16, and by table gathers for larger ksub (an
    8-bit one-hot chunk is M * 256 wide); then ``torch.topk`` and merge.
    The select is exact, where faiss_tpu caps each chunk's select at 32 with
    ``approx_min_k(recall_target=0.97)``: for k <= 32 the two agree up to
    ties. Returns (D [nq, k] float32, slots [nq, k] int64), -1 with +inf
    where there are fewer than k slots."""
    nq, M, ksub = luts.shape
    nb = codes.shape[0]
    lb = luts.to(torch.bfloat16).float()
    flat = lb.reshape(nq, M * ksub)
    vals = torch.full((nq, k), float("inf"), device=luts.device)
    ids = torch.full((nq, k), -1, dtype=torch.int64, device=luts.device)
    for c0 in range(0, nb, db_chunk):
        cc = codes[c0 : c0 + db_chunk]
        if ksub <= 16:
            ip_pq = flat @ codes_onehot(cc, ksub, torch.float32).T
        else:
            ip_pq = adc_scores_gather(lb, cc)
        cip = coarse_ip[:, listnos[c0 : c0 + db_chunk].long()]
        dist = qn2[:, None] + n2[None, c0 : c0 + db_chunk] - 2.0 * cip + ip_pq
        v, pos = torch.topk(dist, min(k, dist.shape[1]), dim=1, largest=False)
        vals, ids = merge_topk(vals, ids, v, pos + c0, k, largest=False)
    return vals, torch.where(torch.isinf(vals), -1, ids)
