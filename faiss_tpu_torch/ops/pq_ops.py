"""Product-quantizer encode, decode, ADC tables and the exhaustive IVF-PQ
ADC scan (counterpart of faiss_tpu/ops/pq_ops.py), and the additive
quantizers' table scan (faiss_tpu models/aq.py:33)."""

from __future__ import annotations

import torch

from .topk import merge_topk


# elements of one encode tile [rows, M, centroids]: the rows and, at large
# ksub, the centroids are tiled so that the distance tile stays bounded
ENCODE_TILE = 1 << 26


def pq_encode(
    x: torch.Tensor,  # [n, d] float32
    codebooks: torch.Tensor,  # [M, ksub, dsub] float32
    chunk: int = 1 << 15,
) -> torch.Tensor:
    """Nearest codeword per subspace -> codes [n, M] int64
    (ProductQuantizer::compute_codes as a batched GEMM + argmin,
    faiss_tpu/ops/pq_ops.py:31). Rows go in chunks of at most ``chunk``
    and the codewords in tiles of ``ENCODE_TILE // (rows * M)``; a running
    minimum keeps the first of equal distances, as one argmin would."""
    n, d = x.shape
    M, ksub, dsub = codebooks.shape
    if d != M * dsub:
        raise ValueError(f"d={d} != M*dsub={M * dsub}")
    c_norms = codebooks.square().sum(-1)  # [M, ksub]
    rows = max(1, min(chunk, ENCODE_TILE // (M * min(ksub, 1 << 10))))
    kc = max(1, ENCODE_TILE // (rows * M))
    out = []
    for s in range(0, n, rows):
        xc = x[s : s + rows].float().reshape(-1, M, dsub)
        best = best_i = None
        for k0 in range(0, ksub, kc):
            ip = torch.einsum("cmd,mkd->cmk", xc, codebooks[:, k0 : k0 + kc])
            v, i = (c_norms[None, :, k0 : k0 + kc] - 2.0 * ip).min(dim=-1)
            if best is None:
                best, best_i = v, i
            else:
                take = v < best
                best = torch.where(take, v, best)
                best_i = torch.where(take, i + k0, best_i)
        out.append(best_i)
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
        acc += luts[:, m, :][:, codes[..., m].long()]
    return acc


def codes_onehot(codes: torch.Tensor, ksub: int, dtype=torch.bfloat16) -> torch.Tensor:
    """[..., M] codes -> [..., M * ksub] one-hot (faiss_tpu/ops/pq_ops.py:153)."""
    oh = torch.nn.functional.one_hot(codes.long(), ksub).to(dtype)
    return oh.reshape(*codes.shape[:-1], codes.shape[-1] * ksub)


def _select_chunk(vals, ids, scores, c0, k, largest):
    """Merge one column chunk's scores [nq, n] (columns c0..) into the
    running top-k; +-inf scores come back as id -1."""
    v, pos = torch.topk(scores, min(k, scores.shape[1]), dim=1, largest=largest)
    cids = torch.where(torch.isinf(v), -1, pos + c0)
    return merge_topk(vals, ids, v, cids, k, largest=largest)


def _knn_init(nq, k, largest, device):
    sentinel = float("-inf") if largest else float("inf")
    return (torch.full((nq, k), sentinel, device=device),
            torch.full((nq, k), -1, dtype=torch.int64, device=device))


def pq_adc_knn(
    luts: torch.Tensor,  # [nq, M, ksub] float32
    codes: torch.Tensor,  # [nb, M] integer codes
    k: int,
    largest: bool = False,
    db_chunk: int = 1 << 16,
):
    """Flat PQ ADC search (faiss_tpu/ops/pq_ops.py:160; IndexPQ::search):
    per chunk of ``db_chunk`` codes the scores, then ``torch.topk`` and a
    merge. At ksub <= 16 the scores are faiss_tpu's one-hot product: the
    LUTs rounded to bf16 against a one-hot of the codes, summed in float32
    (a float32 product of the bf16 values); above, float32 table gathers
    summed in order of m. The select is exact, where faiss_tpu's
    ``approx_min_k`` is exact on the CPU. Returns (D [nq, k] float32,
    ids [nq, k] int64), the sentinel and -1 past nb."""
    nq, M, ksub = luts.shape
    nb = codes.shape[0]
    vals, ids = _knn_init(nq, min(k, nb), largest, luts.device)
    flat = luts.to(torch.bfloat16).float().reshape(nq, M * ksub) if ksub <= 16 else None
    for c0 in range(0, nb, db_chunk):
        cc = codes[c0 : c0 + db_chunk]
        if flat is not None:
            scores = flat @ codes_onehot(cc, ksub, torch.float32).T
        else:
            scores = adc_scores_gather(luts, cc)
        vals, ids = _select_chunk(vals, ids, scores, c0, min(k, nb), largest)
    if nb < k:
        pad_v, pad_i = _knn_init(nq, k - nb, largest, luts.device)
        vals, ids = torch.cat([vals, pad_v], 1), torch.cat([ids, pad_i], 1)
    return vals, ids


def aq_lut_knn(
    luts: torch.Tensor,  # [nq, M, K] float32 inner-product tables
    codes: torch.Tensor,  # [nb, M] integer codes
    norms: torch.Tensor,  # [nb] float32 stored norms (L2)
    k: int,
    largest: bool = False,
    keep: torch.Tensor = None,  # [nb] bool: codes an ID selector keeps
    db_chunk: int = 1 << 16,
):
    """Additive-quantizer search (faiss_tpu models/aq.py:33, _aq_knn): per
    chunk of ``db_chunk`` codes the float32 table sums of
    :func:`adc_scores_gather` (in order of m), scored ``norm - 2 * sum`` for
    L2 (the caller adds |q|^2) or ``sum`` for inner product, the codes that
    ``keep`` clears set to the sentinel before ``torch.topk`` and the merge.
    The select is exact, where faiss_tpu's ``approx_min_k`` is exact only on
    the CPU. Returns (D [nq, min(k, nb)] float32, ids int64), the sentinel
    and -1 where fewer codes are kept."""
    nq = luts.shape[0]
    nb = codes.shape[0]
    kk = min(k, nb)
    vals, ids = _knn_init(nq, kk, largest, luts.device)
    sentinel = float("-inf") if largest else float("inf")
    for c0 in range(0, nb, db_chunk):
        ip = adc_scores_gather(luts, codes[c0 : c0 + db_chunk])
        scores = ip if largest else norms[None, c0 : c0 + db_chunk] - 2.0 * ip
        if keep is not None:
            scores = torch.where(keep[None, c0 : c0 + db_chunk], scores, sentinel)
        vals, ids = _select_chunk(vals, ids, scores, c0, kk, largest)
    return vals, ids


# pairs (query, code) up to which a polysemous chunk scores only the codes
# that pass the Hamming filter (gathers per pair) instead of every code
POLY_SPARSE_PAIRS = 1 << 24


def pq_polysemous_knn(
    luts: torch.Tensor,  # [nq, M, ksub] float32 ADC tables
    qcodes: torch.Tensor,  # [nq, M] query PQ codes
    codes: torch.Tensor,  # [nb, M] PQ codes
    k: int,
    ht: int,
    db_chunk: int = 1 << 16,
):
    """Polysemous-filtered ADC search (faiss_tpu/ops/pq_ops.py:222;
    IndexPQ ST_polysemous): codes whose Hamming distance to the query's
    code (over all M * nbits bits) is >= ``ht`` are dropped, the rest
    ranked by float32 table gathers summed in order of m, smallest first.
    The Hamming distances come from ops/hamming.hamming_product over the
    codes' bits. A chunk with at most POLY_SPARSE_PAIRS surviving pairs
    scores those pairs alone, with the same additions in the same order,
    so its values are those of the full scan. Returns (D, ids) as
    :func:`pq_adc_knn`; -1 and +inf where fewer than k codes pass."""
    from .hamming import code_bits, hamming_product

    nq, M, ksub = luts.shape
    nb = codes.shape[0]
    nbits = ksub.bit_length() - 1
    kk = min(k, nb)
    vals, ids = _knn_init(nq, kk, False, luts.device)
    qbits = code_bits(qcodes, nbits)
    flat = luts.reshape(nq, M * ksub)
    for c0 in range(0, nb, db_chunk):
        cc = codes[c0 : c0 + db_chunk]
        keep = hamming_product(qbits, code_bits(cc, nbits)) < ht
        npass = int(keep.sum())
        if npass <= POLY_SPARSE_PAIRS:
            qi, ci = keep.nonzero(as_tuple=True)
            acc = torch.zeros(npass, device=luts.device)
            for m in range(M):
                acc = acc + flat[qi, cc[ci, m].long() + m * ksub]
            scores = torch.full(keep.shape, float("inf"), device=luts.device)
            scores[qi, ci] = acc
        else:
            scores = torch.where(keep, adc_scores_gather(luts, cc), float("inf"))
        vals, ids = _select_chunk(vals, ids, scores, c0, kk, False)
    return vals, ids


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
