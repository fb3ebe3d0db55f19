"""Port parity for the reference library's own index format
(faiss_tpu_torch/io_ref.py against faiss_tpu/io_ref.py).

Every fourcc faiss_tpu covers, in both directions: an index built by
faiss_tpu and carried to the port through the npz container is written by
both packages' ``write_ref_index`` to the same bytes; the port reads
faiss_tpu's bytes and faiss_tpu reads the port's, and the two read indexes
search alike (ids tie-aware; distances within 1e-5 * (|q|^2 + max |y|^2),
or 1e-4 of that scale where an IVF-PQ returns float32 ADC sums, added in
another order by the two packages); the port's read index writes the same
bytes again. Also sparse lists, nbits 4, 6, 8 and 10, odd FastScan sizes,
the OPQ + Refine composite and a Refine over an fp16 store, the two id
maps, the packing helpers against faiss_tpu's on odd sizes, a file
assembled by hand field by field, the refusals, and ``read_index``
sniffing the format."""

import io as _io
import os
import struct

import numpy as np
import pytest

import faiss_tpu as ftj
import faiss_tpu_torch as ftt
from faiss_tpu import io_ref as jio
from faiss_tpu import transforms as jT
from faiss_tpu_torch import io_ref as tio
from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware
from torch_threads import one_torch_thread  # noqa: F401

D, NB, NQ, K = 16, 1200, 25, 5
KF_ALL = NB // K  # a refinement's candidates: every row


def mixture(rs, n, ncent=32, d=D):
    cent = np.random.RandomState(97).rand(ncent, d).astype(np.float32)
    scales = (1.0 / (np.arange(d) + 1.0)).astype(np.float32) * 0.4
    a = rs.randint(ncent, size=n)
    return (cent[a] + rs.randn(n, d).astype(np.float32) * scales).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(72)
    return mixture(rs, NB), mixture(rs, NQ)


def _small_cp(index):
    """Few k-means iterations in every IVF and PQ of a faiss_tpu tree; a refinement
    re-ranks every probed row (the two packages' ADC sums differ in the last
    bits, which may swap candidates at a shorter cut)."""
    for ix in (index, getattr(index, "index", None), getattr(index, "base_index", None)):
        if ix is not None and hasattr(ix, "cp"):
            ix.cp.niter = 4
            ix.cp.min_points_per_centroid = 1
        if ix is not None and hasattr(ix, "k_factor"):
            ix.k_factor = KF_ALL
        if ix is not None and hasattr(getattr(ix, "pq", None), "cp"):
            ix.pq.cp.niter = 4
    return index


def _factory(s, metric=ftj.METRIC_L2):
    return lambda: _small_cp(ftj.index_factory(D, s, metric))


def _centered():
    vt = jT.CenteringTransform(D)
    return ftj.IndexPreTransform(vt, ftj.IndexFlatL2(D))


def _refine_fp16():
    base = ftj.index_factory(D, "IVF8,PQ4x4fs")
    return _small_cp(ftj.IndexRefineFlat(_small_cp(base), store_float16=True))


def _ivfpq_not_by_residual():
    index = _small_cp(ftj.index_factory(D, "IVF8,PQ4"))
    index.by_residual = False
    return index


# (name, faiss_tpu builder, fourcc at the top, rows added)
CASES = [
    ("flat_l2", _factory("Flat"), b"IxF2", NB),
    ("flat_ip", _factory("Flat", ftj.METRIC_INNER_PRODUCT), b"IxFI", NB),
    ("flat_l1", lambda: ftj.IndexFlat(D, ftj.METRIC_L1), b"IxFl", NB),
    ("flat_lp", lambda: ftj.IndexFlat(D, ftj.METRIC_Lp, 3.0), b"IxFl", NB),
    ("pq8", _factory("PQ4"), b"IxPq", NB),
    ("pq6_odd", _factory("PQ2x6"), b"IxPq", 601),
    ("pq10", _factory("PQ2x10"), b"IxPq", NB),
    ("pq4fs_odd", _factory("PQ1x4fs"), b"IPfs", 77),
    ("pq4fs_bbs64", _factory("PQ4x4fs_64"), b"IPfs", 200),
    ("sq8", _factory("SQ8"), b"IxSQ", NB),
    ("sq4_odd", _factory("SQ4"), b"IxSQ", 333),
    ("sqfp16", _factory("SQfp16"), b"IxSQ", NB),
    ("ivf_flat", _factory("IVF8,Flat"), b"IwFl", NB),
    ("ivf_flat_sparse", _factory("IVF64,Flat"), b"IwFl", 20),
    ("ivf_sq8", _factory("IVF8,SQ8"), b"IwSq", NB),
    ("ivf_pq8", _factory("IVF8,PQ4"), b"IwPQ", NB),
    ("ivf_pq4", _factory("IVF8,PQ4x4"), b"IwPQ", NB),
    ("ivf_pq_not_by_residual", _ivfpq_not_by_residual, b"IwPQ", NB),
    ("ivf_pq4fs_odd", _factory("IVF8,PQ1x4fs"), b"IwPf", 599),
    ("ivf_pq4fs_bbs64", _factory("IVF8,PQ4x4fs_64"), b"IwPf", NB),
    ("pca_ivf", _factory("PCAW8,IVF8,Flat"), b"IxPT", NB),
    ("rr", _factory("RR16,Flat"), b"IxPT", NB),
    ("l2norm", _factory("L2norm,Flat", ftj.METRIC_INNER_PRODUCT), b"IxPT", NB),
    ("pad", _factory("Pad20,Flat"), b"IxPT", NB),
    ("center", _centered, b"IxPT", NB),
    ("opq_ivfpq4fs_rflat", _factory("OPQ4,IVF8,PQ4x4fs,RFlat"), b"IxPT", NB),
    ("refine_fp16", _refine_fp16, b"IxRF", NB),
    ("idmap", _factory("IDMap,Flat"), b"IxMp", NB),
    ("idmap2_ivf", _factory("IDMap2,IVF8,Flat"), b"IxM2", NB),
]


def _nprobe(index, n):
    ivf = index
    while not hasattr(ivf, "nprobe"):
        ivf = getattr(ivf, "index", None) or getattr(ivf, "base_index", None)
        if ivf is None:
            return
    ivf.nprobe = n


def _pq_like(name):
    return "pq" in name


def search_agree(a, b, xq, xb, scale, what):
    Da, Ia = a.search(xq, K)
    Db, Ib = b.search(xq, K)
    tol = scale * ((xq.astype(np.float64) ** 2).sum(1)
                   + float((xb.astype(np.float64) ** 2).sum(1).max()))
    fin = np.isfinite(Da)
    np.testing.assert_array_equal(fin, np.isfinite(Db), err_msg=what)
    assert (np.abs(np.where(fin, Da - Db, 0)) <= tol[:, None]).all(), what
    ok = ids_agree_tie_aware(np.where(fin, Da, 1e30), Ia, np.where(fin, Db, 1e30),
                             Ib, tol)
    assert ok.all(), (what, np.where(~ok))


@pytest.mark.parametrize("name,build,fourcc,n", CASES, ids=[c[0] for c in CASES])
def test_bytes_and_searches_both_ways(data, name, build, fourcc, n):
    xb, xq = data
    ref = build()
    ref.train(xb)
    if name.startswith("idmap"):
        ref.add_with_ids(xb[:n], np.arange(n, dtype=np.int64) * 5 + 3)
    else:
        ref.add(xb[:n])
    _nprobe(ref, 3)
    port = ftt.deserialize_index(ftj.serialize_index(ref), device="cpu")
    bj, bt = jio.write_ref_index(ref), tio.write_ref_index(port)
    assert bj[:4] == fourcc
    assert bt == bj, name
    if name == "ivf_flat_sparse":
        assert b"sprs" in bj
    back_t = tio.read_ref_index(bj, device="cpu")
    back_j = jio.read_ref_index(bt)
    assert type(back_t).__name__ == type(back_j).__name__
    assert back_t.ntotal == back_j.ntotal == n
    assert tio.write_ref_index(back_t) == bj  # the port's read writes it again
    scale = 1e-4 if _pq_like(name) else 1e-5
    search_agree(back_j, back_t, xq, xb, scale, name)
    search_agree(port, back_t, xq, xb, 1e-6, name + " (the port's original)")


def test_refine_fp16_store_reads_as_float32(data):
    """The main path's fp16 refine store is written as the float32 values it
    holds (faiss_tpu's bytes) and read back as a float32 store of them."""
    xb, _ = data
    ref = _refine_fp16()
    ref.train(xb)
    ref.add(xb)
    port = ftt.deserialize_index(ftj.serialize_index(ref), device="cpu")
    assert port.store == "f16"
    back = tio.read_ref_index(tio.write_ref_index(port), device="cpu")
    assert type(back) is ftt.IndexRefineFlat and back.store == "f32"
    assert not back.store_float16
    np.testing.assert_array_equal(back.refine_index.vectors(),
                                  xb.astype(np.float16).astype(np.float32))
    # the host lists came in through the index's own path: no stale layout
    assert back.base_index._brute is None and back.base_index._device is None


def test_refine_over_ivf_reads_back_in_add_order(data):
    """The file holds a Refine's IVF entries list by list; the port's reader
    puts them back in the order of their ids, so the fused re-rank, which
    gathers the refinement's store by entry, pairs each candidate with its
    own row: the read index's big-batch search (K1's plain version here)
    equals the written one's. faiss_tpu's reader leaves them list by list
    (ROADMAP queue 3)."""
    xb, _ = data
    xq = mixture(np.random.RandomState(5), 256)
    ref = _refine_fp16()
    ref.train(xb)
    ref.add(xb)
    port = ftt.deserialize_index(ftj.serialize_index(ref), device="cpu")
    blob = tio.write_ref_index(port)
    back = tio.read_ref_index(blob, device="cpu")
    np.testing.assert_array_equal(back.base_index._ids_host, np.arange(NB))
    assert not np.array_equal(jio.read_ref_index(blob).base_index._ids_host,
                              np.arange(NB))
    assert tio.write_ref_index(back) == blob
    out = []
    for index in (port, back):
        index.base_index.FUSED_CT = 32
        index.base_index.nprobe = 2
        index.base_index.strict_probe = False
        index.base_index.soft_engage_frac = 1.0
        index.k_factor = 4
        assert len(xq) >= index.base_index.big_batch_threshold
        out.append(index.search(xq, K))
    np.testing.assert_array_equal(out[1][1], out[0][1])
    np.testing.assert_array_equal(out[1][0], out[0][0])
    # entries whose ids are not 0..n-1 cannot be paired with the store's rows
    port.base_index._ids_host = port.base_index._ids_host + 3
    with pytest.raises(ValueError, match="ids are not 0..ntotal-1"):
        tio.read_ref_index(tio.write_ref_index(port), device="cpu")


@pytest.mark.parametrize("n,M,bbs", [(1, 1, 32), (31, 3, 32), (33, 5, 64),
                                     (95, 7, 32), (130, 16, 96)])
def test_pq4_pack_matches_reference(n, M, bbs):
    rs = np.random.RandomState(n + M)
    codes = rs.randint(16, size=(n, M)).astype(np.uint8)
    M2 = -(-M // 2) * 2
    packed = tio._pq4_pack(codes, bbs, M2)
    np.testing.assert_array_equal(packed, jio._pq4_pack(codes, bbs, M2))
    np.testing.assert_array_equal(tio._pq4_unpack(packed, n, M, bbs, M2), codes)


@pytest.mark.parametrize("nbits", [1, 3, 4, 6, 8, 10, 12, 16])
def test_bits_pack_matches_reference(nbits):
    rs = np.random.RandomState(nbits)
    n, M = 37, 5
    codes = rs.randint(1 << nbits, size=(n, M)).astype(np.uint32)
    packed = tio._bits_pack(codes, nbits)
    np.testing.assert_array_equal(packed, jio._bits_pack(codes, nbits))
    np.testing.assert_array_equal(tio._bits_unpack(packed, n, M, nbits), codes)


def test_hand_assembled_iwfl():
    """An IwFl file assembled field by field after index_write.cpp
    (tests/test_io_ref.py's, independent of either writer) loads into the
    port and searches right."""
    d, nlist = 4, 2
    cent = np.array([[0.0] * 4, [10.0] * 4], np.float32)
    v0 = np.array([[0.1, 0, 0, 0], [0, 0.2, 0, 0]], np.float32)
    v1 = np.array([[10, 10.3, 10, 10]], np.float32)
    b = _io.BytesIO()

    def w(fmt, *vals):
        b.write(struct.pack(fmt, *vals))

    b.write(b"IwFl")
    w("<iqqq", d, 3, 1 << 20, 1 << 20)
    b.write(b"\x01")
    w("<i", 1)  # METRIC_L2
    w("<QQ", nlist, 1)  # nlist, nprobe
    # quantizer: IxF2 flat with the centroids
    b.write(b"IxF2")
    w("<iqqq", d, nlist, 1 << 20, 1 << 20)
    b.write(b"\x01")
    w("<i", 1)
    w("<Q", nlist * d)
    b.write(cent.tobytes())
    # direct map: type NoMap, empty array
    b.write(b"\x00")
    w("<Q", 0)
    # invlists: ilar, full sizes
    b.write(b"ilar")
    w("<QQ", nlist, d * 4)
    b.write(b"full")
    w("<Q", nlist)
    w("<QQ", 2, 1)
    b.write(v0.tobytes())
    w("<qq", 7, 8)
    b.write(v1.tobytes())
    w("<q", 9)
    index = tio.read_ref_index(b.getvalue(), device="cpu")
    assert type(index) is ftt.IndexIVFFlat
    assert index.ntotal == 3 and index.nlist == 2 and index.nprobe == 1
    _, Iq = index.search(np.zeros((1, 4), np.float32), 2)
    np.testing.assert_array_equal(Iq[0], [7, 8])
    _, Iq = index.search(np.full((1, 4), 10.0, np.float32), 1)
    assert Iq[0, 0] == 9
    assert tio.write_ref_index(index) == b.getvalue()


def test_refusals(data):
    xb, _ = data
    blob = b"IHNf" + b"\x00" * 64
    for read in (jio.read_ref_index, lambda x: tio.read_ref_index(x, device="cpu")):
        with pytest.raises(ValueError, match="unsupported reference index fourcc"):
            read(blob)
    ivf = _factory("IVF8,Flat")()
    ivf.train(xb)
    ivf.add(xb)
    blob = jio.write_ref_index(ivf)
    for cut in (40, len(blob) - 1):
        with pytest.raises(EOFError, match="truncated"):
            tio.read_ref_index(blob[:cut], device="cpu")
    # a trained IVF with no entry yet (faiss_tpu's writer cannot write one)
    empty = ftt.deserialize_index(ftj.serialize_index(ivf), device="cpu")
    empty.reset()
    blob = tio.write_ref_index(empty)
    back = tio.read_ref_index(blob, device="cpu")
    assert back.ntotal == 0 and back.is_trained and tio.write_ref_index(back) == blob
    hnsw = ftt.IndexHNSWFlat(D, 8, device="cpu")
    with pytest.raises(ValueError, match="cannot export IndexHNSWFlat"):
        tio.write_ref_index(hnsw)
    itq = ftt.IndexPreTransform(ftt.ITQTransform(D, D, device="cpu"),
                                ftt.IndexFlatL2(D, device="cpu"))
    with pytest.raises(ValueError, match="cannot export VectorTransform"):
        tio.write_ref_index(itq)


def test_read_index_sniffs_the_format(data, tmp_path):
    xb, xq = data
    ref = _factory("IVF8,PQ4x4fs")()
    ref.train(xb)
    ref.add(xb)
    ref.nprobe = 3
    path = tmp_path / "ivfpq.faissindex"
    jio.write_ref_index(ref, str(path))
    by_path = ftt.read_index(str(path), device="cpu")
    with open(path, "rb") as f:
        by_file = ftt.read_index(f, device="cpu")
    npz = tmp_path / "ivfpq.npz"
    ftj.write_index(ref, str(npz))
    by_npz = ftt.read_index(str(npz), device="cpu")
    by_bytes_path = ftt.read_index(os.fsencode(path), device="cpu")
    by_bytes_npz = ftt.read_index(os.fsencode(npz), device="cpu")
    for got in (by_path, by_file, by_npz, by_bytes_path, by_bytes_npz):
        assert type(got) is ftt.IndexIVFPQFastScan and got.ntotal == NB
        search_agree(ref, got, xq, xb, 1e-4, "sniffed")
    assert ftt.write_ref_index(by_npz) == path.read_bytes()
