"""Port parity for index files (faiss_tpu_torch/io.py against
faiss_tpu/io.py): one npz container, read and written by both packages.

For every class the port has, IndexPreTransform over every transform
included: faiss_tpu writes and the port reads, and the port writes and
faiss_tpu reads; the port's file holds faiss_tpu's meta tree and arrays bit
for bit, and the indexes search alike (ids tie-aware; distances within
1e-5 * (|q|^2 + max |y|^2), or 1e-4 of that scale where an IVF-PQ returns
its float32 ADC sums, which the two packages add in another order). Also
serialize / deserialize, IO_FLAG_MMAP, faiss_tpu's committed
tests/io_compat files and their golden results, and the refusals: classes
the port does not have and the card as the default device when there is
none; a file of the reference library's own format is read, or refused, as
faiss_tpu's read_index does (tests/test_torch_io_ref.py holds the rest)."""

import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import faiss_tpu as ftj
import faiss_tpu_torch as ftt
from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware
from torch_threads import one_torch_thread  # noqa: F401

D, NB, NQ, K = 16, 1200, 40, 5
IO_COMPAT = Path(__file__).resolve().parent / "io_compat"


def mixture(rs, n, ncent=32, d=D):
    cent = np.random.RandomState(98).rand(ncent, d).astype(np.float32)
    scales = (1.0 / (np.arange(d) + 1.0)).astype(np.float32) * 0.4
    a = rs.randint(ncent, size=n)
    return (cent[a] + rs.randn(n, d).astype(np.float32) * scales).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(71)
    return mixture(rs, NB), mixture(rs, NQ)


def _ivf(cls, *args, d=D):
    index = cls(None, d, 8, *args)
    index.cp.niter = 4
    index.cp.min_points_per_centroid = 1
    index.nprobe = 3
    return index


# a refined IVF-PQ probes one list and takes k * KF_ALL candidates, more
# than any list holds: every entry of the list is then re-ranked, whatever
# the order of the 4-bit ADC keys that tie at a candidate cut
KF_ALL = 120


def _one_list_base():
    base = _ivf(ftj.IndexIVFPQFastScan, 4, 4)
    base.nprobe = 1
    return base


def _trained(vt, xb):
    vt.train(xb)
    return vt


def build_ref(case, xb):
    """A trained, filled faiss_tpu index of ``case`` (its search relies on
    the ADC when the bool is True)."""
    if case == "flat_l2":
        index, adc = ftj.IndexFlatL2(D), False
    elif case == "flat_ip":
        index, adc = ftj.IndexFlatIP(D), False
    elif case == "flat_f16":
        index, adc = ftj.IndexFlat(D, ftj.METRIC_L2), False
        index.storage_dtype = np.float16
    elif case == "flat_sq8":
        index, adc = ftj.IndexFlatSQ8(D), False
    elif case == "flat_1d":
        index = ftj.IndexFlat1D()
        index.add(xb[:, :1])
        return index, False
    elif case == "ivf_flat":
        index, adc = _ivf(ftj.IndexIVFFlat), False
    elif case == "ivf_pq8":
        index, adc = _ivf(ftj.IndexIVFPQ, 4, 8), True
    elif case == "ivf_pq4fs_bbs64":
        index, adc = _ivf(ftj.IndexIVFPQFastScan, 4, 4, ftj.METRIC_L2, 64), True
    elif case == "ivf_pqr":
        index, adc = _ivf(ftj.IndexIVFPQR, 4, 8, 4, 8), False
    elif case == "idmap_flat":
        index, adc = ftj.IndexIDMap(ftj.IndexFlatL2(D)), False
        index.add_with_ids(xb, np.arange(NB, dtype=np.int64) * 7 + (1 << 40))
        return index, adc
    elif case == "idmap2_ivf_flat":
        index, adc = ftj.IndexIDMap2(_ivf(ftj.IndexIVFFlat)), False
        index.train(xb)
        index.add_with_ids(xb, np.arange(NB, dtype=np.int64)[::-1] * 3)
        return index, adc
    elif case == "refine_flat_f16":
        index = ftj.IndexRefineFlat(_one_list_base(), store_float16=True)
        index.k_factor, adc = KF_ALL, False
    elif case == "refine_flat_sq8":
        index = ftj.IndexRefineFlat(_one_list_base(), store="sq8")
        index.k_factor, adc = KF_ALL, False
    elif case == "refine_ivf_flat":
        index = ftj.IndexRefine(_ivf(ftj.IndexIVFFlat), ftj.IndexFlatL2(D))
        index.k_factor, adc = 2, False
    elif case == "pre_pca":
        index = ftj.IndexPreTransform(ftj.PCAMatrix(D, 8, -0.5, True),
                                      ftj.IndexFlatL2(8))
        adc = False
    elif case == "pre_opq_refine":
        opq = ftj.OPQMatrix(D, 4)
        opq.niter = 3
        refine = ftj.IndexRefineFlat(_one_list_base())
        refine.k_factor = KF_ALL
        index, adc = ftj.IndexPreTransform(opq, refine), False
    elif case == "pre_rotations":
        rr = ftj.RandomRotationMatrix(D, D)
        rr.init(5)
        itq = ftj.ITQMatrix(D)
        itq.max_iter = 5
        index = ftj.IndexPreTransform(_trained(itq, xb), ftj.IndexFlatL2(D))
        index.prepend_transform(ftj.HadamardRotation(D))
        index.prepend_transform(rr)
        adc = False
    elif case == "pre_center_norm_pad_itq":
        itqt = ftj.ITQTransform(20, 20)
        index = ftj.IndexPreTransform(itqt, _ivf(ftj.IndexIVFFlat, d=20))
        index.prepend_transform(ftj.RemapDimensionsTransform(D, 20, False))
        index.prepend_transform(ftj.NormalizationTransform(D, 2.0))
        index.prepend_transform(ftj.CenteringTransform(D))
        adc = False
    elif case == "hnsw_flat":
        index, adc = ftj.IndexHNSWFlat(D, 8), False
        index.hnsw.efSearch = 24
    elif case == "hnsw_panorama":
        index, adc = ftj.IndexHNSWFlatPanorama(D, 8, 4), False
    elif case == "hnsw_pq":
        index, adc = ftj.IndexHNSWPQ(D, 8, 4, 8), False
        index.storage.pq.cp.niter = 3
    elif case == "hnsw_sq8":
        index, adc = ftj.IndexHNSWSQ(D, ftj.ScalarQuantizer.QT_8bit, 8), False
    elif case in ("imi", "imi2"):
        if case == "imi":
            index = ftj.MultiIndexQuantizer(D, 2, 4)
        else:
            index = ftj.MultiIndexQuantizer2(D, 4, ftj.IndexFlatL2(D // 2),
                                             ftj.IndexHNSWFlat(D // 2, 8))
        index.pq.cp.niter = 3
        index.train(xb)
        return index, False
    elif case == "ivf_hnsw_flat":
        index, adc = ftj.index_factory(D, "IVF8_HNSW8,Flat"), False
        index.cp.niter, index.cp.min_points_per_centroid, index.nprobe = 4, 1, 3
    elif case == "imi_ivf_pq":
        index, adc = ftj.index_factory(D, "IMI2x3,PQ4"), True
        index.quantizer.pq.cp.niter = index.pq.cp.niter = 3
        index.nprobe = 6
    else:
        raise KeyError(case)
    index.train(xb)
    index.add(xb)
    return index, adc


CASES = ["flat_l2", "flat_ip", "flat_f16", "flat_sq8", "flat_1d", "ivf_flat",
         "ivf_pq8", "ivf_pq4fs_bbs64", "ivf_pqr", "idmap_flat", "idmap2_ivf_flat",
         "refine_flat_f16", "refine_flat_sq8", "refine_ivf_flat", "pre_pca",
         "pre_opq_refine", "pre_rotations", "pre_center_norm_pad_itq",
         "hnsw_flat", "hnsw_panorama", "hnsw_pq", "hnsw_sq8", "imi", "imi2",
         "ivf_hnsw_flat", "imi_ivf_pq"]


def contents(blob):
    """(meta tree, {key: array}) of a serialized index (bytes or uint8)."""
    if not isinstance(blob, bytes):
        blob = bytes(np.asarray(blob, np.uint8))
    with np.load(io.BytesIO(blob)) as z:
        arrays = {k: z[k] for k in z.files}
    return json.loads(bytes(arrays.pop("__meta__")).decode()), arrays


def assert_same_file(a, b, linear_as_faiss_tpu_reads=False):
    """Equal meta trees and arrays bit for bit. faiss_tpu reads a linear
    transform whose class it does not name in its reader (ITQMatrix) as a
    LinearTransform, and writes it back so: with
    ``linear_as_faiss_tpu_reads`` that renaming is allowed."""
    ma, aa = contents(a)
    mb, ab = contents(b)
    if linear_as_faiss_tpu_reads:
        ma, mb = (json.loads(json.dumps(m).replace('"ITQMatrix"', '"LinearTransform"'))
                  for m in (ma, mb))
    assert ma == mb
    assert sorted(aa) == sorted(ab)
    for key in aa:
        x, y = aa[key], ab[key]
        assert x.dtype == y.dtype and x.shape == y.shape, key
        assert x.tobytes() == y.tobytes(), key


def search_agree(ref, port, xq, xb, adc, k=K):
    Dj, Ij = ref.search(xq, k)
    Dt, It = port.search(xq, k)
    assert Dt.dtype == np.float32 and It.dtype == np.int64
    largest = int(ref.metric_type) == int(ftj.METRIC_INNER_PRODUCT)
    tol = (1e-4 if adc else 1e-5) * ((xq.astype(np.float64) ** 2).sum(1)
                                     + (xb.astype(np.float64) ** 2).sum(1).max())
    np.testing.assert_array_equal(Ij == -1, It == -1)
    assert (np.abs(Dt - Dj) <= tol[:, None]).all()
    s = -1.0 if largest else 1.0
    assert ids_agree_tie_aware(s * Dj, Ij, s * Dt, It, tol).all()


@pytest.mark.parametrize("case", CASES)
def test_files_round_trip_between_packages(data, case):
    xb, xq = data
    if case == "flat_1d":
        xb, xq = xb[:, :1], xq[:, :1]
    ref, adc = build_ref(case, xb)
    ref_blob = ftj.serialize_index(ref)
    # faiss_tpu writes, the port reads
    port = ftt.deserialize_index(ref_blob, device="cpu")
    assert type(port).__name__ == type(ref).__name__
    assert port.ntotal == ref.ntotal and port.d == ref.d and port.is_trained
    search_agree(ref, port, xq, xb, adc)
    # the port writes faiss_tpu's file, bit for bit, and faiss_tpu reads it
    port_blob = ftt.serialize_index(port)
    assert_same_file(ref_blob, port_blob)
    back = ftj.deserialize_index(port_blob)
    assert type(back).__name__ == type(ref).__name__
    assert_same_file(ref_blob, ftj.serialize_index(back),
                     linear_as_faiss_tpu_reads=True)
    Dj, Ij = ref.search(xq, K)
    Db, Ib = back.search(xq, K)
    np.testing.assert_array_equal(Ib, Ij)
    np.testing.assert_array_equal(Db, Dj)


NSG_CASES = ["nsg_flat", "nndescent", "nsg_pq", "nsg_sq8"]


def build_port_nsg(case, xb):
    """The port's NSG index of ``case`` (faiss_tpu never builds an NSG
    graph in these tests: its NN-descent races, ROADMAP queue 3)."""
    if case == "nsg_flat":
        index = ftt.IndexNSGFlat(D, 8, device="cpu")
    elif case == "nndescent":
        index = ftt.IndexNNDescentFlat(D, 8, device="cpu")
    elif case == "nsg_pq":
        index = ftt.IndexNSGPQ(D, 4, 8, device="cpu")
        index.storage.pq.cp.niter = 3
    else:
        index = ftt.IndexNSGSQ(D, ftt.QuantizerType.QT_8bit, 8, device="cpu")
    index.search_L = 24
    index.train(xb)
    index.add(xb)
    return index


@pytest.mark.parametrize("case", NSG_CASES)
def test_nsg_files_round_trip_between_packages(data, case):
    """The port writes its NSG index, faiss_tpu reads it (restoring the
    graph, no build) and writes it back bit for bit, the port reads that;
    all three search alike."""
    xb, xq = data
    port = build_port_nsg(case, xb)
    blob = ftt.serialize_index(port)
    ref = ftj.deserialize_index(blob)
    assert type(ref).__name__ == type(port).__name__ and ref.ntotal == NB
    assert_same_file(blob, ftj.serialize_index(ref))
    back = ftt.deserialize_index(ftj.serialize_index(ref), device="cpu")
    assert type(back) is type(port) and back.GK == port.GK
    for other in (ref, back):
        Do, Io = other.search(xq, K)
        Dp, Ip = port.search(xq, K)
        np.testing.assert_array_equal(Io, Ip)
        np.testing.assert_allclose(Do, Dp, rtol=0, atol=1e-5)


def test_refine_store_and_knobs_recovered(data):
    """IndexRefineFlat's store comes back from the refine index (faiss_tpu
    io.py:488-503); k_factor, nprobe, bbs and the transforms' classes come
    back from the file."""
    xb, _ = data
    for case, store in (("refine_flat_f16", "f16"), ("refine_flat_sq8", "sq8"),
                        ("pre_opq_refine", "f32")):
        ref, _ = build_ref(case, xb)
        port = ftt.deserialize_index(ftj.serialize_index(ref), device="cpu")
        r, p = (ref.index, port.index) if case.startswith("pre") else (ref, port)
        assert isinstance(p, ftt.IndexRefineFlat) and p.store == r.store == store
        assert p.store_float16 == (store == "f16") and p.k_factor == r.k_factor
        assert p.base_index.nprobe == r.base_index.nprobe == 1
        assert p.base_index.bbs == 32
    ref, _ = build_ref("pre_center_norm_pad_itq", xb)
    port = ftt.deserialize_index(ftj.serialize_index(ref), device="cpu")
    assert [type(vt).__name__ for vt in port.chain] == [
        "CenteringTransform", "NormalizationTransform",
        "RemapDimensionsTransform", "ITQTransform"]


def test_write_read_file_and_mmap(data, tmp_path):
    """write_index to a path (the exact name given), read_index from it, with
    IO_FLAG_MMAP the lists and vectors stay mapped read-only and search
    alike."""
    xb, xq = data
    ref, _ = build_ref("refine_flat_f16", xb)
    fname = tmp_path / "index.bin"
    ftj.write_index(ref, str(fname))
    plain = ftt.read_index(str(fname), device="cpu")
    mapped = ftt.read_index(fname, ftt.IO_FLAG_MMAP | ftt.IO_FLAG_READ_ONLY,
                            device="cpu")
    assert isinstance(mapped.base_index._codes_host, np.memmap)
    assert not mapped.base_index._codes_host.flags.writeable
    for a, b in zip(plain.search(xq, K), mapped.search(xq, K)):
        np.testing.assert_array_equal(a, b)
    out = tmp_path / "port.idx"
    ftt.write_index(mapped, str(out))
    assert out.exists() and not (tmp_path / "port.idx.npz").exists()
    assert_same_file(fname.read_bytes(), out.read_bytes())
    with pytest.raises(ValueError, match="file path"):
        ftt.read_index(io.BytesIO(fname.read_bytes()), ftt.IO_FLAG_MMAP, device="cpu")


def test_io_compat_files_and_golden_results():
    """faiss_tpu 0.1.0's committed files load in the port (ntotal 1200), and
    IVF8_PQ4 at nprobe 8 reproduces golden_ivfpq.npz (rtol 1e-5, atol 1e-6,
    as tests/test_io_compat.py; ids up to ties within it); SQ8 and PQ4x4fs
    (an IndexPQFastScan) load and search as faiss_tpu's readings of them."""
    for name in ("Flat", "IVF8_Flat", "IVF8_PQ4"):
        index = ftt.read_index(str(IO_COMPAT / f"v0_1_0_{name}.npz"), device="cpu")
        assert index.ntotal == 1200, name
    with np.load(IO_COMPAT / "golden_ivfpq.npz") as z:
        Dg, Ig, xq = z["D"], z["I"], z["xq"]
    index.nprobe = 8
    D, I = index.search(xq, 5)
    np.testing.assert_allclose(D, Dg, rtol=1e-5, atol=1e-6)
    assert ids_agree_tie_aware(Dg, Ig, D, I, 1e-5 * np.abs(Dg[:, -1]) + 1e-6).all()
    sq8 = ftt.read_index(str(IO_COMPAT / "v0_1_0_SQ8.npz"), device="cpu")
    ref = ftj.read_index(str(IO_COMPAT / "v0_1_0_SQ8.npz"))
    assert isinstance(sq8, ftt.IndexScalarQuantizer) and sq8.ntotal == 1200
    search_agree(ref, sq8, xq, ref.reconstruct_n(0, ref.ntotal), False)
    fs = ftt.read_index(str(IO_COMPAT / "v0_1_0_PQ4x4fs.npz"), device="cpu")
    ref = ftj.read_index(str(IO_COMPAT / "v0_1_0_PQ4x4fs.npz"))
    assert isinstance(fs, ftt.IndexPQFastScan) and fs.ntotal == 1200
    search_agree(ref, fs, xq, ref.reconstruct_n(0, ref.ntotal), True)


def test_refusals(data, tmp_path, monkeypatch):
    xb, _ = data
    # a class that faiss_tpu writes and neither package reads back
    dedup = ftj.IndexIVFFlatDedup(ftj.IndexFlat(D), D, 4)
    dedup.train(xb)
    dedup.add(xb)
    with pytest.raises(TypeError, match="unknown serialized class IndexIVFFlatDedup"):
        ftt.deserialize_index(ftj.serialize_index(dedup), device="cpu")
    # the reference library's own format (io_ref): read_index sniffs it and
    # reads these bytes (an empty IxF2 flat) as faiss_tpu's read_index does;
    # an unknown fourcc after the sniff is refused by both
    ref_file = tmp_path / "ref.faissindex"
    ref_file.write_bytes(b"IxF2" + bytes(60))
    got, want = ftt.read_index(str(ref_file), device="cpu"), ftj.read_index(str(ref_file))
    assert (type(got).__name__, got.d, got.ntotal, got.metric_type) == (
        type(want).__name__, want.d, want.ntotal, want.metric_type)
    bad = tmp_path / "bad.faissindex"
    bad.write_bytes(b"IxRF" + bytes(33) + b"IHNf" + bytes(60))
    for read in (ftj.read_index, lambda f: ftt.read_index(f, device="cpu")):
        with pytest.raises(ValueError, match="unsupported reference index fourcc"):
            read(str(bad))
    # index classes that neither package writes
    with pytest.raises(TypeError, match="serialize"):
        ftt.serialize_index(ftt.IndexRandom(D, 10, device="cpu"))
    two = ftt.IndexHNSW2Level(ftt.IndexFlatL2(D, device="cpu"), 4, 4, 8)
    with pytest.raises(TypeError, match="Index2Layer"):
        ftt.serialize_index(two)
    # the card is the default device: with none, read_index raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    blob = ftj.serialize_index(build_ref("flat_l2", xb)[0])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ftt.deserialize_index(blob)
