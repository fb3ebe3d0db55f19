"""Port parity for the Hamming family (faiss_tpu_torch/ops/hamming.py,
models/binary.py, models/lsh.py) against faiss_tpu on the CPU.

Hamming distances are integers, so every count is held to numpy's
``unpackbits`` bit for bit, and ids agree up to ties at the k-th distance
(the two packages break ties in different orders). Binary indexes are built
from the same codes and the same trained quantizer (faiss_tpu_torch.convert);
IndexBinaryIVF.train is compared by the k-means objective of its float
clustering. The port's LSH rotates on its device in float32, so a code bit
may differ from faiss_tpu's where its projection lies within 1e-5 |x| of
the threshold; searches are compared on the queries whose codes agree."""

import numpy as np
import pytest
import torch

import faiss_tpu as ftj
import faiss_tpu_torch as ftt
from faiss_tpu.models import binary as bj
from faiss_tpu.ops import hamming as hj
from faiss_tpu_torch import convert
from faiss_tpu_torch.ops import hamming as ht
from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware
from test_torch_io import assert_same_file
from torch_threads import one_torch_thread  # noqa: F401

NB, NQ, K, D = 3000, 64, 10, 32


def hamming64(a, b):
    """[na, nb] Hamming distances by numpy's unpackbits."""
    ua = np.unpackbits(a, axis=1).astype(np.int64)
    ub = np.unpackbits(b, axis=1).astype(np.int64)
    return (ua[:, None, :] != ub[None, :, :]).sum(-1)


def clustered_codes(nbytes, seed, n=NB, ncent=24):
    """Codes around a few centres (flipped bits), so near neighbours
    exist."""
    rs = np.random.RandomState(seed)
    cent = np.random.RandomState(77).randint(0, 2, size=(ncent, nbytes * 8))
    bits = cent[rs.randint(ncent, size=n)] ^ (rs.rand(n, nbytes * 8) < 0.15)
    return np.packbits(bits.astype(np.uint8), axis=1, bitorder="little")


def agree(D_ref, Dt, It, n_ref=None):
    """Distances per rank equal to the reference's, ids tie-aware (ties at
    the k-th distance) against the distances ``n_ref`` [nq, nb] of every
    returned id."""
    np.testing.assert_array_equal(Dt, D_ref)
    if n_ref is not None:
        rows = np.arange(len(Dt))[:, None]
        np.testing.assert_array_equal(np.where(It >= 0, n_ref[rows, np.maximum(It, 0)],
                                               ht.HAMMING_MISSING), Dt)
        assert all(len(set(r[r >= 0])) == (r >= 0).sum() for r in It)


@pytest.mark.parametrize("nbytes", [5, 8, 32])
@pytest.mark.parametrize("method", ["swar", "product"])
def test_hamming_knn_both_forms(nbytes, method):
    """hamming_knn by SWAR words and by the 0/1 product: the distances of
    numpy's unpackbits count, bit for bit, faiss_tpu's too; every bit of a
    word exercised (codes that are not a whole number of words, high bits
    set)."""
    xb, xq = clustered_codes(nbytes, 1), clustered_codes(nbytes, 2, NQ)
    xb[:5] = 0xFF
    n64 = hamming64(xq, xb)
    Dt, It = ht.hamming_knn_host(xq, xb, K, device="cpu", method=method)
    assert Dt.dtype == np.int32 and It.dtype == np.int64
    want = np.sort(n64, axis=1)[:, :K]
    agree(want, Dt, It, n64)
    Dj, Ij = hj.hamming_knn_host(xq, xb, K)
    np.testing.assert_array_equal(Dj, Dt)
    assert ids_agree_tie_aware(Dj, Ij, Dt, It, 0).all()
    full = (ht.hamming_words(ht.to_words(torch.from_numpy(xq)), ht.to_words(torch.from_numpy(xb)))
            if method == "swar" else
            ht.hamming_product(ht.unpack_bits(torch.from_numpy(xq)),
                               ht.unpack_bits(torch.from_numpy(xb))))
    np.testing.assert_array_equal(full.numpy(), n64)


def test_popcount_and_packing():
    x = torch.tensor([0, 1, -1, -2**31, 2**31 - 1, 0x55555555, -0x55555556],
                     dtype=torch.int32)
    want = [bin(v & 0xFFFFFFFF).count("1") for v in x.tolist()]
    assert ht.popcount32(x).tolist() == want
    bits = np.random.RandomState(0).rand(20, 37) > 0.5
    np.testing.assert_array_equal(ht.pack_bits_tensor(torch.from_numpy(bits)).numpy(),
                                  np.packbits(bits, axis=1, bitorder="little"))
    np.testing.assert_array_equal(ht.pack_bits(bits - 0.5), hj.pack_bits(bits - 0.5))


@pytest.fixture(scope="module")
def codes():
    return clustered_codes(D // 8, 3), clustered_codes(D // 8, 4, NQ)


def test_binary_flat_and_1bit(codes):
    xb, xq = codes
    ref = bj.IndexBinaryFlat(D)
    ref.add(xb)
    for cls in (ftt.IndexBinaryFlat, ftt.IndexBinaryFlat1Bit):
        port = cls(D, device="cpu")
        port.add(xb)
        assert port.ntotal == NB and np.array_equal(port.xb, xb)
        Dj, Ij = ref.search(xq, K)
        Dt, It = port.search(xq, K)
        agree(Dj, Dt, It, hamming64(xq, xb))
        assert ids_agree_tie_aware(Dj, Ij, Dt, It, 0).all()
        np.testing.assert_array_equal(port.reconstruct(7), xb[7])
    rj, rt = ref.range_search(xq, 9), port.range_search(xq, 9)
    for name in ("lims", "distances", "labels"):
        a, b = getattr(rj, name), getattr(rt, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    empty = ftt.IndexBinaryFlat(D, device="cpu")
    De, Ie = empty.search(xq, K)
    assert (De == 2**31 - 1).all() and (Ie == -1).all()


@pytest.fixture(scope="module")
def ivf(codes):
    xb, _ = codes
    ref = bj.IndexBinaryIVF(None, D, 16)
    ref.train(xb)
    ref.add(xb)
    return ref


def test_binary_ivf_search(codes, ivf):
    """The port's IndexBinaryIVF from faiss_tpu's quantizer codes and lists:
    on every row, its distances equal numpy's over its own probed lists (ids
    tie-aware); where its probes are faiss_tpu's (a tie at the nprobe-th
    centroid may swap one), its results are faiss_tpu's."""
    xb, xq = codes
    port = convert.binary_ivf_from_arrays(ivf.quantizer.xb, ivf._codes,
                                          ivf._listnos, ivf._ids, 4, device="cpu")
    ivf.nprobe = 4
    Dj, Ij = ivf.search(xq, K)
    Dt, It = port.search(xq, K)
    pj = ivf.quantizer.search(xq, 4)[1]
    pt = port.quantizer.search(xq, 4)[1]
    n64 = hamming64(xq, xb)
    same = 0
    for r in range(NQ):
        cand = np.nonzero(np.isin(port._listnos, pt[r]))[0]
        d = np.sort(n64[r, cand])[:K]
        agree(np.pad(d, (0, K - len(d)), constant_values=2**31 - 1)[None],
              Dt[r : r + 1], It[r : r + 1], n64[r : r + 1])
        assert np.isin(It[r][It[r] >= 0], port._ids[cand]).all()
        if set(pj[r]) == set(pt[r]):
            same += 1
            np.testing.assert_array_equal(Dt[r], Dj[r])
            assert ids_agree_tie_aware(Dj[r : r + 1], Ij[r : r + 1], Dt[r : r + 1],
                                       It[r : r + 1], 0).all()
    assert same >= NQ // 2
    np.testing.assert_array_equal(port.reconstruct(int(ivf._ids[9])), xb[9])


def test_binary_ivf_train_objective(codes):
    """train: the port's float k-means of the unpacked bits (10 iterations)
    reaches faiss_tpu's objective within 1e-4 relative, and the quantizer
    holds its centroids binarized at 0.5."""
    xb, _ = codes
    xf = np.unpackbits(xb, axis=1, bitorder="little").astype(np.float32)
    cj = ftj.Clustering(D, 16, ftj.ClusteringParameters(niter=10))
    ct = ftt.Clustering(D, 16, ftt.ClusteringParameters(niter=10), device="cpu")
    cj.train(xf)
    ct.train(xf)
    oj, ot = cj.iteration_stats[-1].obj, ct.iteration_stats[-1].obj
    assert abs(ot - oj) <= 1e-4 * oj
    port = ftt.IndexBinaryIVF(None, D, 16, device="cpu")
    assert not port.is_trained
    port.train(xb)
    assert port.is_trained and port.quantizer.ntotal == 16
    np.testing.assert_array_equal(port.quantizer.xb, ht.pack_bits(ct.centroids - 0.5))
    port.add(xb)
    assert port.ntotal == NB and np.bincount(port._listnos, minlength=16).sum() == NB


def test_binary_from_float(codes):
    """IndexBinaryFromFloat over the port's IndexFlatL2: IndexBinaryFlat's
    distances, faiss_tpu's results."""
    xb, xq = codes
    ref = bj.IndexBinaryFromFloat(ftj.IndexFlatL2(D))
    port = ftt.IndexBinaryFromFloat(ftt.IndexFlatL2(D, device="cpu"))
    for index in (ref, port):
        index.add(xb)
    Dj, Ij = ref.search(xq, K)
    Dt, It = port.search(xq, K)
    n64 = hamming64(xq, xb)
    agree(np.sort(n64, axis=1)[:, :K], Dt, It, n64)
    assert ids_agree_tie_aware(Dj, Ij, Dt, It, 0).all()


@pytest.mark.parametrize("nflip", [0, 1, 2])
def test_binary_hash(codes, nflip):
    """IndexBinaryHash: the same candidates in the same order as faiss_tpu's
    buckets, so the same results, ties included."""
    xb, xq = codes
    ref, port = bj.IndexBinaryHash(D, 10), ftt.IndexBinaryHash(D, 10, device="cpu")
    for index in (ref, port):
        index.nflip = nflip
        index.add(xb[:2000])
        index.add(xb[2000:])
    Dj, Ij = ref.search(xq, K)
    Dt, It = port.search(xq, K)
    assert Dt.dtype == np.int32 and (It >= 0).any()
    np.testing.assert_array_equal(Dt, Dj)
    np.testing.assert_array_equal(It, Ij)


def test_binary_multihash(codes):
    xb, xq = codes
    ref, port = bj.IndexBinaryMultiHash(D, 3, 10), ftt.IndexBinaryMultiHash(D, 3, 10, device="cpu")
    for index in (ref, port):
        index.add(xb)
    Dj, Ij = ref.search(xq, K)
    Dt, It = port.search(xq, K)
    assert (It >= 0).any()
    np.testing.assert_array_equal(Dt, Dj)
    np.testing.assert_array_equal(It, Ij)
    port.reset()
    assert port.ntotal == 0 and (port.search(xq, K)[1] == -1).all()


def test_binary_hnsw_waits_for_graphs():
    """IndexBinaryHNSW, once refused until the graph wrappers were ported,
    now builds: its int32 distances are the bit counts of the ids it
    returns, and it finds each stored code at distance 0
    (tests/test_torch_graph.py holds it against faiss_tpu)."""
    rs = np.random.RandomState(12)
    xb = rs.randint(0, 256, size=(800, D // 8), dtype=np.uint8)
    index = ftt.IndexBinaryHNSW(D, 16, device="cpu")
    index.add(xb)
    Dt, It = index.search(xb[:20], 5)
    assert Dt.dtype == np.int32 and (It[:, 0] == np.arange(20)).all()
    bits = np.unpackbits(xb[:20, None, :] ^ xb[It], axis=-1).sum(-1)
    np.testing.assert_array_equal(Dt, bits)


# -- IndexLSH -----------------------------------------------------------------
@pytest.fixture(scope="module")
def vectors():
    rs = np.random.RandomState(8)
    cent = rs.randn(30, D).astype(np.float32)
    xb = (cent[rs.randint(30, size=NB)] + 0.4 * rs.randn(NB, D)).astype(np.float32)
    xq = (cent[rs.randint(30, size=NQ)] + 0.4 * rs.randn(NQ, D)).astype(np.float32)
    return xb, xq


def codes_agree_near_thresholds(ref, port, x):
    """The port's codes equal faiss_tpu's but for bits whose projection
    (minus threshold) lies within 1e-5 |x| of 0. Returns the rows that agree
    on every bit."""
    cj, ct = ref.sa_encode(x), port.sa_encode(x)
    proj = ref.apply_preprocess(x)
    near = np.abs(proj) <= 1e-5 * np.linalg.norm(x, axis=1)[:, None]
    differ = np.unpackbits(cj ^ ct, axis=1, bitorder="little")[:, : ref.nbits] == 1
    assert not (differ & ~near).any()
    return ~differ.any(1)


@pytest.mark.parametrize("nbits,rotate,train", [(D, False, False), (D, True, True),
                                                (2 * D, True, True), (24, False, True)])
def test_lsh(vectors, nbits, rotate, train):
    """IndexLSH from faiss_tpu's rotation and thresholds: codes as faiss_tpu's
    up to near-threshold bits; trained thresholds are np.median's; searches
    equal faiss_tpu's on the queries whose codes agree, float32 distances."""
    xb, xq = vectors
    ref = ftj.IndexLSH(D, nbits, rotate, train)
    ref.train(xb)
    ref.add(xb)
    port = ftt.IndexLSH(D, nbits, rotate, train, device="cpu")
    assert (port.rrot is None) == (ref.rrot is None)
    if port.rrot is not None:
        np.testing.assert_array_equal(port.rrot.A, ref.rrot.A)
    port.train(xb)
    if train:  # the median of the port's projections
        np.testing.assert_allclose(port.thresholds, ref.thresholds, rtol=1e-5, atol=1e-5)
    port = convert.lsh_from_arrays(D, nbits, None if ref.rrot is None else ref.rrot.A,
                                   ref.thresholds, ref._codes, rotate_data=rotate,
                                   train_thresholds=train, device="cpu")
    codes_agree_near_thresholds(ref, port, xb)
    ok = codes_agree_near_thresholds(ref, port, xq)
    Dj, Ij = ref.search(xq, K)
    Dt, It = port.search(xq, K)
    assert Dt.dtype == np.float32 and ok.mean() > 0.9
    np.testing.assert_array_equal(Dt[ok], Dj[ok])
    assert ids_agree_tie_aware(Dj[ok], Ij[ok], Dt[ok], It[ok], 0).all()
    n64 = hamming64(port.sa_encode(xq), ref._codes)
    agree(np.sort(n64, axis=1)[:, :K].astype(np.float32), Dt, It, None)


def test_factory_tokens_and_files(codes, ivf, vectors, tmp_path):
    """LSH[r][t] through index_factory, and files of IndexLSH,
    IndexBinaryFlat and IndexBinaryIVF written by each package, read by the
    other: equal meta and arrays bit for bit, equal searches;
    write_index_binary / read_index_binary are write_index / read_index."""
    for desc, rot, thr in (("LSH", False, False), ("LSHr", True, False),
                           ("LSHt", False, True), ("LSHrt", True, True)):
        ref, port = ftj.index_factory(D, desc), ftt.index_factory(D, desc, device="cpu")
        assert type(port) is ftt.IndexLSH and port.nbits == ref.nbits == D
        assert (port.rotate_data, port.train_thresholds) == (rot, thr)
        assert (ref.rotate_data, ref.train_thresholds) == (rot, thr)
    xb, xq = codes
    xv, _ = vectors
    lsh = ftj.IndexLSH(D, 48, True, True)
    lsh.train(xv)
    lsh.add(xv)
    flat = bj.IndexBinaryFlat(D)
    flat.add(xb)
    for ref in (lsh, flat, ivf):
        blob = ftj.serialize_index(ref)
        port = ftt.deserialize_index(blob, device="cpu")
        assert type(port).__name__ == type(ref).__name__
        assert_same_file(ftt.serialize_index(port), blob)
        back = ftj.deserialize_index(ftt.serialize_index(port))
        q = xq if not isinstance(ref, ftj.IndexLSH) else xv[:NQ]
        Dj, Ij = ref.search(q, K)
        Dp, Ip = back.search(q, K)
        np.testing.assert_array_equal(Dp, Dj)
        np.testing.assert_array_equal(Ip, Ij)
    assert ftt.write_index_binary is ftt.write_index
    assert ftt.read_index_binary is ftt.read_index
    fname = str(tmp_path / "bf.npz")
    ftt.write_index_binary(ftt.deserialize_index(ftj.serialize_index(flat), device="cpu"),
                           fname)
    assert isinstance(ftt.read_index_binary(fname, device="cpu"), ftt.IndexBinaryFlat)
