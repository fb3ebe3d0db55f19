"""Port parity for the graph indexes (faiss_tpu_torch/models/hnsw.py,
nsg.py, extra_indexes.py and binary.py's IndexBinaryHNSW against
faiss_tpu's).

HNSW: both packages build their graphs from the same rows with the same
seed, insertion order and compiler flags, so the graphs are identical (the
rows, levels, neighbours, entry point and max level bit for bit) and so are
the searches: ids exactly, distances within 1e-5. The storage (flat, SQ8
trained in both, PQ with faiss_tpu's codebooks) holds the same rows.
IndexHNSW2Level and its flip_to_ivf, and IndexBinaryHNSW, are held against
faiss_tpu likewise.

NSG and NN-descent are built only in the port (faiss_tpu's NN-descent races,
see ROADMAP queue 3): a second build gives a byte-identical graph, and so
does a build in a process with OMP_NUM_THREADS=1. The port's graph goes into
faiss_tpu through restore_graph (its nsg_import; faiss_tpu never builds one
here) and both then search alike. Recall@10 of the port's graphs is checked
against a float64 ground truth, and an interrupt (InterruptCallback) rolls
each build back."""

import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import faiss_tpu as ftj
import faiss_tpu_torch as ftt
from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware

ROOT = Path(__file__).resolve().parents[1]
D, NB, NQ, K = 24, 2500, 64, 10


def mixture(rs, n, ncent=48, d=D):
    cent = np.random.RandomState(97).rand(ncent, d).astype(np.float32)
    scales = (1.0 / (np.arange(d) + 1.0)).astype(np.float32) * 0.5
    a = rs.randint(ncent, size=n)
    return (cent[a] + rs.randn(n, d).astype(np.float32) * scales).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(81)
    return mixture(rs, NB), mixture(rs, NQ)


def gt64(xb, xq, k):
    d2 = ((xq.astype(np.float64)[:, None, :] - xb.astype(np.float64)[None]) ** 2).sum(-1)
    return np.argsort(d2, axis=1, kind="stable")[:, :k]


def recall(I, gt):
    return np.mean([len(set(a) & set(b)) / len(b) for a, b in zip(I, gt)])


def same_graph(a, b):
    assert a.keys() == b.keys()
    for key in a:
        x, y = np.asarray(a[key]), np.asarray(b[key])
        assert x.dtype == y.dtype and x.shape == y.shape, key
        assert x.tobytes() == y.tobytes(), key


def tie_aware(Dj, Ij, Dt, It, atol):
    """Distances within ``atol``, ids equal up to ties within it."""
    np.testing.assert_allclose(Dt, Dj, rtol=0, atol=atol)
    tol = np.full(len(Dj), atol)
    assert ids_agree_tie_aware(Dj, Ij, Dt, It, tol).all()


def build_hnsw_pair(case, xb):
    """faiss_tpu's and the port's HNSW index of ``case``, both filled."""
    if case == "flat":
        ref, port = ftj.IndexHNSWFlat(D, 16), ftt.IndexHNSWFlat(D, 16, device="cpu")
    elif case == "panorama":
        ref = ftj.IndexHNSWFlatPanorama(D, 16, 4)
        port = ftt.IndexHNSWFlatPanorama(D, 16, 4, device="cpu")
    elif case == "sq8":
        ref = ftj.IndexHNSWSQ(D, ftj.ScalarQuantizer.QT_8bit, 16)
        port = ftt.IndexHNSWSQ(D, ftt.QuantizerType.QT_8bit, 16, device="cpu")
        ref.train(xb)
        port.train(xb)
        np.testing.assert_array_equal(port.storage.sq.trained, ref.storage.sq.trained)
    elif case == "pq":
        ref = ftj.IndexHNSWPQ(D, 16, 6, 8)
        ref.storage.pq.cp.niter = 4
        ref.train(xb)
        port = ftt.IndexHNSWPQ(D, 16, 6, 8, device="cpu")
        port.storage.pq.set_centroids(ref.storage.pq.centroids)
        port.storage.is_trained = port.is_trained = True
    else:
        raise KeyError(case)
    for index in (ref, port):
        index.hnsw.efSearch = 32
        index.add(xb)
    return ref, port


@pytest.mark.parametrize("case", ["flat", "sq8", "pq", "panorama"])
def test_hnsw_graph_and_search_match_reference(data, case):
    xb, xq = data
    ref, port = build_hnsw_pair(case, xb)
    assert type(port).__name__ == type(ref).__name__
    same_graph(ref.graph_state(), port.graph_state())
    Dj, Ij = ref.search(xq, K)
    Dt, It = port.search(xq, K)
    np.testing.assert_array_equal(It, Ij)
    np.testing.assert_allclose(Dt, Dj, rtol=0, atol=1e-5)
    # the storage holds the same rows (PQ: codes but for near ties)
    rj, rt = ref.reconstruct_n(0, NB), port.reconstruct_n(0, NB)
    if case == "pq":
        same = (np.abs(rj - rt).max(1) == 0).mean()
        assert same > 0.99, same
    else:
        np.testing.assert_array_equal(rt, rj)
    # params, the storage device and the stats
    Dp, Ip = port.search(xq, K, params=ftt.SearchParametersHNSW(efSearch=64))
    assert recall(Ip, gt64(xb, xq, K)) >= recall(It, gt64(xb, xq, K))
    assert port.storage.device.type == "cpu"
    assert ftt.hnsw_stats.sync().n1 > 0


def test_hnsw_recall_and_device_queries(data):
    """Recall@1 and @10 of the port's HNSW against float64 exact search,
    rising with efSearch; device tensors as queries, alone and as the
    coarse quantizer of an IVF (its coarse search, tensors on the IVF's
    device)."""
    import torch

    xb, xq = data
    index = ftt.IndexHNSWFlat(D, 16, device="cpu")
    index.add(xb)
    gt = gt64(xb, xq, K)
    rec = []
    for ef in (16, 64, 256):
        index.hnsw.efSearch = ef
        _, I = index.search(xq, K)
        rec.append(recall(I, gt))
    assert rec[0] <= rec[1] <= rec[2] and rec[2] >= 0.95, rec
    assert (I[:, 0] == gt[:, 0]).mean() >= 0.95
    Dt, It = index.search(torch.from_numpy(xq), K)
    np.testing.assert_array_equal(It, I)
    ivf = ftt.IndexIVFFlat(index, D, index.ntotal, device="cpu")
    Dd, Id = ivf._quantizer_search(torch.from_numpy(xq), K)
    assert Dd.device.type == "cpu" and Id.dtype == torch.int64
    np.testing.assert_array_equal(Id.numpy(), I)
    np.testing.assert_array_equal(Dd.numpy(), Dt)


def test_hnsw2level_and_flip_to_ivf_match_reference(data):
    """IndexHNSW2Level over a flat quantizer, both packages holding
    faiss_tpu's trained centroids and PQ: the same coarse ids and codes, the
    same graph over the decoded rows, the same searches; flip_to_ivf gives
    IVF-PQ indexes that search by probe alike."""
    xb, xq = data
    ref = ftj.IndexHNSW2Level(ftj.IndexFlatL2(D), 16, 4, 16)
    ref.storage.pq.cp.niter = 4
    ref.train(xb)
    port = ftt.IndexHNSW2Level(ftt.IndexFlatL2(D, device="cpu"), 16, 4, 16)
    port.storage.q1_quantizer.add(ref.storage.q1_quantizer.vectors())
    port.storage.pq.set_centroids(ref.storage.pq.centroids)
    port.storage.is_trained = port.is_trained = True
    ref.add(xb)
    port.add(xb)
    np.testing.assert_array_equal(port.storage._listnos, ref.storage._listnos)
    assert (port.storage._codes == ref.storage._codes).all(1).mean() > 0.99
    if (port.storage._codes == ref.storage._codes).all():
        same_graph(ref.graph_state(), port.graph_state())
    Dj, Ij = ref.search(xq, K)
    Dt, It = port.search(xq, K)
    # decoded rows repeat (equal codes in one list): ids agree up to ties
    tie_aware(Dj, Ij, Dt, It, 1e-5)
    ivf_j, ivf_t = ref.flip_to_ivf(), port.flip_to_ivf()
    assert isinstance(ivf_t, ftt.IndexIVFPQ) and ivf_t.ntotal == NB
    ivf_j.nprobe = ivf_t.nprobe = 4
    Dj, Ij = ivf_j.search(xq[:32], K)
    Dt, It = ivf_t.search(xq[:32], K)
    tie_aware(Dj, Ij, Dt, It, 1e-4)


def test_binary_hnsw_matches_reference_and_bit_counts(data):
    rs = np.random.RandomState(5)
    xb = rs.randint(0, 256, size=(1500, 8), dtype=np.uint8)
    xq = rs.randint(0, 256, size=(NQ, 8), dtype=np.uint8)
    ref, port = ftj.IndexBinaryHNSW(64, 16), ftt.IndexBinaryHNSW(64, 16, device="cpu")
    ref.add(xb)
    port.add(xb)
    same_graph(ref._impl.graph_state(), port._impl.graph_state())
    Dj, Ij = ref.search(xq, K)
    Dt, It = port.search(xq, K)
    assert Dt.dtype == np.int32
    np.testing.assert_array_equal(It, Ij)
    np.testing.assert_array_equal(Dt, Dj)
    bits = np.unpackbits(xq[:, None, :] ^ xb[It], axis=-1).sum(-1)
    np.testing.assert_array_equal(Dt, bits)
    np.testing.assert_array_equal(port.reconstruct(7), xb[7])


def build_nsg(case, xb):
    if case == "flat":
        index = ftt.IndexNSGFlat(D, 16, device="cpu")
    elif case == "nndescent":
        index = ftt.IndexNNDescentFlat(D, 16, device="cpu")
    elif case == "pq":
        index = ftt.IndexNSGPQ(D, 6, 16, device="cpu")
        index.storage.pq.cp.niter = 4
        index.train(xb)
    elif case == "sq8":
        index = ftt.IndexNSGSQ(D, ftt.QuantizerType.QT_8bit, 16, device="cpu")
        index.train(xb)
    else:
        raise KeyError(case)
    index.add(xb)
    return index


def graph_digest(index) -> str:
    st = index.graph_state()
    h = hashlib.sha256(st["graph"].tobytes())
    h.update(str(st["enterpoint"]).encode())
    return h.hexdigest()


NSG_CASES = ["flat", "nndescent", "pq", "sq8"]


@pytest.mark.parametrize("case", NSG_CASES)
def test_nsg_build_is_deterministic(data, case):
    xb, xq = data
    a, b = build_nsg(case, xb), build_nsg(case, xb)
    assert graph_digest(a) == graph_digest(b)
    for x, y in zip(a.search(xq, K), b.search(xq, K)):
        np.testing.assert_array_equal(x, y)


_ONE_THREAD = """
import hashlib, sys
import numpy as np
import faiss_tpu_torch as ftt
xb, cb = np.load(sys.argv[1]), np.load(sys.argv[2])
d = xb.shape[1]
for case in ("flat", "nndescent", "pq", "sq8"):
    if case == "flat":
        idx = ftt.IndexNSGFlat(d, 16, device="cpu")
    elif case == "nndescent":
        idx = ftt.IndexNNDescentFlat(d, 16, device="cpu")
    elif case == "pq":
        idx = ftt.IndexNSGPQ(d, 6, 16, device="cpu")
        idx.storage.pq.set_centroids(cb)
        idx.storage.is_trained = idx.is_trained = True
    else:
        idx = ftt.IndexNSGSQ(d, ftt.QuantizerType.QT_8bit, 16, device="cpu")
        idx.train(xb)
    idx.add(xb)
    st = idx.graph_state()
    h = hashlib.sha256(st["graph"].tobytes())
    h.update(str(st["enterpoint"]).encode())
    print(case, h.hexdigest())
"""


def test_nsg_graph_same_with_one_thread(data, tmp_path):
    """Every NSG kind built in a process with OMP_NUM_THREADS=1 gives the
    same graph as here (the PQ codebooks handed over: k-means is not the
    point here)."""
    xb, _ = data
    here = {case: build_nsg(case, xb) for case in NSG_CASES}
    np.save(tmp_path / "xb.npy", xb)
    np.save(tmp_path / "cb.npy", here["pq"].storage.pq.centroids)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    out = subprocess.run(
        [sys.executable, "-c", _ONE_THREAD, str(tmp_path / "xb.npy"),
         str(tmp_path / "cb.npy")],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = dict(line.split() for line in out.stdout.strip().splitlines())
    assert got == {case: graph_digest(idx) for case, idx in here.items()}


@pytest.mark.parametrize("case", ["flat", "nndescent"])
def test_nsg_graph_restored_in_reference_searches_alike(data, case):
    xb, xq = data
    port = build_nsg(case, xb)
    cls = ftj.IndexNNDescentFlat if case == "nndescent" else ftj.IndexNSGFlat
    ref = cls(D, 16)
    ref.restore_graph(port.graph_state(), port._xb)
    assert graph_digest(ref) == graph_digest(port)
    for L in (16, 48):
        ref.search_L = port.search_L = L
        Dj, Ij = ref.search(xq, K)
        Dt, It = port.search(xq, K)
        np.testing.assert_array_equal(It, Ij)
        np.testing.assert_allclose(Dt, Dj, rtol=0, atol=1e-5)


def test_nsg_recall_against_float64(data):
    xb, xq = data
    gt = gt64(xb, xq, K)
    for case, floor in (("flat", 0.9), ("nndescent", 0.9)):
        index = build_nsg(case, xb)
        index.search_L = 64
        _, I = index.search(xq, K)
        assert recall(I, gt) >= floor, (case, recall(I, gt))
    # PQ / SQ graphs rank by the decoded rows: their recall is against the
    # exact search over those rows
    for case in ("pq", "sq8"):
        index = build_nsg(case, xb)
        index.search_L = 64
        _, I = index.search(xq, K)
        xr = index.storage.reconstruct_n(0, NB)
        assert recall(I, gt64(xr, xq, K)) >= 0.9, case


@pytest.fixture
def interrupt_on():
    ftt.InterruptCallback.instance = ftt.PythonInterruptCallback(lambda: True)
    yield
    ftt.InterruptCallback.clear_instance()


def test_hnsw_interrupt_rolls_back(interrupt_on):
    rs = np.random.RandomState(3)
    xb = rs.randn(20000, 16).astype(np.float32)
    index = ftt.IndexHNSWFlat(16, 16, device="cpu")
    with pytest.raises(ftt.InterruptedException):
        index.add(xb)
    # the graph rolls the whole batch back, the storage keeps what it kept
    assert index.ntotal == index.storage.ntotal == 0
    assert index.graph_state() is None
    ftt.InterruptCallback.clear_instance()
    index.add(xb[:500])
    assert index.ntotal == 500 and index.search(xb[:3], 1)[1][:, 0].tolist() == [0, 1, 2]


def test_hnsw2level_interrupt_truncates_storage(interrupt_on):
    rs = np.random.RandomState(3)
    xb = rs.randn(20000, 16).astype(np.float32)
    index = ftt.IndexHNSW2Level(ftt.IndexFlatL2(16, device="cpu"), 8, 4, 16)
    index.storage.q1_quantizer.add(xb[:8])
    index.storage.pq.set_centroids(rs.randn(4, 256, 4).astype(np.float32))
    index.storage.is_trained = index.is_trained = True
    with pytest.raises(ftt.InterruptedException, match="rolled back"):
        index.add(xb)
    assert index.storage.ntotal == index.ntotal == 0


@pytest.mark.parametrize("case", ["flat", "pq"])
def test_nsg_interrupt_resets(interrupt_on, case):
    rs = np.random.RandomState(4)
    xb = rs.randn(5000, 16).astype(np.float32)
    if case == "flat":
        index = ftt.IndexNSGFlat(16, 16, device="cpu")
    else:
        index = ftt.IndexNSGPQ(16, 4, 16, device="cpu")
        index.storage.pq.set_centroids(rs.randn(4, 256, 4).astype(np.float32))
        index.storage.is_trained = index.is_trained = True
    index.nndescent_iter = 2
    with pytest.raises(ftt.InterruptedException):
        index.add(xb)
    assert index.ntotal == 0 and index.graph_state() is None
    if case == "pq":  # a retry must not encode the rows twice
        assert index.storage.ntotal == 0
    ftt.InterruptCallback.clear_instance()
    index.add(xb[:1000])
    assert index.ntotal == 1000


def test_nsg_needs_one_add_and_l2(data):
    xb, _ = data
    index = build_nsg("flat", xb[:500])
    with pytest.raises(RuntimeError, match="one add"):
        index.add(xb[:10])
    with pytest.raises(ValueError, match="L2"):
        ftt.IndexNSGFlat(D, 16, ftt.METRIC_INNER_PRODUCT, device="cpu")


def test_host_build_goes_to_the_port_build_dir():
    """The graph code is built from faiss_tpu_torch/csrc/host into
    faiss_tpu_torch/_build, never from or into native/."""
    from faiss_tpu_torch import host_build
    from faiss_tpu_torch.models import hnsw, nsg

    hnsw._load_lib()
    nsg._load_lib()
    for name in ("hnsw", "nsg"):
        lib = host_build.build_host_lib(name)
        path = Path(lib._name).resolve()
        assert path.parent.parent == (ROOT / "faiss_tpu_torch" / "_build" / "host")
        assert path.name == f"lib{name}.so"
        assert (ROOT / "faiss_tpu_torch" / "csrc" / "host" / f"{name}.cpp").exists()
