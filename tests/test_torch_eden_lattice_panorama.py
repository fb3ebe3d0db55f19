"""Port parity for EDEN, the Zn lattice and Panorama
(faiss_tpu_torch/codecs/eden.py, models/eden.py, codecs/lattice.py,
models/lattice.py and models/panorama.py against faiss_tpu's), the port on
the CPU.

The Lloyd-Max tables, the lattice's atoms, vertices and ids and
IndexLattice's ``sa_encode`` bytes are faiss_tpu's bit for bit (the port
ranks whole batches where faiss_tpu ranks one vertex at a time). EDEN's
codes equal faiss_tpu's, its factors within 1e-6 relative (the port sums in
float64 on its device), and the flat and IVF searches from faiss_tpu's state
(convert.eden_from_arrays / ivf_eden_from_arrays) equal faiss_tpu's and
float64 of the estimator within 1e-5 of its scale. The Panorama searches
equal faiss_tpu's and the exact search, with the certificate's repairs
forced by a small prune factor. Files go both ways."""

import io

import numpy as np
import pytest
import torch

import faiss_tpu as ftj
from faiss_tpu.codecs import eden as edj
from faiss_tpu.codecs import lattice as latj
import faiss_tpu_torch as ftt
from faiss_tpu_torch import convert
from faiss_tpu_torch.codecs import eden as edt
from faiss_tpu_torch.codecs import lattice as latt
from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware
from torch_threads import one_torch_thread  # noqa: F401

D, NB, NQ, K, NLIST = 16, 2000, 32, 10, 8


def mixture(seed, n, d=D, ncent=16):
    rs = np.random.RandomState(seed)
    cent = np.random.RandomState(97).randn(ncent, d).astype(np.float32)
    return (cent[rs.randint(ncent, size=n)] + 0.5 * rs.randn(n, d)).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    return mixture(1, NB), mixture(2, NQ)


def search_equal(Dr, Ir, Dp, Ip, scale, largest=False):
    """Distances within 1e-5 of the per-row ``scale``, ids tie-aware."""
    tol = 1e-5 * np.asarray(scale, np.float64)
    err = np.abs(np.where(np.isfinite(Dr), Dr - Dp, 0)).max(1)
    assert (err <= tol).all(), (err / tol).max()
    s = -1.0 if largest else 1.0
    assert ids_agree_tie_aware(s * Dr, Ir, s * Dp, Ip, tol).all()


@pytest.mark.parametrize("bits", range(1, 9))
def test_lloyd_max_tables_bit_for_bit(bits):
    cr, br = edj.lloyd_max_gaussian(bits)
    cp, bp = edt.lloyd_max_gaussian(bits)
    assert cr.tobytes() == cp.tobytes() and br.tobytes() == bp.tobytes()


@pytest.mark.parametrize("bits,st", [(1, 1), (4, 1), (3, 2), (8, 2)],
                         ids=["1-UNBIASED", "4-UNBIASED", "3-BIASED", "8-BIASED"])
def test_eden_codec(data, bits, st):
    """Codes equal faiss_tpu's; factors within 1e-6 relative; decode and
    the packed bytes of equal codes and factors equal faiss_tpu's."""
    xb, _ = data
    cent = xb.mean(0)
    ref = edj.EDENQuantizer(D, bits, st)
    port = edt.EDENQuantizer(D, bits, st, device="cpu")
    cr, fr = ref.encode(xb, cent)
    cp, fp = port.encode(torch.from_numpy(xb), torch.from_numpy(cent))
    cp, fp = cp.numpy(), fp.numpy()
    np.testing.assert_array_equal(cp, cr)
    np.testing.assert_allclose(fp, fr, rtol=1e-6)
    np.testing.assert_array_equal(
        port.decode(torch.from_numpy(cr), torch.from_numpy(fr),
                    torch.from_numpy(cent)).numpy(), ref.decode(cr, fr, cent))
    packed = port.pack(cr, fr)
    np.testing.assert_array_equal(packed, ref.pack(cr, fr))
    c2, f2 = port.unpack(packed)
    np.testing.assert_array_equal(c2, cr)
    np.testing.assert_array_equal(f2, fr)


def eden64(xq, center, y, l2, metric):
    """float64 of the flat EDEN estimator over every code."""
    q = xq.astype(np.float64)
    if metric == ftt.METRIC_L2:
        r = q - center
        return (r * r).sum(1)[:, None] + l2[None] - 2 * r @ y.T.astype(np.float64)
    return q @ (y.astype(np.float64) + center).T


@pytest.mark.parametrize("metric,st", [(1, 1), (1, 2), (0, 1)],
                         ids=["L2-UNBIASED", "L2-BIASED", "IP-UNBIASED"])
def test_eden_flat_search(data, metric, st):
    """IndexEDEN from faiss_tpu's state: the search equals faiss_tpu's and
    float64 of the estimator; the port's own add gives the same codes; an
    ID selector keeps only its rows."""
    xb, xq = data
    ref = ftj.IndexEDEN(D, metric, 4, st)
    ref.train(xb)
    ref.add(xb)
    port = convert.eden_from_arrays(D, 4, st, ref.center, ref._codes, ref._factors,
                                    metric, device="cpu")
    Dr, Ir = ref.search(xq, K)
    Dp, Ip = port.search(xq, K)
    y = ref.eden.decode(ref._codes, ref._factors)
    d64 = eden64(xq, ref.center, y, ref._factors[:, 0].astype(np.float64), metric)
    scale = np.abs(d64).max(1)
    search_equal(Dr, Ir, Dp, Ip, scale, largest=metric == 0)
    pick = -d64 if metric == 0 else d64
    order = np.argsort(pick, 1, kind="stable")[:, :K]
    search_equal(np.take_along_axis(d64, order, 1), order, Dp, Ip, scale,
                 largest=metric == 0)
    own = ftt.IndexEDEN(D, metric, 4, st, device="cpu")
    own.train(xb)
    own.add(xb)
    np.testing.assert_array_equal(own.codes_host, ref._codes)
    np.testing.assert_array_equal(own.sa_encode(xb[:50])[:, : own.eden.packed_size],
                                  ref.sa_encode(xb[:50])[:, : own.eden.packed_size])
    np.testing.assert_allclose(own.sa_decode(ref.sa_encode(xb[:50])),
                               ref.sa_decode(ref.sa_encode(xb[:50])), rtol=1e-6, atol=1e-6)
    sel = ftt.SearchParameters(sel=ftt.IDSelectorRange(100, 400))
    _, Is = port.search(xq, K, params=sel)
    assert ((Is >= 100) & (Is < 400)).all()


@pytest.mark.parametrize("metric", [1, 0], ids=["L2", "IP"])
def test_ivf_eden_search(data, metric):
    """IndexIVFEDEN from faiss_tpu's state (its lists' packed bytes): the
    by-probe search equals faiss_tpu's at nprobe 3; decode equals faiss_tpu's
    and the port's own encoding of the rows gives faiss_tpu's codes."""
    xb, xq = data
    ref = ftj.IndexIVFEDEN(ftj.IndexFlat(D, metric), D, NLIST, metric, 4)
    ref.train(xb)
    ref.add(xb)
    ref.nprobe = 3
    port = convert.ivf_eden_from_arrays(ref.quantizer.vectors(), 4, 1, ref._codes_host,
                                        ref._listnos_host, ref._ids_host, metric,
                                        device="cpu")
    port.nprobe = 3
    Dr, Ir = ref.search(xq, K)
    Dp, Ip = port.search(xq, K)
    scale = np.abs(Dr).max(1) + (xq * xq).sum(1)
    search_equal(Dr, Ir, Dp, Ip, scale, largest=metric == 0)
    np.testing.assert_allclose(port.reconstruct_n(0, 100), ref.reconstruct_n(0, 100),
                               rtol=1e-6, atol=1e-6)
    codes = port.encode_vectors(torch.from_numpy(xb[:200]),
                                torch.from_numpy(ref._listnos_host[:200].astype(np.int64)))
    ps = port.eden.packed_size
    np.testing.assert_array_equal(codes[:, :ps], ref._codes_host[:200, :ps])


LATTICE = [(4, 5), (8, 10), (16, 12), (16, 30)]


@pytest.mark.parametrize("dim,r2", LATTICE, ids=[f"{d}-{r}" for d, r in LATTICE])
def test_zn_sphere_codec_ids_bit_for_bit(dim, r2):
    """Atoms, nv, nearest vertices, ids of the vertices and of single
    vectors, and the decoding of random ids: faiss_tpu's, bit for bit."""
    ref = latj.ZnSphereCodec(dim, r2)
    port = latt.ZnSphereCodec(dim, r2, device="cpu")
    assert ref.voc.tobytes() == port.voc.tobytes() and ref.nv == port.nv
    x = np.random.RandomState(dim + r2).randn(150, dim).astype(np.float32)
    cr, dr = ref.search_multi(x)
    cp, dp = port.search_multi(x)
    np.testing.assert_array_equal(cp, cr)
    np.testing.assert_allclose(dp, dr, rtol=1e-6)
    ids = np.array([ref.encode_vertex(v) for v in cr], np.int64)
    np.testing.assert_array_equal(
        port.encode_vertices(torch.from_numpy(cr).long()).numpy(), ids)
    assert port.encode(x[0]) == ref.encode(x[0])
    rand = np.random.RandomState(3).randint(0, ref.nv, 60).astype(np.int64)
    want = np.stack([ref.decode(int(c)) for c in rand])
    np.testing.assert_array_equal(
        port.decode_ids(torch.from_numpy(rand)).numpy().astype(np.float32), want)
    assert port.decode(int(rand[0])).tobytes() == want[0].tobytes()


def test_index_lattice_bytes_and_search(data):
    """IndexLattice(16, 4, 4, 10): the trained range, sa_encode bytes and
    sa_decode rows bit for bit; the search of the added rows equals
    faiss_tpu's."""
    xb, xq = data
    ref = ftj.IndexLattice(D, 4, 4, 10)
    port = ftt.IndexLattice(D, 4, 4, 10, device="cpu")
    ref.train(xb)
    port.train(xb)
    np.testing.assert_array_equal(port.trained, ref.trained)
    codes = ref.sa_encode(xb[:300])
    np.testing.assert_array_equal(port.sa_encode(xb[:300]), codes)
    np.testing.assert_array_equal(port.sa_decode(codes), ref.sa_decode(codes))
    ref.add(xb[:500])
    port.add(xb[:500])
    np.testing.assert_array_equal(port._codes, ref._codes)
    np.testing.assert_array_equal(port.reconstruct_n(0, 500), ref.reconstruct_n(0, 500))
    Dr, Ir = ref.search(xq, K)
    Dp, Ip = port.search(xq, K)
    search_equal(Dr, Ir, Dp, Ip, (xq * xq).sum(1) + Dr.max(1))
    carried = convert.lattice_from_arrays(D, 4, 4, 10, ref.trained, ref._codes,
                                          device="cpu")
    np.testing.assert_array_equal(carried.reconstruct_n(0, 500), port.reconstruct_n(0, 500))
    search_equal(Dr, Ir, *carried.search(xq, K), (xq * xq).sum(1) + Dr.max(1))


def repairs64(xb, xq, d1, c, k):
    """(rows surely uncertified, rows maybe uncertified) by float64: the
    k-th exact distance against the (c + 1)-th smallest level-1 bound, with
    a 1e-4 relative margin either way."""
    q, x = xq.astype(np.float64), xb.astype(np.float64)
    d = ((q[:, None] - x[None]) ** 2).sum(-1)
    lb = (((q[:, None, :d1] - x[None, :, :d1]) ** 2).sum(-1)
          + (np.linalg.norm(q[:, d1:], axis=1)[:, None]
             - np.linalg.norm(x[:, d1:], axis=1)[None]) ** 2)
    kth = np.sort(d, 1)[:, k - 1]
    thr = np.sort(lb, 1)[:, c]
    return int((kth > thr * (1 + 1e-4)).sum()), int((kth > thr * (1 - 1e-4)).sum())


def test_flat_panorama(data):
    """IndexFlatPanorama: faiss_tpu's search and the exact one; the rows
    the certificate leaves to the repair those of float64, at prune factor
    32 and at 1 (most rows repaired), the results exact either way."""
    xb, xq = data
    ref = ftj.IndexFlatPanorama(D, 4)
    ref.add(xb)
    port = convert.panorama_from_arrays(xb, 4, device="cpu")
    exact = ftt.IndexFlatL2(D, device="cpu")
    exact.add(xb)
    De, Ie = exact.search(xq, K)
    scale = (xq * xq).sum(1) + (xb * xb).sum(1).max()
    for pf in (32, 1):
        port.prune_factor = ref.prune_factor = pf
        Dp, Ip = port.search(xq, K)
        lo, hi = repairs64(xb, xq, D // 4, pf * K, K)
        assert lo <= port.last_repaired <= hi
        search_equal(*ref.search(xq, K), Dp, Ip, scale)
    assert port.last_repaired > 0


def test_ivf_flat_panorama(data):
    """IndexIVFFlatPanorama from faiss_tpu's lists: its search equals
    faiss_tpu's and the port's IndexIVFFlat on the same lists at nprobe 3,
    at prune factors 32 and 2 (repairs through IndexIVFFlat)."""
    xb, xq = data
    ref = ftj.IndexIVFFlatPanorama(ftj.IndexFlat(D), D, NLIST, 4)
    ref.train(xb)
    ref.add(xb)
    args = (ref.quantizer.vectors(), ref._codes_host, ref._listnos_host, ref._ids_host)
    port = convert.ivf_panorama_from_arrays(*args, 4, device="cpu")
    plain = convert.ivfflat_from_arrays(*args, device="cpu")
    ref.nprobe = port.nprobe = plain.nprobe = 3
    scale = (xq * xq).sum(1) + (xb * xb).sum(1).max()
    Df, If = plain.search(xq, K)
    for pf in (32, 2):
        port.prune_factor = ref.prune_factor = pf
        Dp, Ip = port.search(xq, K)
        search_equal(Df, If, Dp, Ip, scale)
        search_equal(*ref.search(xq, K), Dp, Ip, scale)
    assert port.last_repaired > 0


def test_files_both_ways(data):
    """IndexEDEN, IndexIVFEDEN, IndexFlatPanorama, IndexIVFFlatPanorama and
    IndexLattice: faiss_tpu's files read by the port and the port's read by
    faiss_tpu, each search unchanged."""
    xb, xq = data
    xs = xb[:600]
    built = []
    for mk in (lambda: ftj.IndexEDEN(D, 1, 2),
               lambda: ftj.IndexIVFEDEN(ftj.IndexFlat(D), D, NLIST, 1, 3),
               lambda: ftj.IndexFlatPanorama(D, 2),
               lambda: ftj.IndexIVFFlatPanorama(ftj.IndexFlat(D), D, NLIST, 2),
               lambda: ftj.IndexLattice(D, 4, 3, 6)):
        ref = mk()
        ref.train(xs)
        ref.add(xs)
        if hasattr(ref, "nprobe"):
            ref.nprobe = 2
        built.append(ref)
    for ref in built:
        port = ftt.deserialize_index(ftj.serialize_index(ref), device="cpu")
        assert type(port).__name__ == type(ref).__name__
        Dr, Ir = ref.search(xq, K)
        Dp, Ip = port.search(xq, K)
        scale = (xq * xq).sum(1) + np.abs(Dr).max(1)
        search_equal(Dr, Ir, Dp, Ip, scale)
        buf = io.BytesIO()
        ftt.write_index(port, buf)
        back = ftj.read_index(io.BytesIO(buf.getvalue()))
        if hasattr(back, "nprobe"):
            back.nprobe = 2
        search_equal(Dr, Ir, *back.search(xq, K), scale)
        again = ftt.deserialize_index(ftt.serialize_index(port), device="cpu")
        if hasattr(again, "nprobe"):
            again.nprobe = 2
        D2, I2 = again.search(xq, K)
        np.testing.assert_array_equal(D2, Dp)
        np.testing.assert_array_equal(I2, Ip)
