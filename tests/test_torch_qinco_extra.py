"""Port parity for the neural codec and the small IVF variants
(faiss_tpu_torch/utils/neuralnet.py, models/neuralnet_codec.py and
models/extra_indexes.py against faiss_tpu's), the port on the CPU.

QINCo: faiss_tpu's numpy state dicts load into the port's modules under the
same names; decode agrees within 1e-5 and encode gives the same codes;
``train_qinco`` from faiss_tpu's ``_qinco_init`` state on faiss_tpu's
batches ends within 1e-3 relative of faiss_tpu's reconstruction error on a
tiny model. IndexIVFFlatDedup (its ``instances``, search and
``remove_ids``), IndexRowwiseMinMax / FP16 (their bytes), and
IndexIVFIndependentQuantizer and IndexIVFSpectralHash (their searches) equal
faiss_tpu's on the same coarse centroids."""

import numpy as np
import pytest
import torch

import faiss_tpu as ftj
from faiss_tpu.utils import neuralnet as nnj
import faiss_tpu_torch as ftt
from faiss_tpu_torch import convert
from faiss_tpu_torch.utils import neuralnet as nnt
from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware
from torch_threads import one_torch_thread  # noqa: F401

D, NB, NQ, K, NLIST = 16, 2000, 32, 10, 8
QD, QK, QL, QM, QH = 8, 16, 1, 3, 16  # the tiny QINCo


def mixture(seed, n, d=D, ncent=16):
    rs = np.random.RandomState(seed)
    cent = np.random.RandomState(96).randn(ncent, d).astype(np.float32)
    return (cent[rs.randint(ncent, size=n)] + 0.5 * rs.randn(n, d)).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    return mixture(1, NB), mixture(2, NQ)


@pytest.fixture(scope="module")
def qinco_state():
    import jax

    x = mixture(3, 1200, QD)
    return x, nnj._qinco_init(jax.random.PRNGKey(0), QD, QK, QL, QM, QH, x)


def centroids(xb):
    return np.ascontiguousarray(xb[:: NB // NLIST][:NLIST])


def search_equal(Dr, Ir, Dp, Ip, scale):
    tol = 1e-5 * np.asarray(scale, np.float64)
    err = np.abs(np.where(np.isfinite(Dr), Dr - Dp, 0)).max(1)
    assert (err <= tol).all() and (np.isfinite(Dr) == np.isfinite(Dp)).all()
    assert ids_agree_tie_aware(Dr, Ir, Dp, Ip, tol).all()


def test_qinco_state_names_decode_and_encode(qinco_state):
    """The port's module has faiss_tpu's state-dict names; decode within
    1e-5 and encode equal to faiss_tpu's (a different code only where both
    reconstruct equally well)."""
    x, state = qinco_state
    ref = nnj.QINCo(QD, QK, QL, QM, QH)
    ref.load_state(state)
    port = convert.qinco_from_state(state, QD, QK, QL, QM, QH, device="cpu")
    assert set(port.state_dict()) == set(state)
    codes = ref.encode(x)
    got = port.encode(torch.from_numpy(x)).numpy()
    same = (got == codes).all(1)
    assert same.mean() > 0.99
    rec_r = ref.decode(codes)
    rec_p = port.decode(torch.from_numpy(codes)).numpy()
    np.testing.assert_allclose(rec_p, rec_r, rtol=1e-5, atol=1e-5)
    if not same.all():  # the rows that differ reconstruct as well
        e_r = ((x - rec_r) ** 2).sum(1)[~same]
        e_p = ((x - port.decode(torch.from_numpy(got)).numpy()) ** 2).sum(1)[~same]
        np.testing.assert_allclose(e_p, e_r, rtol=1e-4)
    step_r = ref.steps[0].encode(rec_r * 0.5, x)
    step_p = port.steps[0].encode(torch.from_numpy(rec_r * 0.5), torch.from_numpy(x))
    assert (step_p.numpy() == step_r).mean() > 0.99


def test_train_qinco_matches_reference(qinco_state):
    """train_qinco from faiss_tpu's initial state on its batches (two
    epochs of four batches of 256, the partial one skipped): the losses
    fall, and the reconstruction error of the trained codec is within 1e-3
    relative of faiss_tpu's."""
    x, state = qinco_state
    ref = nnj.train_qinco(x, QK, QM, QL, QH, epochs=2, batch=256, lr=1e-3, seed=0)
    port = nnt.train_qinco(x, QK, QM, QL, QH, epochs=2, batch=256, lr=1e-3, seed=0,
                           init_state=state, device="cpu")
    assert port.train_losses[1] < port.train_losses[0]
    mse_r = ((x - ref.decode(ref.encode(x))) ** 2).sum(1).mean()
    xt = torch.from_numpy(x)
    mse_p = float(((xt - port.decode(port.encode(xt))) ** 2).sum(1).mean())
    assert abs(mse_p - mse_r) <= 1e-3 * mse_r, (mse_p, mse_r)


def test_index_qinco(qinco_state):
    """IndexQINCo with faiss_tpu's weights: sa_encode bytes and sa_decode
    rows as faiss_tpu's, the search over the decoded codes equal; the
    generic codec refuses to train, as faiss_tpu's."""
    x, state = qinco_state
    ref = ftj.IndexQINCo(QD, QM, 4, QL, QH)
    ref.load_state(state)
    port = ftt.IndexQINCo(QD, QM, 4, QL, QH, device="cpu")
    assert not port.is_trained
    port.load_state(state)
    codes = ref.sa_encode(x[:200])
    assert (port.sa_encode(x[:200]) == codes).all(1).mean() > 0.99
    np.testing.assert_allclose(port.sa_decode(codes), ref.sa_decode(codes),
                               rtol=1e-5, atol=1e-5)
    ref.add(x[:1000])
    port.add(x[:1000])
    xq = x[1000:1032]
    Dr, Ir = ref.search(xq, K)
    Dp, Ip = port.search(xq, K)
    search_equal(Dr, Ir, Dp, Ip, (xq * xq).sum(1) + Dr.max(1))
    with pytest.raises(RuntimeError, match="trained externally"):
        ftt.IndexNeuralNetCodec(QD, QM, 4, device="cpu").train(x)


def test_ivf_flat_dedup(data):
    """Rows duplicated within a batch and across adds: ``instances`` equal
    faiss_tpu's, the search equals faiss_tpu's (representatives), with
    ``expand_instances`` every duplicate follows its representative, and
    remove_ids removes duplicates and representatives as faiss_tpu's."""
    xb, xq = data
    rs = np.random.RandomState(4)
    dup = np.concatenate([xb, xb[rs.randint(0, NB, 300)]])
    ids = rs.permutation(len(dup)).astype(np.int64) + 10
    cent = centroids(xb)
    ref = ftj.IndexIVFFlatDedup(ftj.IndexFlat(D), D, NLIST)
    ref.quantizer.add(cent)
    q = ftt.IndexFlat(D, device="cpu")
    q.add(cent)
    port = ftt.IndexIVFFlatDedup(q, D, NLIST, device="cpu")
    ref.train(xb)  # the quantizers hold their centroids: no k-means
    port.train(xb)
    for s, e in ((0, 1500), (1500, len(dup))):
        ref.add_with_ids(dup[s:e], ids[s:e])
        port.add_with_ids(dup[s:e], ids[s:e])
    assert port.instances == ref.instances and port.ntotal == ref.ntotal
    assert sum(map(len, port.instances.values())) == len(dup) - port.ntotal
    ref.nprobe = port.nprobe = 3
    Dr, Ir = ref.search(xq, K)
    Dp, Ip = port.search(xq, K)
    search_equal(Dr, Ir, Dp, Ip, (xq * xq).sum(1) + Dr.max(1))
    Dk, Ik = port.search(xq, 2 * K)
    port.expand_instances = True
    De, Ie = port.search(xq, 2 * K)
    for r in range(NQ):  # each representative, then its duplicates, up to k
        want = [(d, j) for d, i in zip(Dk[r], Ik[r]) if i >= 0
                for j in [int(i)] + port.instances.get(int(i), [])][: 2 * K]
        assert Ie[r, : len(want)].tolist() == [j for _, j in want]
        np.testing.assert_array_equal(De[r, : len(want)], [d for d, _ in want])
    port.expand_instances = False
    sel = ftt.IDSelectorRange(0, 600)
    assert port.remove_ids(sel) == ref.remove_ids(ftj.IDSelectorRange(0, 600))
    assert port.instances == ref.instances and port.ntotal == ref.ntotal


@pytest.mark.parametrize("fp16", [False, True], ids=["fp32", "fp16"])
def test_rowwise_minmax_bytes(data, fp16):
    """IndexRowwiseMinMax(FP16) over an SQ8 index: sa_encode bytes and
    sa_decode rows bit for bit, reconstruct; search raises, as faiss_tpu's."""
    xb, _ = data
    rcls = ftj.IndexRowwiseMinMaxFP16 if fp16 else ftj.IndexRowwiseMinMax
    pcls = ftt.IndexRowwiseMinMaxFP16 if fp16 else ftt.IndexRowwiseMinMax
    ref = rcls(ftj.IndexScalarQuantizer(D, ftj.QuantizerType.QT_8bit))
    port = pcls(ftt.IndexScalarQuantizer(D, ftt.QuantizerType.QT_8bit, device="cpu"))
    ref.train(xb)
    port.train(xb)
    codes = ref.sa_encode(xb[:300])
    np.testing.assert_array_equal(port.sa_encode(xb[:300]), codes)
    np.testing.assert_array_equal(port.sa_decode(codes), ref.sa_decode(codes))
    ref.add(xb[:300])
    port.add(xb[:300])
    np.testing.assert_allclose(port.reconstruct(7), ref.reconstruct(7), rtol=1e-6)
    with pytest.raises(NotImplementedError):
        port.search(xb[:2], K)


def test_ivf_independent_quantizer(data):
    """A flat coarse quantizer over the vectors, IVF-Flat codes of their
    random rotation: the search by the quantizer's probes equals
    faiss_tpu's."""
    xb, xq = data
    cent = centroids(xb)
    rq = ftj.IndexFlat(D)
    rq.add(cent)
    rvt = ftj.RandomRotationMatrix(D, D)
    rvt.init()
    ref = ftj.IndexIVFIndependentQuantizer(rq, ftj.IndexIVFFlat(ftj.IndexFlat(D), D, NLIST),
                                           rvt)
    pq = ftt.IndexFlat(D, device="cpu")
    pq.add(cent)
    pvt = ftt.RandomRotationMatrix(D, D, device="cpu")
    pvt.init()
    port = ftt.IndexIVFIndependentQuantizer(
        pq, ftt.IndexIVFFlat(ftt.IndexFlat(D, device="cpu"), D, NLIST, device="cpu"), pvt)
    for index in (ref, port):
        index.train(xb)
        index.add(xb)
        index.index_ivf.nprobe = 3
    np.testing.assert_array_equal(port.index_ivf._listnos_host, ref.index_ivf._listnos_host)
    Dr, Ir = ref.search(xq, K)
    Dp, Ip = port.search(xq, K)
    search_equal(Dr, Ir, Dp, Ip, (xq * xq).sum(1) + Dr.max(1))


def test_ivf_spectral_hash(data):
    """The median thresholds, the codes and the Hamming search by probe:
    faiss_tpu's (distances exactly, ids up to ties, which both break by
    slot)."""
    xb, xq = data
    cent = centroids(xb)
    ref = ftj.IndexIVFSpectralHash(ftj.IndexFlat(D), D, NLIST, 24)
    ref.quantizer.add(cent)
    q = ftt.IndexFlat(D, device="cpu")
    q.add(cent)
    port = ftt.IndexIVFSpectralHash(q, D, NLIST, 24, device="cpu")
    for index in (ref, port):
        index.train(xb)
        index.add(xb)
        index.nprobe = 3
    np.testing.assert_allclose(port.trained_thresholds, ref.trained_thresholds,
                               rtol=1e-6, atol=1e-7)
    assert (port._codes_host == ref._codes_host).all(1).mean() > 0.999
    Dr, Ir = ref.search(xq, K)
    Dp, Ip = port.search(xq, K)
    np.testing.assert_array_equal(Dp, Dr)
    assert (Ip == Ir).mean() > 0.99
    assert ids_agree_tie_aware(Dr, Ir, Dp, Ip, 0.0).all()
