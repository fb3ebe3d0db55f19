"""Port parity for index_factory (faiss_tpu_torch/factory.py against
faiss_tpu/factory.py): the tree the port builds from each supported string
has faiss_tpu's classes, dimensions, list counts, PQ shapes, transforms and
refine store (the EDEN, Panorama and lattice tokens too, with their codecs'
settings), and malformed strings raise ValueError in both packages. Also the data of the slice's configuration:
chip_smoke.py's copy of the Deep10M-like generator against
benchs/bench_deep10m.py's, bit for bit."""

import sys
from pathlib import Path

import numpy as np
import pytest

import faiss_tpu as ftj
import faiss_tpu_torch as ftt
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def tree(index):
    """The comparable description of an index tree, in either package."""
    out = {"class": type(index).__name__, "d": index.d,
           "metric": int(index.metric_type)}
    if hasattr(index, "chain"):
        out["chain"] = []
        for vt in index.chain:
            t = {"class": type(vt).__name__, "d_in": vt.d_in, "d_out": vt.d_out}
            for name in ("M", "eigen_power", "random_rotation", "norm", "do_pca"):
                if hasattr(vt, name):
                    t[name] = getattr(vt, name)
            if hasattr(vt, "map"):
                t["map"] = np.asarray(vt.map).tolist()
            if type(vt).__name__ == "RandomRotationMatrix":
                t["A"] = vt.A.tolist()
            out["chain"].append(t)
        out["sub"] = tree(index.index)
    elif hasattr(index, "base_index"):
        out["k_factor"] = index.k_factor
        out["store"] = getattr(index, "store", None)
        out["base"] = tree(index.base_index)
        out["refine"] = tree(index.refine_index)
        if hasattr(index.refine_index, "storage_dtype"):
            out["refine_dtype"] = np.dtype(index.refine_index.storage_dtype).name
    elif hasattr(index, "id_map"):
        out["sub"] = tree(index.index)
    if hasattr(index, "nlist"):  # IVF, or Index2Layer's q1_quantizer
        q = getattr(index, "quantizer", None) or index.q1_quantizer
        out.update(nlist=index.nlist, nprobe=getattr(index, "nprobe", None),
                   quantizer=tree(q),
                   trains_alone=getattr(index, "quantizer_trains_alone", 0))
    if hasattr(index, "storage"):  # the graph indexes
        out["storage"] = tree(index.storage)
    if hasattr(index, "hnsw"):
        out["hnsw"] = (index.hnsw.M, index.hnsw.efConstruction, index.hnsw.efSearch)
    for name in ("R", "GK", "search_L", "num_panorama_levels"):
        if hasattr(index, name):
            out[name] = getattr(index, name)
    for name in ("pq", "refine_pq"):
        if hasattr(index, name):
            pq = getattr(index, name)
            out[name] = (pq.d, pq.M, pq.nbits)
    if hasattr(index, "bbs"):
        out["bbs"] = index.bbs
    if hasattr(index, "pq"):
        out["by_residual"] = getattr(index, "by_residual", None)
    for name in ("nbits", "rotate_data", "train_thresholds"):  # IndexLSH
        if hasattr(index, name):
            out[name] = getattr(index, name)
    if hasattr(index, "sq"):
        out["sq"] = (int(index.sq.qtype), index.sq.code_size)
    if hasattr(index, "aq"):  # the additive quantizers
        aq = index.aq
        out["aq"] = (type(aq).__name__, aq.d, aq.M, aq.nbits, aq.search_type,
                     aq.code_size, getattr(aq, "nsplits", None),
                     [type(s).__name__ for s in getattr(aq, "subs", [])])
        out["code_size"] = getattr(index, "code_size", None)
    if hasattr(index, "eden"):
        out["eden"] = (index.eden.d, index.eden.nb_bits, int(index.eden.scale_type),
                       index.eden.code_size)
    for name in ("num_levels", "n_levels", "prune_factor"):  # Panorama
        if hasattr(index, name):
            out[name] = getattr(index, name)
    if hasattr(index, "zn_sphere_codec"):
        out["lattice"] = (index.nsq, index.dsq, index.scale_nbit,
                          index.zn_sphere_codec.r2, index.zn_sphere_codec.nv,
                          index.lattice_nbit, index.code_size)
    if hasattr(index, "rabitq"):
        out["rabitq"] = (type(index.rabitq).__name__, index.nb_bits, index.qb,
                         index.rabitq.code_size, getattr(index, "code_size", None),
                         getattr(index, "by_residual", None))
    return out


SUPPORTED = [
    (32, "Flat", "l2"), (32, "Flat", "ip"), (1, "Flat1D", "l2"),
    (32, "IVF16,Flat", "l2"), (32, "IVF16,Flat", "ip"), (32, "IVF16,PQ8", "l2"),
    (32, "IVF16,PQ8x4fs", "l2"), (32, "IVF16,PQ8x4fs_64", "l2"),
    (32, "IVF16,PQ4x8", "l2"), (32, "IVF16,PQ4+8", "l2"),
    (32, "PCA16,Flat", "l2"), (32, "PCAW16,Flat", "l2"), (32, "PCAR16,IVF16,Flat", "l2"),
    (32, "PCAWR8,IVF16,PQ4", "l2"), (32, "OPQ4_16,IVF16,PQ4", "l2"),
    (32, "OPQ8,IVF16,PQ8x4fs,RFlat", "l2"), (32, "RR,Flat", "l2"), (32, "RR16,Flat", "l2"),
    (32, "ITQ,Flat", "l2"), (32, "ITQ16,Flat", "l2"), (32, "Pad48,IVF16,Flat", "l2"),
    (32, "L2norm,IVF16,Flat", "ip"), (32, "IDMap,Flat", "l2"), (32, "IDMap2,IVF16,Flat", "l2"),
    (32, "IDMap2,IVF32,PQ4x4fs,Refine(SQ8)", "l2"), (32, "IVF16,PQ8x4fs,Refine(Flat)", "l2"),
    (32, "IVF16,PQ8,Refine(IVF8,Flat)", "l2"), (32, "IDMap,OPQ8,IVF16,PQ8,RFlat", "l2"),
    (96, "OPQ32,IVF8192,PQ32x4fs,RFlat", "l2"),
    (32, "SQ8", "l2"), (32, "IVF16,SQ8", "l2"), (32, "IVF16,SQfp16", "l2"),
    (32, "IVF16,Flat,Refine(SQ4)", "l2"),
    (32, "PQ4,RFlat", "l2"), (32, "PQ8", "l2"), (32, "PQ8", "ip"), (32, "PQ8x4fs", "l2"),
    (32, "PQ16x12", "l2"), (128, "PQ64", "l2"), (32, "PQ32x4fs_64", "l2"),
    (32, "OPQ8,PQ8", "l2"), (32, "IVF16,Flat,Refine(PQ4)", "l2"), (32, "LSH", "l2"),
    (32, "LSHrt", "l2"), (32, "IVF16,PQ8x6", "l2"),
    # the graphs and the coarse quantizers other than flat
    (32, "HNSW32,SQ8", "l2"), (32, "NSG32,SQ8", "l2"), (32, "HNSW32", "l2"),
    (32, "HNSW32,PQ8", "l2"), (32, "NSG32", "l2"), (32, "IVF16(PQ4),Flat", "l2"),
    (32, "IVF16_HNSW32,Flat", "l2"), (32, "IMI2x4,PQ8", "l2"),
    (32, "HNSW16,Flat", "ip"), (32, "HNSW16,FlatPanorama4", "l2"),
    (32, "HNSW32,PQ8x4np", "l2"), (32, "HNSW32,16+PQ8", "l2"),
    (32, "HNSW32,2x4+PQ8", "l2"), (32, "NNDescent32", "l2"), (32, "NSG16,PQ8", "l2"),
    (32, "HNSW32,RFlat", "l2"), (32, "IVF16_HNSW,PQ8x4fs,RFlat", "l2"),
    (32, "IMI2x4,Flat", "l2"), (32, "IVF16(IVF4,Flat),SQ8", "l2"),
    # the additive quantizers and RaBitQ
    (32, "RQ4x4", "l2"), (32, "RQ4x8", "ip"), (32, "LSQ4x6", "l2"),
    (32, "RQ8x4fs", "l2"), (32, "LSQ4x4fs_64", "l2"), (32, "PRQ2x4x8", "l2"),
    (32, "PLSQ2x2x4", "l2"), (32, "RQ4x8_Nqint8", "l2"), (32, "LSQ4x4_Nlsq2x4", "l2"),
    (32, "PRQ2x2x6_Ncqint4", "l2"), (32, "RQ4x4_Nnone", "l2"),
    (32, "IVF16,RQ4x4", "l2"), (32, "IVF16,LSQ4x6_Nrq2x4", "l2"),
    (32, "IVF16,RQ8x4fs_64", "l2"), (32, "IVF16,LSQ4x4fs", "l2"),
    (32, "IVF16,PRQ2x4x4fs", "l2"), (32, "IVF16,PLSQ2x2x4fs_64", "l2"),
    (32, "IVF16,PRQ2x2x6", "ip"), (32, "IVF16,PLSQ2x2x4_Nqint4", "l2"),
    (32, "RaBitQ", "l2"), (32, "RaBitQ4", "l2"), (32, "RaBitQfs", "l2"),
    (32, "RaBitQfs2_64", "l2"), (32, "IVF16,RaBitQ", "l2"), (32, "IVF16,RaBitQ3", "l2"),
    (32, "IVF16,RaBitQfs", "l2"), (32, "IVF16,RaBitQfs4_64", "l2"),
    (32, "IVF16,RaBitQ,RFlat", "l2"), (32, "IDMap2,RR,RaBitQ", "l2"),
]


@pytest.mark.parametrize("d,desc,metric", SUPPORTED,
                         ids=[f"{d}-{s}-{m}" for d, s, m in SUPPORTED])
def test_factory_tree_matches_reference(d, desc, metric):
    mj = ftj.METRIC_L2 if metric == "l2" else ftj.METRIC_INNER_PRODUCT
    mt = ftt.METRIC_L2 if metric == "l2" else ftt.METRIC_INNER_PRODUCT
    ref = ftj.index_factory(d, desc, mj)
    port = ftt.index_factory(d, desc, mt, device="cpu")
    assert tree(port) == tree(ref)
    assert port.device.type == "cpu"
    if desc == "OPQ32,IVF8192,PQ32x4fs,RFlat":  # the slice's configuration
        assert isinstance(port.index, ftt.IndexRefineFlat) and port.index.store == "f32"
        assert isinstance(port.index.base_index, ftt.IndexIVFPQFastScan)


CODECS = [
    "EDEN4", "EDEN2BIASED", "IVF16,EDEN", "IVF16,EDEN3BIAS", "FlatPanorama8",
    "IVF16,FlatPanorama", "IVF16,FlatPanorama4", "ZnLattice2x4_6", "ZnLattice4x4_8",
]


@pytest.mark.parametrize("desc", CODECS)
def test_codec_tokens_build_the_reference_tree(desc):
    """The EDEN, Panorama and Zn-lattice tokens, flat and in IVF, build
    faiss_tpu's tree with its codecs' settings (sizes, levels, bits)."""
    port = ftt.index_factory(32, desc, device="cpu")
    assert tree(port) == tree(ftj.index_factory(32, desc))
    assert port.device.type == "cpu"


MALFORMED = ["Foo", "IVF16", "Flat,Flat", "IVF16,Bar", "", "IDMap", "OPQ4",
             "IVF16,Flat,Junk", "Refine(Flat)"]


@pytest.mark.parametrize("desc", MALFORMED)
def test_malformed_strings_raise_value_error(desc):
    with pytest.raises(ValueError):
        ftj.index_factory(32, desc)
    with pytest.raises(ValueError):
        ftt.index_factory(32, desc, device="cpu")


def test_factory_needs_a_card_unless_told_otherwise(monkeypatch):
    """The default device is the card: with none, index_factory raises
    rather than falling back to the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ftt.index_factory(32, "Flat")


def test_factory_index_trains_and_searches_on_cpu():
    """The port's OPQ4_16,IVF16,PQ4 trains, adds and searches end to end, as
    tests/test_components.py drives faiss_tpu's (nprobe set on the inner
    index: the wrapper forwards reads only)."""
    rs = np.random.RandomState(4)
    xb = rs.randn(3000, 32).astype(np.float32)
    index = ftt.index_factory(32, "OPQ4_16,IVF16,PQ4", device="cpu")
    index.chain[0].niter = 4
    index.index.cp.niter = 4
    index.train(xb)
    index.add(xb)
    index.nprobe = 16  # a write to the wrapper does not reach the base
    assert index.index.nprobe == 1
    index.index.nprobe = 16
    assert index.nprobe == 16  # reads are forwarded
    _, I = index.search(xb[:50], 5)
    assert (I[:, 0] == np.arange(50)).mean() > 0.5


@pytest.fixture
def modules(monkeypatch):
    """chip_smoke and benchs/bench_deep10m, importable without a card (the
    benchmark imports jax only inside main)."""
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.syspath_prepend(str(ROOT / "benchs"))
    import bench_deep10m
    import chip_smoke

    yield chip_smoke, bench_deep10m
    for name in ("chip_smoke", "bench_deep10m"):
        sys.modules.pop(name, None)


def test_chip_smoke_deep10m_data_equals_benchmark_generator(modules, monkeypatch,
                                                            tmp_path):
    """chip_smoke's Deep10M-like data (its copy of gen_deep, seeds 7, 1, 2,
    3) bit for bit against benchs/bench_deep10m.py's load_or_gen_data at a
    small n, its cache files redirected to a temporary directory."""
    cs, bd = modules
    nb, nt, nq = 2500, 700, 300
    for name, value in (("NB", nb), ("NT", nt), ("NQ", nq),
                        ("DATA_XB", str(tmp_path / "xb.npy")),
                        ("DATA_XT", str(tmp_path / "xt.npy")),
                        ("DATA_XQ", str(tmp_path / "xq.npy"))):
        monkeypatch.setattr(bd, name, value)
    ref = bd.load_or_gen_data(log=lambda m: None)
    got = cs.deep_data(nb, nt, nq)
    for a, b in zip(ref, got):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        assert np.array_equal(np.asarray(a), b)
    # and the generator alone, on other modes and another seed
    rs = np.random.RandomState(11)
    coarse = rs.randn(bd.NCOARSE, bd.D).astype(np.float32)
    subdirs = rs.randn(bd.NCOARSE, bd.NSUB, bd.D).astype(np.float32)
    scales = rs.rand(bd.D).astype(np.float32)
    assert np.array_equal(bd.gen_deep(1000, 5, coarse, subdirs, scales),
                          cs.gen_deep(1000, 5, coarse, subdirs, scales))
