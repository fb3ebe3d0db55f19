"""Port parity for the contrib modules and the C API
(faiss_tpu_torch/contrib/ and faiss_tpu_torch/c_api against faiss_tpu's
contrib/ and c_api/).

The port's modules run on ``device="cpu"`` against faiss_tpu's on the same
index state (an index carried across through the npz container or
faiss_tpu_torch.convert): exact k-NN ids tie-aware, distances within
1e-5 * (|q|^2 + max |y|^2); k-means by its objective (the centroids may
differ in the last bits of a float32 sum), within 1e-4 for the Python driver
on the same seeds and 5% for the two-level recipe; the list-major big-batch
search against faiss_tpu's and the index's own exact search, and resumed
from its checkpoint; the on-disk merge of shard files written by either
package; the offline IVF pipeline over faiss_tpu's shard files; the socket
wire both ways (a port client on a faiss_tpu server and the reverse) and a
server error reaching the client; torch_utils in a process of its own (its
import patches every index class); the C API built with gcc and its example
run on the CPU."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import faiss_tpu as ftj
import faiss_tpu_torch as ftt
from faiss_tpu.contrib import big_batch_search as jbbs
from faiss_tpu.contrib import client_server as jcs
from faiss_tpu.contrib import clustering as jcl
from faiss_tpu.contrib import exhaustive_search as jes
from faiss_tpu.contrib import inspect_tools as jit
from faiss_tpu.contrib import ondisk as jod
from faiss_tpu_torch.callbacks import InterruptCallback, InterruptedException
from faiss_tpu_torch.contrib import big_batch_search as tbbs
from faiss_tpu_torch.contrib import client_server as tcs
from faiss_tpu_torch.contrib import clustering as tcl
from faiss_tpu_torch.contrib import exhaustive_search as tes
from faiss_tpu_torch.contrib import inspect_tools as tit
from faiss_tpu_torch.contrib import ondisk as tod
from faiss_tpu_torch.convert import ivfflat_from_arrays, ivfpq_from_arrays
from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
D, NB, NQ, K, NLIST = 16, 3000, 40, 10, 32


def mixture(rs, n, ncent=48, d=D):
    cent = np.random.RandomState(96).rand(ncent, d).astype(np.float32)
    scales = (1.0 / (np.arange(d) + 1.0)).astype(np.float32) * 0.4
    a = rs.randint(ncent, size=n)
    return (cent[a] + rs.randn(n, d).astype(np.float32) * scales).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(73)
    return mixture(rs, NB), mixture(rs, NQ)


@pytest.fixture(scope="module")
def ivfs(data):
    """Trained faiss_tpu IVF32,Flat and IVF32,PQ4 and the port's from their
    state."""
    xb, _ = data
    out = {}
    for name, ref in (("flat", ftj.IndexIVFFlat(None, D, NLIST)),
                      ("pq", ftj.IndexIVFPQ(None, D, NLIST, 4, 8))):
        ref.cp.niter = 4
        ref.cp.min_points_per_centroid = 1
        if name == "pq":
            ref.pq.cp.niter = 4
        ref.train(xb)
        ref.add(xb)
        ref.nprobe = 4
        if name == "flat":
            port = ivfflat_from_arrays(ref.quantizer.vectors(), ref._codes_host,
                                       ref._listnos_host, ref._ids_host, device="cpu")
        else:
            port = ivfpq_from_arrays(ref.quantizer.vectors(), ref.pq.centroids,
                                     ref._codes_host, ref._listnos_host,
                                     ref._ids_host, device="cpu")
        port.nprobe = 4
        out[name] = (ref, port)
    return out


def tol_of(xq, xb, scale=1e-5):
    return scale * ((xq.astype(np.float64) ** 2).sum(1)
                    + float((xb.astype(np.float64) ** 2).sum(1).max()))


def agree(Da, Ia, Db, Ib, tol, what):
    fin = np.isfinite(Da)
    np.testing.assert_array_equal(fin, np.isfinite(Db), err_msg=what)
    assert (np.abs(np.where(fin, Da.astype(np.float64) - Db, 0)) <= tol[:, None]).all(), what
    ok = ids_agree_tie_aware(np.where(fin, Da, 1e30), Ia, np.where(fin, Db, 1e30), Ib, tol)
    assert ok.all(), (what, np.where(~ok))


# ---------------------------------------------------------------------------
# exhaustive_search, inspect_tools
# ---------------------------------------------------------------------------

def test_exhaustive_search_matches_reference(data):
    xb, xq = data
    blocks = lambda: (xb[i : i + 700] for i in range(0, NB, 700))  # noqa: E731
    for metric in (ftt.METRIC_L2, ftt.METRIC_INNER_PRODUCT):
        Dj, Ij = jes.knn_ground_truth(xq, blocks(), K, metric=metric)
        Dt, It = tes.knn_ground_truth(xq, blocks(), K, metric=metric, device="cpu")
        sign = -1.0 if metric == ftt.METRIC_INNER_PRODUCT else 1.0
        agree(sign * Dj, Ij, sign * Dt, It, tol_of(xq, xb), f"knn_ground_truth {metric}")
    Dk, Ik = ftt.knn(xq, xb, K, device="cpu")
    Dt, It = tes.knn_ground_truth(xq, blocks(), K, device="cpu")
    agree(Dk, Ik, Dt, It, tol_of(xq, xb), "against extra.knn")
    jflat, tflat = ftj.IndexFlatL2(D), ftt.IndexFlatL2(D, device="cpu")
    jflat.add(xb)
    tflat.add(xb)
    radius = float(np.median(Dk[:, -1])) * 4
    rj = jes.range_search_max_results(jflat, xq, radius, max_results=NQ * 20)
    rt = tes.range_search_max_results(tflat, xq, radius, max_results=NQ * 20)
    assert rt[0] == rj[0] and rt[1][-1] <= NQ * 20
    np.testing.assert_array_equal(rt[1], rj[1])


def test_inspect_tools_match_reference(ivfs, capsys):
    ref, port = ivfs["pq"]
    for ln in (0, 7, NLIST - 1):
        for a, b in zip(jit.get_invlist(ref, ln), tit.get_invlist(port, ln)):
            np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(tit.get_invlist_sizes(port), jit.get_invlist_sizes(ref))
    np.testing.assert_array_equal(tit.get_flat_data(port.quantizer),
                                  jit.get_flat_data(ref.quantizer))
    np.testing.assert_array_equal(tit.get_pq_centroids(port.pq), jit.get_pq_centroids(ref.pq))
    pca = ftt.PCAMatrix(D, 8, device="cpu")
    pca.train(data_rows(500))
    A, b = tit.get_LinearTransform_matrix(pca)
    assert A.shape == (8, D) and b.shape == (8,)
    tit.print_object_fields(port.pq)
    assert "centroids: array" in capsys.readouterr().out


def data_rows(n):
    return mixture(np.random.RandomState(n), n)


# ---------------------------------------------------------------------------
# clustering
# ---------------------------------------------------------------------------

def objective(x, cent):
    return float(((x[:, None].astype(np.float64) - cent[None]) ** 2).sum(-1).min(1).sum())


def test_clustering_matches_reference(data):
    xb, _ = data
    cent = xb[:20]
    Ij, Dj, Sj, Cj = jcl.DatasetAssign(xb).assign_to(cent)
    It, Dt, St, Ct = tcl.DatasetAssign(xb, device="cpu").assign_to(cent)
    tol = tol_of(xb, cent)
    assert (It == Ij).mean() > 0.999
    np.testing.assert_allclose(Dt, Dj, atol=float(tol.max()))
    same = (It == Ij).all()
    if same:
        np.testing.assert_array_equal(Ct, Cj)
        np.testing.assert_allclose(St, Sj, rtol=1e-5, atol=1e-4)
    w = np.random.RandomState(1).rand(NB).astype(np.float32)
    _, _, Sw, Cw = tcl.DatasetAssign(xb, device="cpu").assign_to(cent, weights=w)
    np.testing.assert_allclose(Cw, np.bincount(It, weights=w, minlength=20), rtol=1e-5)
    cj = jcl.kmeans(32, jcl.DatasetAssign(xb), niter=6, seed=5)
    ct = tcl.kmeans(32, tcl.DatasetAssign(xb, device="cpu"), niter=6, seed=5)
    oj, ot = objective(xb, cj), objective(xb, ct)
    assert abs(ot - oj) <= 1e-4 * oj, (ot, oj)
    tj = jcl.two_level_clustering(xb, 4, 24, niter=8)
    tt = tcl.two_level_clustering(xb, 4, 24, niter=8, device="cpu")
    assert tt.shape == tj.shape == (24, D)
    oj, ot = objective(xb, tj), objective(xb, tt)
    assert ot <= 1.05 * oj, (ot, oj)


# ---------------------------------------------------------------------------
# big_batch_search
# ---------------------------------------------------------------------------

class StopAfter(InterruptCallback):
    def __init__(self, n):
        self.n = n

    def want_interrupt(self):
        self.n -= 1
        return self.n < 0


@pytest.mark.parametrize("kind", ["flat", "pq"])
def test_big_batch_search_matches_reference(ivfs, data, kind, tmp_path):
    xb, xq = data
    ref, port = ivfs[kind]
    Dj, Ij = jbbs.big_batch_search(ref, xq, K)
    Dt, It = tbbs.big_batch_search(port, xq, K)
    assert Dt.dtype == np.float32 and It.dtype == np.int64
    scale = 1e-5 if kind == "flat" else 1e-4
    agree(Dj, Ij, Dt, It, tol_of(xq, xb, scale), f"big_batch_search {kind}")
    # the index's own search (by probe, exact within the probed lists)
    Ds, Is = port.search(xq, K)
    agree(Ds, Is, Dt, It, tol_of(xq, xb, scale), f"{kind} against its own search")
    # interrupted after 11 lists, then resumed from the checkpoint
    ckpt = str(tmp_path / "bbs.npz")
    InterruptCallback.instance = StopAfter(11)
    try:
        with pytest.raises(InterruptedException):
            tbbs.big_batch_search(port, xq, K, checkpoint_path=ckpt, checkpoint_every=4)
    finally:
        InterruptCallback.instance = None
    with np.load(ckpt) as z:
        assert int(z["next_list"]) == 8
    Dr, Ir = tbbs.big_batch_search(port, xq, K, checkpoint_path=ckpt, checkpoint_every=4)
    np.testing.assert_array_equal(Dr, Dt)
    np.testing.assert_array_equal(Ir, It)


# ---------------------------------------------------------------------------
# ondisk
# ---------------------------------------------------------------------------

def test_merge_ondisk_matches_reference(data, tmp_path):
    xb, xq = data
    ref = ftj.IndexIVFFlat(None, D, NLIST)
    ref.cp.niter = 4
    ref.train(xb)
    trained = tmp_path / "trained.npz"
    ftj.write_index(ref, str(trained))
    shards = []
    for s, (pkg, kw) in enumerate(((ftj, {}), (ftt, {"device": "cpu"}))):
        shard = pkg.read_index(str(trained), **kw)
        lo, hi = s * NB // 2, (s + 1) * NB // 2
        shard.add_with_ids(xb[lo:hi], np.arange(lo, hi, dtype=np.int64))
        shards.append(str(tmp_path / f"shard{s}.npz"))
        pkg.write_index(shard, shards[-1])
    merged = {}
    for pkg, od, kw in ((ftj, jod, {}), (ftt, tod, {"device": "cpu"})):
        for ivfdata in (None, str(tmp_path / f"{pkg.__name__}.ivfdata")):
            index = pkg.read_index(str(trained), **kw)
            od.merge_ondisk(index, shards, ivfdata, chunk_rows=700)
            index.nprobe = 8
            merged[pkg.__name__, ivfdata is None] = index
    t = merged["faiss_tpu_torch", False]  # memory maps; no stale layout
    assert isinstance(t._codes_host, np.memmap) and t._device is None
    for in_ram in (True, False):
        j, t = merged["faiss_tpu", in_ram], merged["faiss_tpu_torch", in_ram]
        assert t.ntotal == j.ntotal == NB
        for name in ("_listnos_host", "_ids_host", "_codes_host"):
            np.testing.assert_array_equal(np.asarray(getattr(t, name)),
                                          np.asarray(getattr(j, name)))
        Dt, It = t.search(xq, K)
        agree(*j.search(xq, K), Dt, It, tol_of(xq, xb), f"merged in_ram={in_ram}")


# ---------------------------------------------------------------------------
# offline_ivf
# ---------------------------------------------------------------------------

def test_offline_ivf_over_reference_shards(data, tmp_path, capsys):
    """faiss_tpu trains the index and encodes the shards; the port merges,
    searches, evaluates and checks them, and faiss_tpu reads the port's
    merged index to the same search."""
    from faiss_tpu.contrib.offline_ivf import OfflineIVF as JOff
    from faiss_tpu_torch.contrib.offline_ivf import OfflineIVF as TOff
    from faiss_tpu_torch.contrib.offline_ivf import main

    xb, xq = data
    root = tmp_path / "data"
    root.mkdir()
    files = []
    for s in range(3):
        np.save(root / f"xb_{s}.npy", xb[s * NB // 3 : (s + 1) * NB // 3])
        files.append(f"xb_{s}.npy")
    np.save(root / "xq.npy", xq)
    cfg = {"d": D, "output": str(tmp_path / "out"), "index": f"IVF{NLIST},Flat",
           "nprobe": 8, "k": K, "training_sample": 2000,
           "datasets": {"db": {"root": str(root), "files": files},
                        "queries": {"root": str(root), "files": ["xq.npy"]}}}
    joff = JOff(cfg)
    joff.train_index()
    assert len(joff.index_shard()) == 3
    toff = TOff(cfg, device="cpu")
    toff.merge_index()
    toff.consistency_check()
    stats = toff.index_stats()
    assert stats["ntotal"] == NB and stats["nlist"] == NLIST
    Dt, It = toff.search()
    assert toff.evaluate(sample=NQ) > 0.9
    merged = ftt.read_index(toff.merged_index_path(), device="cpu")
    merged.nprobe = 8
    agree(*merged.search(xq, K), Dt, It, tol_of(xq, xb), "offline search vs the index's")
    jmerged = ftj.read_index(toff.merged_index_path())
    jmerged.nprobe = 8
    agree(*jmerged.search(xq, K), Dt, It, tol_of(xq, xb), "faiss_tpu reads the merge")
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(dict(cfg, device="cpu")))
    main([str(cfg_path), "index_stats"])
    assert json.loads(capsys.readouterr().out)["ntotal"] == NB


# ---------------------------------------------------------------------------
# client_server
# ---------------------------------------------------------------------------

class Broken:
    ntotal = 5

    def search(self, x, k):
        raise ValueError("boom")


def test_client_server_wire_both_ways(ivfs, data):
    xb, xq = data
    ref, port = ivfs["flat"]
    Dd, Id = port.search(xq, K)
    tserv = tcs.SearchServer(port).start()
    jserv = jcs.SearchServer(ref).start()
    try:
        for client_mod in (tcs, jcs):  # either package's client, the port's server
            client = client_mod.ClientIndex([("127.0.0.1", tserv.port)])
            assert client.ntotal == NB
            Dc, Ic = client.search(xq, K)
            client.close()
            np.testing.assert_array_equal(Dc, Dd)
            np.testing.assert_array_equal(Ic, Id)
        # the port's client over a faiss_tpu server and the port's server
        client = tcs.ClientIndex([("127.0.0.1", jserv.port), ("127.0.0.1", tserv.port)])
        assert client.ntotal == 2 * NB
        Dc, Ic = client.search(xq, K)
        client.close()
        Dj, Ij = ref.search(xq, K // 2)  # each id comes back from both
        agree(Dj, Ij, Dc[:, ::2], Ic[:, ::2], tol_of(xq, xb), "two servers")
    finally:
        tserv.stop()
        jserv.stop()
    bad = tcs.SearchServer(Broken()).start()
    try:
        client = tcs.ClientIndex([("127.0.0.1", bad.port)])
        with pytest.raises(RuntimeError, match="ValueError: boom"):
            client.search(xq, K)
        client.close()
    finally:
        bad.stop()


# ---------------------------------------------------------------------------
# torch_utils, in a process of its own
# ---------------------------------------------------------------------------

TORCH_UTILS = r"""
import ast, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
import faiss_tpu_torch as ftt
from faiss_tpu_torch.contrib import torch_utils as tu

src = open(sys.argv[1] + "/faiss_tpu/contrib/torch_utils.py").read()
ref_methods = next(ast.literal_eval(n.value) for n in ast.parse(src).body
                   if isinstance(n, ast.Assign) and n.targets[0].id == "_PATCHED_METHODS")
assert tu._PATCHED_METHODS == ref_methods
rs = np.random.RandomState(0)
xb, xq = rs.rand(500, 16).astype(np.float32), rs.rand(20, 16).astype(np.float32)
index = ftt.IndexFlatL2(16, device="cpu")
index.add(torch.from_numpy(xb))
D, I = index.search(torch.from_numpy(xq), 5)
assert tu.is_torch(D) and D.device.type == "cpu" and I.dtype == torch.int64
Dn, In = index.search(xq, 5)
assert isinstance(Dn, np.ndarray)
assert np.array_equal(D.numpy(), Dn) and np.array_equal(I.numpy(), In)
assert ftt.IndexIVFFlat.search._torch_wrapped and ftt.IndexRefineFlat.add._torch_wrapped
Ds, Is = tu.search_with_torch(index, torch.from_numpy(xq), 5)
assert np.array_equal(Ds.numpy(), Dn)
tu.add_with_torch(index, torch.from_numpy(xb[:10]))
assert index.ntotal == 510
Dk, Ik = tu.torch_knn(torch.from_numpy(xq), torch.from_numpy(xb), 5)
assert np.array_equal(Ik.numpy(), In)
P = tu.torch_pairwise_distances(torch.from_numpy(xq), torch.from_numpy(xb))
assert P.shape == (20, 500)
cent, assign = tu.torch_kmeans(torch.from_numpy(xb), 8, niter=4)
assert cent.shape == (8, 16) and assign.shape == (500,)
assert not hasattr(tu, "torch_to_jax") and not hasattr(tu, "jax_to_torch")
assert tu.numpy_to_torch(xq, torch.zeros(1)).device.type == "cpu"
print("TORCH_UTILS OK")
"""


def test_torch_utils_in_its_own_process():
    res = subprocess.run([sys.executable, "-c", TORCH_UTILS, str(ROOT)],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0 and "TORCH_UTILS OK" in res.stdout, res.stderr


# ---------------------------------------------------------------------------
# the C API
# ---------------------------------------------------------------------------

@pytest.mark.skipif(shutil.which("gcc") is None, reason="no C compiler")
def test_c_api_example_on_the_cpu():
    from faiss_tpu_torch import c_api

    paths = c_api.build()
    assert Path(paths["lib"]).exists()
    assert "faiss_tpu_torch/_build/c_api/" in paths["dir"].replace(os.sep, "/")
    out = c_api.run_example("cpu")
    assert "device cpu" in out and "reloaded ntotal=4000" in out
    src = (ROOT / "faiss_tpu_torch" / "c_api" / "faiss_tpu_torch_c.c").read_text()
    assert 'PyImport_ImportModule("faiss_tpu")' not in src
    if not torch.cuda.is_available():  # the card as the device, with none
        with pytest.raises(RuntimeError, match="no CUDA card"):
            c_api.run_example("cuda")
