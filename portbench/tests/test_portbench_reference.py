"""The plain reference's exact k-NN against a float64 NumPy search, and the
roundings of the store and of the control."""

import numpy as np
import pytest
import torch

from portbench.reference import knn


@pytest.mark.parametrize("k", [1, 10, 100])
def test_exact_knn_equals_float64_numpy(k):
    rng = np.random.default_rng(0)
    xb = rng.standard_normal((5000, 32)).astype(np.float32)
    xq = rng.standard_normal((300, 32)).astype(np.float32)
    D, I = knn.exact_knn(torch.from_numpy(xq), torch.from_numpy(xb), k,
                         qblock=128, bblock=1024)
    d64 = ((xq[:, None, :].astype(np.float64) - xb[None]) ** 2).sum(-1)
    gt = np.argsort(d64, axis=1, kind="stable")[:, :k]
    assert (I.numpy() == gt).mean() > 0.999  # float32 ties aside
    np.testing.assert_allclose(D.numpy(), np.take_along_axis(d64, gt, 1),
                               rtol=1e-4, atol=1e-4)


def test_dist64_and_store_rows():
    q = torch.tensor([[0.0, 0.0]])
    rows = knn.store_rows(torch.tensor([[[1.0001, 2.0]]]), "float16")
    assert rows.dtype == torch.float64
    assert rows[0, 0, 0].item() == float(np.float16(1.0001))
    assert knn.dist64(q, rows)[0, 0].item() == pytest.approx(
        float(np.float16(1.0001)) ** 2 + 4.0, rel=1e-12)


def test_lower_precisions():
    x = torch.tensor([1.0 + 2**-12, 3.14159265, -0.1])
    t = knn.lower(x, "float32")
    assert t[0].item() == 1.0  # 10 mantissa bits drop 2^-12
    assert abs(t[1].item() - 3.14159265) < 2**-9
    assert abs(t[1].item() - 3.14159265) > 0
    b = knn.lower(torch.tensor([1.0 + 2**-9, 3.14159265]), "float16")
    assert float(np.float16(1.0 + 2**-9)) == 1.0 + 2**-9  # float16 keeps it
    assert b[0].item() == 1.0  # bfloat16: 7 mantissa bits drop 2^-9
    assert b[1].item() == 3.140625
    with pytest.raises(ValueError):
        knn.lower(x, "int8")


def test_control_search_is_exact_over_rounded_operands():
    rng = np.random.default_rng(1)
    xb = torch.from_numpy(rng.random((2000, 16), dtype=np.float32))
    xq = torch.from_numpy(rng.random((50, 16), dtype=np.float32))
    D, I = knn.control_search(xq, xb, 5, "float16")
    Dr, Ir = knn.exact_knn(knn.lower(xq, "float16"), knn.lower(xb, "float16"), 5)
    assert torch.equal(I, Ir) and torch.equal(D, Dr)
