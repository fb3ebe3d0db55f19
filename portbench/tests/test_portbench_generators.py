"""The generators reproduce themselves from a seed, and only from it."""

import numpy as np
import pytest
import torch

from portbench import spec
from portbench.run import RECALL_ROWS, Queries, draw_rows, recall_sample

PARAMS = {
    "sift_mixture": {"mixture_seed": 42, "ncent": 64, "noise": 0.4},
    "deep_two_level": {"mixture_seed": 7, "ncoarse": 16, "nsub": 8, "subdir_std": 0.3,
                       "sub_scale": 0.25, "noise": 0.05},
}


def rows(name, seed, n=3000, d=24, chunk=1000):
    def gen(*parts):
        g = torch.Generator()
        g.manual_seed(spec.stream_seed(seed, *parts))
        return g
    sampler = spec.generator(name).make(PARAMS[name], d, torch.device("cpu"))
    out = torch.empty(n, d)
    draw_rows(sampler, n, gen("base"), out=out, chunk=chunk)
    return sampler, out


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_same_seed_same_rows(name):
    _, a = rows(name, 2**31 + 11)
    _, b = rows(name, 2**31 + 11)
    _, c = rows(name, 2**31 + 12)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert a.dtype == torch.float32 and a.shape == (3000, 24)


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_rows_on_the_device_equal_rows_on_the_host(name):
    """The reference draws the base again on the device: the same rows."""
    sampler, host = rows(name, 7)
    g = torch.Generator()
    g.manual_seed(spec.stream_seed(7, "base"))
    again = draw_rows(sampler, 3000, g, chunk=1000)
    assert torch.equal(host, again)


def test_modes_are_the_original_generators():
    """bench.py:228-244 and benchs/bench_deep10m.py:67-71 draw the modes
    from numpy's RandomState of a fixed seed: the same modes here."""
    sift = spec.generator("sift_mixture").make(PARAMS["sift_mixture"], 24, "cpu")
    want = np.random.RandomState(42).rand(64, 24).astype(np.float32)
    assert np.array_equal(sift.cent.numpy(), want)
    deep = spec.generator("deep_two_level").make(PARAMS["deep_two_level"], 24, "cpu")
    rs = np.random.RandomState(7)
    coarse = rs.randn(16, 24).astype(np.float32)
    coarse /= np.linalg.norm(coarse, axis=1, keepdims=True)
    subdirs = rs.randn(16, 8, 24).astype(np.float32) * 0.3
    assert np.array_equal(deep.coarse.numpy(), coarse)
    assert np.array_equal(deep.subdirs.numpy(), subdirs)


def test_deep_rows_are_unit_norm():
    _, x = rows("deep_two_level", 3)
    assert torch.allclose(x.norm(dim=1), torch.ones(len(x)), atol=1e-5)


def test_query_batches_are_drawn_again_bit_for_bit():
    sampler, _ = rows("sift_mixture", 5)
    q = Queries(sampler, 128, 5, "query", torch.device("cpu"), ring=4)
    first = [q(j).copy() for j in range(3)]
    assert all(torch.equal(torch.from_numpy(first[j]), q.on_device(j)) for j in range(3))
    assert not (first[0] == first[1]).all()
    other = Queries(sampler, 128, 5, "warmup", torch.device("cpu"), ring=4)
    assert not (other(0) == first[0]).all()


def test_stream_seed_takes_seeds_past_32_bits():
    s = spec.stream_seed(2**33 + 5, "base")
    assert 0 <= s < 2**63
    assert s != spec.stream_seed(2**33 + 6, "base")


def test_recall_sample_is_drawn_anew_for_every_batch():
    seed = 2**31 + 77
    a, b = recall_sample(seed, 0, 8192), recall_sample(seed, 1, 8192)
    assert len(a) == RECALL_ROWS == len(np.unique(a)) and (np.diff(a) > 0).all()
    assert not np.array_equal(a, b)
    assert np.array_equal(a, recall_sample(seed, 0, 8192))
    # over a run's batches the sample reaches every part of a batch
    seen = np.concatenate([recall_sample(seed, j, 8192) for j in range(64)])
    assert len(np.unique(seen // 512)) == 16
