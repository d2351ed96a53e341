"""The port's data modules against the JAX package's: the synthetic
datasets and the staircase partition are numpy copies and must be
bit-identical for the same seed; client selection likewise."""
import numpy as np
import pytest
import torch

from repro.data import make_dataset as j_make_dataset
from repro.data import staircase_partition as j_partition
from repro.fl.selection import select_clients as j_select
from repro_torch.data import (make_dataset, sample_batch_indices,
                              staircase_partition)
from repro_torch.fl.selection import select_clients


@pytest.mark.parametrize("name", ["mnist", "fmnist", "cifar", "cinic"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_datasets_bit_identical(name, split):
    got = make_dataset(name, 6, seed=7, split=split)
    want = j_make_dataset(name, 6, seed=7, split=split)
    assert got.x.dtype == want.x.dtype and got.y.dtype == want.y.dtype
    np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_array_equal(got.y, want.y)


@pytest.mark.parametrize("n_clients,r_max,pad", [(10, 64, True), (4, 8, True),
                                                 (7, 16, False)])
def test_staircase_partition_bit_identical(n_clients, r_max, pad):
    ds = make_dataset("mnist", 20, seed=3)
    got = staircase_partition(ds, n_clients, r_max, seed=3, pad_to_max=pad)
    want = j_partition(j_make_dataset("mnist", 20, seed=3), n_clients, r_max,
                       seed=3, pad_to_max=pad)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.x, w.x)
        np.testing.assert_array_equal(g.y, w.y)
        assert (g.n, g.labels, g.rank) == (w.n, w.labels, w.rank)


@pytest.mark.parametrize("fraction", [1.0, 0.2, 0.5])
def test_select_clients_identical(fraction):
    for rnd in range(4):
        assert (select_clients(10, rnd, fraction, seed=5)
                == j_select(10, rnd, fraction, seed=5))


def test_sample_batch_indices_range_and_determinism():
    def draw():
        gen = torch.Generator().manual_seed(11)
        return sample_batch_indices(gen, 37, 8, 5)
    a, b = draw(), draw()
    assert a.shape == (5, 8) and a.dtype == torch.int64
    assert torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < 37
    zero = sample_batch_indices(torch.Generator().manual_seed(0), 0, 4, 2)
    assert torch.equal(zero, torch.zeros(2, 4, dtype=torch.int64))
