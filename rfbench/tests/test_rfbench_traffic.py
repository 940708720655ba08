"""The traffic generators: deterministic per seed, the same work for every seed."""

import numpy as np
import pytest
import torch

from conftest import TRAIN, tiny
from rfbench.kinds import serve_open_loop, train_epochs


def test_schedule_repeats_per_seed_and_keeps_one_set_of_work():
    traffic = {"rate_per_s": 130, "sizes": {"log_uniform": [1, 64]}}
    due, sizes = serve_open_loop.schedule(traffic, 10, 2**33 + 5)
    again = serve_open_loop.schedule(traffic, 10, 2**33 + 5)
    assert np.array_equal(due, again[0]) and np.array_equal(sizes, again[1])
    other_due, other_sizes = serve_open_loop.schedule(traffic, 10, 17)
    assert not np.array_equal(sizes, other_sizes)
    assert np.array_equal(np.sort(sizes), np.sort(other_sizes))
    assert np.allclose(np.sort(np.diff(due, prepend=0)), np.sort(np.diff(other_due, prepend=0)))
    assert len(due) == 1300 and np.all(np.diff(due) > 0)
    assert due[-1] == pytest.approx(10, rel=0.05)  # the mean gap is 1 / rate
    assert sizes.min() == 1 and sizes.max() == 64
    # log-uniform: about as many requests of 1 as of 2-3, of 4-7, ...
    counts = [np.sum((sizes >= 2**i) & (sizes < 2**(i + 1))) for i in range(6)]
    assert max(counts) - min(counts) <= 0.05 * len(sizes)


def test_train_rows_and_corpus_repeat_per_seed():
    cell = tiny(TRAIN[0])
    one = train_epochs.Run(cell, 2**32 + 1, torch.device("cpu"))
    two = train_epochs.Run(cell, 2**32 + 1, torch.device("cpu"))
    assert np.array_equal(one.first_rows, two.first_rows)
    assert len(set(one.first_rows.tolist())) == len(one.first_rows)
    x = train_epochs.corpus(cell.config, cell.traffic, 9, torch.device("cpu"))
    assert torch.equal(x, train_epochs.corpus(cell.config, cell.traffic, 9, torch.device("cpu")))
    assert x.abs().max() <= 1.0
