"""The port's training data pipeline (``repro_torch.data.events``) against
the reference's: the same numpy generators and seeds draw the same batch
indices, so both packages train on identical batches."""

import itertools

import jax
import numpy as np
import pytest

from repro.data.events import EventDatasetConfig as RefData
from repro.data.events import event_batch_at as ref_batch_at
from repro.data.events import event_batches as ref_batches
from repro.data.events import synthetic_event_dataset as ref_dataset

from repro_torch.data.events import EventDatasetConfig, event_batch_at, \
    event_batches, synthetic_event_dataset


@pytest.fixture(scope="module")
def dataset():
    cfg = RefData("data-test", 8, 8, num_steps=6)
    return ref_dataset(cfg, n_per_class=3, key=jax.random.key(0))


@pytest.mark.parametrize("batch,seed", [(8, 0), (5, 3), (32, 11)])
def test_event_batches_draw_the_reference_batches(dataset, batch, seed):
    spikes, labels = dataset
    ref = ref_batches(spikes, labels, batch, seed=seed)
    port = event_batches(spikes, labels, batch, seed=seed)
    for (rs, rl), (ps, pl) in itertools.islice(zip(ref, port), 4):
        assert isinstance(ps, np.ndarray) and isinstance(pl, np.ndarray)
        np.testing.assert_array_equal(ps, np.asarray(rs))
        np.testing.assert_array_equal(pl, np.asarray(rl))


@pytest.mark.parametrize("step", [0, 1, 7, 1000])
@pytest.mark.parametrize("seed", [0, 5])
def test_event_batch_at_is_the_reference_batch(dataset, step, seed):
    spikes, labels = dataset
    rs, rl = ref_batch_at(spikes, labels, 16, step, seed=seed)
    ps, pl = event_batch_at(spikes, labels, 16, step, seed=seed)
    np.testing.assert_array_equal(ps, rs)
    np.testing.assert_array_equal(pl, rl)
    # step-keyed: the same (seed, step) gives the same batch again
    again, _ = event_batch_at(spikes, labels, 16, step, seed=seed)
    np.testing.assert_array_equal(again, ps)


def test_event_batches_time_major():
    """Twin of tests/test_data.py::test_event_batches_time_major."""
    cfg = EventDatasetConfig.nmnist_like()
    spikes, labels = synthetic_event_dataset(cfg, 2,
                                             np.random.default_rng(1))
    sb, lb = next(event_batches(spikes, labels, batch=8))
    assert sb.shape == (cfg.num_steps, 8, cfg.n_in)
    assert lb.shape == (8,)
    sa, la = event_batch_at(spikes, labels, 8, 3)
    assert sa.shape == (cfg.num_steps, 8, cfg.n_in) and la.shape == (8,)
