"""The port's synthetic data pipeline against the reference package.

Twins of the five data tests of ``tests/test_data_and_batcher.py`` on the
port's copy (``repro_torch.data``), and the port's batches bit for bit
equal to the reference's for the same config and step (both draw the same
Philox streams), tokens, labels and the frontend stub's embeddings.
"""
import numpy as np
import pytest

from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticLM as JaxSyntheticLM
from repro_torch.data import DataConfig, Prefetcher, SyntheticLM


def test_data_deterministic():
    cfg = DataConfig(vocab_size=128, seq_len=32, global_batch=4, seed=1)
    a = SyntheticLM(cfg).batch(5)
    b = SyntheticLM(cfg).batch(5)
    assert np.array_equal(a["tokens"], b["tokens"])
    c = SyntheticLM(cfg).batch(6)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_data_labels_are_next_token():
    cfg = DataConfig(vocab_size=128, seq_len=16, global_batch=2)
    b = SyntheticLM(cfg).batch(0)
    assert np.array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])


def test_data_host_sharding_partitions():
    cfg = DataConfig(vocab_size=64, seq_len=8, global_batch=8)
    assert SyntheticLM(cfg).local_batch == 8
    sh0 = SyntheticLM(DataConfig(vocab_size=64, seq_len=8, global_batch=8,
                                 n_hosts=4, host_ix=0))
    assert sh0.local_batch == 2
    with pytest.raises(ValueError):
        SyntheticLM(DataConfig(vocab_size=64, seq_len=8, global_batch=6,
                               n_hosts=4))


def test_data_embed_stub():
    cfg = DataConfig(vocab_size=64, seq_len=8, global_batch=2, embed_dim=16)
    b = SyntheticLM(cfg).batch(0)
    assert b["embeds"].shape == (2, 8, 16)
    assert b["labels"].shape == (2, 8)


def test_prefetcher_preserves_order():
    it = Prefetcher(iter(range(20)), prefetch=4)
    assert list(it) == list(range(20))


@pytest.mark.parametrize("kw", [
    dict(vocab_size=262_144, seq_len=64, global_batch=3, seed=0),
    dict(vocab_size=1000, seq_len=17, global_batch=8, seed=5, n_hosts=4,
         host_ix=3),
    dict(vocab_size=2048, seq_len=12, global_batch=2, seed=2, embed_dim=24),
])
def test_batches_bit_equal_to_reference(kw):
    mine, ref = SyntheticLM(DataConfig(**kw)), JaxSyntheticLM(
        JaxDataConfig(**kw))
    for step in (0, 1, 7, 1000):
        a, b = mine.batch(step), ref.batch(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    # the iterator walks the same steps
    it_a, it_b = iter(mine), iter(ref)
    for _ in range(3):
        np.testing.assert_array_equal(next(it_a)["labels"],
                                      next(it_b)["labels"])
