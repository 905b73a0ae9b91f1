"""The port's token pipeline against the JAX package's
(``repro/data/pipeline.py``): the tokens and labels of every batch equal
JAX's bit for bit (both draw from numpy's ``default_rng((seed, step))``),
the state round-trips (a pipeline loaded at step k continues as the
uninterrupted one), and the ``Prefetcher`` yields the pipeline's batches
in order, on the device it was given, and ``close()`` joins its thread."""
import numpy as np
import pytest
import torch

from repro.data.pipeline import BigramPipeline as JaxPipeline
from repro_torch.data import BigramPipeline, Prefetcher


@pytest.mark.parametrize("vocab,batch,seq,seed", [(128, 4, 16, 7),
                                                   (50_280, 2, 33, 1),
                                                   (512, 3, 1, 0)])
def test_tokens_equal_jax_bit_for_bit(vocab, batch, seq, seed):
    jp = JaxPipeline(vocab, batch, seq, seed=seed)
    tp = BigramPipeline(vocab, batch, seq, seed=seed)
    np.testing.assert_array_equal(tp._succ, jp._succ)
    for _ in range(4):
        want, got = jp.next_batch(), tp.next_batch()
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(tp.peek_batch(9)["tokens"],
                                  jp.peek_batch(9)["tokens"])
    assert tp.state_dict() == jp.state_dict()


def test_state_round_trip_and_seed_check():
    p1 = BigramPipeline(128, 4, 16, seed=7)
    batches = [p1.next_batch() for _ in range(5)]
    p2 = BigramPipeline(128, 4, 16, seed=7)
    p2.load_state_dict(p1.state_dict() | {"step": 3})
    for b in batches[3:]:
        np.testing.assert_array_equal(p2.next_batch()["tokens"], b["tokens"])
    np.testing.assert_array_equal(batches[0]["labels"][:, :-1],
                                  batches[0]["tokens"][:, 1:])
    with pytest.raises(ValueError, match="seed"):
        BigramPipeline(128, 4, 16, seed=8).load_state_dict(p1.state_dict())


def test_prefetcher_order_device_and_close():
    pipe = BigramPipeline(64, 2, 8, seed=3)
    ref = BigramPipeline(64, 2, 8, seed=3)
    pf = Prefetcher(pipe, depth=2, device="cpu")
    try:
        for _ in range(5):
            got, want = pf.next(), ref.next_batch()
            assert got["tokens"].dtype == torch.int64
            assert got["tokens"].device.type == "cpu"
            np.testing.assert_array_equal(got["tokens"].numpy(),
                                          want["tokens"])
            np.testing.assert_array_equal(got["labels"].numpy(),
                                          want["labels"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()
    raw = Prefetcher(BigramPipeline(64, 2, 8, seed=3), depth=1)
    first = raw.next()
    raw.close()
    assert isinstance(first["tokens"], np.ndarray)
    assert not raw._thread.is_alive()
