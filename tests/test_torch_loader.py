"""The port's Loader (coclr_tpu_torch/data/loader.py) with a ragged final
batch: thread and process workers give the same batches and `valid` rows,
one process or sharded over ranks.

The JAX package's process mode is not driven down this path: its
`_iter_process` counts nb * batch rows (nb rounded up) and indexes past the
end of the epoch order with drop_last=False and a length the batch does not
divide (coclr_tpu/data/loader.py:310,352; an IndexError at 5 samples,
batch 2). The port pads and shards that batch instead.
"""

import numpy as np
import pytest

from coclr_tpu_torch.data.loader import Loader


class _Clips:
    """n samples {'seq': [2, 3, 3] uint8 filled with the index, 'label'}."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"seq": np.full((2, 3, 3), i, np.uint8),
                "label": np.int64(100 + i)}


def _epoch(mode, shard, shuffle, n=5, batch=2):
    loader = Loader(_Clips(n), batch, shuffle=shuffle, num_workers=2,
                    drop_last=False, seed=3, worker_mode=mode,
                    process_shard=shard)
    try:
        loader.set_epoch(1)
        return list(loader)
    finally:
        loader.close()


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("shard", [None, (0, 2), (1, 2)])
def test_ragged_final_batch_same_in_thread_and_process_mode(shard, shuffle):
    """5 samples at a global batch of 2, drop_last=False: both worker modes
    yield the same batches, bit for bit, and the same `valid` rows. One
    process: batches of 2, 2 and 1 that cover the 5 samples once, no
    `valid`. Two ranks: 3 batches of one row each; rank 1's last row
    repeats the last sample and is the one row marked not valid, so that
    the valid rows of both ranks cover the 5 samples once."""
    thread = _epoch("thread", shard, shuffle)
    process = _epoch("process", shard, shuffle)
    assert len(thread) == len(process) == 3
    for a, b in zip(thread, process):
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    for batch in thread:
        np.testing.assert_array_equal(batch["label"] - 100,
                                      batch["seq"][:, 0, 0, 0])
    ids = np.concatenate([b["seq"][:, 0, 0, 0] for b in thread])
    if shard is None:
        assert [len(b["label"]) for b in thread] == [2, 2, 1]
        assert all("valid" not in b for b in thread)
        assert sorted(ids) == list(range(5))
        return
    assert [len(b["label"]) for b in thread] == [1, 1, 1]
    valid = np.concatenate([b["valid"] for b in thread])
    assert valid.dtype == np.float32
    np.testing.assert_array_equal(valid, [1, 1, 1 - shard[0]])
    other = _epoch("thread", (1 - shard[0], 2), shuffle)
    both = np.concatenate([ids[valid > 0]] + [
        b["seq"][:, 0, 0, 0][b["valid"] > 0] for b in other])
    assert sorted(both) == list(range(5))
