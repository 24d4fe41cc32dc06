"""Text pipeline for the LM (tpu_ddp/data/text.py): byte tokenizer,
document packing and rank-sharded epoch batches, on numpy.

- :class:`ByteTokenizer`: PAD=0, BOS=1, EOS=2, byte b -> b + 3 (259 ids);
  no download, any language.
- :func:`pack_documents`: one stream ``[BOS] doc EOS [BOS] doc EOS ...``
  cut into (N, seq_len + 1) int32 rows (the +1 feeds ``make_lm_batch``'s
  shift); the tail remainder is dropped. The JAX package's numpy path,
  row for row; its C++ packer (``native/``) is not ported.
- :func:`epoch_batches`: this rank's (inputs, targets) batches over the
  rows, through the vision loaders' :class:`DistributedShardSampler`
  (wrap padding, stride sharding, a per-epoch shuffle seeded alike on
  every rank).
"""

from __future__ import annotations

import numpy as np

from tpu_ddp_torch.data.sampler import DistributedShardSampler

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
_BYTE_OFFSET = 3
VOCAB_SIZE = 256 + _BYTE_OFFSET


class ByteTokenizer:
    """Byte-level tokenizer: PAD=0, BOS=1, EOS=2, byte b -> b + 3."""

    vocab_size = VOCAB_SIZE
    pad_id, bos_id, eos_id = PAD_ID, BOS_ID, EOS_ID

    def encode(self, text) -> np.ndarray:
        data = text.encode("utf-8") if isinstance(text, str) else bytes(text)
        return np.frombuffer(data, np.uint8).astype(np.int32) + _BYTE_OFFSET

    def decode(self, ids) -> str:
        ids = np.asarray(ids)
        ids = ids[ids >= _BYTE_OFFSET] - _BYTE_OFFSET
        return ids.astype(np.uint8).tobytes().decode("utf-8",
                                                     errors="replace")


def pack_documents(docs, seq_len: int, add_bos: bool = True,
                   use_native: bool | None = None) -> np.ndarray:
    """Pack ``docs`` (a list of str or bytes) into (N, seq_len + 1) int32
    rows. Raises on empty input or a stream shorter than one row.
    ``use_native=True`` (the JAX package's C++ packer) raises: only the
    numpy path is ported, and it gives the same rows."""
    if use_native:
        raise NotImplementedError(
            "use_native=True: the native text packer (native/) is not "
            "ported to tpu_ddp_torch; the numpy path gives the same rows")
    if not docs:
        raise ValueError("pack_documents: no documents")
    row_len = seq_len + 1
    pieces = []
    for d in docs:
        data = d.encode("utf-8") if isinstance(d, str) else bytes(d)
        if add_bos:
            pieces.append(np.array([BOS_ID], np.int32))
        pieces.append(np.frombuffer(data, np.uint8).astype(np.int32)
                      + _BYTE_OFFSET)
        pieces.append(np.array([EOS_ID], np.int32))
    stream = np.concatenate(pieces)
    n_rows = len(stream) // row_len
    if n_rows == 0:
        raise ValueError(f"documents too short: {len(stream)} tokens < "
                         f"one row of {row_len}")
    return stream[:n_rows * row_len].reshape(n_rows, row_len)


def epoch_batches(rows: np.ndarray, batch_size: int, *, rank: int = 0,
                  world_size: int = 1, shuffle: bool = True,
                  seed: int = 0, epoch: int = 0, drop_last: bool = True):
    """Yield this rank's (inputs, targets) batches for one epoch: rows
    permuted per epoch with a seed every rank shares (``shuffle``),
    wrap-padded and stride-sharded by rank; ``drop_last`` drops a ragged
    final batch."""
    from tpu_ddp_torch.train.lm import make_lm_batch
    sampler = DistributedShardSampler(len(rows), world_size, rank,
                                      shuffle=shuffle, seed=seed,
                                      drop_last=False)
    sampler.set_epoch(epoch)
    mine = sampler.indices()
    for i in range(0, len(mine), batch_size):
        take = mine[i:i + batch_size]
        if drop_last and len(take) < batch_size:
            break
        yield make_lm_batch(rows[take])
