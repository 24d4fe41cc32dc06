"""The port's text pipeline (tpu_ddp_torch/data/text.py) held against the
JAX package's numpy path bit for bit: the tokenizer, the packed rows and
every rank's epoch batches; and the byte-text example
(tpu_ddp_torch/examples/lm_text_train.py) end to end on the CPU."""

import re

import numpy as np
import pytest

from tpu_ddp.data import text as jtext
from tpu_ddp_torch.data import text

DOCS = ["the quick brown fox. ", "héllo wörld — ünïcode ",
        b"\x00\xffraw", "pack my box with five dozen liquor jugs. "] * 7


def test_tokenizer_matches_jax():
    j, t = jtext.ByteTokenizer(), text.ByteTokenizer()
    assert (t.vocab_size, t.pad_id, t.bos_id, t.eos_id) == (
        j.vocab_size, j.pad_id, j.bos_id, j.eos_id) == (259, 0, 1, 2)
    for d in DOCS[:4]:
        ids = t.encode(d)
        np.testing.assert_array_equal(ids, j.encode(d))
        assert ids.dtype == np.int32
        assert t.decode(ids) == j.decode(ids)
    assert t.decode([1, 2, 0] + list(t.encode("ok"))) == "ok"


@pytest.mark.parametrize("seq_len", [8, 31, 64])
@pytest.mark.parametrize("add_bos", [True, False])
def test_packed_rows_match_jax(seq_len, add_bos):
    want = jtext.pack_documents(DOCS, seq_len, add_bos=add_bos,
                                use_native=False)
    got = text.pack_documents(DOCS, seq_len, add_bos=add_bos)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("world,shuffle,drop_last", [
    (1, True, True), (2, True, True), (3, False, False), (2, True, False)])
def test_epoch_batches_match_jax(world, shuffle, drop_last):
    rows = text.pack_documents(DOCS, 16)
    for rank in range(world):
        for epoch in (0, 1):
            kw = dict(rank=rank, world_size=world, shuffle=shuffle,
                      seed=17, epoch=epoch, drop_last=drop_last)
            want = list(jtext.epoch_batches(rows, 3, **kw))
            got = list(text.epoch_batches(rows, 3, **kw))
            assert len(got) == len(want) > 0
            for (x, y), (u, v) in zip(got, want):
                np.testing.assert_array_equal(x, u)
                np.testing.assert_array_equal(y, v)


def test_errors_match_jax():
    for bad in ([], ["ab"]):
        with pytest.raises(ValueError):
            jtext.pack_documents(bad, 64, use_native=False)
        with pytest.raises(ValueError):
            text.pack_documents(bad, 64)
    with pytest.raises(NotImplementedError, match="native"):
        text.pack_documents(DOCS, 8, use_native=True)


def test_lm_text_example_trains_and_samples(monkeypatch, capsys, tmp_path):
    """Two epochs on the CPU: the epoch losses fall, a sample prints, and
    the checkpoint lands where ``TPU_DDP_CKPT_DIR`` says."""
    from tpu_ddp_torch.examples.lm_text_train import main
    monkeypatch.setenv("TPU_DDP_LM_TEXT_EPOCHS", "2")
    monkeypatch.setenv("TPU_DDP_CKPT_DIR", str(tmp_path))
    assert main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    losses = [float(v) for v in re.findall(r"mean loss (\S+)", out)]
    assert len(losses) == 2 and losses[1] < losses[0], out
    assert re.search(r"sample: 'the quick brown ' -> '.+'", out), out
    assert (tmp_path / "step_00000014" / "manifest.json").exists()
