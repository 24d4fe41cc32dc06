"""End-to-end LM walkthrough (examples/lm_text_train.py of the JAX
package): raw text -> packed byte batches -> training -> sampling, on one
device::

    python -m tpu_ddp_torch.examples.lm_text_train [--device cuda|cpu]

Byte tokenization and packing (data/text.py), an ``LMTrainer`` over
TransformerLM-tiny (vocab 259, seq 64) with dropout 0.05 and a
warmup-cosine AdamW schedule, an optional checkpoint, and greedy
sampling from the trained model (models/generate.py). No download: the
corpus is inline. Env knobs, with the JAX example's defaults:
``TPU_DDP_LM_TEXT_EPOCHS`` (3), ``TPU_DDP_LM_TEXT_BATCH`` (8) and
``TPU_DDP_CKPT_DIR`` (a checkpoint directory, optional).
"""

from __future__ import annotations

import argparse
import os
import sys

# A tiny self-contained corpus: structure the model can learn in a few
# epochs of byte-level training (the JAX example's).
CORPUS = [
    "the quick brown fox jumps over the lazy dog. ",
    "pack my box with five dozen liquor jugs. ",
    "how vexingly quick daft zebras jump! ",
    "the five boxing wizards jump quickly. ",
] * 24


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpu_ddp_torch.examples.lm_text_train")
    p.add_argument("--device", default=None,
                   help="cuda (default), cuda:N or cpu")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from tpu_ddp_torch.data.text import (ByteTokenizer, epoch_batches,
                                         pack_documents)
    from tpu_ddp_torch.models.generate import generate
    from tpu_ddp_torch.models.transformer import make_transformer
    from tpu_ddp_torch.ops.optim import AdamW, warmup_cosine
    from tpu_ddp_torch.train.lm import LMTrainer
    from tpu_ddp_torch.utils.config import refuse_unported_env
    from tpu_ddp_torch.utils.tree import tree_leaves

    refuse_unported_env()
    epochs = int(os.environ.get("TPU_DDP_LM_TEXT_EPOCHS", "3"))
    batch = int(os.environ.get("TPU_DDP_LM_TEXT_BATCH", "8"))
    ckpt_dir = os.environ.get("TPU_DDP_CKPT_DIR")
    seq_len = 64

    tok = ByteTokenizer()
    rows = pack_documents(CORPUS, seq_len=seq_len)
    print(f"[lm_text] corpus: {len(CORPUS)} docs -> {rows.shape[0]} rows "
          f"of {seq_len + 1} tokens (vocab {tok.vocab_size})")
    if batch > rows.shape[0]:
        raise SystemExit(
            f"[lm_text] TPU_DDP_LM_TEXT_BATCH={batch} exceeds the "
            f"{rows.shape[0]} packed rows — every epoch would be empty "
            f"(drop_last); lower the batch or grow the corpus")
    model = make_transformer("TransformerLM-tiny", vocab_size=tok.vocab_size,
                             max_seq_len=seq_len, dropout_rate=0.05)
    # Schedule length = the steps that actually run (drop_last floors).
    total_steps = rows.shape[0] // batch * epochs
    trainer = LMTrainer(model, device=args.device, optimizer=AdamW(
        learning_rate=warmup_cosine(3e-3, max(total_steps // 6, 1),
                                    max(total_steps, 2))))
    state = trainer.init_state(seed=0)
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    print(f"[lm_text] {n_params:,} params on {trainer.device}")

    for epoch in range(epochs):
        losses = []
        for inp, tgt in epoch_batches(rows, batch, seed=17, epoch=epoch):
            x, y = trainer.put_batch(inp, tgt)
            state, loss = trainer.train_step(state, x, y)
            losses.append(loss)
        mean = float(torch.stack(losses).mean())
        print(f"[lm_text] epoch {epoch}: mean loss {mean:.4f} over "
              f"{len(losses)} steps")
    if ckpt_dir:
        path = trainer.save_checkpoint(ckpt_dir, state)
        print(f"[lm_text] checkpoint: {path}")

    # Greedy sampling passes no dropout key: the masks are off.
    prompt = tok.encode("the quick brown ")[None, :]
    out = generate(model, state.params, prompt, max_new_tokens=24)
    print(f"[lm_text] sample: {tok.decode(prompt[0])!r} -> "
          f"{tok.decode(np.asarray(out.cpu())[0])!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
