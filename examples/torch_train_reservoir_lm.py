"""End-to-end driver on the port: train a small reservoir-mixer LM.

The port of ``examples/train_reservoir_lm.py``: the paper's diagonal linear
recurrence as the sequence mixer of a language model (LRU-style, DPG
spectral init), trained with AdamW on a Markov-chain synthetic corpus with
real learnable structure — on the GPU, every scan and its gradient through
the hand-written CUDA kernels, unless ``--device cpu``.  Loss drops from
~log(vocab) toward the chain's transition entropy log(4) ~ 1.39.

    PYTHONPATH=src python examples/torch_train_reservoir_lm.py [--steps 200]
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.configs import get_config
from repro_torch.data.pipeline import MarkovTokens
from repro_torch.train.trainer import TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(
        get_config("linear-esn"),
        n_layers=2, d_model=128, n_heads=2, n_kv=2, d_ff=256, d_rnn=192,
        vocab=256, dtype="float32")
    print(f"reservoir LM: {cfg.param_count()/1e6:.2f}M params")

    data = MarkovTokens(vocab=cfg.vocab, batch=8, seq_len=64, branching=4)
    tc = TrainConfig(steps=args.steps, lr=3e-3, log_every=20,
                     ckpt_dir=args.ckpt, ckpt_every=100)
    trainer = Trainer(cfg, tc, data, device=args.device)
    trainer.run()
    first = float(np.mean(trainer.losses[:10]))
    last = float(np.mean(trainer.losses[-10:]))
    print(f"loss {first:.3f} -> {last:.3f} "
          f"(unigram ~{np.log(cfg.vocab):.2f}, markov floor ~{data.target_entropy:.2f})")
    assert last < first - 0.5, "training failed to learn"


if __name__ == "__main__":
    main()
