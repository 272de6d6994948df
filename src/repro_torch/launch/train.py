"""End-to-end training driver of the port (the JAX package's
``launch/train.py``, same flags plus ``--device``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch linear-esn \\
        --vocab 50304 --batch 8 --seq 1024 --steps 10

trains the paper's reservoir LM at full width on the GPU: a Markov-chain
synthetic corpus, AdamW, float32, checkpoints and preemption handling;

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --vocab 49152 --batch 8 --seq 2048 --steps 10

trains the attention LM ``smollm-135m`` the same way, and

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
        --vocab 50304 --batch 8 --seq 2048 --steps 10
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch recurrentgemma-2b --layers 9 --vocab 256000 --batch 2 \\
        --seq 2048 --steps 5

the recurrent LMs (recurrentgemma at 9 of its 26 layers: float32 params,
gradients and AdamW moments of all 26 would take ~57 GB alone), and

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch kimi-k2-1t-a32b --d-model 1024 --layers 1 --batch 8 \\
        --seq 512 --steps 5

an MoE LM at its published expert count, top-k and expert width, cut in
width and depth through the flags (its full config does not fit one
card).  Every reservoir, RG-LRU and sLSTM scan and its gradient, and every
flash-attention forward, run through the hand-written CUDA kernels.
``--device cpu`` runs the same loop on the host with their plain PyTorch
versions.  The Markov corpus feeds tokens only, as the JAX driver's does:
an encoder-decoder (frames) or an embedding-input model trains through the
library's ``Trainer`` with a source that yields those inputs.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics

import numpy as np

from .. import resolve_device
from ..configs import get_config, smoke_config
from ..data.pipeline import MarkovTokens
from ..train.trainer import TrainConfig, Trainer


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="linear-esn")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    return ap


def arch_config(args):
    """The config the flags select: the arch (or its smoke reduction) at
    ``--vocab`` in float32, with ``--d-model`` / ``--layers`` applied as the
    JAX driver applies them."""
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    repl = {"vocab": args.vocab, "dtype": "float32"}
    if args.d_model:
        heads = max(1, args.d_model // 64)
        repl.update(d_model=args.d_model, n_heads=heads,
                    n_kv=min(cfg.n_kv, heads),
                    d_ff=0 if cfg.d_ff == 0 else 4 * args.d_model,
                    d_rnn=args.d_model if cfg.d_rnn else None)
    if args.layers:
        repl["n_layers"] = args.layers
    return dataclasses.replace(cfg, **repl)


def main(argv=None) -> dict:
    """Train; returns the run's losses and step rates (the first step, which
    builds the kernels and warms the allocator, is left out of the rates)."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = arch_config(args)
    n_params = cfg.param_count()
    print(f"arch={cfg.name} params~{n_params / 1e6:.1f}M device={device}",
          flush=True)
    data = MarkovTokens(vocab=cfg.vocab, batch=args.batch, seq_len=args.seq)
    tc = TrainConfig(steps=args.steps, ckpt_dir=args.ckpt,
                     ckpt_every=args.ckpt_every, accum=args.accum,
                     compress_grads=args.compress_grads, lr=args.lr)
    trainer = Trainer(cfg, tc, data, device=device, attn_impl="auto")
    trainer.run()
    timed = trainer.step_seconds[1:] or trainer.step_seconds
    ms = 1e3 * statistics.median(timed) if timed else float("nan")
    tokens = args.batch * args.seq
    res = {"arch": cfg.name, "device": str(device), "params": n_params,
           "batch": args.batch, "seq": args.seq,
           "steps_run": len(trainer.losses), "losses": trainer.losses,
           "ms_per_step": ms, "tokens_per_s": tokens / (ms * 1e-3),
           "finite": bool(np.isfinite(trainer.losses).all())}
    if trainer.losses:
        print(f"final loss {trainer.losses[-1]:.4f} "
              f"(unigram entropy ~{float(np.log(cfg.vocab)):.2f}, "
              f"markov target ~{data.target_entropy:.2f}); "
              f"{ms:.1f} ms/step, {res['tokens_per_s']:.0f} tokens/s "
              f"(median over steps 2..{len(trainer.losses)})", flush=True)
    return res


if __name__ == "__main__":
    main()
