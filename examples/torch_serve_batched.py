"""Serving example on the port: batched prefill + decode with KV/state caches.

The port of ``examples/serve_batched.py``: serves a small hybrid model
(recurrentgemma-style: RG-LRU + local attention — the paper's diagonal
recurrence gives O(1)-per-token decode states) over a batch of concurrent
requests with different prompt lengths (left-padded into one batch), then
decodes 32 tokens for all of them in lock-step.  The weights are drawn from
a seeded ``torch.Generator`` (the JAX example draws its own from a JAX
key), the prompts from the same numpy seed as the JAX example's.

    PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu]
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.models import lm


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(smoke_config("recurrentgemma-2b"), vocab=512)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                            args.device)
    device = params["embed"].device

    rng = np.random.default_rng(0)
    batch_size, max_prompt, gen_len = 4, 24, 32
    prompts = [rng.integers(0, cfg.vocab, size=rng.integers(8, max_prompt))
               for _ in range(batch_size)]

    # one-token-at-a-time prefill via the decode path (state caches make the
    # recurrent layers O(1) per token; attention uses the ring KV buffer)
    cache = lm.make_decode_cache(params, cfg, batch_size,
                                 max_prompt + gen_len)

    maxlen = max(len(p) for p in prompts)
    toks = np.zeros((batch_size, maxlen), np.int64)
    for i, p in enumerate(prompts):   # right-align (left-pad with 0)
        toks[i, maxlen - len(p):] = p
    toks = torch.as_tensor(toks, device=device)

    with torch.no_grad():
        t0 = time.time()
        logits = None
        for t in range(maxlen):
            logits, cache = lm.decode_step(params, cfg, cache,
                                           toks[:, t:t + 1])
        torch.cuda.synchronize(device) if device.type == "cuda" else None
        prefill_s = time.time() - t0

        # greedy decode, all requests in lock-step
        out = []
        cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
        t0 = time.time()
        for _ in range(gen_len):
            out.append(cur[:, 0].cpu().numpy())
            logits, cache = lm.decode_step(params, cfg, cache, cur)
            cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
        decode_s = time.time() - t0

    gen = np.stack(out, axis=1)
    print(f"served {batch_size} requests: prefill {maxlen} steps in "
          f"{prefill_s:.2f}s, decoded {gen_len} tokens in {decode_s:.2f}s "
          f"({batch_size * gen_len / decode_s:.1f} tok/s on {device.type.upper()})")
    print("sample continuations:")
    for i in range(batch_size):
        print(f"  req{i}: ...{prompts[i][-5:].tolist()} -> "
              f"{gen[i, :10].tolist()}")
    assert bool(torch.isfinite(logits.float()).all())


if __name__ == "__main__":
    main()
