"""Serving drivers on the GPU: the ReservoirEngine session loop and the LM
loop.

Sessions arrive, queue in the wave scheduler, are admitted in same-bucket
waves (each wave ONE batched prefill through the CUDA scan kernel for long
buckets), free-run closed-loop decode in lock-step (one fused CUDA launch
per wave of ``--gen`` tokens), and are released:

    PYTHONPATH=src python -m repro_torch.launch.serve --reservoir \\
        --n 1024 --slots 8 --sessions 16 --prompt-len 1024 --gen 128

The LM loop (without ``--reservoir``) prefills random prompts token by
token and decodes greedily (or samples at ``--temperature``) through the
decode caches (KV caches for attention layers, ring buffers for windowed
ones; decode attention is a dense product, as in the JAX package), for
archs whose blocks are all attention or reservoir layers with dense MLPs:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --batch 4 --prompt-len 64 --gen 32

It computes in the config's dtype (``bfloat16`` for the registered archs)
as the JAX loop does: parameters, activations and caches follow
``cfg.dtype``, with the float32 islands of the JAX blocks (norms, RoPE, the
reservoir recurrence, the attention softmax).  :func:`generate` is the loop
as a library function; with ``forced`` tokens it replays another run's
sequence (teacher forcing), which is how a bfloat16 run on the card is held
against the CPU.  Other archs exit naming ROADMAP A12.

``--device cpu`` runs either loop on the host with the plain PyTorch
versions of the kernels.  Reservoir flags of the JAX driver whose planes are
not ported yet exit with a message naming the ROADMAP item.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config, smoke_config
from ..core import esn as esn_fn
from ..core.params import ESNConfig
from ..data.signals import mso_series
from ..models import lm
from ..serve.engine import ReservoirEngine

#: Flags of the JAX driver that later slices port -> the ROADMAP item.
_NOT_PORTED = {
    "ensemble": "A5 (param-batched arena and ensemble voting)",
    "learn": "A9 (serve/learn.py learn-while-serving)",
    "refit_every": "A9 (serve/learn.py learn-while-serving)",
    "refit_decay": "A9 (serve/learn.py learn-while-serving)",
    "drift_threshold": "A9 (serve/learn.py learn-while-serving)",
    "mesh": "A11 (sharded arena)",
    "autotune": "A6 (serve/cost.py cost model)",
    "cost_seed": "A6 (serve/cost.py cost model)",
    "cost_save": "A6 (serve/cost.py cost model)",
    "decode_wave_tokens": "A7 (decode-SLO interleave)",
    "decode_slo": "A7 (decode-SLO interleave)",
    "park_host_rows": "A8 (serve/store.py paging)",
    "cold_dir": "A8 (serve/store.py paging)",
    "snapshot": "A8 (serve/store.py snapshot/restore)",
    "profile_dir": "A6 (ProfilerTracker -> torch.profiler)",
}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_engine(args):
    """The served model — a ``DiagParams`` struct from ``dpg_params`` plus a
    ridge-fitted ``Readout`` — in a ``ReservoirEngine``.  Returns
    ``(engine, signal, train_t)``."""
    device = resolve_device(args.device)
    cfg = ESNConfig(n=args.n, spectral_radius=0.95, leak=0.9,
                    input_scaling=0.5, ridge_alpha=1e-8, seed=args.seed)
    train_t = max(2000, args.prompt_len + args.gen + 512)
    sig = mso_series(3, train_t + 1)
    u_train, y_train = sig[:-1, None], sig[1:, None]

    params = esn_fn.dpg_params(cfg, "noisy_golden", sigma=0.1, device=device)
    readout = esn_fn.fit(params, u_train, y_train, washout=100)
    engine = ReservoirEngine(params, max_slots=args.slots, readout=readout,
                             bucket_min=args.bucket,
                             chunk_max=args.chunk_max,
                             pipeline_depth=args.pipeline_depth,
                             tracker=args.tracker, device=device)
    return engine, sig, train_t


def serve_sessions(engine, args, sig, train_t: int) -> dict:
    """Warm up, then serve ``args.sessions`` prompts drawn from ``sig`` in
    waves: prefill, ``args.gen`` closed-loop tokens, release.  Returns the
    run's counts and rates."""
    device, cfg = engine.device, engine.cfg
    rng = np.random.default_rng(args.seed)
    # Untimed warmup over every wave width the timed loop will hit (full
    # waves of `slots` rows plus the final partial wave) and the decode.
    warm_sizes = {min(args.slots, args.sessions)}
    tail = args.sessions % args.slots
    if args.sessions > args.slots and tail:
        warm_sizes.add(tail)
    for wb in sorted(warm_sizes):
        for i in range(wb):
            engine.submit(("warm", i), sig[:args.prompt_len, None])
        engine.flush()
        engine.decode_closed_loop(args.gen)
        _sync(device)
        engine.reset()
    engine.clear_decode_gaps()
    for sid in range(args.sessions):
        lo = int(rng.integers(0, train_t - args.prompt_len - 1))
        engine.submit(sid, sig[lo:lo + args.prompt_len, None])

    done = prefill_tokens = decode_tokens = 0
    t_prefill = t_decode = 0.0
    finite = True
    t0 = time.perf_counter()
    while engine.active_sessions or len(engine.pending):
        t1 = time.perf_counter()
        engine.flush()
        _sync(device)          # don't let prefill drain into the decode timer
        t_prefill += time.perf_counter() - t1
        wave = list(engine.ready_sessions)
        prefill_tokens += args.prompt_len * len(wave)
        t1 = time.perf_counter()
        ys = engine.decode_closed_loop(args.gen, sids=wave)
        _sync(device)
        t_decode += time.perf_counter() - t1
        decode_tokens += args.gen * len(wave)
        for sid in wave:
            finite = finite and bool(torch.isfinite(ys[sid]).all())
            engine.release(sid)
            done += 1
    wall = time.perf_counter() - t0
    res = {"device": str(device), "n": cfg.n, "slots": args.slots,
           "sessions": done, "wall_s": wall, "sessions_per_s": done / wall,
           "prefill_tokens": prefill_tokens, "prefill_s": t_prefill,
           "prefill_tok_s": prefill_tokens / max(t_prefill, 1e-9),
           "decode_tokens": decode_tokens, "decode_s": t_decode,
           "decode_tok_s": decode_tokens / max(t_decode, 1e-9),
           "finite": finite}
    print(f"reservoir n={cfg.n} slots={args.slots} on {device}: served "
          f"{done} sessions in {wall:.3f}s ({res['sessions_per_s']:.2f} "
          f"sessions/s)")
    print(f"  prefill {prefill_tokens} tok in {t_prefill:.3f}s "
          f"({res['prefill_tok_s']:.0f} tok/s, bucketed waves)")
    print(f"  decode  {decode_tokens} tok in {t_decode:.3f}s "
          f"({res['decode_tok_s']:.0f} tok/s, closed loop)")
    engine.tracker.close()
    return res


def serve_reservoir(args) -> dict:
    """Streaming session serving through ``serve.engine.ReservoirEngine``:
    build the model and engine, then serve.  Returns counts and rates."""
    engine, sig, train_t = build_engine(args)
    return serve_sessions(engine, args, sig, train_t)


# ----------------------------------------------------------------------- lm
def generate(params, cfg, prompts, gen: int, *, temperature: float = 0.0,
             seed: int = 0, forced=None) -> dict:
    """The LM loop on ``params``: token-by-token prefill of ``prompts``
    (B, P) through the decode caches, then ``gen`` tokens, greedy or sampled
    at ``temperature`` (drawn on the host from ``seed``, so every device
    draws the same).  ``forced`` (B, gen): feed these tokens instead of the
    picked ones (teacher forcing), to replay another run's sequence.

    Returns ``tokens`` (B, gen), the tokens the loop picked; ``step_logits``
    (B, gen + 1, V) float32 on the host, the logits each token was picked
    from and, last, those after the last token; ``prefill_s``,
    ``decode_s``."""
    device = prompts.device
    batch, prompt_len = prompts.shape
    sampler = torch.Generator().manual_seed(seed)
    if forced is not None:
        forced = torch.as_tensor(np.asarray(forced), device=device)

    def pick(logits):
        last = logits[:, -1].float()
        steps.append(last)
        if temperature > 0:           # drawn on the host: same on any device
            probs = torch.softmax(last / temperature, -1).cpu()
            return torch.multinomial(probs, 1, generator=sampler).to(device)
        return torch.argmax(last, -1)[:, None]

    steps, out = [], []
    with torch.no_grad():
        cache = lm.make_decode_cache(params, cfg, batch, prompt_len + gen)
        t0 = time.perf_counter()
        logits = None
        for t in range(prompt_len):
            logits, cache = lm.decode_step(params, cfg, cache,
                                           prompts[:, t:t + 1])
        _sync(device)
        t_prefill = time.perf_counter() - t0
        cur = pick(logits)
        t0 = time.perf_counter()
        for i in range(gen):
            out.append(cur[:, 0].cpu())
            if forced is not None:
                cur = forced[:, i:i + 1]
            logits, cache = lm.decode_step(params, cfg, cache, cur)
            cur = pick(logits)
        _sync(device)
        t_decode = time.perf_counter() - t0
    toks = torch.stack(out, 1).numpy() if out else np.zeros((batch, 0))
    return {"tokens": toks, "step_logits": torch.stack(steps, 1).cpu(),
            "prefill_s": t_prefill, "decode_s": t_decode}


def lm_setup(args, device=None):
    """The LM loop's inputs for ``args`` on ``device`` (default
    ``args.device``): ``(cfg, params, prompts)``, the weights from
    ``--seed`` (drawn on the host: the same on every device) and
    ``--batch`` random prompts of ``--prompt-len`` tokens."""
    device = resolve_device(args.device if device is None else device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    try:
        lm.check_ported(cfg)
    except NotImplementedError as e:
        raise SystemExit(str(e)) from e
    params = lm.init_params(torch.Generator().manual_seed(args.seed), cfg,
                            device)
    rng = np.random.default_rng(args.seed)
    prompts = torch.as_tensor(rng.integers(
        0, cfg.vocab, size=(args.batch, args.prompt_len)), device=device)
    return cfg, params, prompts


def serve_lm(args) -> dict:
    """The LM loop: token-by-token prefill of ``--batch`` random prompts,
    then ``--gen`` decoded tokens, in the config's dtype.  Returns the
    timings, the generated tokens, every step's logits and the last
    step's."""
    cfg, params, prompts = lm_setup(args)
    device = prompts.device
    run = generate(params, cfg, prompts, args.gen,
                   temperature=args.temperature, seed=args.seed + 1)
    toks, t_prefill, t_decode = run["tokens"], run["prefill_s"], \
        run["decode_s"]
    last = run["step_logits"][:, -1]
    res = {"arch": cfg.name, "dtype": cfg.dtype, "device": str(device),
           "batch": args.batch, "prompt_len": args.prompt_len,
           "gen": args.gen, "prefill_s": t_prefill, "decode_s": t_decode,
           "prefill_tok_s": args.batch * args.prompt_len / max(t_prefill,
                                                               1e-9),
           "decode_tok_s": args.batch * args.gen / max(t_decode, 1e-9),
           "tokens": toks, "step_logits": run["step_logits"],
           "last_logits": last, "finite": bool(torch.isfinite(last).all())}
    print(f"arch={cfg.name} ({cfg.dtype}) batch={args.batch} on {device}: "
          f"prefill={args.prompt_len}tok in {t_prefill:.3f}s  "
          f"decode={args.gen}tok in {t_decode:.3f}s "
          f"({res['decode_tok_s']:.1f} tok/s)")
    for i in range(min(args.batch, 4)):
        print(f"  req{i}: {toks[i, :12].tolist()}")
    return res


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="recurrentgemma-2b",
                    help="the LM loop's arch (ported: "
                         + ", ".join(lm.ported_archs()) + ")")
    ap.add_argument("--smoke", action="store_true",
                    help="the LM loop on the arch's reduced smoke config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--reservoir", action="store_true",
                    help="serve streaming reservoir sessions via "
                         "ReservoirEngine instead of the LM loop")
    ap.add_argument("--n", type=int, default=512, help="reservoir size")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--sessions", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--bucket", type=int, default=16,
                    help="smallest prefill bucket; prompt lengths are "
                         "padded up to powers of two for wave batching")
    ap.add_argument("--chunk-max", type=int, default=None,
                    help="split prompts longer than this into sequential "
                         "chunk waves (same slot, same result)")
    ap.add_argument("--pipeline-depth", type=int, default=2, metavar="D",
                    help="waves in flight while the host plans ahead; 0 "
                         "waits after every wave")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tracker", default=None, metavar="SPEC",
                    help="observability sink: 'null' or 'jsonl:PATH'")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    for name in _NOT_PORTED:
        ap.add_argument("--" + name.replace("_", "-"), dest=name, nargs="?",
                        const=True, default=None, help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    for name, item in _NOT_PORTED.items():
        if getattr(args, name) is not None:
            raise SystemExit(f"--{name.replace('_', '-')} is not ported yet: "
                             f"ROADMAP {item}")
    if not args.reservoir:
        return serve_lm(args)
    return serve_reservoir(args)


if __name__ == "__main__":
    main()
