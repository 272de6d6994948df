"""Serving drivers on the GPU: the ReservoirEngine session loop and the LM
loop.

Sessions arrive, queue in the wave scheduler, are admitted in same-bucket
waves (each wave ONE batched prefill through the CUDA scan kernel for long
buckets), free-run closed-loop decode in lock-step (one fused CUDA launch
per wave of ``--gen`` tokens), and are released:

    PYTHONPATH=src python -m repro_torch.launch.serve --reservoir \\
        --n 1024 --slots 8 --sessions 16 --prompt-len 1024 --gen 128

``--ensemble mean`` serves one stream from ``--slots`` independently seeded
reservoirs (a param-batched engine: one prefill launch with per-row
coefficients, one fused decode launch whose kernel averages the members'
outputs every step) and scores the continuation against the signal;
``weighted`` votes by validation RMSE, ``independent`` serves the session
loop on the param batch.  ``--decode-slo US`` (with ``--chunk-max`` and
``--decode-wave-tokens K``) interleaves SLO-protected decode waves into the
flushes, planned by the wave cost model (``--autotune``, ``--cost-seed``,
``--cost-save``); ``--profile-dir`` writes a ``torch.profiler`` trace of
the timed loop.

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
import dataclasses
import time

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config, smoke_config
from ..core import esn as esn_fn
from ..core.params import ESNConfig, Readout, stack_params
from ..data.signals import mso_series
from ..models import lm
from ..serve.cost import WaveCostModel, cost_key
from ..serve.engine import ReservoirEngine

#: Flags of the JAX driver that later slices port -> the ROADMAP item.
_NOT_PORTED = {
    "learn": "A9 (serve/learn.py learn-while-serving)",
    "refit_every": "A9 (serve/learn.py learn-while-serving)",
    "refit_decay": "A9 (serve/learn.py learn-while-serving)",
    "drift_threshold": "A9 (serve/learn.py learn-while-serving)",
    "mesh": "A11 (sharded arena)",
    "park_host_rows": "A8 (serve/store.py paging)",
    "cold_dir": "A8 (serve/store.py paging)",
    "snapshot": "A8 (serve/store.py snapshot/restore)",
}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _cost_model(args, device: torch.device):
    """The cost model the flags ask for (None: the engine builds its own
    when a decode SLO or ``--decode-wave-tokens auto`` needs one), keyed by
    this device so a stale artifact from another machine or shape
    shelves instead of fitting."""
    key = cost_key(device.type, args.n, 1)
    if args.cost_seed:
        # A seed alone enables cost-model planning without per-wave timing
        # syncs; --autotune adds online refinement on top.
        model = WaveCostModel.from_artifact(args.cost_seed, key=key)
        print(f"cost model seeded with {model.n_observations} wave timings "
              f"from {args.cost_seed} ("
              + ("refining online" if args.autotune else "planning only")
              + ")")
        return model
    if args.autotune:
        print("autotune: cold cost model — learning from this run's wave "
              "timings")
        return WaveCostModel(key=key)
    return None


def build_engine(args):
    """The served model in a ``ReservoirEngine``: a ``DiagParams`` struct
    from ``dpg_params`` plus a ridge-fitted ``Readout`` — or, with
    ``--ensemble``, one independently seeded reservoir per slot, each with
    its own readout, in a param-batched engine.  Returns
    ``(engine, signal, train_t)``."""
    device = resolve_device(args.device)
    cfg = ESNConfig(n=args.n, spectral_radius=0.95, leak=0.9,
                    input_scaling=0.5, ridge_alpha=1e-8, seed=args.seed)
    train_t = max(2000, args.prompt_len + args.gen + 512)
    sig = mso_series(3, train_t + 1)
    u_train, y_train = sig[:-1, None], sig[1:, None]
    kw = dict(bucket_min=args.bucket, chunk_max=args.chunk_max,
              pipeline_depth=args.pipeline_depth, tracker=args.tracker,
              device=device, autotune=args.autotune,
              cost_model=_cost_model(args, device),
              decode_slo_us=args.decode_slo,
              decode_wave_tokens=args.decode_wave_tokens,
              profile_dir=args.profile_dir)
    if args.decode_slo is not None:
        print(f"decode-aware planning: SLO {args.decode_slo:.0f} us of "
              f"predicted prefill cost between decode waves "
              f"({args.decode_wave_tokens} tok per fused decode wave)")
    if not args.ensemble:
        params = esn_fn.dpg_params(cfg, "noisy_golden", sigma=0.1,
                                   device=device)
        readout = esn_fn.fit(params, u_train, y_train, washout=100)
        engine = ReservoirEngine(params, max_slots=args.slots,
                                 readout=readout, **kw)
        return engine, sig, train_t
    batch = [esn_fn.dpg_params(dataclasses.replace(cfg, seed=args.seed + i),
                               "noisy_golden", sigma=0.1, device=device)
             for i in range(args.slots)]
    readouts = [esn_fn.fit(p, u_train, y_train, washout=100).w_out
                for p in batch]
    engine = ReservoirEngine.from_param_batch(
        stack_params(batch), Readout(torch.stack(readouts)),
        ensemble="off" if args.ensemble == "independent" else args.ensemble,
        **kw)
    print(f"ensemble mode ({args.ensemble}): {args.slots} independently "
          f"seeded reservoirs, one param-batched arena")
    if args.ensemble == "weighted":
        # Validation-RMSE-weighted voting: score each member on a held-out
        # teacher-forced window, weight 1 / (rmse^2 + eps).
        v0 = train_t - 400
        rmses = [float(torch.sqrt(torch.mean((esn_fn.predict(
            p, Readout(w), u_train[v0:]).cpu()
            - torch.as_tensor(y_train[v0:])) ** 2)))
            for p, w in zip(batch, readouts)]
        engine.set_ensemble_weights([1.0 / (r * r + 1e-9) for r in rmses])
        print("  member val-RMSE: " + ", ".join(f"{r:.3e}" for r in rmses))
    return engine, sig, train_t


def serve_ensemble(engine, args, sig) -> dict:
    """One logical stream, B reservoirs voting (``--ensemble mean`` /
    ``weighted``): every slot prefills the same prompt, then the fused
    closed-loop continuation is scored against the true signal.  An
    untimed warm-up pass first; the timed pass counts each member as a
    served session."""
    device, p, g = engine.device, args.prompt_len, args.gen
    for timed in (False, True):
        engine.reset()
        t0 = time.perf_counter()
        for i in range(args.slots):
            engine.submit(i, sig[:p, None])
        engine.flush()
        ys = engine.decode_closed_loop(g)
        _sync(device)
        wall = time.perf_counter() - t0
    fused = ys[0][:, 0].cpu().numpy()
    # After prefilling sig[:P] the model predicts one step ahead, so the
    # closed-loop outputs align to sig[P+1 : P+1+G].
    truth = sig[p + 1:p + 1 + g]
    rmse = float(np.sqrt(np.mean((fused - truth) ** 2)))
    res = {"device": str(device), "n": engine.cfg.n, "slots": args.slots,
           "ensemble": args.ensemble, "sessions": args.slots, "wall_s": wall,
           "sessions_per_s": args.slots / wall, "gen": g,
           "continuation": fused, "rmse_vs_signal": rmse,
           "finite": bool(np.isfinite(fused).all())}
    print(f"ensemble-{args.ensemble} continuation: {g} tok closed loop, "
          f"rmse vs signal {rmse:.3e} (B={args.slots} reservoirs fused into "
          f"one output) in {wall:.3f}s ({res['sessions_per_s']:.2f} "
          f"sessions/s)")
    engine.tracker.close()
    return res


def serve_sessions(engine, args, sig, train_t: int) -> dict:
    """Warm up, then serve ``args.sessions`` prompts drawn from ``sig`` in
    waves: prefill, ``args.gen`` closed-loop tokens, release.  Under
    ``--decode-slo`` one session stays resident across flushes (a live
    stream) while the flushes interleave decode waves for the ready
    sessions, and a second ready session streams a few teacher-forced tokens
    (``decode_step`` + ``observe``).  Returns the run's counts and
    rates."""
    device, cfg = engine.device, engine.cfg
    rng = np.random.default_rng(args.seed)
    interleave = args.decode_slo is not None
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
        if interleave:
            engine.decode_closed_loop(engine.decode_wave_tokens)
            engine.decode_step({("warm", 0): sig[:1]})
        engine.decode_closed_loop(args.gen)
        _sync(device)
        engine.reset()
    engine.clear_decode_gaps()
    for sid in range(args.sessions):
        lo = int(rng.integers(0, train_t - args.prompt_len - 1))
        engine.submit(sid, sig[lo:lo + args.prompt_len, None])

    done = prefill_tokens = decode_tokens = interleaved_tokens = 0
    t_prefill = t_decode = 0.0
    finite = True
    persistent = 0 if interleave and args.sessions > 1 else None
    seen: set = set()
    with engine.tracker.capture("serve"):
        t0 = time.perf_counter()
        while engine.active_sessions or len(engine.pending):
            t1 = time.perf_counter()
            engine.flush(decode_interleave=interleave)
            _sync(device)      # don't let prefill drain into the decode timer
            t_prefill += time.perf_counter() - t1
            wave = list(engine.ready_sessions)
            # A resident session re-appears in every wave; count it once.
            prefill_tokens += args.prompt_len * len(set(wave) - seen)
            seen.update(wave)
            t1 = time.perf_counter()
            if interleave and wave:
                # Tokens the interleaved decode waves made mid-flush
                # (their time sits in the flush timer, so they are counted
                # apart from decode_tokens).
                for sid, buf in engine.collect_decoded().items():
                    interleaved_tokens += int(buf.shape[0])
                    finite = finite and bool(torch.isfinite(buf).all())
                open_sid = next((s for s in wave if s != persistent), None)
                if open_sid is not None:
                    for t in range(args.prompt_len, args.prompt_len + 4):
                        engine.decode_step({open_sid: sig[t, None]})
                        engine.observe(open_sid, sig[t + 1, None])
                        decode_tokens += 1
            ys = engine.decode_closed_loop(args.gen, sids=wave)
            _sync(device)
            t_decode += time.perf_counter() - t1
            decode_tokens += args.gen * len(wave)
            for sid in wave:
                finite = finite and bool(torch.isfinite(ys[sid]).all())
                if sid == persistent and len(engine.pending):
                    continue    # resident until the prefill flood drains
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
    st = engine.stats()
    if args.autotune:
        lat = st.wave_us_mean
        print(f"  autotune: {st.waves_total} waves, mean occupancy "
              f"{st.occupancy_mean:.2f}, mean wave latency "
              f"{lat / 1e3 if lat else float('nan'):.3f} ms, "
              f"{engine.cost_model.n_observations} cost observations")
    if interleave:
        res.update(interleaved_tokens=interleaved_tokens,
                   decode_interleave_waves=st.decode_interleave_waves,
                   decode_gap_p50_us=st.decode_gap_p50_us,
                   decode_gap_p95_us=st.decode_gap_p95_us)
        print(f"  decode-aware: {st.decode_interleave_waves} interleaved "
              f"decode waves / {st.decode_waves_total} decode launches, "
              f"{interleaved_tokens} tok made mid-flush; inter-token gap "
              f"p50 {st.decode_gap_p50_us} us, p95 {st.decode_gap_p95_us} "
              f"us")
    if args.cost_save and engine.cost_model is not None:
        engine.cost_model.to_artifact(args.cost_save)
        print(f"cost model saved: {engine.cost_model.n_observations} "
              f"observations -> {args.cost_save} (reload with --cost-seed)")
    engine.tracker.close()
    return res


def serve_reservoir(args) -> dict:
    """Streaming session serving through ``serve.engine.ReservoirEngine``:
    build the model and engine, then serve (one fused stream under
    ``--ensemble mean`` / ``weighted``).  Returns counts and rates."""
    engine, sig, train_t = build_engine(args)
    if args.ensemble in ("mean", "weighted"):
        return serve_ensemble(engine, args, sig)
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


def _wave_tokens(v: str):
    """argparse type of --decode-wave-tokens: an int K, or 'auto'."""
    return "auto" if v == "auto" else int(v)


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
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="a torch.profiler window around the timed serving "
                         "loop, its Chrome trace written under DIR")
    ap.add_argument("--ensemble", nargs="?", const="independent",
                    choices=["independent", "mean", "weighted"], default=None,
                    help="one independently seeded reservoir per slot in a "
                         "param-batched engine; 'mean' fuses their "
                         "predictions into one output (closed loop through "
                         "the fused kernel's mean route), 'weighted' with "
                         "validation-RMSE weights 1/(rmse^2+eps)")
    ap.add_argument("--decode-wave-tokens", type=_wave_tokens, default=1,
                    metavar="K",
                    help="tokens per interleaved decode wave (one fused "
                         "launch each), or 'auto' to pick K each flush from "
                         "the fitted c_dec(B, K) surface, capped by "
                         "--decode-slo")
    ap.add_argument("--decode-slo", type=float, default=None, metavar="US",
                    help="decode-aware planning: bound the predicted prefill "
                         "cost (microseconds) between a ready session's "
                         "decode waves; flushes interleave decode waves to "
                         "hold it (combine with --chunk-max)")
    ap.add_argument("--autotune", action="store_true",
                    help="time every wave and decode launch into the cost "
                         "model that plans the waves")
    ap.add_argument("--cost-seed", default=None, metavar="PATH",
                    help="seed the cost model from a cost artifact; alone it "
                         "plans without per-wave timing syncs, with "
                         "--autotune it warm-starts the refinement")
    ap.add_argument("--cost-save", default=None, metavar="PATH",
                    help="write the engine's cost model to PATH at the end "
                         "(reload with --cost-seed)")
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
