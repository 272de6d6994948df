"""Streaming reservoir sessions through the port's ReservoirEngine.

The port of ``examples/serve_sessions.py``: sessions are *submitted*
(requests queue in the wave scheduler), a *flush* admits what fits into
fixed slots and prefills each same-bucket wave as ONE batched
time-parallel scan (backend picked by ``core.dispatch`` for the engine's
device), admitted sessions free-run a closed-loop continuation in
lock-step (one fused decode launch on the GPU), and can be *parked* —
evicted with their exact state returned — then re-submitted later with
``h0=``/``y0=`` to continue where they stopped.

    PYTHONPATH=src python examples/torch_serve_sessions.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import esn
from repro_torch.core.esn import ESNConfig
from repro_torch.data.signals import mso_series
from repro_torch.serve import ReservoirEngine, resolve_method


def mso(t, k=2):
    return mso_series(k, t)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    # A DPG reservoir (no W ever built) trained to continue the MSO signal:
    # an immutable DiagParams struct + a Readout fitted by a plain function.
    cfg = ESNConfig(n=256, spectral_radius=0.95, leak=0.9, input_scaling=0.5,
                    ridge_alpha=1e-9, seed=3)
    params = esn.dpg_params(cfg, "noisy_golden", sigma=0.1,
                            device=args.device)
    sig = mso(2001)
    readout = esn.fit(params, sig[:-1, None], sig[1:, None], washout=100)

    engine = ReservoirEngine(params, max_slots=2, readout=readout,
                             device=args.device)
    print(f"engine: {engine.max_slots} slots, N={cfg.n} "
          f"(prefill backend for T=400: "
          f"{resolve_method(400, device=engine.device)!r})")

    # Three sessions arrive: submit() queues all three, one flush() admits
    # what fits and runs the batched prefill waves — carol waits for a slot.
    engine.submit("alice", sig[:400, None])
    engine.submit("bob", sig[100:500, None])
    engine.submit("carol", sig[200:600, None])
    engine.flush()
    for sid in ("alice", "bob", "carol"):
        print(f"  {sid}: "
              f"{'active' if sid in engine.active_sessions else 'queued'}")

    # Closed-loop continuation for the resident pair.
    ys = engine.decode_closed_loop(50, sids=["alice", "bob"])
    err_a = np.sqrt(np.mean((ys["alice"][:, 0].cpu().numpy()
                             - sig[400:450]) ** 2))
    print(f"alice: decoded 50 tokens closed-loop, rmse vs signal {err_a:.4f}")

    # Park alice (exact state comes back); the next flush admits carol.
    state, y_prev = engine.evict("alice")
    engine.flush()
    print(f"alice parked (state {tuple(state.shape)}); active: "
          f"{engine.active_sessions}")
    engine.decode_closed_loop(25, sids=["carol"])

    # Re-admit alice from the parked state: submit(h0=, y0=) restores her
    # slot exactly, and the one-token prompt (the true signal value her last
    # decode landed on) teacher-forces a single step before free-running.
    engine.evict("bob")
    engine.submit("alice", sig[449:450, None], h0=state, y0=y_prev)
    engine.flush()
    more = engine.decode_closed_loop(25, sids=["alice"])["alice"]
    more = more.cpu().numpy()
    err_b = np.sqrt(np.mean((more[:, 0] - sig[451:476]) ** 2))
    print(f"alice resumed after parking, rmse vs signal {err_b:.4f}")
    assert np.isfinite(more).all()


if __name__ == "__main__":
    main()
