"""Quickstart on the PyTorch/CUDA port: the paper in 60 lines.

The port of ``examples/quickstart.py``: a model is an immutable param
struct (``StandardParams`` / ``DiagParams``) plus plain functions over it —
build on the MSO-3 task, show EWT/EET/DPG all reproduce the standard model,
then free-run the trained reservoir closed-loop.  Runs on the GPU (the
scans through the hand-written CUDA kernel) unless ``--device cpu``:

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import ESNConfig, LinearESN, esn
from repro_torch.data.signals import mso_series


def mso(t, k=3):
    return mso_series(k, t)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = args.device

    series = mso(1001)
    u, y = series[:-1, None], series[1:, None]
    cfg = ESNConfig(n=100, spectral_radius=0.95, leak=1.0, input_scaling=0.1,
                    ridge_alpha=1e-9, seed=0)

    def rmse(params, readout, **kw):
        pred = esn.predict(params, readout, u, **kw).cpu().numpy()[700:]
        return float(np.sqrt(np.mean((pred - y[700:]) ** 2)))

    # 1. the O(N^2) baseline: params struct + plain ridge fit
    std = esn.standard_params(cfg, device=dev)
    ro_std = esn.fit(std, u[:400], y[:400], washout=100)
    print(f"standard  (O(N^2) step)   test RMSE = {rmse(std, ro_std):.3e}")

    # 2. EWT: same trained readout, transplanted into the eigenbasis -> O(N).
    # The transplant needs the eigenbasis, which the LinearESN facade keeps.
    dia = LinearESN.diagonalized(cfg, device=dev)
    ro_ewt = esn.ewt_readout(dia.basis, cfg, ro_std)
    print(f"EWT       (O(N)   step)   test RMSE = "
          f"{rmse(dia.params, ro_ewt):.3e}")

    # 3. EET: trained directly in the eigenbasis (Eq. 14 metric)
    ro_eet = esn.fit(dia.params, u[:400], y[:400], washout=100)
    print(f"EET       (O(N)   step)   test RMSE = "
          f"{rmse(dia.params, ro_eet):.3e}")

    # 4. DPG: never build W at all — sample the spectrum (noisy golden).
    # Algorithm 3 adds noise AFTER radius scaling, so sigma must stay small
    # relative to 1 - sr for open-loop stability.
    dpg = esn.dpg_params(cfg, "noisy_golden", sigma=0.03, device=dev)
    ro_dpg = esn.fit(dpg, u[:400], y[:400], washout=100)
    print(f"DPG       (no W, no eig)  test RMSE = {rmse(dpg, ro_dpg):.3e}")

    # 5. Appendix B: state collection parallelized over time.
    par = esn.run(dia.params, u, method="associative").cpu().numpy()
    seq = esn.run(dia.params, u, method="sequential").cpu().numpy()
    print(f"time-parallel scan max err = {np.abs(par - seq).max():.2e}")

    # 6. closed-loop generation from the diagonal model (plain function)
    gen = esn.generate(dia.params, ro_eet, 100, u[:400],
                       y[:400]).cpu().numpy()
    err = float(np.sqrt(np.mean((gen[:50] - y[400:450]) ** 2)))
    print(f"closed-loop 50-step RMSE  = {err:.3e}")


if __name__ == "__main__":
    main()
