#!/usr/bin/env python3
"""Where flash attention's (B3) float32 error lies, at whisper-tiny's
encoder shape, on the GPU.

    python3 scripts/b3_f32_error.py

Imports ``repro_torch`` from this checkout's ``src``, builds its kernels,
and on non-causal q / k / v (8, 6, 1500, 64) float32 prints one JSON line
a case with the largest |error| of ``ops.flash_attention_fwd`` (B3), of
``ref.flash_attention_fwd_ref`` in float32 (the plain version) and of
``scaled_dot_product_attention`` against dense softmax attention in
float64 on the same inputs, and of B3's ``lse``.  The cases:

* ``random``: standard normal q, k, v (as ``chip_smoke.py``'s case);
* ``qk_grid``: q and k rounded to multiples of 1/8, so every q.k product
  and sum is exact in TF32 and float32 and the scores carry no error;
* ``qkv_grid``: v rounded as well;
* ``scores_x3``: q scaled by 3 (larger scores, a peakier softmax).

If B3's error stays when the scores are exact, it lies past S = Q K^T:
in the softmax or in the P.V product and its accumulation.  The last line
before the end is the card's name and power limit.
"""
import json
import subprocess
import sys
from pathlib import Path

SHAPE = (8, 6, 1500, 64)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("this script needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    import torch.nn.functional as F
    from repro_torch.kernels import build, ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(SHAPE, generator=g).cuda() for _ in range(3))

    def grid(t):
        return torch.round(t * 8) / 8
    cases = {"random": (q, k, v), "qk_grid": (grid(q), grid(k), v),
             "qkv_grid": (grid(q), grid(k), grid(v)),
             "scores_x3": (3 * q, k, v)}
    for name, (cq, ck, cv) in cases.items():
        out, lse = ops.flash_attention_fwd(cq, ck, cv, causal=False)
        s = cq.double() @ ck.double().transpose(-1, -2) * SHAPE[-1] ** -0.5
        want = torch.softmax(s, dim=-1) @ cv.double()
        want_lse = torch.logsumexp(s, dim=-1)
        del s
        plain, _ = ref.flash_attention_fwd_ref(cq, ck, cv, causal=False)
        sdpa = F.scaled_dot_product_attention(cq, ck, cv)

        def err(t):
            return float((t.double() - want).abs().max())
        print(json.dumps({
            "case": name, "shape": list(SHAPE), "b3_err": err(out),
            "plain_f32_err": err(plain), "sdpa_err": err(sdpa),
            "b3_lse_err": float((lse.double() - want_lse).abs().max()),
            "max_abs_ref": float(want.abs().max())}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
