#!/usr/bin/env python3
"""Where flash attention's (B3) float32 error lies, on the GPU.

    python3 scripts/b3_f32_error.py [--src path/to/checkout/src] [--label NAME]

Imports ``repro_torch`` from ``--src`` (this checkout's ``src`` by
default), builds its kernels, and prints one JSON line a case with the
largest |error| of ``ops.flash_attention_fwd`` (B3), of
``ref.flash_attention_fwd_ref`` in float32 (the plain version) and of
``scaled_dot_product_attention`` against dense softmax attention in
float64 on the same inputs, and of B3's ``lse``.  The cases at
whisper-tiny's encoder shape (q, k, v (8, 6, 1500, 64), non-causal):

* ``random``: standard normal q, k, v (as ``chip_smoke.py``'s case);
* ``qk_grid``: q and k rounded to multiples of 1/8, so every q.k product
  and sum is exact in TF32 and float32 and the scores carry no error;
* ``qkv_grid``: v rounded as well;
* ``scores_x3``: q scaled by 3 (larger scores, a peakier softmax);
* ``keys32`` / ``keys256``: the random q against only the first 32 / 256
  keys (``random`` is 1500).  An error that grows with the key count
  while the other two stay flat lies in the accumulation of O across key
  tiles;

and one case a route at the other head dims the main paths give B3:
``llava_chunk1`` (q (2, 32, 1024, 128) against k / v (2, 8, 2048, 128),
causal from offset 1024, window 4096) and ``local_chunk1`` (q (2, 10,
1024, 256) against k / v (2, 1, 2048, 256), window 2048: the route that
splits the head dim between two warpgroups).  Before them, one line with
ptxas's registers and spills of the build; the last line is the card's
name and power limit.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

SHAPE = (8, 6, 1500, 64)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("this script needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch.nn.functional as F
    from repro_torch.kernels import build, ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    print(json.dumps({"label": args.label, "src": args.src, "ptxas": [
        line.strip() for line in build.build_log("flash_attention")
        .splitlines() if "registers" in line or "spill" in line]}),
        flush=True)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(SHAPE, generator=g).cuda() for _ in range(3))

    def grid(t):
        return torch.round(t * 8) / 8

    def randn(*shape):
        return torch.randn(shape, generator=g).cuda()
    plain_kw = dict(causal=False)
    cases = {"random": (q, k, v, plain_kw),
             "qk_grid": (grid(q), grid(k), v, plain_kw),
             "qkv_grid": (grid(q), grid(k), grid(v), plain_kw),
             "scores_x3": (3 * q, k, v, plain_kw),
             "keys32": (q, k[:, :, :32], v[:, :, :32], plain_kw),
             "keys256": (q, k[:, :, :256], v[:, :, :256], plain_kw),
             "llava_chunk1": (randn(2, 32, 1024, 128), randn(2, 8, 2048, 128),
                              randn(2, 8, 2048, 128),
                              dict(causal=True, window=4096, q_offset=1024)),
             "local_chunk1": (randn(2, 10, 1024, 256), randn(2, 1, 2048, 256),
                              randn(2, 1, 2048, 256),
                              dict(causal=True, window=2048, q_offset=1024))}
    for name, (cq, ck, cv, kw) in cases.items():
        ck, cv = ck.contiguous(), cv.contiguous()
        out, lse = ops.flash_attention_fwd(cq, ck, cv, **kw)
        group = cq.shape[1] // ck.shape[1]
        k64 = ck.double().repeat_interleave(group, 1)
        s = cq.double() @ k64.transpose(-1, -2) * cq.shape[-1] ** -0.5
        del k64
        mask = None
        if kw.get("causal"):
            mask = ref.attention_mask(cq.shape[2], ck.shape[2], device="cuda",
                                      **kw)
            s = s.masked_fill(~mask, float("-inf"))
        want = torch.softmax(s, dim=-1) @ cv.double().repeat_interleave(
            group, 1)
        want_lse = torch.logsumexp(s, dim=-1)
        del s
        plain, _ = ref.flash_attention_fwd_ref(cq, ck, cv, **kw)
        sdpa = F.scaled_dot_product_attention(cq, ck, cv, attn_mask=mask,
                                              enable_gqa=True)

        def err(t):
            return float((t.double() - want).abs().max())
        print(json.dumps({
            "label": args.label, "case": name, "q": list(cq.shape),
            "kv": list(ck.shape), **kw, "b3_err": err(out),
            "plain_f32_err": err(plain), "sdpa_err": err(sdpa),
            "b3_lse_err": float((lse.double() - want_lse).abs().max()),
            "max_abs_ref": float(want.abs().max())}), flush=True)
        del want, plain, sdpa, out
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
