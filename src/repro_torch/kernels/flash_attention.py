"""Launcher of the Hopper kernel in ``csrc/flash_attention.cu``.

``flash_attention_fwd_cuda`` takes CUDA tensors, checks them (device, dtype,
shapes, the GQA grouping, the head-dimension limit), allocates the outputs
with ``torch.empty`` and launches on PyTorch's current stream without
synchronising; it raises when the C entry point reports a CUDA error.  It is
a raw launcher: it routes nothing (``kernels.ops`` sends CPU tensors to the
plain version instead) and records nothing for autograd (the model's
``models.attention.jnp_flash`` supplies the backward); nothing here runs
without a GPU.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = ["flash_attention_fwd_cuda", "MAX_HEAD_DIM"]

#: Both routes of ``csrc/flash_attention.cu`` run their products on the
#: tensor cores (``wgmma``; 3xTF32 for float32, bf16 for bfloat16).  Head
#: dims padded to 32, 64 or 128 take the first kernel (one warpgroup keeps
#: a head's 64-row output tile in registers); head dims 129..256 take the
#: second, which pads to 256 and splits the head dim between two
#: warpgroups that add their partial scores through shared memory
#: ("head_dim 129..256 route").
MAX_HEAD_DIM = 256

_VP, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = ([_VP] * 5 + [_INT] * 6 + [_LL] * 9 + [_INT] * 5
             + [ctypes.c_float, _VP])
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _entry(dtype: torch.dtype):
    fn = getattr(build.library("flash_attention"),
                 f"flash_attention_fwd_{_SUFFIX[dtype]}")
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(rc: int) -> None:
    if rc != 0:
        lib = build.library("flash_attention")
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.cuda_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel launch failed: error {rc} ({msg})")


def flash_attention_fwd_cuda(q, k, v, *, causal: bool = True, window=None,
                             q_offset: int = 0, kv_len=None, scale=None):
    """Blocked online-softmax attention through the CUDA kernel.

    ``q`` (B, Hq, Sq, D); ``k``, ``v`` (B, Hkv, Skv, D) with Hq % Hkv == 0;
    all float32 or all bfloat16 on one CUDA device; D <= MAX_HEAD_DIM.
    Keys at or past ``kv_len`` (default Skv) are masked, as are those the
    causal mask (key position <= ``q_offset`` + query index) and the
    ``window`` (key position > query position - window) exclude.  Returns
    ``(out, lse)``: ``out`` (B, Hq, Sq, D) contiguous in q's dtype (zeros
    for a row with no visible key) and ``lse`` (B, Hq, Sq) float32.
    """
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q, k, v must be 4-D (B, H, S, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    dev, dtype = q.device, q.dtype
    if dev.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got "
                         f"{dev}")
    if dtype not in _SUFFIX:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name} must be a {dtype} tensor on {dev}, got "
                             f"{t.dtype} on {t.device}")
        # Batch, head and sequence strides are read as they are.
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name} must have a unit-stride head "
                             f"dimension, got strides {t.stride()}")
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if tuple(k.shape) != (b, hkv, skv, d) or v.shape != k.shape:
        raise ValueError(f"k and v must be (B, Hkv, Skv, D) = "
                         f"{(b, hkv, skv, d)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"Hq={hq} must be a multiple of Hkv={hkv} (GQA)")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes head_dim 1.."
                         f"{MAX_HEAD_DIM}, got {d}")
    kv_len = skv if kv_len is None else int(kv_len)
    scale = d ** -0.5 if scale is None else float(scale)
    out = torch.empty((b, hq, sq, d), dtype=dtype, device=dev)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
    rc = _entry(dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, hq, hkv, sq, skv, d, *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], int(bool(causal)),
        int(window is not None), 0 if window is None else int(window),
        int(q_offset), kv_len, scale,
        torch.cuda.current_stream(dev).cuda_stream)
    _check(rc)
    return out, lse
