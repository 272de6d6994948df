"""LM assembly of the port (the JAX package's ``models/lm.py``): decoder
LMs whose layers are attention (``attn`` — full causal GQA, ``swa`` —
sliding-window GQA, ``local`` — local attention; e.g. ``smollm-135m``),
recurrent (``rglru`` — recurrentgemma's Griffin block, ``mlstm`` /
``slstm`` — xLSTM's blocks) or the paper's LinearReservoir mixer
(``linear-esn``), each followed by a SwiGLU / GELU MLP, an MoE block (with
arctic's dense residual MLP beside it; ``arctic-480b``,
``kimi-k2-1t-a32b``) or nothing where ``d_ff == 0``; the whisper-style
encoder-decoder (``whisper-tiny``: a bidirectional encoder over
precomputed frame embeddings, learned positions, dense cross-attention in
every decoder layer); and embedding inputs (``llava-next-mistral-7b``:
``batch["embeds"]`` in place of the token lookup).

The parameter tree is a nested dict under the JAX key names (``embed``,
``layers/attn/wq``, ``layers/moe/router``, ``layers/xattn/wq``,
``encoder/layers/...``, ``dec_pos``, ``final_norm``, ``head``); a
homogeneous stack keeps the leading layer dimension, which
:func:`_stack_forward` indexes layer by layer (the loop that JAX's
``lax.scan`` over layers compiles).  :func:`lm_params_from_numpy` carries a
JAX ``init_params`` tree over, so both packages compute the same function,
in the same dtypes: with ``embed_scale`` the embeddings are scaled by a
float32 scalar, as JAX's ``np.float32`` scale does, so a bfloat16 model runs
float32 activations against its bfloat16 weights from there on.  Every
registered config is ported; a device mesh raises ``NotImplementedError``
naming ROADMAP A11 (LM sharding).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..tree import tree_map
from . import attention as attn_mod
from . import blocks
from .blocks import NULL_PROFILE, ShardProfile, apply_norm, constrain, init_norm

__all__ = ["MIXERS", "ATTN_KINDS", "layer_kinds", "check_ported",
           "ported_archs", "init_layer", "apply_layer", "init_params",
           "encode", "forward", "loss_fn",
           "make_decode_cache", "decode_step", "lm_params_from_numpy",
           "NULL_PROFILE", "ShardProfile"]

MIXERS = ("attn", "swa", "local", "rglru", "mlstm", "slstm", "reservoir")
ATTN_KINDS = ("attn", "swa", "local")


def layer_kinds(cfg):
    pat = cfg.block_pattern
    return [pat[i % len(pat)] for i in range(cfg.n_layers)]


def _is_homogeneous(cfg):
    return len(set(layer_kinds(cfg))) == 1 and cfg.scan_layers


def check_ported(cfg, prof: ShardProfile = NULL_PROFILE) -> None:
    """Raise unless the port runs ``cfg`` under ``prof``: a ``ValueError``
    for a layer kind no package knows, ``NotImplementedError`` naming
    ROADMAP A11 (LM sharding) for a device mesh."""
    other = sorted(set(layer_kinds(cfg)) - set(MIXERS))
    if other:
        raise ValueError(f"{cfg.name}: unknown mixer(s) {', '.join(other)}")
    blocks.one_device(prof)


def ported_archs():
    """Names of the registered configs the port runs on one device."""
    from ..configs import REGISTRY
    out = []
    for name, cfg in REGISTRY.items():
        check_ported(cfg)
        out.append(name)
    return out


# --------------------------------------------------------------------------- #
# Per-layer init / apply                                                       #
# --------------------------------------------------------------------------- #
def init_layer(gen, cfg, kind, dtype, cross=False):
    """One layer's params, keyed as the JAX ``init_layer``'s: ``norm1`` and
    the mixer; with ``cross`` (an encoder-decoder's decoder layer)
    ``norm_x`` and the cross-attention ``xattn``; ``norm2`` where an MLP or
    MoE follows, then ``moe`` (plus arctic's dense residual ``mlp``, which
    has no biases) or the dense ``mlp`` (biases with layernorm)."""
    p = {"norm1": init_norm(cfg.d_model, dtype, cfg.norm)}
    if kind in ATTN_KINDS:
        p["attn"] = blocks.init_attention(gen, cfg, dtype)
    elif kind == "rglru":
        p["rglru"] = blocks.init_rglru_block(gen, cfg, dtype)
    elif kind == "mlstm":
        p["mix"] = blocks.init_mlstm(gen, cfg, dtype)
    elif kind == "slstm":
        p["mix"] = blocks.init_slstm(gen, cfg, dtype)
    elif kind == "reservoir":
        p["res"] = blocks.init_reservoir(gen, cfg, dtype,
                                         n_state=cfg.d_rnn or cfg.d_model)
    else:
        raise ValueError(kind)
    if cross:
        p["norm_x"] = init_norm(cfg.d_model, dtype, cfg.norm)
        p["xattn"] = blocks.init_attention(gen, cfg, dtype)
    if cfg.d_ff > 0 or cfg.n_experts > 0:
        p["norm2"] = init_norm(cfg.d_model, dtype, cfg.norm)
    if cfg.n_experts > 0:
        p["moe"] = blocks.init_moe(gen, cfg, dtype)
        if cfg.dense_residual and cfg.d_ff > 0:
            p["mlp"] = blocks.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype,
                                       gated=cfg.act != "gelu")
    elif cfg.d_ff > 0:
        p["mlp"] = blocks.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype,
                                   gated=cfg.act != "gelu",
                                   bias=cfg.norm == "layernorm")
    return p


def apply_layer(p, x, cfg, kind, prof=NULL_PROFILE, *, mode="train",
                cache=None, positions=None, enc_kv=None, attn_impl="auto"):
    """Returns ``(x, new_cache, aux)``; ``aux`` holds the MoE block's
    ``load_balance`` and ``router_z`` (zero without one).  ``mode``:
    ``"train"`` / ``"prefill"`` run the full sequence (an attention layer's
    new cache is its full-length ``{"kv": {"k", "v"}}``, a recurrent
    layer's its last state under the kind's key), ``"decode"`` one token
    against ``cache``.  ``enc_kv``: the encoder's output, which a layer
    with ``xattn`` attends to densely (no mask), as in JAX."""
    zero = x.new_zeros((), dtype=torch.float32)
    aux = {"load_balance": zero, "router_z": zero}
    h = apply_norm(p["norm1"], x, cfg.norm)
    window = cfg.window if kind in ("swa", "local") else None
    if kind in ATTN_KINDS and mode == "decode":
        mix, kv = blocks.apply_attention_decode(p["attn"], h, cfg,
                                                cache["kv"], window=window)
        st = {"kv": kv}
    elif kind in ATTN_KINDS:
        mix, (k, v) = blocks.apply_attention(
            p["attn"], h, cfg, causal=not cfg.bidirectional_attn,
            window=window, positions=positions, impl=attn_impl)
        st = {"kv": {"k": k, "v": v}}
    elif kind == "rglru":
        mix, rec = blocks.apply_rglru_block(
            p["rglru"], h, cfg, cache=cache and cache.get("rglru"))
        st = {"rglru": rec}
    elif kind in ("mlstm", "slstm"):
        apply = blocks.apply_mlstm if kind == "mlstm" else blocks.apply_slstm
        mix, rec = apply(p["mix"], h, cfg, cache=cache and cache.get(kind))
        st = {kind: rec}
    elif kind == "reservoir":
        mix, res = blocks.apply_reservoir(p["res"], h, cfg,
                                          cache=cache and cache.get("res"))
        st = {"res": res}
    else:
        raise ValueError(kind)
    x = x + mix
    if "xattn" in p and enc_kv is not None:
        # Per-layer K/V projections over the raw encoder states.
        xa = p["xattn"]
        hx = apply_norm(p["norm_x"], x, cfg.norm)
        q = blocks.einsum("bsd,dhk->bhsk", hx, xa["wq"])
        k = blocks.einsum("bsd,dhk->bhsk", enc_kv, xa["wk"])
        v = blocks.einsum("bsd,dhk->bhsk", enc_kv, xa["wv"])
        o = attn_mod.attention(q, k, v, causal=False, impl="dense")
        x = x + blocks.einsum("bhsk,hkd->bsd", o, xa["wo"])
    if "norm2" in p:
        h2 = apply_norm(p["norm2"], x, cfg.norm)
        ff = None
        if "moe" in p:
            ff, aux = blocks.apply_moe(p["moe"], h2, cfg, prof)
        if "mlp" in p:
            mlp = blocks.apply_mlp(p["mlp"], h2, cfg.act,
                                   gated=cfg.act != "gelu")
            ff = mlp if ff is None else ff + mlp
        x = x + ff
    return x, st, aux


# --------------------------------------------------------------------------- #
# Whole-model init                                                             #
# --------------------------------------------------------------------------- #
def _encoder_cfg(cfg):
    """The config the JAX package builds and runs the encoder under:
    bidirectional attention, no RoPE (learned positions), no experts."""
    return dataclasses.replace(cfg, n_layers=cfg.encoder_layers,
                               bidirectional_attn=True, rope_theta=0.0,
                               block_pattern=("attn",), n_experts=0)


def _stack(layers):
    return tree_map(lambda *xs: torch.stack(xs), *layers)


def init_params(gen: torch.Generator, cfg, device=None):
    """Random parameters drawn from the CPU generator ``gen`` (so a seed
    gives the same weights on every device), then moved to ``device``
    (``None``: the GPU).  An encoder-decoder also gets ``encoder``
    (``layers``, stacked, ``final_norm``, ``pos`` (encoder_seq, d)) and the
    decoder's learned positions ``dec_pos`` (max_position, d)."""
    dev = resolve_device(device)
    check_ported(cfg)
    dtype = blocks.torch_dtype(cfg.dtype)
    p = {"embed": (torch.randn((cfg.vocab, cfg.d_model), generator=gen)
                   * 0.02).to(dtype)}
    kinds = layer_kinds(cfg)
    layers = [init_layer(gen, cfg, k, dtype, cross=cfg.is_encoder_decoder)
              for k in kinds]
    if _is_homogeneous(cfg):
        p["layers"] = _stack(layers)
    else:
        p["layers"] = {f"layer_{i}": lp for i, lp in enumerate(layers)}
    p["final_norm"] = init_norm(cfg.d_model, dtype, cfg.norm)
    if not cfg.tie_embeddings:
        p["head"] = (torch.randn((cfg.d_model, cfg.vocab), generator=gen)
                     * 0.02).to(dtype)
    if cfg.is_encoder_decoder:
        ecfg = _encoder_cfg(cfg)
        p["encoder"] = {
            "layers": _stack([init_layer(gen, ecfg, "attn", dtype)
                              for _ in range(cfg.encoder_layers)]),
            "final_norm": init_norm(cfg.d_model, dtype, cfg.norm),
            "pos": (torch.randn((cfg.encoder_seq, cfg.d_model),
                                generator=gen) * 0.02).to(dtype)}
        p["dec_pos"] = (torch.randn((cfg.max_position, cfg.d_model),
                                    generator=gen) * 0.02).to(dtype)
    return tree_map(lambda v: v.to(dev), p)


def lm_params_from_numpy(tree, device=None):
    """The port's tree of a nested dict of numpy arrays (the JAX
    ``init_params`` output, or any state tree, taken through ``np.asarray``):
    same keys, values and dtypes, on ``device`` (``None``: the GPU)."""
    dev = resolve_device(device)

    def one(v):
        arr = np.asarray(v)
        if arr.dtype.name == "bfloat16":      # ml_dtypes: no numpy bridge
            return torch.from_numpy(arr.astype(np.float32)).to(
                dev, torch.bfloat16)
        return torch.tensor(arr, device=dev)
    return tree_map(one, tree)


# --------------------------------------------------------------------------- #
# Forward passes                                                               #
# --------------------------------------------------------------------------- #
def _embed_scale(cfg, x):
    """With ``embed_scale``, ``x`` times sqrt(d_model) as a float32 scalar.
    JAX scales by a numpy float32, which is not weakly typed: bfloat16
    embeddings become float32 there, and so here."""
    if not cfg.embed_scale:
        return x
    return x.to(torch.promote_types(x.dtype, torch.float32)) * float(
        np.sqrt(cfg.d_model).astype(np.float32))


def _embed_tokens(p, cfg, tokens, prof):
    """The embeddings of ``tokens``, scaled (:func:`_embed_scale`)."""
    return _embed_scale(cfg, constrain(p["embed"][tokens.long()], None, prof))


def _layer(tree, cfg, i):
    """Layer ``i``'s slice of a stacked (homogeneous) or per-layer tree."""
    if _is_homogeneous(cfg):
        return tree_map(lambda v: v[i], tree)
    return tree[f"layer_{i}"]


def _collect(cfg, caches):
    if _is_homogeneous(cfg):
        return tree_map(lambda *xs: torch.stack(xs), *caches)
    return {f"layer_{i}": c for i, c in enumerate(caches)}


def _stack_forward(p, x, cfg, prof=NULL_PROFILE, *, mode, positions=None,
                   enc_kv=None, attn_impl="auto", remat=False):
    """Full-sequence stack (train / prefill), one layer after another.
    Caches come back in prefill mode only (training keeps no per-layer KV);
    ``remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``) instead of keeping its activations."""
    caches, auxes = [], []
    for i, kind in enumerate(layer_kinds(cfg)):
        lp = _layer(p["layers"], cfg, i)

        def run(x, lp=lp, kind=kind):
            return apply_layer(lp, x, cfg, kind, prof, mode=mode,
                               positions=positions, enc_kv=enc_kv,
                               attn_impl=attn_impl)
        if remat:
            x, nc, aux = checkpoint(run, x, use_reentrant=False)
        else:
            x, nc, aux = run(x)
        x = constrain(x, None, prof)
        if mode == "prefill":
            caches.append(nc)
        auxes.append(aux)
    aux = {k: torch.stack([a[k] for a in auxes]).mean() for k in auxes[0]}
    return x, (_collect(cfg, caches) if mode == "prefill" else None), aux


def encode(p, cfg, frames, prof=NULL_PROFILE, attn_impl="auto"):
    """The whisper-style encoder over precomputed frame embeddings
    ``frames`` (B, T, d): learned positions, then the bidirectional layer
    stack (its attention through flash from 1024 frames, as ``"auto"``
    picks), then its final norm."""
    x = frames + p["encoder"]["pos"][None, :frames.shape[1]]
    ecfg = _encoder_cfg(cfg)
    for i in range(cfg.encoder_layers):
        lp = tree_map(lambda v: v[i], p["encoder"]["layers"])
        x, _, _ = apply_layer(lp, x, ecfg, "attn", prof, mode="train",
                              attn_impl=attn_impl)
    return apply_norm(p["encoder"]["final_norm"], x, cfg.norm)


def forward(p, cfg, batch, prof: ShardProfile = NULL_PROFILE, *,
            mode="train", attn_impl="auto", remat=False):
    """Full-sequence forward.  ``batch``: ``{"tokens": (B, S)}``, or
    ``{"embeds": (B, S, d)}`` for a config with ``input_mode ==
    "embeddings"``, plus ``{"frames": (B, T, d)}`` for an encoder-decoder.
    Returns ``(logits (B, S, V), caches, aux)``.  ``attn_impl``:
    ``"auto"`` (dense below 1024 keys, else the flash kernel), ``"dense"``
    or ``"flash"``."""
    if cfg.input_mode == "embeddings" and "embeds" in batch:
        x = _embed_scale(cfg, batch["embeds"])
    else:
        x = _embed_tokens(p, cfg, batch["tokens"], prof)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    enc_kv = None
    if cfg.is_encoder_decoder:
        enc_kv = encode(p, cfg, batch["frames"], prof, attn_impl)
        x = x + p["dec_pos"][None, :s]
    x, new_caches, aux = _stack_forward(p, x, cfg, prof, mode=mode,
                                        positions=positions, enc_kv=enc_kv,
                                        attn_impl=attn_impl, remat=remat)
    x = apply_norm(p["final_norm"], x, cfg.norm)
    head = p["embed"].T if cfg.tie_embeddings else p["head"]
    return x @ head.to(x.dtype), new_caches, aux


def loss_fn(p, cfg, batch, prof=NULL_PROFILE, **kw):
    """Next-token cross-entropy (float32), plus the MoE aux losses."""
    logits, _, aux = forward(p, cfg, batch, prof, mode="train", **kw)
    if "labels" in batch:
        labels = batch["labels"].long()
    else:
        tokens = batch["tokens"].long()
        labels = torch.cat([tokens[:, 1:], tokens[:, :1] * 0], dim=1)
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None])[..., 0]
    nll = (logz - gold).mean()
    total = nll + 0.01 * aux["load_balance"] + 1e-4 * aux["router_z"]
    return total, {"nll": nll, **aux}


# --------------------------------------------------------------------------- #
# Decode                                                                       #
# --------------------------------------------------------------------------- #
def make_decode_cache(p, cfg, batch_size, max_len, dtype=None):
    """Empty decode caches on the params' device, shaped as
    :func:`_stack_forward` returns them, with a leading layer dimension for
    a homogeneous stack.  An attention layer gets ``{"kv": {"k", "v",
    "len"}}``: (B, Hkv, L, hd) in ``dtype`` (default the config's) and an
    int32 count of the valid entries, where L is ``max_len``, or the window
    for a ``swa``/``local`` layer (a ring buffer: O(window) memory however
    long the sequence).  A recurrent layer gets its carried state, as the
    JAX package's: ``{"rglru": {"conv": (B, W-1, d_rnn) in dtype, "h":
    (B, d_rnn) float32}}``, ``{"mlstm": {"C": (B, H, hd, hd), "n": (B, H,
    hd)}}``, ``{"slstm": {"c", "n", "m"}}`` (B, d) with ``m`` at -1e30, and
    a reservoir layer ``{"res": {"h_re", "h_im"}}`` (B, N), all float32."""
    check_ported(cfg)
    dev = p["embed"].device
    dtype = blocks.torch_dtype(dtype or cfg.dtype)
    homo = _is_homogeneous(cfg)
    lead = (cfg.n_layers,) if homo else ()

    def state(*shape, dtype=torch.float32, fill=0.0):
        return torch.full(lead + (batch_size,) + shape, fill, dtype=dtype,
                          device=dev)

    def one(kind):
        if kind in ATTN_KINDS:
            eff_len = max_len
            if cfg.window is not None and kind in ("swa", "local"):
                eff_len = min(max_len, cfg.window)
            shape = lead + (batch_size, cfg.n_kv, eff_len, cfg.head_dim)
            return {"kv": {"k": torch.zeros(shape, dtype=dtype, device=dev),
                           "v": torch.zeros(shape, dtype=dtype, device=dev),
                           "len": torch.zeros(lead, dtype=torch.int32,
                                              device=dev)}}
        if kind == "rglru":
            return {"rglru": {"conv": state(cfg.conv_width - 1, cfg.d_rnn,
                                            dtype=dtype),
                              "h": state(cfg.d_rnn)}}
        if kind == "mlstm":
            hd = cfg.d_model // cfg.n_heads
            return {"mlstm": {"C": state(cfg.n_heads, hd, hd),
                              "n": state(cfg.n_heads, hd)}}
        if kind == "slstm":
            return {"slstm": {"c": state(cfg.d_model), "n": state(cfg.d_model),
                              "m": state(cfg.d_model, fill=-1e30)}}
        n = cfg.d_rnn or cfg.d_model
        return {"res": {k: state(n) for k in ("h_re", "h_im")}}
    kinds = layer_kinds(cfg)
    if homo:
        return one(kinds[0])
    return {f"layer_{i}": one(k) for i, k in enumerate(kinds)}


def decode_step(p, cfg, cache, tokens, prof=NULL_PROFILE):
    """One token for every sequence.  ``tokens``: (B, 1).  Returns
    ``(logits (B, 1, V), cache)``.  As the JAX package's, an
    encoder-decoder decodes against an empty encoder context: no learned
    decoder position is added and no layer cross-attends (ROADMAP C8)."""
    x = _embed_tokens(p, cfg, tokens, prof)
    caches = []
    for i, kind in enumerate(layer_kinds(cfg)):
        x, nc, _ = apply_layer(_layer(p["layers"], cfg, i), x, cfg, kind,
                               prof, mode="decode",
                               cache=_layer(cache, cfg, i))
        caches.append(nc)
    x = apply_norm(p["final_norm"], x, cfg.norm)
    head = p["embed"].T if cfg.tie_embeddings else p["head"]
    return x @ head.to(x.dtype), _collect(cfg, caches)
