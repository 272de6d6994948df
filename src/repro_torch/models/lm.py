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
registered config is ported.

On a device mesh (a :class:`ShardProfile` over a ``DeviceMesh``, one rank a
device) the params are DTensors placed by :func:`param_specs` — JAX's
``init_params`` spec tree, leaf for leaf — through :func:`place_params`,
the batch by ``sharding.rules.batch_specs`` and the decode cache by
:func:`cache_specs`.  The forward constrains the residual stream and the
logits where JAX does, and also at each residual sum and block entry;
DTensor's sharding propagation does the rest, but for the lookup and the
loss, which are vocab-parallel ``local_map`` bodies here, as are the
blocks' head projections, attention and scans.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import dist, resolve_device
from ..tree import tree_map
from . import attention as attn_mod
from . import blocks
from .blocks import NULL_PROFILE, ShardProfile, apply_norm, constrain, init_norm

__all__ = ["MIXERS", "ATTN_KINDS", "layer_kinds", "check_ported",
           "ported_archs", "init_layer", "layer_specs", "apply_layer",
           "init_params", "param_specs", "place_params", "encode", "forward",
           "loss_fn", "make_decode_cache", "cache_specs", "decode_step",
           "lm_params_from_numpy", "NULL_PROFILE", "ShardProfile"]

MIXERS = ("attn", "swa", "local", "rglru", "mlstm", "slstm", "reservoir")
ATTN_KINDS = ("attn", "swa", "local")


def layer_kinds(cfg):
    pat = cfg.block_pattern
    return [pat[i % len(pat)] for i in range(cfg.n_layers)]


def _is_homogeneous(cfg):
    return len(set(layer_kinds(cfg))) == 1 and cfg.scan_layers


def check_ported(cfg, prof: ShardProfile = NULL_PROFILE) -> None:
    """Raise unless the port runs ``cfg`` under ``prof``: a ``ValueError``
    for a layer kind no package knows, for a profile naming an axis its
    mesh lacks, or for an MoE config whose experts do not split over the
    profile's tp axis (``blocks.check_moe_mesh``)."""
    other = sorted(set(layer_kinds(cfg)) - set(MIXERS))
    if other:
        raise ValueError(f"{cfg.name}: unknown mixer(s) {', '.join(other)}")
    if prof.mesh is not None:
        axes = dist.mesh_axes(prof.mesh)
        named = [prof.tp, prof.fsdp, prof.seq, *prof.dp]
        missing = [a for a in named if a is not None and a not in axes]
        if missing:
            raise ValueError(f"profile axes {missing} are not in the mesh "
                             f"{tuple(axes)}")
        if cfg.n_experts > 0:
            blocks.check_moe_mesh(cfg, prof)


def ported_archs():
    """Names of the registered configs the port runs (on one device or a
    mesh)."""
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
    # On a mesh whose residual stream is split over its sequence (SP),
    # each block gathers the sequence at its entry and its residual sum
    # scatters it again (Megatron's sequence parallelism); without SP
    # both constraints keep the stream's layout.
    whole = (prof.dp_spec, None, None)
    h = constrain(apply_norm(p["norm1"], x, cfg.norm), whole, prof)
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
            p["rglru"], h, cfg, cache=cache and cache.get("rglru"), prof=prof)
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
    # On a mesh each residual sum is reduced where it is made (JAX
    # constrains the stream at layer boundaries and XLA places the sums
    # inside; DTensor would otherwise carry a partial sum into the next
    # norm and products, and gather weights to meet it).
    res = (prof.dp_spec, prof.seq, None)
    x = constrain(x + mix, res, prof)
    if "xattn" in p and enc_kv is not None:
        # Per-layer K/V projections over the raw encoder states.
        xa = p["xattn"]
        hx = constrain(apply_norm(p["norm_x"], x, cfg.norm), whole, prof)
        q = blocks.heads_in("bsd,dhk->bhsk", hx, xa["wq"])
        k = blocks.heads_in("bsd,dhk->bhsk", enc_kv, xa["wk"])
        v = blocks.heads_in("bsd,dhk->bhsk", enc_kv, xa["wv"])
        o = attn_mod.attention(q, k, v, causal=False, impl="dense")
        x = constrain(x + blocks.heads_out(o, xa["wo"]), res, prof)
    if "norm2" in p:
        h2 = constrain(apply_norm(p["norm2"], x, cfg.norm), whole, prof)
        ff = None
        if "moe" in p:
            ff, aux = blocks.apply_moe(p["moe"], h2, cfg, prof)
        if "mlp" in p:
            mlp = blocks.apply_mlp(p["mlp"], h2, cfg.act,
                                   gated=cfg.act != "gelu")
            ff = mlp if ff is None else ff + mlp
        x = constrain(x + ff, res, prof)
    return x, st, aux


def layer_specs(cfg, kind, prof: ShardProfile, cross=False):
    """The specs of :func:`init_layer`'s tree, as the JAX ``init_layer``
    returns them."""
    s = {"norm1": blocks.norm_specs(cfg.norm)}
    if kind in ATTN_KINDS:
        s["attn"] = blocks.attention_specs(cfg, prof)
    elif kind == "rglru":
        s["rglru"] = blocks.rglru_specs(cfg, prof)
    elif kind == "mlstm":
        s["mix"] = blocks.mlstm_specs(cfg, prof)
    elif kind == "slstm":
        s["mix"] = blocks.slstm_specs(cfg, prof)
    elif kind == "reservoir":
        s["res"] = blocks.reservoir_specs(cfg, prof,
                                          n_state=cfg.d_rnn or cfg.d_model)
    else:
        raise ValueError(kind)
    if cross:
        s["norm_x"] = blocks.norm_specs(cfg.norm)
        s["xattn"] = blocks.attention_specs(cfg, prof)
    if cfg.d_ff > 0 or cfg.n_experts > 0:
        s["norm2"] = blocks.norm_specs(cfg.norm)
    if cfg.n_experts > 0:
        s["moe"] = blocks.moe_specs(cfg, prof)
        if cfg.dense_residual and cfg.d_ff > 0:
            s["mlp"] = blocks.mlp_specs(cfg.d_model, cfg.d_ff, prof,
                                        gated=cfg.act != "gelu")
    elif cfg.d_ff > 0:
        s["mlp"] = blocks.mlp_specs(cfg.d_model, cfg.d_ff, prof,
                                    gated=cfg.act != "gelu",
                                    bias=cfg.norm == "layernorm")
    return s


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
    decoder's learned positions ``dec_pos`` (max_position, d).  ``gen=None``
    with ``device="meta"``: the tree's shapes and dtypes only (JAX's
    ``eval_shape`` of the init; no memory, any config)."""
    dev = resolve_device(device)
    check_ported(cfg)
    dtype = blocks.torch_dtype(cfg.dtype)
    randn = functools.partial(blocks.randn, gen)
    p = {"embed": (randn((cfg.vocab, cfg.d_model)) * 0.02).to(dtype)}
    kinds = layer_kinds(cfg)
    layers = [init_layer(gen, cfg, k, dtype, cross=cfg.is_encoder_decoder)
              for k in kinds]
    if _is_homogeneous(cfg):
        p["layers"] = _stack(layers)
    else:
        p["layers"] = {f"layer_{i}": lp for i, lp in enumerate(layers)}
    p["final_norm"] = init_norm(cfg.d_model, dtype, cfg.norm)
    if not cfg.tie_embeddings:
        p["head"] = (randn((cfg.d_model, cfg.vocab)) * 0.02).to(dtype)
    if cfg.is_encoder_decoder:
        ecfg = _encoder_cfg(cfg)
        p["encoder"] = {
            "layers": _stack([init_layer(gen, ecfg, "attn", dtype)
                              for _ in range(cfg.encoder_layers)]),
            "final_norm": init_norm(cfg.d_model, dtype, cfg.norm),
            "pos": (randn((cfg.encoder_seq, cfg.d_model)) * 0.02).to(dtype)}
        p["dec_pos"] = (randn((cfg.max_position, cfg.d_model))
                        * 0.02).to(dtype)
    return tree_map(lambda v: v.to(dev), p)


def _lead_none(specs):
    """Specs of a stacked tree: a replicated leading layer dim."""
    return tree_map(lambda sp: (None, *sp), specs)


def param_specs(cfg, prof: ShardProfile = NULL_PROFILE):
    """The spec tree of :func:`init_params`'s tree: the second value of the
    JAX ``init_params``, leaf for leaf (vocab over tp for the embeddings
    and head, each block's rules from ``blocks.*_specs``, a replicated
    leading dim on a stacked layer tree)."""
    tp_v = blocks._tp_dim(prof, cfg.vocab)
    s = {"embed": (tp_v, None)}
    kinds = layer_kinds(cfg)
    cross = cfg.is_encoder_decoder
    if _is_homogeneous(cfg):
        s["layers"] = _lead_none(layer_specs(cfg, kinds[0], prof, cross))
    else:
        s["layers"] = {f"layer_{i}": layer_specs(cfg, k, prof, cross)
                       for i, k in enumerate(kinds)}
    s["final_norm"] = blocks.norm_specs(cfg.norm)
    if not cfg.tie_embeddings:
        s["head"] = (None, tp_v)
    if cfg.is_encoder_decoder:
        s["encoder"] = {
            "layers": _lead_none(layer_specs(_encoder_cfg(cfg), "attn",
                                             prof)),
            "final_norm": blocks.norm_specs(cfg.norm), "pos": (None, None)}
        s["dec_pos"] = (None, None)
    return s


def place_params(params, cfg, prof: ShardProfile):
    """``params`` (the same full tree on every rank) as DTensors on
    ``prof.mesh`` by :func:`param_specs` (``jax.device_put(params,
    p_sh)``); each rank keeps its own slices."""
    return dist.place(params, param_specs(cfg, prof), prof.mesh)


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
    """The embeddings of ``tokens``, scaled (:func:`_embed_scale`); on a
    mesh through :func:`_vocab_parallel_lookup`."""
    table, tokens = p["embed"], tokens.long()
    e = _vocab_parallel_lookup(table, tokens) if dist.is_dtensor(table) \
        else table[tokens]
    return _embed_scale(cfg, constrain(e, (prof.dp_spec, prof.seq, None),
                                       prof))


def _vocab_parallel_lookup(table, tokens):
    """``table[tokens]`` for a DTensor table split over its vocabulary: a
    ``local_map`` body in which each rank looks up the tokens in its own
    rows (zeros for the rest) and one sum over the vocab split completes
    the rows — DTensor's own ``embedding`` rule leaves a masked partial
    whose backward it cannot redistribute.  A rank's table gradient is
    exact on its rows, and partial over a batch split of the tokens."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    names = mesh.mesh_dim_names
    if not dist.is_dtensor(tokens):
        tokens = dist.place(tokens, (None,) * tokens.ndim, mesh)
    t_pl = [Shard(0) if p == Shard(0) else Replicate()
            for p in tokens.placements]
    w_pl = [Shard(0) if p == Shard(0) else Replicate()
            for p in table.placements]
    w_grad = [Shard(0) if w == Shard(0) else Partial() if t == Shard(0)
              else Replicate() for w, t in zip(w_pl, t_pl)]
    vocab_axes = tuple(names[i] for i, p in enumerate(w_pl) if p == Shard(0))

    def local(table, tokens):
        v_loc = table.shape[0]
        idx = tokens - dist.block_index(mesh, vocab_axes) * v_loc
        mine = (idx >= 0) & (idx < v_loc)
        e = table[idx.clamp(0, v_loc - 1)]
        e = torch.where(mine[..., None], e, torch.zeros_like(e))
        return dist.psum(e, mesh, vocab_axes)

    run = local_map(local, out_placements=t_pl, in_placements=(w_pl, t_pl),
                    in_grad_placements=(w_grad, t_pl), device_mesh=mesh,
                    redistribute_inputs=True)
    return run(table, tokens)


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
        x = constrain(x, (prof.dp_spec, prof.seq, None), prof)
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
    with dist.mesh_context(prof.mesh):
        return _forward(p, cfg, batch, prof, mode=mode, attn_impl=attn_impl,
                        remat=remat)


def _forward(p, cfg, batch, prof, *, mode, attn_impl, remat):
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
    logits = constrain(x @ head.to(x.dtype), (
        prof.dp_spec, None, blocks._tp_dim(prof, cfg.vocab)), prof)
    return logits, new_caches, aux


def loss_fn(p, cfg, batch, prof=NULL_PROFILE, **kw):
    """Next-token cross-entropy (float32), plus the MoE aux losses."""
    with dist.mesh_context(prof.mesh):
        return _loss(p, cfg, batch, prof, **kw)


def _loss(p, cfg, batch, prof, **kw):
    logits, _, aux = forward(p, cfg, batch, prof, mode="train", **kw)
    if "labels" in batch:
        labels = batch["labels"].long()
    else:
        tokens = batch["tokens"].long()
        labels = torch.cat([tokens[:, 1:], tokens[:, :1] * 0], dim=1)
    nll = _token_nll(logits.float(), labels).mean()
    total = nll + 0.01 * aux["load_balance"] + 1e-4 * aux["router_z"]
    return total, {"nll": nll, **aux}


def _token_nll(lf, labels):
    """``logsumexp(lf) - lf[labels]`` per token (B, S).  On a mesh it is a
    ``local_map`` body, vocab-parallel as Megatron's cross-entropy: each
    rank takes its slice's max, exp-sum and the labels that fall in its
    slice, and one max and two sums over the vocab split complete them —
    the logits are never gathered (DTensor's ``logsumexp`` rule gathers
    the vocab, and its ``gather`` rule leaves a masked partial that it
    then fails to reduce)."""
    if not dist.is_dtensor(lf):
        return torch.logsumexp(lf, dim=-1) - torch.gather(
            lf, -1, labels[..., None])[..., 0]
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = lf.device_mesh
    names = mesh.mesh_dim_names
    lf_pl = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
             for p in lf.placements]
    rows = [Shard(0) if p == Shard(0) else Replicate() for p in lf_pl]
    vocab_axes = tuple(names[i] for i, p in enumerate(lf_pl)
                       if p == Shard(2))

    def local(lf, labels):
        v_loc = lf.shape[-1]
        m = dist.pmax(lf.detach().amax(-1, keepdim=True), mesh, vocab_axes)
        logz = m[..., 0] + torch.log(dist.psum(
            torch.exp(lf - m).sum(-1), mesh, vocab_axes))
        idx = labels - dist.block_index(mesh, vocab_axes) * v_loc
        mine = (idx >= 0) & (idx < v_loc)
        g = torch.gather(lf, -1, idx.clamp(0, v_loc - 1)[..., None])[..., 0]
        return logz - dist.psum(torch.where(mine, g, 0.0), mesh, vocab_axes)

    run = local_map(local, out_placements=rows,
                    in_placements=(lf_pl, rows), device_mesh=mesh,
                    redistribute_inputs=True)
    return run(lf, labels)


# --------------------------------------------------------------------------- #
# Decode                                                                       #
# --------------------------------------------------------------------------- #
def make_decode_cache(p, cfg, batch_size, max_len, prof=NULL_PROFILE,
                      dtype=None):
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
    a reservoir layer ``{"res": {"h_re", "h_im"}}`` (B, N), all float32.
    On a mesh (``prof``) each leaf is a DTensor placed by
    :func:`cache_specs`, each rank allocating only its own slice."""
    check_ported(cfg, prof)
    dev = p["embed"].device
    dtype = blocks.torch_dtype(dtype or cfg.dtype)
    f32 = torch.float32
    lead = (cfg.n_layers,) if _is_homogeneous(cfg) else ()

    def layout(kind):
        """Each leaf's (shape after the batch dim, or None for a count;
        dtype; fill)."""
        if kind in ATTN_KINDS:
            eff_len = max_len
            if cfg.window is not None and kind in ("swa", "local"):
                eff_len = min(max_len, cfg.window)
            kv = ((cfg.n_kv, eff_len, cfg.head_dim), dtype, 0.0)
            return {"kv": {"k": kv, "v": kv, "len": (None, torch.int32, 0)}}
        if kind == "rglru":
            return {"rglru": {"conv": ((cfg.conv_width - 1, cfg.d_rnn),
                                       dtype, 0.0),
                              "h": ((cfg.d_rnn,), f32, 0.0)}}
        if kind == "mlstm":
            hd = cfg.d_model // cfg.n_heads
            return {"mlstm": {"C": ((cfg.n_heads, hd, hd), f32, 0.0),
                              "n": ((cfg.n_heads, hd), f32, 0.0)}}
        if kind == "slstm":
            d = ((cfg.d_model,), f32, 0.0)
            return {"slstm": {"c": d, "n": d,
                              "m": ((cfg.d_model,), f32, -1e30)}}
        n = ((cfg.d_rnn or cfg.d_model,), f32, 0.0)
        return {"res": {"h_re": n, "h_im": n}}

    def make(leaf, spec):
        shape, dt, fill = leaf
        shape = lead if shape is None else lead + (batch_size,) + shape
        if prof.mesh is None or dev.type == "meta":
            t = torch.full(shape, fill, dtype=dt, device=dev)
            return t if prof.mesh is None else dist.place(t, spec, prof.mesh)
        from torch.distributed.tensor import full
        return full(shape, fill, dtype=dt, device_mesh=prof.mesh,
                    placements=dist.spec_placements(
                        spec, prof.mesh.mesh_dim_names))

    kinds = layer_kinds(cfg)
    layouts = layout(kinds[0]) if lead else {
        f"layer_{i}": layout(k) for i, k in enumerate(kinds)}
    return tree_map(make, layouts, cache_specs(cfg, prof))


def cache_specs(cfg, prof: ShardProfile = NULL_PROFILE):
    """The spec tree of :func:`make_decode_cache`'s tree (JAX's
    ``cache_specs``): batch over dp; attention KV split over its
    *sequence* on tp (flash-decoding); recurrent state over tp where it
    divides; a replicated leading dim on a stacked tree."""
    tp, dp = prof.tp, prof.dp_spec

    def one(kind):
        if kind in ATTN_KINDS:
            kv = (dp, None, tp, None)
            return {"kv": {"k": kv, "v": kv, "len": ()}}
        if kind == "rglru":
            tp_r = blocks._tp_dim(prof, cfg.d_rnn)
            return {"rglru": {"conv": (dp, None, tp_r), "h": (dp, tp_r)}}
        if kind == "mlstm":
            tp_h = blocks._tp_dim(prof, cfg.n_heads)
            return {"mlstm": {"C": (dp, tp_h, None, None),
                              "n": (dp, tp_h, None)}}
        if kind == "slstm":
            sp = (dp, blocks._tp_dim(prof, cfg.d_model))
            return {"slstm": {"c": sp, "n": sp, "m": sp}}
        sp = (dp, blocks._tp_dim(prof, cfg.d_rnn or cfg.d_model))
        return {"res": {"h_re": sp, "h_im": sp}}

    kinds = layer_kinds(cfg)
    if _is_homogeneous(cfg):
        return _lead_none(one(kinds[0]))
    return {f"layer_{i}": one(k) for i, k in enumerate(kinds)}


def decode_step(p, cfg, cache, tokens, prof=NULL_PROFILE):
    """One token for every sequence.  ``tokens``: (B, 1).  Returns
    ``(logits (B, 1, V), cache)``.  As the JAX package's, an
    encoder-decoder decodes against an empty encoder context: no learned
    decoder position is added and no layer cross-attends (ROADMAP C8)."""
    with dist.mesh_context(prof.mesh):
        return _decode_step(p, cfg, cache, tokens, prof)


def _decode_step(p, cfg, cache, tokens, prof):
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
