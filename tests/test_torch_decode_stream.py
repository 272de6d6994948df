"""B2's streamed route (``csrc/decode_stream.cu``) on the CPU: its layout
rule, and the plain version and the engine past D = 128 against the JAX
package.

``decode_stream_layout`` gives a layout exactly where ``decode_layout``
raises for a shape (``decode_plan`` takes it there, and ``decode_layout``'s
elsewhere), within the blocks the card holds at once, and ``decode_route``
on CUDA says ``"fused"`` at every ``off`` and ``mean`` shape.  Its mode is
resident exactly where a block's share fits the card's shared memory, and
every forced mode, segment count and round count still covers every row
and lane.  The plain
version the route is held against on the card (``ref.
decode_fused_packed_ref``) agrees with the JAX funnel's plain route and its
kernel in interpret mode at D = 136 and 200, float64, 1e-12 (the same
arithmetic summed in another order), and the port's engine with 136
outputs fed back agrees with the JAX engine at 1e-9 x max(|ref|, 1)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as jdispatch
from repro.core import esn as jesn
from repro.core import params as jparams
from repro.serve.engine import ReservoirEngine as JaxEngine
from repro_torch.core import params as tparams
from repro_torch.data.signals import mso_series
from repro_torch.kernels import ref as tref
from repro_torch.kernels.diag_scan import (DECODE_MAX_SMEM_BYTES,
                                          DECODE_STREAM_MAX_BLOCKS,
                                          DECODE_STREAM_MODES,
                                          DECODE_STREAM_ONE_ROUND,
                                          DECODE_STREAM_THREADS,
                                          DecodeStreamLayout, _stream_smem,
                                          decode_layout, decode_plan,
                                          decode_stream_layout)
from repro_torch.serve import arena as tarena
from repro_torch.serve.engine import ReservoirEngine

F64 = dict(rtol=1e-12, atol=1e-12)

#: (B, NC, D) of the shapes the card raised on before the route (n = 3000
#: to 6000 at D = 40 / 64 with 8 or 16 slots, n = 2048 at D = 128, D past
#: 128, 80000 lanes, mean members past the grid's 1056) and shapes that
#: keep ``decode_layout``'s layouts.
SHAPES = [(8, 1537, 64), (16, 1537, 64), (8, 2050, 64), (8, 2562, 64),
          (16, 2562, 64), (8, 3075, 40), (8, 1049, 128), (8, 525, 129),
          (8, 525, 256), (4, 48, 512), (2, 80000, 1), (1100, 525, 1),
          (2048, 525, 1), (2048, 80000, 512), (8, 525, 1), (1, 4609, 1),
          (128, 525, 1), (8, 525, 64), (17, 4133, 2)]
#: (B, NC, D) where a block's rows' y and readouts do not fit its shared
#: memory beside its lanes (many rows a block, or a wide D), where not one
#: lane's operands fit a ring tile (the direct mode), and a mean of
#: millions of members: the route has a layout at each.
LIMIT_SHAPES = [(8, 525, 1500), (16384, 64, 100), (16384, 525, 100),
                (8, 525, 5000), (1, 64, 20000), (3300000, 1, 1)]


def _covers(lay, b, nc, d, itemsize=8, batched=False):
    """The layout covers every row and lane with at most
    DECODE_STREAM_MAX_BLOCKS blocks, its thread groups divide the block,
    and its shared memory is what its mode takes, within the card's."""
    assert isinstance(lay, DecodeStreamLayout) and lay.streamed
    assert lay.blocks == lay.groups * lay.segs <= DECODE_STREAM_MAX_BLOCKS
    assert lay.groups * lay.rows >= b > (lay.groups - 1) * lay.rows
    assert lay.segs * lay.lanes >= nc > (lay.segs - 1) * lay.lanes
    t = lay.threads
    assert t == DECODE_STREAM_THREADS
    assert t % lay.qa == 0 and t % lay.qb == 0 and lay.qa <= d
    assert t // lay.qb >= min(d, t)          # a chunk of outputs spans D
    assert lay.mode in DECODE_STREAM_MODES and lay.rounds in (1, 2)
    if lay.mode == "resident":
        assert lay.tile == lay.lanes and lay.state_on_chip
    else:
        assert 1 <= lay.tile <= lay.lanes
    assert lay.smem == _stream_smem(lay.rows, lay.lanes, d, itemsize,
                                    batched, lay.mode, lay.tile,
                                    lay.state_on_chip, lay.y_on_chip, t)
    assert lay.smem <= DECODE_MAX_SMEM_BYTES


@pytest.mark.parametrize("per_slot", [False, True], ids=["shared", "per_slot"])
@pytest.mark.parametrize("ensemble", ["off", "mean"])
@pytest.mark.parametrize("itemsize", [8, 4], ids=["f64", "f32"])
@pytest.mark.parametrize("b,nc,d", SHAPES)
def test_stream_layout_exactly_where_decode_layout_raises(b, nc, d, itemsize,
                                                          ensemble, per_slot):
    """Where ``decode_layout`` has a layout ``decode_plan`` keeps it; where
    it raises for the shape ``decode_plan`` is the streamed layout, which
    covers every row and lane with at most DECODE_STREAM_MAX_BLOCKS blocks;
    ``decode_route`` on CUDA is ``"fused"`` either way."""
    kw = dict(ensemble=ensemble, batched=per_slot)
    try:
        lay = decode_layout(b, nc, d, itemsize, **kw)
    except ValueError as e:
        assert "fits" in str(e) or "1 <= D <= 128" in str(e)
        lay = None
    plan = decode_plan(b, nc, d, itemsize, **kw)
    stream = decode_stream_layout(b, nc, d, itemsize, **kw)
    _covers(stream, b, nc, d, itemsize, per_slot)
    assert plan == (stream if lay is None else lay)
    assert plan.streamed == (lay is None)
    for dev in ("cuda", "cpu"):
        assert tarena.decode_route(b, nc, d, itemsize, dev, ensemble=ensemble,
                                   per_slot=per_slot) == "fused"
    assert tarena.decode_route(b, nc, d, itemsize, "cuda",
                               ensemble="weighted",
                               per_slot=per_slot) == "step"


@pytest.mark.parametrize("per_slot", [False, True], ids=["shared", "per_slot"])
@pytest.mark.parametrize("ensemble", ["off", "mean"])
@pytest.mark.parametrize("itemsize", [8, 4], ids=["f64", "f32"])
@pytest.mark.parametrize("b,nc,d", SHAPES)
def test_stream_mode_resident_exactly_where_it_fits(b, nc, d, itemsize,
                                                    ensemble, per_slot):
    """The rule's mode is resident exactly where a block's share (its
    lanes' operands, its rows' state, the fixed buffers) fits
    DECODE_MAX_SMEM_BYTES, its rows' y in shared memory exactly where it
    fits beside them; forcing another mode covers the rows and lanes too
    (forcing resident where it does not fit raises, naming the bytes);
    one round exactly where a block's own sums read at most
    DECODE_STREAM_ONE_ROUND partials; forced segments and rounds cover."""
    kw = dict(ensemble=ensemble, batched=per_slot)
    lay = decode_stream_layout(b, nc, d, itemsize, **kw)

    def resident(y_on):
        return _stream_smem(lay.rows, lay.lanes, d, itemsize, per_slot,
                            "resident", lay.lanes, True, y_on,
                            lay.threads) <= DECODE_MAX_SMEM_BYTES
    fits = resident(False)
    assert (lay.mode == "resident") == fits
    if fits:
        assert lay.y_on_chip == resident(True)
    reads = (lay.blocks if ensemble == "mean" else lay.segs * lay.rows) * d
    assert (lay.rounds == 1) == (reads <= DECODE_STREAM_ONE_ROUND)
    streamed = decode_stream_layout(b, nc, d, itemsize, mode="streamed", **kw)
    _covers(streamed, b, nc, d, itemsize, per_slot)
    assert streamed.mode == "streamed"
    assert streamed[:5] == lay[:5]
    if fits:
        assert decode_stream_layout(b, nc, d, itemsize, mode="resident",
                                    **kw) == lay
    else:
        with pytest.raises(ValueError, match="resident mode needs"):
            decode_stream_layout(b, nc, d, itemsize, mode="resident", **kw)
    for forced in (dict(rounds=1), dict(rounds=2),
                   dict(segs=max(1, lay.segs // 3)),
                   dict(segs=1, mode="streamed"),
                   dict(mode="direct")):
        other = decode_stream_layout(b, nc, d, itemsize, **forced, **kw)
        _covers(other, b, nc, d, itemsize, per_slot)
        for key, v in forced.items():
            assert getattr(other, key) == v or key == "segs"


@pytest.mark.parametrize("per_slot", [False, True], ids=["shared", "per_slot"])
@pytest.mark.parametrize("ensemble", ["off", "mean"])
@pytest.mark.parametrize("itemsize", [8, 4], ids=["f64", "f32"])
@pytest.mark.parametrize("b,nc,d", LIMIT_SHAPES)
def test_stream_layout_at_every_shape(b, nc, d, itemsize, ensemble,
                                      per_slot):
    """Past a block's shared memory for the rows' y or for one lane's ring
    tile the route still has a layout (the rows' y in the global scratch,
    or the operands read directly), within the card's shared memory, and
    ``decode_route`` on CUDA is ``"fused"``: only device memory bounds it."""
    kw = dict(ensemble=ensemble, batched=per_slot)
    lay = decode_stream_layout(b, nc, d, itemsize, **kw)
    _covers(lay, b, nc, d, itemsize, per_slot)
    for mode in ("streamed", "direct"):
        try:
            forced = decode_stream_layout(b, nc, d, itemsize, mode=mode, **kw)
        except ValueError as e:
            assert mode == "streamed" and lay.mode == "direct", e
            continue
        _covers(forced, b, nc, d, itemsize, per_slot)
    assert tarena.decode_route(b, nc, d, itemsize, "cuda", ensemble=ensemble,
                               per_slot=per_slot) == "fused"


def test_stream_layout_rule():
    """The rule's choices at the card's shapes: path 23 (8 shared rows of
    2562 lanes, D = 64) one row group over every SM the lanes allow,
    resident, two rounds; per-slot rows one a group, streamed past shared
    memory with the state on chip, one round (16 segments of 64 outputs);
    1100 mean members 9 rows a group; 80000 lanes one round; the rows' y in the global scratch where it does
    not fit (D = 1500; 16384 mean members at D = 100); direct past one
    lane's ring tile (D = 5000); ``segs``, ``mode`` and ``rounds`` force
    (S past the card too, refused at launch); nothing but an input no
    kernel takes raises."""
    def lay(*shape, **kw):
        return decode_stream_layout(*shape, **kw)[:13]
    assert lay(8, 2562, 64, 8) == (129, 1, 8, 129, 20, 8, 4, "resident", 20,
                                   True, True, 2, 84864)
    assert lay(8, 2562, 64, 8, batched=True) == (
        128, 8, 1, 16, 161, 4, 4, "streamed", 41, True, True, 1, 205624)
    assert lay(8, 2562, 64, 4, batched=True)[7] == "resident"
    assert lay(16, 2562, 64, 8, ensemble="mean", batched=True) == (
        128, 16, 1, 8, 321, 4, 4, "streamed", 46, True, True, 2, 228824)
    assert lay(1100, 525, 1, 8, ensemble="mean", batched=True) == (
        123, 123, 9, 1, 525, 1, 256, "streamed", 525, True, True, 1, 158984)
    assert lay(2, 80000, 1, 8) == (132, 1, 2, 132, 607, 1, 256, "resident",
                                   607, True, True, 1, 81376)
    assert lay(8, 525, 256, 8)[5:8] == (64, 1, "resident")
    assert lay(2048, 80000, 512, 8, batched=True)[7:11] == ("streamed", 6,
                                                            False, False)
    assert lay(8, 525, 1500, 8)[7:11] == ("resident", 4, True, False)
    assert lay(16384, 64, 100, 8, ensemble="mean")[7:11] == (
        "streamed", 22, False, False)
    assert lay(16384, 525, 100, 8, ensemble="mean", batched=True)[7:11] == (
        "streamed", 30, False, False)
    assert lay(8, 525, 5000, 8)[7:11] == ("direct", 4, True, False)
    # The exchange probe's shape: path 23's B and D, one lane a block.
    assert lay(8, 132, 64, 8)[:5] == (132, 1, 8, 132, 1)
    assert lay(8, 2562, 64, 8, mode="streamed")[7:9] == ("streamed", 20)
    assert lay(8, 2562, 64, 8, mode="direct")[7:11] == ("direct", 20, True,
                                                        True)
    assert lay(8, 2562, 64, 8, rounds=1)[11] == 1
    assert decode_stream_layout(2, 80000, 1, 8, segs=1000).blocks == 1000
    assert decode_stream_layout(2, 5, 1, 8, segs=1000).segs == 5
    for bad in (dict(d=0), dict(b=0), dict(nc=0), dict(segs=0),
                dict(ensemble="weighted"), dict(mode="cluster"),
                dict(rounds=3)):
        args = dict(b=2, nc=40, d=3, itemsize=8)
        args.update(bad)
        kw = {k: args.pop(k) for k in ("ensemble", "segs", "mode", "rounds")
              if k in args}
        with pytest.raises(ValueError):
            decode_stream_layout(*args.values(), **kw)
    with pytest.raises(ValueError, match="streamed mode needs"):
        decode_stream_layout(8, 525, 5000, 8, mode="streamed")
    with pytest.raises(ValueError, match="D >= 1"):
        tarena.decode_route(4, 64, 0, 8, "cuda")


def _packed_case(rng, b, nr, npairs, d, batched):
    """Packed Q operands ``(lam_q, w_drive, w_out, states, y_prev)`` with
    the bias and feedback rows, the feedback's gain below one."""
    n = nr + 2 * npairs
    lead = (b,) if batched else ()
    mag = rng.uniform(0.5, 0.95, lead + (npairs,))
    ph = rng.uniform(0, np.pi, lead + (npairs,))
    pairs = np.stack([mag * np.cos(ph), mag * np.sin(ph)], -1).reshape(
        lead + (2 * npairs,))
    lam = np.concatenate([rng.uniform(-0.9, 0.9, lead + (nr,)), pairs], -1)
    w_out = 0.1 * rng.normal(size=lead + (1 + d + n, d))
    w_out[..., 1:1 + d, :] *= 8.0 / d
    return (lam, 0.3 * rng.normal(size=lead + (d, n)), w_out,
            rng.normal(size=(b, n)), rng.normal(size=(b, d)))


@pytest.mark.parametrize("batched", [False, True], ids=["shared", "per_slot"])
@pytest.mark.parametrize("ensemble", ["off", "mean"])
@pytest.mark.parametrize("d", [136, 200])
def test_packed_plain_matches_jax_past_128_outputs(d, ensemble, batched):
    """n = 48 (8 real slots, 20 pairs), 4 slots, a partial mask, K = 4: the
    port's plain version against the JAX funnel's plain route and, at
    D = 136, its kernel in interpret mode (D padded to 256 there)."""
    rng = np.random.default_rng(d + 3 * batched)
    nr, b, k = 8, 4, 4
    ops = _packed_case(rng, b, nr, 20, d, batched)
    mask = np.array([True, False, True, True])
    kw = dict(use_bias=True, use_feedback=True, ensemble=ensemble)
    t = [torch.tensor(v) for v in ops]
    got = tref.decode_fused_packed_ref(t[0], nr, *t[1:], torch.tensor(mask),
                                       k=k, **kw)
    for method in ("ref", "pallas") if d == 136 else ("ref",):
        want = jdispatch.run_decode_fused(
            jnp.asarray(ops[0]), nr, *map(jnp.asarray, ops[1:] + (mask,)),
            k, method=method, **kw)
        for g, w in zip(got, want):
            assert g.shape == tuple(np.shape(w))
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **F64)
    np.testing.assert_array_equal(got[0][1].numpy(), ops[3][1])
    np.testing.assert_array_equal(got[1][1].numpy(), ops[4][1])


def test_engine_matches_jax_engine_past_128_outputs():
    """A closed loop of 136 outputs fed back (the card serves it through
    the streamed route): the port's engine against the JAX engine on the
    CPU, 4 slots of teacher-forced prompts then 16 closed-loop tokens,
    every stream and released state within 1e-9 x max(|ref|, 1)."""
    d, t = 136, 600
    sig = np.stack([mso_series(1 + i % 12, t + i)[i:] for i in range(d)], -1)
    jc = jparams.ESNConfig(n=48, d_in=d, d_out=d, leak=0.9,
                           input_scaling=0.5, use_feedback=True,
                           feedback_scaling=0.3, seed=4)
    jp = jesn.dpg_params(jc, sigma=0.1)
    jr = jesn.fit(jp, sig[:-1], sig[1:], washout=100)
    arrays = {k: np.asarray(getattr(jp, k))
              for k in ("lam_q", "win_q", "wfb_q", "qtq")}
    tp = tparams.params_from_numpy(jp.mode, arrays, dataclasses.asdict(jc),
                                   n_real=jp.n_real, device="cpu")
    tr = tparams.readout_from_numpy(np.asarray(jr.w_out), device="cpu")
    nc = (48 + int(jp.n_real)) // 2
    assert decode_plan(4, nc, d, 8).streamed

    def run(engine):
        rec = []
        for i in range(4):
            lo = 37 * i
            engine.submit(i, sig[lo:lo + 60], y_teacher=sig[lo + 1:lo + 61])
        engine.flush()
        ys = engine.decode_closed_loop(16)
        rec += [np.asarray(ys[s]) for s in sorted(ys)]
        for sid in range(4):
            rec += [np.asarray(v) for v in engine.release(sid)]
        return rec
    want = run(JaxEngine(jp, 4, readout=jr))
    got = run(ReservoirEngine(tp, 4, readout=tr, device="cpu"))
    assert len(got) == len(want) == 12
    assert want[0].shape == (16, d)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-9 * max(np.abs(w).max(), 1.0))
