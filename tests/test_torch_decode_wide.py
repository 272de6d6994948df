"""B2's layout rule past 8 outputs (the wide family, ``DM = 0`` in
``csrc/decode_fused.cu``), on the CPU: no card, no JAX.

``decode_layout`` has a layout at every shape the wide family is built
for, within the block's shared memory and its instantiation's thread
bound, and ``decode_route`` is ``"fused"`` there on CUDA; past the
limits it raises, naming them, and ``decode_plan`` takes B2's streamed
route there instead (``decode_route`` stays ``"fused"``); nothing steps.  Every D <= 8 shape keeps
the layout it had before the wide family (a list written from a run of the
rule on the tree before it).
"""
import pytest

from repro_torch.kernels.diag_scan import (DECODE_MAX_D,
                                          DECODE_MAX_GRID_CLUSTERS,
                                          DECODE_MAX_SMEM_BYTES,
                                          DECODE_NARROW_D,
                                          DECODE_WIDE_PER, decode_layout,
                                          decode_max_threads, decode_plan,
                                          decode_stream_layout)
from repro_torch.serve import arena as tarena

#: (NC, the largest D) of ``off`` at every B: n = 1024 (525 lanes) up to
#: 128 outputs, n = 2048 (1037) up to 64, n = 8192 (4133) up to 16.
OFF_LIMITS = ((525, 128), (1037, 64), (4133, 16))
#: (NC, the largest D, slots) of ``mean``: 16 members at n = 1024 up to 64
#: outputs, 8 at n = 4096 (2074 lanes) at 16.
MEAN_LIMITS = ((525, 64, 16), (2074, 16, 8))
DS = (9, 10, 15, 16, 17, 31, 32, 33, 48, 63, 64, 65, 100, 127, 128)


def _within(lay, d, itemsize):
    assert lay.wide and lay.per in DECODE_WIDE_PER
    assert lay.smem <= DECODE_MAX_SMEM_BYTES
    assert lay.threads <= decode_max_threads(lay.per, d, itemsize,
                                             lay.segs > 1 or lay.grid > 1,
                                             lay.grid > 1, True)
    assert lay.segs * 32 * lay.warps * lay.per >= 1


@pytest.mark.parametrize("per_slot", [False, True], ids=["shared", "per_slot"])
@pytest.mark.parametrize("itemsize", [8, 4], ids=["f64", "f32"])
def test_off_has_a_layout_at_every_wide_shape(itemsize, per_slot):
    for nc, top in OFF_LIMITS:
        for d in (d for d in DS if d <= top):
            lay = decode_layout(1, nc, d, itemsize, batched=per_slot)
            _within(lay, d, itemsize)
            assert lay.cluster == lay.segs <= 16
            assert -(-nc // lay.segs) <= 32 * lay.warps * lay.per
            for b in (8, 17, 4096):
                assert decode_layout(b, nc, d, itemsize,
                                     batched=per_slot) == lay
                assert tarena.decode_route(b, nc, d, itemsize, "cuda",
                                           per_slot=per_slot) == "fused"


@pytest.mark.parametrize("per_slot", [False, True], ids=["shared", "per_slot"])
@pytest.mark.parametrize("itemsize", [8, 4], ids=["f64", "f32"])
def test_mean_has_a_layout_at_every_wide_shape(itemsize, per_slot):
    for nc, top, slots in MEAN_LIMITS:
        for d in (d for d in DS if d <= top):
            for b in sorted({1, 2, 3, slots // 2, slots}):
                lay = decode_layout(b, nc, d, itemsize, ensemble="mean",
                                    batched=per_slot)
                _within(lay, d, itemsize)
                if lay.grid > 1:
                    assert lay.grid <= DECODE_MAX_GRID_CLUSTERS[
                        lay.cluster - 1]
                assert tarena.decode_route(
                    b, nc, d, itemsize, "cuda", ensemble="mean",
                    per_slot=per_slot) == "fused"


@pytest.mark.parametrize("itemsize", [8, 4], ids=["f64", "f32"])
def test_past_the_wide_limits_raises_naming_them(itemsize):
    """Past D = 128, past the lanes a cluster holds, past the slots a grid
    holds: ``decode_layout`` raises with the limit.  ``decode_route`` on
    CUDA is ``"fused"`` there all the same: the call runs B2's streamed
    route (``decode_plan``; it used to raise ``decode_layout``'s error).
    D = 0 no kernel takes, on either route."""
    for b, nc, d, kw, match in (
            (4, 64, DECODE_MAX_D + 1, {}, "1 <= D <= 128 outputs"),
            (4, 64, 0, {}, "1 <= D <= 128 outputs"),
            (1, 80000, 16, {}, r"NC <= \d+ fits"),
            (1, 80000, 16, dict(ensemble="mean"), r"B <= \d+ fits")):
        with pytest.raises(ValueError, match=match):
            decode_layout(b, nc, d, itemsize, **kw)
        if d < 1:
            with pytest.raises(ValueError, match="D >= 1"):
                tarena.decode_route(b, nc, d, itemsize, "cuda", **kw)
        else:
            assert decode_plan(b, nc, d, itemsize, **kw) == \
                decode_stream_layout(b, nc, d, itemsize, **kw)
            assert tarena.decode_route(b, nc, d, itemsize, "cuda",
                                       **kw) == "fused"
        assert tarena.decode_route(b, nc, d, itemsize, "cpu", **kw) == \
            "fused"
    with pytest.raises(ValueError, match="wide family only"):
        decode_layout(4, 64, 9, itemsize, wide=False)
    # The named limit is exact: it fits, one past it does not.
    for d in (16, 64, 128):
        with pytest.raises(ValueError) as err:
            decode_layout(1, 100000, d, itemsize)
        most = int(str(err.value).split("NC <= ")[1].split()[0])
        assert decode_layout(1, most, d, itemsize).wide
        with pytest.raises(ValueError):
            decode_layout(1, most + 1, d, itemsize)
    for nc, d in ((525, 64), (2074, 16)):
        with pytest.raises(ValueError) as err:
            decode_layout(5000, nc, d, itemsize, ensemble="mean",
                          batched=True)
        most = int(str(err.value).split("B <= ")[1].split()[0])
        assert decode_layout(most, nc, d, itemsize, ensemble="mean",
                             batched=True).wide
        with pytest.raises(ValueError):
            decode_layout(most + 1, nc, d, itemsize, ensemble="mean",
                          batched=True)


@pytest.mark.parametrize("per,itemsize,split,grid", [
    (1, 8, False, False), (12, 8, True, True), (1, 4, False, False),
    (4, 4, True, False), (12, 4, True, True)])
def test_decode_max_threads_of_the_wide_family(per, itemsize, split, grid):
    """The wide family's thread bound, 256 (at 512 float32 instantiations
    spilled), which ``csrc/decode_fused.cu`` repeats in its
    ``__launch_bounds__``; the same at D = 2 forced wide and at D > 8; and
    every wide layout takes an instantiated lanes-a-thread, at most 4
    under the rule (the family instantiates DECODE_WIDE_PER)."""
    assert decode_max_threads(per, 2, itemsize, split, grid, True) == 256
    assert decode_max_threads(per, 64, itemsize, split, grid) == 256
    for nc in (40, 525, 4133, 6000):
        lay = decode_layout(1, nc, 16, itemsize)
        assert lay.per in DECODE_WIDE_PER and lay.per <= 4


@pytest.mark.parametrize("ensemble", ["off", "mean"])
def test_the_wide_family_is_forced_only_where_asked(ensemble):
    """D <= 8 keeps its families unless ``wide=True`` asks for the wide one
    (to time it there); the forced layout fits the same limits."""
    for d in range(1, DECODE_NARROW_D + 1):
        assert not decode_layout(8, 2074, d, 8, ensemble=ensemble).wide
        lay = decode_layout(8, 2074, d, 8, ensemble=ensemble, wide=True)
        _within(lay, d, 8)


#: (B, NC, D, itemsize, ensemble, per-slot, the DecodeLayout fields of the
#: rule before the wide family: warps, per, copies, smem, threads, rows,
#: cluster, segs, grid), written from a run of ``decode_layout`` on that
#: tree.
NARROW_LAYOUTS = [
    (8, 525, 1, 8, 'off', False, (4, 5, 1, 30808, 128, 1, 1, 1, 1)),
    (8, 525, 1, 4, 'off', False, (4, 5, 1, 15404, 128, 1, 1, 1, 1)),
    (16, 525, 1, 8, 'off', False, (4, 5, 1, 30808, 128, 1, 1, 1, 1)),
    (16, 525, 1, 4, 'off', False, (4, 5, 1, 15404, 128, 1, 1, 1, 1)),
    (8, 1043, 1, 8, 'off', False, (8, 5, 1, 61592, 256, 1, 1, 1, 1)),
    (8, 1043, 1, 4, 'off', False, (8, 5, 1, 30796, 256, 1, 1, 1, 1)),
    (4, 4096, 1, 8, 'off', False, (8, 16, 1, 196760, 256, 1, 1, 1, 1)),
    (4, 4096, 1, 4, 'off', False, (8, 16, 1, 98380, 256, 1, 1, 1, 1)),
    (4, 525, 8, 8, 'off', False, (8, 3, 1, 210504, 256, 1, 1, 1, 1)),
    (4, 525, 8, 4, 'off', False, (8, 3, 1, 105252, 256, 1, 1, 1, 1)),
    (3, 40, 2, 8, 'off', False, (1, 2, 1, 5208, 32, 1, 1, 1, 1)),
    (3, 40, 2, 4, 'off', False, (1, 2, 1, 2604, 32, 1, 1, 1, 1)),
    (8, 8244, 1, 8, 'off', False, (16, 9, 1, 221744, 512, 1, 2, 2, 1)),
    (8, 8244, 1, 4, 'off', False, (16, 9, 1, 110880, 512, 1, 2, 2, 1)),
    (8, 4133, 2, 8, 'off', False, (8, 9, 1, 184912, 256, 1, 2, 2, 1)),
    (8, 4133, 2, 4, 'off', False, (16, 9, 1, 184604, 512, 1, 1, 1, 1)),
    (3, 4609, 1, 8, 'off', False, (8, 10, 1, 123184, 256, 1, 2, 2, 1)),
    (3, 4609, 1, 4, 'off', False, (16, 10, 1, 123020, 512, 1, 1, 1, 1)),
    (2, 8244, 8, 8, 'off', False, (8, 3, 1, 220840, 256, 1, 11, 11, 1)),
    (2, 8244, 8, 4, 'off', False, (8, 6, 1, 212296, 256, 1, 6, 6, 1)),
    (8, 2074, 2, 8, 'off', False, (8, 9, 1, 184632, 256, 1, 1, 1, 1)),
    (8, 2074, 2, 4, 'off', False, (8, 9, 1, 92316, 256, 1, 1, 1, 1)),
    (8, 525, 2, 8, 'off', False, (8, 3, 1, 61752, 256, 1, 1, 1, 1)),
    (8, 525, 2, 4, 'off', False, (8, 3, 1, 30876, 256, 1, 1, 1, 1)),
    (1, 73728, 1, 8, 'off', False, (16, 9, 1, 225440, 512, 1, 16, 16, 1)),
    (1, 73728, 1, 4, 'off', False, (16, 12, 1, 149064, 512, 1, 12, 12, 1)),
    (5, 64, 8, 8, 'off', False, (1, 2, 1, 18120, 32, 1, 1, 1, 1)),
    (5, 64, 8, 4, 'off', False, (1, 2, 1, 9060, 32, 1, 1, 1, 1)),
    (8, 525, 1, 8, 'mean', True, (2, 9, 1, 28000, 64, 1, 8, 1, 1)),
    (8, 525, 1, 8, 'mean', False, (2, 9, 1, 28000, 64, 1, 8, 1, 1)),
    (8, 525, 1, 4, 'mean', True, (2, 9, 1, 14008, 64, 1, 8, 1, 1)),
    (8, 525, 1, 4, 'mean', False, (2, 9, 1, 14008, 64, 1, 8, 1, 1)),
    (16, 525, 1, 8, 'mean', True, (2, 9, 1, 28320, 64, 1, 16, 1, 1)),
    (16, 525, 1, 8, 'mean', False, (2, 9, 1, 28320, 64, 1, 16, 1, 1)),
    (16, 525, 1, 4, 'mean', True, (2, 9, 1, 14168, 64, 1, 16, 1, 1)),
    (16, 525, 1, 4, 'mean', False, (2, 9, 1, 14168, 64, 1, 16, 1, 1)),
    (32, 525, 3, 8, 'mean', True, (2, 9, 2, 132560, 128, 2, 16, 1, 1)),
    (32, 525, 3, 8, 'mean', False, (2, 9, 1, 68048, 128, 2, 16, 1, 1)),
    (32, 525, 3, 4, 'mean', True, (2, 9, 2, 66288, 128, 2, 16, 1, 1)),
    (32, 525, 3, 4, 'mean', False, (2, 9, 1, 34032, 128, 2, 16, 1, 1)),
    (128, 525, 1, 8, 'mean', True, (2, 9, 8, 226448, 512, 8, 16, 1, 1)),
    (128, 525, 1, 8, 'mean', False, (2, 9, 1, 32912, 512, 8, 16, 1, 1)),
    (128, 525, 1, 4, 'mean', True, (2, 9, 8, 113232, 512, 8, 16, 1, 1)),
    (128, 525, 1, 4, 'mean', False, (2, 9, 1, 16464, 512, 8, 16, 1, 1)),
    (129, 525, 1, 8, 'mean', True, (2, 9, 8, 221944, 512, 8, 2, 1, 9)),
    (129, 525, 1, 8, 'mean', False, (2, 9, 1, 28408, 512, 8, 2, 1, 9)),
    (129, 525, 1, 4, 'mean', True, (2, 9, 8, 110980, 512, 8, 2, 1, 9)),
    (129, 525, 1, 4, 'mean', False, (2, 9, 1, 14212, 512, 8, 2, 1, 9)),
    (256, 525, 1, 8, 'mean', True, (2, 9, 8, 221984, 512, 8, 2, 1, 16)),
    (256, 525, 1, 8, 'mean', False, (2, 9, 1, 28448, 512, 8, 2, 1, 16)),
    (256, 525, 1, 4, 'mean', True, (2, 9, 8, 111000, 512, 8, 2, 1, 16)),
    (256, 525, 1, 4, 'mean', False, (2, 9, 1, 14232, 512, 8, 2, 1, 16)),
    (8, 8244, 1, 8, 'mean', True, (16, 9, 1, 225440, 512, 1, 16, 2, 1)),
    (8, 8244, 1, 8, 'mean', False, (16, 9, 1, 225440, 512, 1, 16, 2, 1)),
    (8, 8244, 1, 4, 'mean', True, (16, 9, 1, 112728, 512, 1, 16, 2, 1)),
    (8, 8244, 1, 4, 'mean', False, (16, 9, 1, 112728, 512, 1, 16, 2, 1)),
    (32, 2074, 1, 8, 'mean', True, (8, 9, 2, 225584, 512, 2, 16, 1, 1)),
    (32, 2074, 1, 8, 'mean', False, (8, 9, 1, 114992, 512, 2, 16, 1, 1)),
    (32, 2074, 1, 4, 'mean', True, (8, 9, 2, 112800, 512, 2, 16, 1, 1)),
    (32, 2074, 1, 4, 'mean', False, (8, 9, 1, 57504, 512, 2, 16, 1, 1)),
    (32, 4133, 2, 8, 'mean', True, (8, 9, 1, 184944, 256, 1, 2, 2, 32)),
    (32, 4133, 2, 8, 'mean', False, (8, 9, 1, 184944, 256, 1, 2, 2, 32)),
    (32, 4133, 2, 4, 'mean', True, (16, 9, 1, 184896, 512, 1, 2, 1, 16)),
    (32, 4133, 2, 4, 'mean', False, (16, 9, 1, 184896, 512, 1, 2, 1, 16)),
    (2, 8244, 8, 8, 'mean', True, (2, 12, 1, 212520, 64, 1, 11, 11, 2)),
    (2, 8244, 8, 8, 'mean', False, (2, 12, 1, 212520, 64, 1, 11, 11, 2)),
    (2, 8244, 8, 4, 'mean', True, (4, 12, 1, 212320, 128, 1, 12, 6, 1)),
    (2, 8244, 8, 4, 'mean', False, (4, 12, 1, 212320, 128, 1, 12, 6, 1)),
    (8, 2074, 2, 8, 'mean', True, (8, 9, 1, 186496, 256, 1, 8, 1, 1)),
    (8, 2074, 2, 8, 'mean', False, (8, 9, 1, 186496, 256, 1, 8, 1, 1)),
    (8, 2074, 2, 4, 'mean', True, (8, 9, 1, 93256, 256, 1, 8, 1, 1)),
    (8, 2074, 2, 4, 'mean', False, (8, 9, 1, 93256, 256, 1, 8, 1, 1)),
    (16, 525, 8, 8, 'mean', True, (2, 9, 1, 161488, 64, 1, 16, 1, 1)),
    (16, 525, 8, 8, 'mean', False, (2, 9, 1, 161488, 64, 1, 16, 1, 1)),
    (16, 525, 8, 4, 'mean', True, (2, 9, 1, 80752, 64, 1, 16, 1, 1)),
    (16, 525, 8, 4, 'mean', False, (2, 9, 1, 80752, 64, 1, 16, 1, 1)),
]


@pytest.mark.parametrize("b,nc,d,itemsize,ensemble,per_slot,fields",
                         NARROW_LAYOUTS)
def test_narrow_layouts_are_unchanged(b, nc, d, itemsize, ensemble, per_slot,
                                      fields):
    lay = decode_layout(b, nc, d, itemsize, ensemble=ensemble,
                        batched=per_slot)
    assert tuple(lay) == fields
    assert not lay.wide
