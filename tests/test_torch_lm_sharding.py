"""Port parity: the LM's sharding plans and spec trees (``sharding.rules``'s
LM half, ``lm.param_specs`` / ``cache_specs``), in one process with no
process group: both packages plan against a stand-in mesh that has only
axis names and sizes.

For every registered config on the meshes (1, 1), (2, 4), (16, 16) and
(2, 16, 16): ``make_profile`` and ``plan_cell`` (every ``CellPlan`` field,
for each of the config's shape cells), and the spec trees of the params,
the decode cache, the batch and the optimizer state (AdamW and Adafactor)
equal JAX's leaf for leaf, each spec tuple equal to ``tuple()`` of the
``PartitionSpec`` (a one-axis tuple entry and the bare axis name are the
same spec to both).  JAX's param specs come from ``rules.params_abstract``
(its ``eval_shape``, no memory) on the config cut to one block pattern in
depth; widths, and so every divisibility rule, are the config's own, and
the profile is planned from the full config.  ``dist.spec_placements`` is
checked on its own cases.
"""
import dataclasses
import types

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import REGISTRY as JREGISTRY
from repro.configs import shape_cells as jshape_cells
from repro.models import lm as jlm
from repro.sharding import rules as jrules
from repro.train import optimizer as jopt
from repro_torch import dist
from repro_torch.configs import REGISTRY, shape_cells
from repro_torch.models import lm
from repro_torch.sharding import rules
from repro_torch.train import optimizer as topt
from repro_torch.tree import flatten

MESHES = {"1x1": (("data", "model"), (1, 1)),
          "2x4": (("data", "model"), (2, 4)),
          "16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


def stand_in(name):
    """A mesh of names and sizes only: JAX's ``make_profile`` reads
    ``axis_names`` and ``devices.shape``, its ``_fsdp_dim`` ``shape[a]``."""
    axes, shape = MESHES[name]
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape),
                                 shape=dict(zip(axes, shape)))


def _entry(e):
    return e[0] if isinstance(e, tuple) and len(e) == 1 else e


def _norm(spec):
    return tuple(_entry(e) for e in tuple(spec))


def jax_flat(specs):
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda v: isinstance(v, P))[0]
    return {"/".join(str(k.key) for k in path): _norm(v)
            for path, v in leaves}


def port_flat(specs):
    return {k: _norm(v) for k, v in flatten(specs).items()}


def shallow(cfg):
    """The config one block pattern deep (an encoder of one layer): the
    spec rules read widths only."""
    return dataclasses.replace(
        cfg, n_layers=len(cfg.block_pattern),
        encoder_layers=min(cfg.encoder_layers, 1))


def _prof_fields(prof):
    return (prof.tp, prof.fsdp, tuple(prof.dp), prof.tp_size, prof.seq)


CASES = [(a, m) for a in REGISTRY for m in MESHES]


@pytest.mark.parametrize("arch,mesh_name", CASES)
def test_plans_and_specs_equal_jax(arch, mesh_name):
    cfg, jcfg = REGISTRY[arch], JREGISTRY[arch]
    mesh = stand_in(mesh_name)
    prof, jprof = rules.make_profile(mesh, cfg), jrules.make_profile(
        mesh, jcfg)
    assert _prof_fields(prof) == _prof_fields(jprof)
    lm.check_ported(cfg, prof)

    # Params: the profile of the full config, the tree of one pattern.
    _, jspecs = jrules.params_abstract(shallow(jcfg), jprof)
    p_specs = lm.param_specs(shallow(cfg), prof)
    assert port_flat(p_specs) == jax_flat(jspecs)
    # At full depth: the same tree (a stack), or one entry a layer.
    full = port_flat(lm.param_specs(cfg, prof))
    if lm._is_homogeneous(cfg):
        assert full == port_flat(p_specs)
    else:
        assert {k.split("/")[1] for k in full if k.startswith("layers/")} \
            == {f"layer_{i}" for i in range(cfg.n_layers)}
    for name, jo, to in (("adamw", jopt.AdamW(), topt.AdamW()),
                         ("adafactor", jopt.Adafactor(), topt.Adafactor())):
        assert port_flat(rules.opt_state_specs(to, p_specs)) == jax_flat(
            jrules.opt_state_specs(jo, jspecs)), name

    cells = shape_cells(cfg)
    assert [c.name for c in cells] == [c.name for c in jshape_cells(jcfg)]
    for cell, jcell in zip(cells, jshape_cells(jcfg)):
        plan, jplan = rules.plan_cell(mesh, cfg, cell), jrules.plan_cell(
            mesh, jcfg, jcell)
        assert dataclasses.asdict(plan.cfg) == dataclasses.asdict(jplan.cfg)
        assert dataclasses.asdict(plan.cell) == dataclasses.asdict(
            jplan.cell)
        assert _prof_fields(plan.prof) == _prof_fields(jplan.prof)
        assert (tuple(plan.batch_axes), plan.seq_shard, plan.optimizer) == (
            tuple(jplan.batch_axes), jplan.seq_shard, jplan.optimizer)
        assert port_flat(rules.batch_specs(cfg, cell, plan)) == jax_flat(
            jrules.batch_specs(jcfg, jcell, jplan)), cell.name
        structs = rules.batch_structs(cfg, cell)
        jstructs = jrules.batch_structs(jcfg, jcell)
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in structs.items()} == {
            k: (tuple(v.shape), str(v.dtype)) for k, v in jstructs.items()}
        assert port_flat(lm.cache_specs(cfg, plan.prof)) == jax_flat(
            jlm.cache_specs(jcfg, jplan.prof)), cell.name


def test_moe_refuses_a_tp_axis_that_does_not_split_the_experts():
    """kimi's 384 experts do not split over a model axis of 5: both
    ``check_ported`` and ``apply_moe`` refuse the mesh (the port does not
    gather the experts whole on every rank); 4 splits them."""
    import torch

    from repro_torch.models import blocks
    cfg = REGISTRY["kimi-k2-1t-a32b"]

    def prof(tp):
        mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                     devices=np.empty((2, tp)))
        return blocks.ShardProfile(mesh=mesh, tp="model", dp=("data",),
                                   tp_size=tp)
    with pytest.raises(ValueError, match="E = 384"):
        lm.check_ported(cfg, prof(5))
    with pytest.raises(ValueError, match="tp 'model' of size 5"):
        blocks.apply_moe({}, torch.zeros((2, 3, 8)), cfg, prof(5))
    lm.check_ported(cfg, prof(4))


def test_abstract_params_are_meta_and_shaped_as_jax():
    """``params_abstract`` allocates nothing, at any size: kimi's full
    tree, on the meta device, shape for shape and dtype for dtype against
    JAX's ``eval_shape`` (one pattern deep on the JAX side)."""
    cfg = REGISTRY["kimi-k2-1t-a32b"]
    prof = rules.make_profile(stand_in("16x16"), cfg)
    shapes, specs = rules.params_abstract(cfg, prof)
    flat = flatten(shapes)
    assert all(v.device.type == "meta" for v in flat.values())
    assert flat["layers/moe/wg"].shape == (61, 384, 7168, 2048)
    jshapes, _ = jrules.params_abstract(shallow(JREGISTRY[cfg.name]),
                                        jrules.make_profile(
                                            stand_in("16x16"),
                                            JREGISTRY[cfg.name]))
    want = {"/".join(str(k.key) for k in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    got = flatten(rules.params_abstract(shallow(cfg), prof)[0])
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in got.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}


PLACEMENT_CASES = [
    # (spec, mesh axes, placements as (kind, dim) per mesh dim)
    ((None, "model"), ("data", "model"), [("R", None), ("S", 1)]),
    (("data", None, "model"), ("data", "model"), [("S", 0), ("S", 2)]),
    ((("pod", "data"), None), ("pod", "data", "model"),
     [("S", 0), ("S", 0), ("R", None)]),
    ((("data", "model"), None), ("data", "model"), [("S", 0), ("S", 0)]),
    ((), ("data", "model"), [("R", None), ("R", None)]),
    ((None, None, "model", None), ("pod", "data", "model"),
     [("R", None), ("R", None), ("S", 2)]),
    ((("data",), "model"), ("data", "model"), [("S", 0), ("S", 1)]),
]


@pytest.mark.parametrize("spec,axes,want", PLACEMENT_CASES)
def test_spec_placements(spec, axes, want):
    from torch.distributed.tensor import Replicate, Shard
    got = dist.spec_placements(spec, axes)
    assert got == [Replicate() if k == "R" else Shard(d) for k, d in want]


@pytest.mark.parametrize("spec,axes,match", [
    (("pod", None), ("data", "model"), "not in the mesh"),
    ((("model", "data"), None), ("data", "model"), "out of the mesh"),
    (("model", "model"), ("data", "model"), "twice"),
])
def test_spec_placements_refusals(spec, axes, match):
    with pytest.raises(ValueError, match=match):
        dist.spec_placements(spec, axes)
