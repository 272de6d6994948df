"""The port's dry run (``repro_torch.launch.dryrun``): one cell of the
production mesh traced under a fake process group of 256 ranks writes a
record with the JAX dry run's keys to ``artifacts/dryrun_torch.jsonl``
(never to the JAX package's ``artifacts/dryrun.jsonl``), and a rank's
FLOPs times the ranks match the unsharded step's.  Each run is a
subprocess: a process group is not started inside the test process."""
import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")

#: The keys of a JAX dry-run record of status "ok"
#: (``repro.launch.dryrun.run_cell``).
JAX_KEYS = {"arch", "shape", "kind", "mesh", "optimizer", "fsdp", "dp_axes",
            "seq_shard", "n_devices", "status", "lower_s", "compile_s",
            "memory", "cost", "collectives", "model"}


def _env():
    return dict(os.environ, PYTHONPATH=os.path.abspath(SRC))


def test_dryrun_cell_writes_a_jax_shaped_record(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "linear-esn", "--shape", "train_4k", "--mesh", "single",
         "--probes"],
        cwd=tmp_path, env=_env(), capture_output=True, text=True,
        timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr[-4000:]
    assert not (tmp_path / "artifacts" / "dryrun.jsonl").exists()
    rec, probe2, probe4 = [json.loads(line) for line in open(
        tmp_path / "artifacts" / "dryrun_torch.jsonl")]
    # --probes: the 2- and 4-unit unrolled stacks, after the cell.
    assert [(p["status"], p["mesh"], p["probe_layers"]) for p in (
        probe2, probe4)] == [("probe", "probe2", 2), ("probe", "probe4", 4)]
    assert 0 < probe2["cost"]["flops"] < probe4["cost"]["flops"]
    assert set(rec) == JAX_KEYS
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["dp_axes"],
            rec["optimizer"]) == ("linear-esn", "train_4k", "single",
                                  ["data"], "adamw")
    assert {"argument_bytes", "output_bytes", "temp_bytes",
            "peak_bytes"} <= set(rec["memory"])
    assert rec["memory"]["peak_bytes"] > rec["memory"]["argument_bytes"] > 0
    assert {"flops", "bytes_accessed", "transcendentals"} <= set(rec["cost"])
    assert rec["cost"]["flops"] > 0
    assert {"per_kind_bytes", "total_bytes", "static_bytes", "n_ops",
            "top_ops"} <= set(rec["collectives"])
    assert rec["collectives"]["total_bytes"] > 0
    assert set(rec["model"]) == {"params", "active_params", "tokens"}


def test_dryrun_refuses_the_jax_record():
    from repro_torch.launch import dryrun
    with pytest.raises(SystemExit, match="JAX package"):
        dryrun.main(["--out", "artifacts/dryrun.jsonl"])
    assert dryrun.DEFAULT_OUT == "artifacts/dryrun_torch.jsonl"


FLOPS = """
import json
from repro_torch.configs import ShapeCell, get_config, shape_cells, smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_lm_mesh, make_production_mesh
from repro_torch.models import lm
from repro_torch.models.blocks import NULL_PROFILE
from repro_torch.sharding import rules
from repro_torch.train import optimizer as opt_mod
cell = ShapeCell("t", 64, 8, "train")
out = {}
for arch in ("linear-esn", "smollm-135m"):
    cfg = smoke_config(arch)
    with dryrun._fake_world(8):
        mesh = make_lm_mesh((2, 4), device_type="cpu")
        per_device = dryrun.trace_cell(mesh, cfg, cell)[2]["flops"]
    opt = opt_mod.make_optimizer("adamw")
    step = rules.make_train_step(
        rules.CellPlan(cfg, cell, NULL_PROFILE, (), False, "adamw"), opt)
    p = lm.init_params(None, cfg, "meta")
    flops = dryrun._LocalFlops(display=False)
    with ops.shape_only(), flops:
        step(p, opt.init(p), rules.batch_structs(cfg, cell))
    out[arch] = [per_device, flops.get_total_flops()]
# The cost probe (UNROLL_SCANS) against the same 2-layer stack traced with
# B3's forward shape-only.
import dataclasses
cfg = get_config("smollm-135m")
cell = {c.name: c for c in shape_cells(cfg)}["train_4k"]
with dryrun._fake_world(256):
    plain = dryrun.trace_cell(
        make_production_mesh(), dataclasses.replace(
            cfg, n_layers=2, scan_layers=False), cell, donate=False)[2]
out["probe"] = [dryrun.run_probe("smollm-135m", "train_4k", 2)["cost"]["flops"],
                plain["flops"]]
print(json.dumps(out))
"""


def test_per_device_flops_times_devices_match_the_unsharded_step():
    """On a (2, 4) mesh of 8 fake ranks, a rank's products times 8 are the
    unsharded step's (``FlopCounterMode`` on plain meta tensors) plus the
    work that is not split: no less, and at most a quarter more at these
    smoke widths (the recompute of a layer's last products, which the
    unsharded checkpoint stops short of, and products DTensor runs whole
    on each rank of an axis).  A lost split would be x2 or more.  And the
    dry run's cost probe (``--probes``, ``attention.UNROLL_SCANS``) counts
    exactly B3's forward products on top of the plain trace."""
    out = subprocess.run([sys.executable, "-c", FLOPS], env=_env(),
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    probe, plain = res.pop("probe")
    for arch, (per_device, unsharded) in res.items():
        ratio = per_device * 8 / unsharded
        assert 1.0 <= ratio <= 1.25, (arch, ratio)
    # The cost probe counts B3's forward, which the plain trace runs
    # shape-only: per rank of the (16, 16) mesh, 256 / 16 sequences of
    # 4096 tokens, smollm-135m's 9 query heads whole (9 does not split
    # over 16) of head_dim 64, causal in 1024-row query chunks that see
    # 1024, 2048, 3072 and 4096 keys; QK and PV, 2 flops a multiply-add,
    # twice a layer (the forward and its recompute under remat), 2 layers.
    pairs = 1024 * (1024 + 2048 + 3072 + 4096)
    fwd = 2 * 2 * (256 // 16) * 9 * pairs * 64
    assert probe - plain == 2 * 2 * fwd, (probe, plain)
