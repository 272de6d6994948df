"""The port's serving planes keep the reference's import layering.

The JAX package pins its plane split in ``tests/test_serving_planes.py``:
planes import only downward (telemetry / infra), never each other sideways
or upward, and the facade (``serve/engine.py``) stays under 700 lines.  The
same map, copied here rather than imported from that module, holds for
``src/repro_torch/serve/``.  Function-level (indented) lazy imports are the
sanctioned escape hatch and pass, as in the reference.
"""
import pathlib
import re

import pytest

import repro_torch.serve as serve_pkg

SERVE_DIR = pathlib.Path(serve_pkg.__file__).parent

#: module -> serve-sibling modules it must NEVER import at module level
#: (the reference's map, ``tests/test_serving_planes.py``).
_FORBIDDEN = {
    "telemetry.py": {"arena", "cost", "scheduler", "store", "ingest",
                     "exec_plane", "learn", "engine", "frontend"},
    "arena.py": {"ingest", "exec_plane", "learn", "engine", "frontend"},
    "cost.py": {"ingest", "exec_plane", "learn", "engine", "frontend"},
    "scheduler.py": {"ingest", "exec_plane", "learn", "engine", "frontend"},
    "store.py": {"ingest", "exec_plane", "learn", "engine", "frontend"},
    "ingest.py": {"exec_plane", "learn", "engine", "frontend"},
    "exec_plane.py": {"ingest", "learn", "engine", "frontend"},
    "learn.py": {"ingest", "exec_plane", "engine", "frontend"},
    "engine.py": {"frontend"},
    "frontend.py": {"exec_plane", "learn", "engine", "arena", "store",
                    "scheduler", "cost"},
}


def _module_level_import(src: str, mod: str):
    pat = re.compile(rf"^(from|import)\s+[.\w]*\b{mod}\b", re.MULTILINE)
    return pat.search(src)


@pytest.mark.parametrize("fname", sorted(_FORBIDDEN))
def test_plane_imports_are_one_way(fname):
    src = (SERVE_DIR / fname).read_text()
    for mod in sorted(_FORBIDDEN[fname]):
        m = _module_level_import(src, mod)
        assert m is None, (
            f"{fname} imports sibling {mod!r} at module level: "
            f"{m.group(0)!r} — planes talk through facade-wired callbacks, "
            f"not imports")


def test_every_plane_is_in_the_map():
    planes = {p.name for p in SERVE_DIR.glob("*.py")} - {"__init__.py"}
    assert planes <= set(_FORBIDDEN), sorted(planes - set(_FORBIDDEN))


def test_the_check_sees_a_module_level_import_and_passes_a_lazy_one():
    assert _module_level_import("from .ingest import SessionStats\n",
                                "ingest")
    assert _module_level_import("from repro_torch.serve.ingest import x\n",
                                "ingest")
    assert not _module_level_import(
        "def f():\n    from .ingest import SessionStats\n", "ingest")
    assert not _module_level_import(
        "from .scheduler import host_array\n", "ingest")


def test_facade_is_thin():
    n_lines = len((SERVE_DIR / "engine.py").read_text().splitlines())
    assert n_lines < 700, (
        f"serve/engine.py has {n_lines} lines — the facade must stay thin; "
        f"move logic into the owning plane")
