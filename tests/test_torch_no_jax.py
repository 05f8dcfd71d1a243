"""Guards of the port: it imports neither JAX nor the JAX package, and its
entry points default to the CUDA card (raising where there is none)."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "fusion_sim_tpu")


def _port_sources():
    files = sorted((ROOT / "fusion_sim_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_guard_covers_the_sharded_modules():
    """The parametrization above picks up every port source by itself,
    ``parallel/``, the sharded models and their examples among them."""
    names = {str(p.relative_to(ROOT)) for p in _port_sources()}
    for module in ("parallel/__init__.py", "parallel/mesh.py",
                   "parallel/halo.py", "parallel/migration.py",
                   "parallel/sharding.py",
                   "models/electrostatic_sharded.py",
                   "models/electromagnetic_sharded.py",
                   "models/electrostatic_sharded2d.py",
                   "models/electromagnetic_sharded2d.py",
                   "examples/bench_sharded_1chip.py",
                   "examples/bench_weak_scaling.py"):
        assert f"fusion_sim_torch/{module}" in names, module


def test_guard_sees_a_forbidden_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import numpy\nfrom jax import numpy as jnp\n"
                     "def f():\n    import fusion_sim_tpu.constants\n")
    assert [m for m in _imported_modules(probe)
            if m.split(".")[0] in FORBIDDEN] == ["jax",
                                                 "fusion_sim_tpu.constants"]


def test_default_device_is_cuda():
    from fusion_sim_torch._device import resolve_device
    from fusion_sim_torch.models import electromagnetic as em
    from fusion_sim_torch.models import electrostatic as es
    from fusion_sim_torch.models.pusher import CylindricalParticlePusher
    from fusion_sim_torch.ops.sorted_deposit import Tiling2D
    from fusion_sim_torch.scenarios import apply_default_scenario

    spec = {"radius": 1.0, "height": 2.0, "nr": 16, "nz": 32, "dt": 2e-9,
            "nparticles": 8, "particle_mass": 1.67e-27,
            "particle_charge": 1.602e-19}
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        assert CylindricalParticlePusher(spec).device.type == "cuda"
        from fusion_sim_torch.viewer.server import SimulationService
        assert SimulationService().device.type == "cuda"
        return
    config = es.ESConfig(grid_shape=(32, 32), cell_size=(0.1, 0.1), dt=0.05,
                         charge=-1e-3, mass=1e-3)
    pos = np.random.default_rng(0).random((256, 2)).astype(np.float32) * 32
    with pytest.raises(RuntimeError, match="CUDA"):
        es.ElectrostaticPIC(config, pos, 0 * pos)
    with pytest.raises(RuntimeError, match="CUDA"):
        es.SortedElectrostaticPIC(config, pos, 0 * pos, backend="pallas",
                                  tiling=Tiling2D(16, 16, 256, margin=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        CylindricalParticlePusher(spec)
    em_config = em.EMConfig(grid_shape=(32, 32), cell_size=(0.5, 0.5),
                            dt=0.1, charge=-0.01, mass=0.01)
    vel3 = np.zeros((256, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        em.ElectromagneticPIC(em_config, pos, vel3)
    with pytest.raises(RuntimeError, match="CUDA"):
        em.SortedElectromagneticPIC(em_config, pos, vel3,
                                    gather_backend="fused",
                                    tiling=Tiling2D(16, 16, 256, margin=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        em.weibel(n_particles=1024, n_cells=32, sorted_layout=True)
    # the 3D entry points (default Tiling3D: block 512)
    pos3 = np.random.default_rng(1).random((512, 3)).astype(np.float32) * 16
    es3 = es.ESConfig(grid_shape=(16,) * 3, cell_size=(0.1,) * 3, dt=0.05,
                      charge=-1e-3, mass=1e-3)
    em3 = em.EMConfig(grid_shape=(16,) * 3, cell_size=(0.5,) * 3, dt=0.1,
                      charge=-0.01, mass=0.01)
    for build in (
            lambda: es.ElectrostaticPIC(es3, pos3, 0 * pos3),
            lambda: es.SortedElectrostaticPIC(es3, pos3, 0 * pos3,
                                              backend="pallas"),
            lambda: em.ElectromagneticPIC(em3, pos3, 0 * pos3),
            lambda: em.SortedElectromagneticPIC(em3, pos3, 0 * pos3,
                                                gather_backend="fused"),
            lambda: em.SortedElectromagneticPIC(em3, pos3, 0 * pos3)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    # this slice's entry points: ES xla, repair, the X1 experiment
    tiling = Tiling2D(16, 16, 256, margin=2)
    from fusion_sim_torch.examples import mxu_experiment
    for build in (
            lambda: es.SortedElectrostaticPIC(config, pos, 0 * pos,
                                              tiling=tiling),
            lambda: es.SortedElectrostaticPIC(config, pos, 0 * pos,
                                              tiling=tiling, repair=True),
            lambda: em.SortedElectromagneticPIC(em_config, pos, vel3,
                                                tiling=tiling, repair=True),
            lambda: mxu_experiment.make_bench(16, 24, 128, 2, 2,
                                              "lhs_k_lanes", "default")):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    # this slice's entry points: the spindle field, the iterative solvers'
    # wrapper, the viewer's service and server
    from fusion_sim_torch.models.spindle import spindle_cusp_field
    from fusion_sim_torch.ops.solvers import SORIterative
    from fusion_sim_torch.viewer.server import SimulationService, serve
    for build in (
            lambda: spindle_cusp_field(1.0, 2.0, 8, 16, 1e6, n_power=1),
            lambda: SORIterative(1),
            lambda: SimulationService(),
            lambda: serve(port=0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    # this slice's entry points: the world of one, the sharded ES model
    from fusion_sim_torch.models import electrostatic_sharded as shd
    from fusion_sim_torch.parallel.mesh import make_mesh
    sharded = shd.ShardedESConfig(base=config, n_shards=1, capacity=512,
                                  migration_buffer=64, tiling=tiling,
                                  backend="pallas")
    for build in (lambda: make_mesh(1, ("space",)),
                  lambda: shd.ShardedElectrostaticPIC(sharded, None, pos,
                                                      0 * pos)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    # the sharded EM model and the two-axis models
    from fusion_sim_torch.models import electromagnetic_sharded as emd
    from fusion_sim_torch.models import electromagnetic_sharded2d as em2
    from fusion_sim_torch.models import electrostatic_sharded2d as es2
    for build in (
            lambda: emd.ShardedElectromagneticPIC(
                emd.ShardedEMConfig(base=em_config, n_shards=1,
                                    capacity=512, migration_buffer=64,
                                    tiling=tiling, gather_backend="fused"),
                None, pos, vel3),
            lambda: es2.ShardedElectrostaticPIC2D(
                es2.ShardedESConfig2D(base=config, mesh_shape=(1, 1),
                                      capacity=512, migration_buffer=64,
                                      tiling=tiling, backend="pallas"),
                None, pos, 0 * pos),
            lambda: em2.ShardedElectromagneticPIC2D(
                em2.ShardedEMConfig2D(base=em_config, mesh_shape=(1, 1),
                                      capacity=512, migration_buffer=64,
                                      tiling=tiling, gather_backend="fused"),
                None, pos, vel3)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    assert resolve_device("cpu").type == "cpu"
    sim = CylindricalParticlePusher(spec, device="cpu")
    apply_default_scenario(sim)
    sim.step(1)
    assert sim.state.position.device.type == "cpu"
    assert bool(torch.isfinite(sim.state.position).all())


def _reference_root_names():
    """The names the JAX package's root imports, read from its source (the
    package itself is not imported here)."""
    tree = ast.parse((ROOT / "fusion_sim_tpu" / "__init__.py").read_text())
    return sorted(alias.asname or alias.name for node in tree.body
                  if isinstance(node, ast.ImportFrom)
                  for alias in node.names)


def test_package_root_exports_the_reference_names():
    assert _reference_root_names() == sorted(
        ["config", "constants", "CylindricalParticlePusher", "PusherSpec",
         "make_cylindrical_particle_pusher"])


@pytest.mark.parametrize("name", ["config", "constants",
                                  "CylindricalParticlePusher", "PusherSpec",
                                  "make_cylindrical_particle_pusher"])
def test_package_root_export_is_its_modules_object(name):
    import importlib

    import fusion_sim_torch

    exported = getattr(fusion_sim_torch, name)
    home = (f"fusion_sim_torch.{name}" if name in ("config", "constants")
            else "fusion_sim_torch.models.pusher")
    module = importlib.import_module(home)
    expected = module if name in ("config", "constants") else getattr(
        module, name)
    assert exported is expected
    ns = {}
    exec(f"from fusion_sim_torch import {name}", ns)
    assert ns[name] is expected


def test_importing_the_package_root_builds_no_kernel():
    """A fresh interpreter in which starting a process fails imports the
    root and its exports: no nvcc runs and no kernel library is loaded."""
    import subprocess
    import sys

    code = ("import subprocess, sys\n"
            "def refuse(*a, **k):\n"
            "    raise AssertionError('a process was started')\n"
            "subprocess.Popen = refuse\n"
            "from fusion_sim_torch import (CylindricalParticlePusher, "
            "PusherSpec, make_cylindrical_particle_pusher, config, "
            "constants)\n"
            "b = sys.modules.get('fusion_sim_torch.ops._build')\n"
            "print(0 if b is None else len(b._LOADED))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "0"
