"""The port stands alone: no JAX and nothing of ``repro`` in it, no ``msgpack``,
``orjson`` or ``ml_dtypes`` (the card's machine has none of them) and ``zstandard`` only
optionally, its own config copy, and no silent fall back to the CPU."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "repro"}
# the port keeps its own encoder, and its own host form of bfloat16 (wire/bfloat16.py)
NOT_ON_THE_CARD = {"msgpack", "orjson", "ml_dtypes"}
OPTIONAL = {"zstandard"}  # only inside try/except ImportError


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_the_port_loads_neither_jax_nor_repro():
    mods = list(_port_modules())
    assert "repro_torch.serve.batcher" in mods and "repro_torch.launch.serve" in mods
    for new in (
        "repro_torch.kernels.rglru",
        "repro_torch.models.rglru",
        "repro_torch.kernels.wkv6",
        "repro_torch.models.rwkv",
        "repro_torch.wire.packer",
        "repro_torch.wire.payload",
        "repro_torch.core.context",
        "repro_torch.core.graph",
        "repro_torch.core.durable",
        "repro_torch.core.executor",
        "repro_torch.core.failure",
        "repro_torch.core.heartbeat",
        "repro_torch.core.server",
        "repro_torch.core.gateway",
        "repro_torch.obs.trace",
        "repro_torch.launch.gateway_serve",
        "repro_torch.checkpoint.store",
        "repro_torch.obs.metrics",
        "repro_torch.train.host",
        "repro_torch.train.trainer",
        "repro_torch.launch.train",
        "repro_torch.train.distributed",
        "repro_torch.launch.train_distributed",
        "repro_torch.optim.compression",
        "repro_torch.wire.bfloat16",
    ):
        assert new in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'repro',\n"
        "                                     'msgpack', 'orjson', 'ml_dtypes'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=300
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"],
)
def test_no_jax_or_repro_import_in_the_source(path):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [(node.module or "").split(".")[0]]
        else:
            continue
        assert not FORBIDDEN.intersection(roots), f"{path}:{node.lineno} imports {roots}"


def _optional_imports(tree):
    """Ids of the import nodes that sit in a ``try`` whose handlers catch ImportError."""
    ok = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try):
            continue
        names = set()
        for handler in node.handlers:
            kinds = handler.type.elts if isinstance(handler.type, ast.Tuple) else [handler.type]
            names |= {k.id for k in kinds if isinstance(k, ast.Name)}
        if names & {"ImportError", "ModuleNotFoundError"}:
            ok |= {id(n) for stmt in node.body for n in ast.walk(stmt)}
    return ok


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"],
)
def test_no_msgpack_or_orjson_and_zstandard_only_optional(path):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    optional = _optional_imports(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = {(node.module or "").split(".")[0]}
        else:
            continue
        assert not NOT_ON_THE_CARD & roots, f"{path}:{node.lineno} imports {roots}"
        if OPTIONAL & roots:
            assert id(node) in optional, f"{path}:{node.lineno} imports {roots} unguarded"


def test_config_mirror_equals_the_reference_for_every_arch():
    assert tconfigs.list_archs() == jconfigs.list_archs()
    for name in jconfigs.list_archs():
        want, got = jconfigs.get_config(name), tconfigs.get_config(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        smoke_want = jconfigs.smoke_variant(want)
        assert dataclasses.asdict(tconfigs.smoke_variant(got)) == dataclasses.asdict(smoke_want)
    assert [f.name for f in dataclasses.fields(tconfigs.ModelConfig)] == [
        f.name for f in dataclasses.fields(jconfigs.ModelConfig)
    ]
    assert tconfigs.SHAPES == {
        k: tconfigs.ShapeConfig(**dataclasses.asdict(v)) for k, v in jconfigs.SHAPES.items()
    }


def _entry_points():
    from repro_torch.launch import gateway_serve, serve, train
    from repro_torch.models import build
    from repro_torch.params import from_numpy_tree, init_params
    from repro_torch.train import TrainConfig, Trainer

    cfg = tconfigs.smoke_variant(tconfigs.get_config("serpytor-demo-100m"))
    return {
        "build": lambda: build(cfg),
        "init_params": lambda: init_params(cfg),
        "from_numpy_tree": lambda: from_numpy_tree({}),
        "launch.serve": lambda: serve.main(["--smoke", "--requests", "1"]),
        "launch.gateway_serve": lambda: gateway_serve.main(["--smoke", "--requests", "1"]),
        "Trainer": lambda run_dir: Trainer(cfg, TrainConfig(run_dir)),
        "launch.train": lambda run_dir: train.main(
            ["--arch", "serpytor-demo-100m", "--steps", "1", "--run-dir", run_dir]
        ),
    }


@pytest.mark.parametrize(
    "name",
    [
        "build",
        "init_params",
        "from_numpy_tree",
        "launch.serve",
        "launch.gateway_serve",
        "Trainer",
        "launch.train",
    ],
)
def test_entry_point_without_device_raises_without_cuda(name, monkeypatch, tmp_path):
    """No device given means cuda; with no card that raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    entry = _entry_points()[name]
    with pytest.raises(RuntimeError, match="CUDA"):
        entry(str(tmp_path / "run")) if name in ("Trainer", "launch.train") else entry()


def test_launch_serve_runs_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import serve

    args = "--smoke --requests 2 --slots 2 --max-len 48 --min-prompt 4 --max-prompt 9"
    serve.main(args.split() + ["--new-tokens", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "serpytor-demo-100m-smoke on cpu: 2 requests, 6 tokens" in out
