"""Guards on the port's boundaries.

* No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports JAX or
  the JAX package (checked on the AST, so strings and comments don't count).
* The port's CLI imports with JAX made unimportable.
* Without CUDA the default device raises instead of training on the CPU.
* The CLI trains on the CPU when asked to (fused and sparse), and names the
  ROADMAP item of a path that is not ported yet.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_torch_port_imports_no_jax(path):
    assert path.exists(), path
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_torch_cli_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch.launch.train, repro_torch.train.loop, "
            "repro_torch.kernels.cowclip; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_torch_run_ctr_without_device_refuses_cpu(monkeypatch):
    """No --device means cuda; with no CUDA device that raises before any
    data is built or any step runs."""
    from repro_torch.launch import train as launch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = launch.build_parser().parse_args(["--task", "ctr", "--samples",
                                             "4096", "--batch", "512",
                                             "--steps", "2"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        launch.run_ctr(args)


def test_torch_cli_trains_on_cpu():
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--task", "ctr",
           "--placement", "fused", "--device", "cpu", "--samples", "4096",
           "--batch", "512", "--steps", "2"]
    out = subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "[train] done: 2 steps" in out.stdout


def test_torch_cli_trains_sparse_on_cpu():
    """--placement sparse, and the deprecated --sparse alias, train on the
    CPU through the plain versions of the sparse kernels."""
    base = [sys.executable, "-m", "repro_torch.launch.train", "--task",
            "ctr", "--device", "cpu", "--samples", "4096", "--batch", "512",
            "--steps", "2"]
    for flags in (["--placement", "sparse", "--unique-capacity", "64"],
                  ["--sparse"]):
        out = subprocess.run(base + flags, env=_env(), capture_output=True,
                             text=True, timeout=300, cwd=REPO)
        assert out.returncode == 0, out.stderr
        assert "embedding store sparse" in out.stdout
        assert "[train] done: 2 steps" in out.stdout


def test_torch_cli_sparse_alias_conflicts_with_other_placement():
    from repro_torch.launch import train as launch

    with pytest.raises(SystemExit, match="--sparse conflicts"):
        launch.main(["--device", "cpu", "--sparse", "--placement", "fused"])
    assert launch.resolve_placement(None, False) == "fused"
    assert launch.resolve_placement("sparse", True, warn=lambda _: None) \
        == "sparse"


@pytest.mark.parametrize("flags,item", [
    (["--placement", "sharded_sparse"], "queue 1 item 7"),
    (["--placement", "substrate"], "queue 1 item 4"),
    (["--placement", "sharded"], "queue 1 item 7"),
    (["--engine", "scan"], "queue 1 item 3"),
    (["--mode", "stream"], "queue 1 item 5"),
    (["--snapshot-dir", "snaps"], "queue 1 item 6"),
    (["--task", "lm"], "queue 1 item 8"),
])
def test_torch_cli_names_roadmap_for_unported(flags, item):
    from repro_torch.launch import train as launch

    with pytest.raises(SystemExit, match=item):
        launch.main(["--device", "cpu"] + flags)


def test_torch_cli_checkpoint_and_profile_trace(tmp_path):
    """--checkpoint writes run_ctr's npz layout (params + final_eval +
    id_freq) that loads back through params_from_numpy; --profile-trace
    writes a chrome trace."""
    from repro_torch.launch import train as launch
    from repro_torch.train.checkpoint import params_from_numpy

    ckpt, trace = tmp_path / "c.npz", tmp_path / "trace"
    launch.main(["--device", "cpu", "--samples", "2048", "--batch", "256",
                 "--steps", "2", "--checkpoint", str(ckpt),
                 "--profile-trace", str(trace)])
    params = params_from_numpy(str(ckpt), device="cpu")
    assert set(params) == {"embed", "dense"}
    assert params["embed"]["fm"]["field_0"].shape == (30000, 10)
    assert (trace / "trace.json").stat().st_size > 0
