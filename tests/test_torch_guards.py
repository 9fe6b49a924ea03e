"""Guards on the port's boundaries.

* No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports JAX or
  the JAX package (checked on the AST, so strings and comments don't count).
* The port's CLI imports with JAX made unimportable.
* Without CUDA the default device raises instead of training on the CPU,
  and no public function of the port defaults ``device`` to ``"cpu"``.
* The CLI trains on the CPU when asked to (fused, sparse, and hotcold
  online from a stream), refuses the reference's bad streaming flag
  combinations and the grid flags without a sharded placement, and names
  the ROADMAP item of a path not ported yet.
* The LM serving CLI decodes on the CPU with JAX unimportable, and refuses
  to start without a card when no device is named.
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


def _cpu_device_defaults(path: Path) -> list:
    """``name`` of each public function in ``path`` (not ``_``-prefixed,
    nor nested in one that is) whose ``device`` parameter defaults to the
    string ``"cpu"``."""
    found = []

    def visit(node, private):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                hidden = private or child.name.startswith("_")
                a = child.args
                params = a.posonlyargs + a.args
                pairs = list(zip(params[len(params) - len(a.defaults):],
                                 a.defaults))
                pairs += [(p, d) for p, d in zip(a.kwonlyargs, a.kw_defaults)
                          if d is not None]
                if not hidden and any(
                        p.arg == "device" and isinstance(d, ast.Constant)
                        and d.value == "cpu" for p, d in pairs):
                    found.append(child.name)
                visit(child, hidden)
            elif isinstance(child, ast.ClassDef):
                visit(child, private or child.name.startswith("_"))

    visit(ast.parse(path.read_text(), filename=str(path)), False)
    return found


def test_torch_port_device_defaults_are_not_cpu(monkeypatch):
    """Entry points run on the card unless the caller asks for the CPU:
    no public function of ``repro_torch`` defaults ``device`` to "cpu",
    and the model initialisers refuse to start without a card when no
    device is named."""
    bad = {str(p.relative_to(REPO)): names for p in PORT_FILES
           if (names := _cpu_device_defaults(p))}
    assert not bad, f"device defaults to 'cpu' in {bad}"
    from repro_torch.models import layers, rwkv

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    for call in (lambda: layers.init_rmsnorm(8),
                 lambda: rwkv.init_rwkv6(gen, 16, 2),
                 lambda: rwkv.init_rwkv_state(1, 16, 2),
                 lambda: rwkv.init_channel_mix(gen, 16, 32)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert layers.init_rmsnorm(8, device="cpu")["scale"].device.type == "cpu"


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


# The four cases named "queue 1 item 7" once checked that the sharded
# placements' flags exited naming that item, and then that the guard,
# snapshots, resume and streaming on them exited naming queue 1 item 9.
# Those are ported now (test_torch_sharded_guard.py and
# test_torch_sharded_snapshot.py hold them), so each case, with its id,
# checks that its flags start a run with a sharded placement (a tiny one,
# on the CPU) or reach the reference's own refusal: --resume without
# --snapshot-dir. --task lm once exited naming queue 1 item 8; it trains
# now, and its case starts a tiny reduced LM run.
_TINY = ["--samples", "512", "--batch", "64", "--base-batch", "64",
         "--mlp-dim", "16"]


@pytest.mark.parametrize("flags,expect", [
    pytest.param(["--placement", "sharded_sparse", "--nonfinite-guard",
                  "--steps", "1"] + _TINY,
                 "[train] done: 1 steps", id="flags0-queue 1 item 7"),
    pytest.param(["--placement", "sharded", "--mode", "stream", "--steps",
                  "2"] + _TINY,
                 "[train] done: 2 steps", id="flags2-queue 1 item 7"),
    pytest.param(["--host-devices", "2", "--placement", "sharded",
                  "--mode", "stream", "--steps", "4", "--snapshot-dir",
                  "snaps", "--snapshot-every", "2", "--scan-steps", "2"]
                 + _TINY,
                 "[train] done: 4 steps", id="flags3-queue 1 item 7"),
    pytest.param(["--mesh", "2,4", "--host-devices", "8", "--placement",
                  "sharded_sparse", "--resume"],
                 "--resume needs --snapshot-dir", id="flags5-queue 1 item 7"),
    pytest.param(["--task", "lm", "--reduced", "--arch", "stablelm-3b",
                  "--batch", "16", "--seq", "64", "--steps", "2",
                  "--samples", "4096"],
                 "[train-lm] 2 steps in", id="flags6-queue 1 item 8"),
])
def test_torch_cli_names_roadmap_for_unported(flags, expect, tmp_path,
                                              monkeypatch):
    """A run's flags start it (the CLI in a child process; ``--host-devices``
    spawns gloo ranks), its snapshots land in the working directory; a
    refusal exits before any rank starts or any file is made."""
    from repro_torch.launch import train as launch

    monkeypatch.chdir(tmp_path)
    if not expect.startswith("[train"):
        with pytest.raises(SystemExit, match=expect):
            launch.main(["--device", "cpu"] + flags)
        assert not any(tmp_path.iterdir())
        return
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device",
         "cpu"] + flags, env=_env(), capture_output=True, text=True,
        timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count(expect) == 1, out.stdout
    if "--snapshot-dir" in flags:
        assert sorted(p.name for p in (tmp_path / "snaps").iterdir()) == [
            "snap-00000002", "snap-00000004"]


@pytest.mark.parametrize("cold_store", ["none", "mem"])
def test_torch_cli_trains_stream_hotcold_on_cpu(cold_store):
    """``--mode stream --placement hotcold`` trains online on the CPU, with
    the cold tier in the step and with the async host cold store (these
    flags once exited naming ROADMAP queue 1 item 5)."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--task", "ctr",
         "--device", "cpu", "--samples", "4096", "--batch", "256",
         "--mode", "stream", "--placement", "hotcold", "--hot-capacity",
         "64", "--steps", "2", "--cold-store", cold_store],
        env=_env(), capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "mode stream (online, no epochs)" in out.stdout
    assert ("async mem cold store" in out.stdout) == (cold_store == "mem")
    assert "[train] done: 2 steps" in out.stdout


@pytest.mark.parametrize("flags,message", [
    (["--mode", "stream", "--placement", "hotcold"],
     "--mode stream has no epoch boundary; pass --steps to bound the run"),
    (["--cold-store", "mem", "--mode", "stream", "--steps", "2"],
     "--cold-store needs --placement hotcold"),
    (["--cold-store", "mem", "--placement", "hotcold", "--steps", "2"],
     "--cold-store trains online only; add --mode stream"),
    (["--cold-store", "mmap", "--placement", "hotcold", "--mode", "stream",
      "--steps", "2"], "--cold-store mmap needs --cold-dir"),
])
def test_torch_cli_refuses_bad_stream_flags(flags, message):
    """The reference CLI's refusals, with its messages."""
    from repro_torch.launch import train as launch

    with pytest.raises(SystemExit, match=message):
        launch.main(["--device", "cpu"] + flags)


@pytest.fixture(scope="module")
def checkpointed_and_profiled(tmp_path_factory):
    """One CPU run of the CLI on the scan engine with --checkpoint and
    --profile-trace: ``(checkpoint, trace dir)``."""
    from repro_torch.launch import train as launch

    tmp = tmp_path_factory.mktemp("cli")
    ckpt, trace = tmp / "c.npz", tmp / "trace"
    launch.main(["--device", "cpu", "--samples", "2048", "--batch", "256",
                 "--steps", "2", "--engine", "scan",
                 "--checkpoint", str(ckpt), "--profile-trace", str(trace)])
    return ckpt, trace


def test_torch_cli_checkpoint_and_profile_trace(checkpointed_and_profiled):
    """--checkpoint writes run_ctr's npz layout (params + final_eval +
    id_freq) that loads back through params_from_numpy; --profile-trace
    writes a chrome trace."""
    from repro_torch.train.checkpoint import params_from_numpy

    ckpt, trace = checkpointed_and_profiled
    params = params_from_numpy(str(ckpt), device="cpu")
    assert set(params) == {"embed", "dense"}
    assert params["embed"]["fm"]["field_0"].shape == (30000, 10)
    assert (trace / "trace.json").stat().st_size > 0


def test_torch_cli_profile_trace_holds_the_program_spans(
        checkpointed_and_profiled):
    """--profile-trace writes the program's spans into the trace, on its
    clock: the prefetch worker's gather on a lane of its own, the
    consumer's wait for it on another, both inside the profile's time
    range."""
    import json

    from repro_torch.core import spans

    _, trace = checkpointed_and_profiled
    data = json.loads((trace / "trace.json").read_text())
    events = [e for e in data["traceEvents"] if e.get("ph") == "X"]
    ours = [e for e in events if e.get("cat") == "repro_torch"]
    profiled = [e for e in events if e.get("cat") != "repro_torch"]
    lo = min(e["ts"] for e in profiled)
    hi = max(e["ts"] + e["dur"] for e in profiled)
    lanes = {}
    for e in ours:
        assert lo <= e["ts"] and e["ts"] + e["dur"] <= hi, e
        lanes.setdefault(e["name"], set()).add(e["tid"])
    gather, wait = lanes["prefetch.gather"], lanes["prefetch.wait_worker"]
    assert len(gather) == len(wait) == 1 and gather != wait
    assert lanes["engine.chunk"] == wait
    assert all(tid >= spans.LANE_BASE for tid in gather | wait)
    assert 0 <= data["repro_torch"]["anchor_error_ns"] < 1_000_000


def test_torch_serve_decode_cli_on_cpu_without_jax():
    code = ("import runpy, sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "sys.argv = ['decode', '--device', 'cpu', '--batch', '2', "
            "'--new-tokens', '4']; "
            "runpy.run_module('repro_torch.serve.decode', "
            "run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "serving rwkv6-7b (reduced)" in out.stdout
    assert "generated (2, 4) tokens" in out.stdout


def test_torch_serve_decode_cli_without_device_refuses():
    """No --device means cuda; with no card visible it exits non-zero
    before building anything."""
    env = dict(_env(), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "repro_torch.serve.decode"],
                         env=env, capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
    assert "serving" not in out.stdout


@pytest.mark.parametrize("flags,message", [
    (["--host-devices", "4"], "--mesh and --host-devices apply to "
     "--placement sharded|sharded_sparse"),
    (["--mesh", "1,2"], "--mesh and --host-devices apply to"),
])
def test_torch_cli_refuses_grid_flags_without_a_sharded_placement(
        flags, message):
    from repro_torch.launch import train as launch

    with pytest.raises(SystemExit, match=message):
        launch.main(["--device", "cpu"] + flags)


def test_torch_cli_host_devices_need_the_cpu(monkeypatch):
    """``--host-devices`` spawns gloo CPU ranks; with the card as the
    device it exits before spawning anything."""
    from repro_torch.launch import train as launch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(SystemExit, match="add --device cpu"):
        launch.main(["--placement", "sharded", "--host-devices", "2"])
