"""The port's several-process launch, mirroring tests/test_multihost.py.

Two OS processes join through a localhost rendezvous (the JAX package's
variables ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and
``JAX_PROCESS_ID``) with gloo collectives on the CPU, and render the same
plotfile through the port's CLI (``python -m amrvolumerenderer_torch.driver
--device cpu``) over 8 shards, 4 in each process.  Rank 0's saved image
must be byte-identical to a one-process 8-shard render, and rank 1 saves
nothing: the same program, split across processes, may not change a byte.
Cases: the one-shot frame, the persistent renderer's orbit
(``--orbit-frames 3``) and a 512-piece scene, which the router hands to the
tile-march pipeline; rank 0's images equal the JAX package's one-process
CLI on the same plotfile too.  Also the shard placement over processes
(``directsend.make_mesh``, the cases of tests/test_parallel.py), the launch
environment that ``driver.maybe_initialize_distributed`` reads and its
backend rule.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from amrvolumerenderer_torch import driver
from amrvolumerenderer_torch.parallel import directsend as ds
from amrvolumerenderer_torch.plotfile import write_plotfile
from amrvolumerenderer_torch.scene import LevelBox, LevelGeometry

from test_torch_worklist import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--device", "cpu", "--devices", "8", "--width", "32", "--height", "32",
         "--render-method", "slicemarch"]


def r2_plotfile(path, brick):
    """The 16^3 r^2 field of tests/test_multihost.py in ``brick``^3 boxes."""
    n = 16
    c = np.arange(n) / (n - 1)
    field = c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2
    boxes = [LevelBox(field[i:i + brick, j:j + brick, k:k + brick],
                      np.array([i, j, k]))
             for i in range(0, n, brick) for j in range(0, n, brick)
             for k in range(0, n, brick)]
    write_plotfile(path, [boxes], [LevelGeometry(np.zeros(3), np.full(3, 1.0 / n))],
                   var_names=["density"])
    return path


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_rank(rank, port, argv, cwd):
    env = dict(os.environ)
    for key in ("AVR_DISTRIBUTED", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(key, None)
    env.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", JAX_NUM_PROCESSES="2",
               JAX_PROCESS_ID=str(rank), OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    return subprocess.Popen(
        [sys.executable, "-m", "amrvolumerenderer_torch.driver", *argv],
        cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def two_process_run(tmp_path, argv):
    """Each rank in a directory of its own; returns (logs, dirs)."""
    port = _free_port()
    dirs = [tmp_path / f"rank{r}" for r in (0, 1)]
    for d in dirs:
        d.mkdir()
    procs = [_spawn_rank(r, port, argv, str(d)) for r, d in enumerate(dirs)]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(out)
    assert procs[0].returncode == 0, logs[0]
    assert procs[1].returncode == 0, logs[1]
    return logs, dirs


def one_process_run(tmp_path, argv, main=driver.main):
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert main(argv) == 0
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("brick,extra,names", [
    (8, [], ["mh.ppm"]),
    (8, ["--orbit-frames", "3"], [f"mh_{i:04d}.ppm" for i in range(3)]),
    (2, [], ["mh.ppm"]),
], ids=["oneshot", "orbit", "512-pieces"])
def test_two_process_render_matches_single_process(tmp_path, brick, extra, names):
    plotfile = r2_plotfile(str(tmp_path / "plt00000"), brick)
    argv = [plotfile, *FLAGS, *extra, "--output", "mh.ppm"]
    logs, dirs = two_process_run(tmp_path, argv)
    # the process group came up with the backend the device asks for
    assert "distributed runtime up — 2 host(s), 2 device(s), backend gloo" in logs[0]
    assert "distributed runtime up" not in logs[1]
    # only rank 0 saves
    assert "Saved" in logs[0]
    assert "Saved" not in logs[1]
    assert sorted(os.listdir(dirs[1])) == []
    assert sorted(os.listdir(dirs[0])) == names

    (tmp_path / "single").mkdir()
    one_process_run(tmp_path / "single", [plotfile, *FLAGS, *extra, "--output",
                                          "mh.ppm"])
    # the JAX package's one-process CLI on the same plotfile and flags
    from amrvolumerenderer_tpu import driver as jax_driver

    (tmp_path / "jax").mkdir()
    one_process_run(tmp_path / "jax", [plotfile, *FLAGS[2:], *extra, "--output",
                                       "mh.ppm"], main=jax_driver.main)
    for name in names:
        got = (dirs[0] / name).read_bytes()
        assert got == (tmp_path / "single" / name).read_bytes(), name
        assert got == (tmp_path / "jax" / name).read_bytes(), name


def _fake_group(monkeypatch, world, rank):
    """make_mesh's view of a process group of ``world`` processes."""
    monkeypatch.setattr(ds.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(ds.dist, "get_world_size", lambda group=None: world)
    monkeypatch.setattr(ds.dist, "get_rank", lambda group=None: rank)


def test_make_mesh_one_process_round_robin():
    mesh = ds.make_mesh(4, "cpu")
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert mesh.num_processes == 1 and mesh.local == [0, 1, 2, 3]
    # more shards than devices: round-robin (the JAX package clamps)
    devs = ["a", "b", "c"]
    assert ds._subset_devices(devs, 2) == devs[:2]
    assert ds._subset_devices(devs, 6) == devs + devs


@pytest.mark.parametrize("rank", [0, 1])
def test_make_mesh_processes_take_equal_shares(monkeypatch, rank):
    """tests/test_parallel.py:727-760: an equal, process-major share of the
    shards on each process."""
    _fake_group(monkeypatch, 2, rank)
    mesh = ds.make_mesh(8, "cpu")
    assert mesh.processes == (0, 0, 0, 0, 1, 1, 1, 1) and mesh.rank == rank
    assert mesh.num_processes == 2
    assert mesh.local == list(range(4 * rank, 4 * rank + 4))
    assert [d is not None for d in mesh.devices] == [
        p == rank for p in mesh.processes]
    # one shard a process by default
    assert ds.make_mesh(None, "cpu").processes == (0, 1)


def test_make_mesh_processes_must_divide(monkeypatch):
    _fake_group(monkeypatch, 2, 0)
    with pytest.raises(ValueError, match="multiple of the"):
        ds.make_mesh(3, "cpu")
    with pytest.raises(ValueError, match="positive"):
        ds.make_mesh(0, "cpu")


LAUNCH_VARS = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
               "AVR_DISTRIBUTED", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
               "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


@pytest.mark.parametrize("env,want", [
    ({}, None),
    ({"AVR_DISTRIBUTED": "0", "WORLD_SIZE": "2", "RANK": "1"}, None),
    ({"JAX_COORDINATOR_ADDRESS": "10.0.0.1:1234", "JAX_NUM_PROCESSES": "4",
      "JAX_PROCESS_ID": "3"}, ("tcp://10.0.0.1:1234", 4, 3, 3, None)),
    ({"JAX_COORDINATOR_ADDRESS": "10.0.0.1:1234", "JAX_NUM_PROCESSES": "32",
      "JAX_PROCESS_ID": "11", "LOCAL_WORLD_SIZE": "8"},
     ("tcp://10.0.0.1:1234", 32, 11, 3, 8)),
    ({"AVR_DISTRIBUTED": "1", "MASTER_ADDR": "node0", "MASTER_PORT": "29500",
      "WORLD_SIZE": "8", "RANK": "5", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "4"},
     ("tcp://node0:29500", 8, 5, 1, 4)),
    # the JAX variables win, so one launch line drives both packages
    ({"JAX_COORDINATOR_ADDRESS": "127.0.0.1:9", "JAX_NUM_PROCESSES": "2",
      "JAX_PROCESS_ID": "0", "AVR_DISTRIBUTED": "1", "MASTER_ADDR": "x",
      "MASTER_PORT": "1", "WORLD_SIZE": "8", "RANK": "7"},
     ("tcp://127.0.0.1:9", 2, 0, 0, None)),
], ids=["none", "avr-off", "jax", "jax-local", "torchrun", "jax-wins"])
def test_distributed_environment(monkeypatch, env, want):
    for key in LAUNCH_VARS:
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    assert driver._distributed_env() == want
    if want is None:
        assert driver.maybe_initialize_distributed("cpu") is False


@pytest.mark.parametrize("world,local,cards,want", [
    (2, None, 0, "needs a card"),
    (2, None, 8, "2 host(s), 2 device(s), backend nccl"),
    # 4 hosts of 8 cards, 8 processes each: a card a process
    (32, "8", 8, "32 host(s), 32 device(s), backend nccl"),
    # more processes than cards and no LOCAL_WORLD_SIZE: no guess
    (32, None, 8, "set LOCAL_WORLD_SIZE"),
    (2, "2", 1, "2 host(s), 1 device(s), backend gloo, 2 processes share 1 card(s)"),
], ids=["no-card", "nccl", "nccl-4-hosts", "unknown-share", "gloo-shared"])
def test_backend_rule(monkeypatch, capsys, world, local, cards, want):
    """The backend is chosen before the process group starts, from the
    device, the card count and LOCAL_WORLD_SIZE, and printed on rank 0."""
    import torch.distributed as dist

    for key in LAUNCH_VARS:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:9")
    monkeypatch.setenv("JAX_NUM_PROCESSES", str(world))
    monkeypatch.setenv("JAX_PROCESS_ID", "0")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    if local:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    started, selected = [], []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", selected.append)
    monkeypatch.setattr(dist, "is_nccl_available", lambda: True)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: started.append((backend, kw)))
    if "device(s)" not in want:
        with pytest.raises(RuntimeError, match=want.replace("(", r"\(")):
            driver.maybe_initialize_distributed("cuda")
        assert started == []
        return
    assert driver.maybe_initialize_distributed("cuda") is True
    assert want in capsys.readouterr().out
    assert started[0][0] == want.split("backend ")[1].split(",")[0]
    assert started[0][1]["world_size"] == world and selected == [0]
