"""The port's --jax_dist / --jax_dist_launch (parallel/jaxdist.py): OS
processes join one torch.distributed gloo group, each assembles a disjoint
region shard, the shard payloads ride two all-gathers, and rank 0 writes
the merged outputs: every output file byte-identical to a one-process port
run and to python -m aletsch_tpu (the port's counterpart of
tests/test_jaxdist.py).  jax and the JAX package are unimportable in every
process the runs spawn.  Also the group's setup: gloo, the coordinator's
address, and the port's device left as the environment names it (the JAX
package forces its processes onto the CPU)."""

import os
import socket
import subprocess
import sys

import pytest

from aletsch_tpu import __main__ as ref_main
from aletsch_tpu_torch import __main__ as port_main
from aletsch_tpu_torch.config import default_params
from aletsch_tpu_torch.meta import device_wave
from aletsch_tpu_torch.parallel import jaxdist
from test_distributed import make_cohort
from torch_helpers import REPO, blocked_env, output_bytes

FLAGS = ["--max_num_exons", "8", "--verbose", "0"]
FORCED = ["--device_greedy", "on", "--device_min_vertices", "2",
          "--device_min_groups", "0"]


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("ALETSCH_TORCH_DEVICE", "cpu")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _args(bl, region_len, out):
    os.makedirs(os.path.join(out, "gtf"))
    return ["-i", bl, "-o", os.path.join(out, "meta.gtf"), "-d",
            os.path.join(out, "gtf"), "-g", str(region_len), *FLAGS]


def _bytes(out):
    return output_bytes(os.path.join(out, "meta.gtf"),
                        os.path.join(out, "gtf"))


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """tests/test_jaxdist.py's cohort (many regions), with the bytes of the
    JAX package's CLI and of a one-process port run, which must agree."""
    base = tmp_path_factory.mktemp("cohort")
    bl, region_len = make_cohort(base)
    ref = str(base / "ref")
    assert ref_main.main(_args(bl, region_len, ref) +
                         ["--device_greedy", "off"]) == 0
    one = str(base / "one")
    assert port_main.main(_args(bl, region_len, one)) == 0
    assert _bytes(ref) == _bytes(one)
    assert _bytes(ref)["meta.gtf"].count(b"\ttranscript\t") > 0
    return bl, region_len, _bytes(ref)


@pytest.mark.parametrize("how,n,extra", [
    ("launch", 2, []), ("launch", 3, []), ("ranks", 2, []),
    ("launch", 2, FORCED)], ids=["launch-2", "launch-3", "ranks-2",
                                 "launch-2-drain-forced"])
def test_process_group_equals_one_process(cohort, tmp_path, how, n, extra):
    """--jax_dist_launch n (3: the region grid does not divide evenly), and
    n processes started by hand with --jax_dist <pid> <n> <host:port>; one
    run with the drain forced in every rank."""
    bl, region_len, want = cohort
    out = str(tmp_path / "dist")
    argv = [sys.executable, "-m", "aletsch_tpu_torch",
            *_args(bl, region_len, out), *extra]
    env = blocked_env(str(tmp_path / "shim"))
    if how == "launch":
        res = subprocess.run(argv + ["--jax_dist_launch", str(n)], cwd=REPO,
                             env=env, capture_output=True, text=True,
                             timeout=300)
        assert res.returncode == 0, res.stderr[-2000:]
    else:
        coord = "127.0.0.1:%d" % _free_port()
        procs = [subprocess.Popen(
            argv + ["--jax_dist", str(pid), str(n), coord], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for pid in range(n)]
        try:
            outs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for p, o in zip(procs, outs):
            assert p.returncode == 0, o[-2000:]
    assert _bytes(out) == want


def test_allgather_bytes_in_a_group_of_one(tmp_path):
    """The two collectives in a group of one: each payload (empty, bytes of
    every value) comes back whole."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d"
                            % _free_port(), world_size=1, rank=0)
    try:
        for payload in (b"", bytes(range(256)) * 3):
            assert jaxdist._allgather_bytes(payload) == [payload]
    finally:
        dist.destroy_process_group()


def test_run_jax_distributed_keeps_the_device(monkeypatch):
    """The group is gloo at tcp://<coordinator> with the given size and
    rank, it is torn down when the shard fails, and the shard runs on the
    device ALETSCH_TORCH_DEVICE names: nothing moves it to the CPU, and
    ALETSCH_JAXDIST_PLATFORM is not read."""
    import torch.distributed as dist
    calls = []

    class Stop(Exception):
        pass

    def shard(params, region_filter):
        calls.append(("shard", os.environ["ALETSCH_TORCH_DEVICE"],
                      device_wave._cpu_device()))
        raise Stop

    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: calls.append(("init", a, k)))
    monkeypatch.setattr(dist, "destroy_process_group",
                        lambda: calls.append(("destroy",)))
    monkeypatch.setattr(jaxdist, "Incubator", shard)
    monkeypatch.setenv("ALETSCH_TORCH_DEVICE", "cuda:1")
    monkeypatch.setenv("ALETSCH_JAXDIST_PLATFORM", "cpu")
    with pytest.raises(Stop):
        jaxdist.run_jax_distributed(default_params(), 1, 3, "10.0.0.7:2345")
    assert calls == [
        ("init", ("gloo",), {"init_method": "tcp://10.0.0.7:2345",
                             "world_size": 3, "rank": 1}),
        ("shard", "cuda:1", False), ("destroy",)]


def test_launcher_spawns_the_port(monkeypatch):
    """launch_jax_distributed starts n ranks of python -m aletsch_tpu_torch
    at one free coordinator, the CLI's flags first, and raises when a rank
    fails."""
    started = []

    class Proc:
        def __init__(self, argv, env):
            started.append((argv, env))

        def wait(self):
            return 0

    monkeypatch.setattr(subprocess, "Popen", Proc)
    jaxdist.launch_jax_distributed(["-i", "x.list"], 3)
    assert len(started) == 3
    coords = {argv[-1] for argv, _ in started}
    assert len(coords) == 1 and coords.pop().startswith("127.0.0.1:")
    for pid, (argv, env) in enumerate(started):
        assert argv[1:3] == ["-m", "aletsch_tpu_torch"]
        assert argv[3:5] == ["-i", "x.list"]
        assert argv[5:-1] == ["--jax_dist", str(pid), "3"]
        assert env["PYTHONPATH"].split(os.pathsep)[0] == REPO
    monkeypatch.setattr(Proc, "wait", lambda self: 1)
    with pytest.raises(RuntimeError, match="jax_dist worker failed"):
        jaxdist.launch_jax_distributed(["-i", "x.list"], 2)
