"""dist/multihost.py of the PyTorch port: tests/test_multihost.py's cases
with torch.distributed.init_process_group patched where those patch
jax.distributed, the NCCL guard, and a real two-process handshake over
localhost (gloo, CPU)."""
import os
import socket
import subprocess
import sys
import textwrap

import pytest
import torch
import torch.distributed as dist

from mitsuba2_tpu_torch.dist import multihost

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT")


class _Recorder:
    def __init__(self, raise_exc=None):
        self.calls = []
        self.raise_exc = raise_exc

    def __call__(self, **kwargs):
        self.calls.append(kwargs)
        if self.raise_exc is not None:
            raise self.raise_exc


@pytest.fixture
def no_launch(monkeypatch):
    """No torchrun environment and no group in this process."""
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    return monkeypatch


def test_initialize_forwards_explicit_args(no_launch):
    rec = _Recorder()
    no_launch.setattr(dist, "init_process_group", rec)
    multihost.initialize(coordinator_address="10.0.0.1:1234",
                         num_processes=4, process_id=2)
    assert rec.calls == [{"backend": "gloo",
                          "init_method": "tcp://10.0.0.1:1234",
                          "world_size": 4, "rank": 2}]


def test_initialize_omits_unset_args(no_launch):
    """Unset arguments are not forwarded as None: a bare call under
    torchrun leaves init_process_group to read its environment."""
    rec = _Recorder()
    no_launch.setattr(dist, "init_process_group", rec)
    for k, v in (("RANK", "1"), ("WORLD_SIZE", "2"), ("LOCAL_RANK", "1"),
                 ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "29500")):
        no_launch.setenv(k, v)
    multihost.initialize()
    assert rec.calls == [{"backend": "gloo"}]
    rec.calls.clear()
    for k in TORCHRUN_ENV:
        no_launch.delenv(k, raising=False)
    multihost.initialize(num_processes=2)
    assert rec.calls == [{"backend": "gloo", "world_size": 2}]


def test_initialize_idempotent_when_already_distributed(no_launch):
    rec = _Recorder()
    no_launch.setattr(dist, "init_process_group", rec)
    no_launch.setattr(multihost, "_already_initialized", lambda: True)
    multihost.initialize(coordinator_address="x:1")
    assert rec.calls == []  # already initialized: no second handshake


def test_already_initialized_does_not_touch_cuda(no_launch):
    """Neither the guard nor a standalone bare call asks CUDA anything
    (the H100 machine's rank 0 must not make a context it does not
    use)."""
    def boom(*a, **k):
        raise AssertionError("CUDA queried")
    no_launch.setattr(torch.cuda, "is_available", boom)
    no_launch.setattr(torch.cuda, "device_count", boom)
    assert multihost._already_initialized() is False
    multihost.initialize()


def test_initialize_single_process_fallback(no_launch):
    """A bare call with no launch around it runs standalone. Explicit
    arguments, or torchrun's environment, with a failed handshake raise
    (a misconfigured launch must surface); other exceptions escape."""
    rec = _Recorder(raise_exc=ValueError("no coordinator"))
    no_launch.setattr(dist, "init_process_group", rec)
    multihost.initialize()  # must not raise
    assert rec.calls == []
    no_launch.setattr(dist, "init_process_group",
                      _Recorder(raise_exc=RuntimeError("no coordinator")))
    with pytest.raises(RuntimeError):
        multihost.initialize(coordinator_address="10.0.0.1:9999",
                             num_processes=2, process_id=0)
    no_launch.setenv("RANK", "0")
    no_launch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError):
        multihost.initialize()
    no_launch.setattr(dist, "init_process_group",
                      _Recorder(raise_exc=KeyboardInterrupt()))
    with pytest.raises(KeyboardInterrupt):
        multihost.initialize()


def test_nccl_with_more_ranks_than_cards_names_gloo(no_launch):
    """Two ranks on one card: NCCL refuses them, so initialize does, and
    names gloo; on a CUDA machine the default backend is NCCL and is
    never switched to gloo unasked."""
    rec = _Recorder()
    no_launch.setattr(dist, "init_process_group", rec)
    no_launch.setattr(torch.cuda, "is_available", lambda: True)
    no_launch.setattr(torch.cuda, "device_count", lambda: 1)
    for backend in ("nccl", None):
        with pytest.raises(RuntimeError, match="backend='gloo'"):
            multihost.initialize("127.0.0.1:29500", 2, 0, backend=backend)
    no_launch.setenv("LOCAL_WORLD_SIZE", "2")
    no_launch.setenv("RANK", "0")
    no_launch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="1 CUDA device"):
        multihost.initialize()
    assert rec.calls == []
    for k in TORCHRUN_ENV:
        no_launch.delenv(k, raising=False)
    multihost.initialize("127.0.0.1:29500", 2, 0, backend="gloo")
    multihost.initialize("127.0.0.1:29500", 1, 0)
    assert [c["backend"] for c in rec.calls] == ["gloo", "nccl"]


def test_pod_mesh_covers_all_ranks(no_launch):
    mesh = multihost.pod_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.grouped) == (0, 1, False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            multihost.pod_mesh()


def test_is_coordinator_single_host(no_launch):
    assert multihost.is_coordinator() is True
    assert multihost.local_rank() == 0


_WORKER = textwrap.dedent("""
    import sys
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    sys.path.insert(0, {repo!r})
    from mitsuba2_tpu_torch.dist import multihost
    rank = int(sys.argv[1])
    multihost.initialize(coordinator_address={addr!r}, num_processes=2,
                         process_id=rank, backend="gloo")
    multihost.initialize(coordinator_address={addr!r}, num_processes=2,
                         process_id=rank, backend="gloo")  # idempotent
    assert dist.get_world_size() == 2 and dist.get_rank() == rank
    assert multihost.is_coordinator() == (rank == 0)
    mesh = multihost.pod_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.grouped) == (rank, 2, True)
    # one real collective over both processes
    from mitsuba2_tpu_torch.dist.sharding import all_reduce
    t = all_reduce(torch.tensor([rank + 1.0]), mesh)
    assert float(t) == 3.0, t
    dist.destroy_process_group()
    print("MULTIHOST-OK", flush=True)
""")


def test_two_process_handshake(tmp_path, no_launch):
    """A real handshake: two CPU processes over localhost, gloo."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=REPO, addr=f"127.0.0.1:{port}"))
    procs = [subprocess.Popen([sys.executable, str(script), str(i)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("the two-process handshake did not finish in 120 s")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        assert "MULTIHOST-OK" in out
