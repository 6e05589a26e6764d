"""Device meshes over a ``torch.distributed`` world, one rank per slot.

The reference builds a ``jax.sharding.Mesh`` with named axes over the
devices of one process.  Here a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names`` over
the ranks of a process group that is already initialised: every rank
runs the same program (SPMD, as the body of a ``shard_map``), a rank's
coordinate along an axis (``mesh.get_local_rank(dim)``) says which slice
it holds, and the axis's process group (``mesh.get_group(dim)``) carries
the collectives.

Single pod: ``(data=16, model=16)``; multi-pod: ``(pod=2, data=16,
model=16)``, where ``pod`` composes with ``data`` for data parallelism.
The meshes are made by functions, so importing this module starts
nothing.

:func:`init_world` starts a ``gloo`` group from a ``file://`` store, and :func:`run_world` starts one fresh interpreter per
rank, joins them under a deadline and kills whatever outlives it: how a
world of several ranks is made on one host, for the CPU tests and for a
card that holds every rank.
"""
from __future__ import annotations

import datetime
import os
import pickle
import subprocess
import sys
import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh("cuda", shape, mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1,
                   device_type: str = "cpu") -> DeviceMesh:
    """A small ``(data, model)`` mesh over the initialised world (tests,
    examples); ``data * model`` must be the world size."""
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


def dp_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    """The composed data-parallel axes for this mesh."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def init_world(store: str, rank: int, world_size: int,
               timeout_s: float = 120.0) -> None:
    """Join a ``world_size``-rank ``gloo`` group through the ``file://``
    store at path ``store``: no TCP port, so worlds that run side by side
    on one host cannot collide.  ``gloo`` takes CPU and CUDA tensors and
    several ranks on one card, which NCCL refuses.  A collective that
    waits past ``timeout_s`` raises."""
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.abspath(store)}",
        rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))


def run_world(target: str, world_size: int, args: tuple = (), *,
              workdir: str, timeout_s: float = 120.0) -> list:
    """Run ``target(rank, world_size, *args)`` on every rank of a new
    world and return each rank's result, in rank order.

    ``target`` names a module-level function, ``"module:function"``,
    which each rank imports.  The group is :func:`init_world`'s.  A rank
    is a fresh interpreter (the spawn model: no fork of a process that
    holds torch's threads or a card) started with ``subprocess``;
    multiprocessing's spawn would also start a resource-tracker process
    that lives as long as this one.  The job and the results travel as
    pickles in ``workdir``, which also holds the group's store.  If a rank fails, the others are killed; if the
    deadline passes, every rank still running is killed; either raises.
    Every rank has been reaped when this returns or raises.
    """
    job = os.path.join(workdir, "job.pkl")
    with open(job, "wb") as f:
        pickle.dump({"target": target, "world_size": world_size,
                     "args": args, "store": os.path.join(workdir, "store"),
                     "timeout_s": timeout_s, "sys_path": sys.path}, f)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.mesh", job, str(r)],
        env=_child_env()) for r in range(world_size)]
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(
                    p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        late = [r for r, p in enumerate(procs) if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    failed = [(r, p.returncode) for r, p in enumerate(procs)
              if p.returncode != 0 and r not in late]
    if failed:
        raise RuntimeError(f"{target}: ranks failed (rank, exit code): "
                           f"{failed}; killed {late}")
    if late:
        raise TimeoutError(f"{target}: ranks {late} still ran after "
                           f"{timeout_s:.0f} s and were killed")
    out = []
    for r in range(world_size):
        with open(os.path.join(workdir, f"result_{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _child_env() -> dict:
    """The environment of a rank: this one, with the package importable."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ,
                PYTHONPATH=src if not path else src + os.pathsep + path)


def _rank_main(job_path: str, rank: int) -> None:
    """One rank of :func:`run_world`: join the world, run the target,
    leave the group, write the result beside the job."""
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    sys.path[:] = job["sys_path"]
    module, name = job["target"].split(":")
    fn = getattr(__import__(module, fromlist=[name]), name)
    init_world(job["store"], rank, job["world_size"],
               timeout_s=job["timeout_s"])
    try:
        result = fn(rank, job["world_size"], *job["args"])
    finally:
        dist.destroy_process_group()
    out = os.path.join(os.path.dirname(job_path), f"result_{rank}.pkl")
    with open(out, "wb") as f:
        pickle.dump(result, f)


if __name__ == "__main__":
    torch.set_num_threads(1)
    _rank_main(sys.argv[1], int(sys.argv[2]))
