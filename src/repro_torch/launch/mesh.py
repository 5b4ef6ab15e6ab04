"""Device meshes over ranks, and the mesh layer's collectives.

The reference's ``launch/mesh.py`` names the meshes: (data=16, model=16)
for one pod, (pod=2, data=16, model=16) for two, and small host meshes for
tests. Here a mesh is torch's ``DeviceMesh`` over the ranks of an
initialised process group, one rank per process; :class:`AbstractMesh` is
its counterpart without ranks (the reference's ``make_abstract_mesh``), so
that the sharding rules are data that can be tested anywhere.

The backend is always named by the caller, never chosen here: ``nccl``
where each rank has a card of its own, ``gloo`` on the CPU and where
several ranks share one card (NCCL refuses two ranks on one device).
Gloo has no all-gather, reduce-scatter or all-to-all for CUDA tensors, and
its TCP transport is slow between ranks of one host, so under gloo every
collective of this layer goes through :func:`host_staged`: the ranks of a group, on one host,
exchange their tensors through a host buffer they all map, and the bytes
(``staged_bytes``) and seconds (``collective_s``) are counted; gloo itself
carries only barriers. Nothing gives way silently: an unsupported
backend raises.

A rank's process gets its place from the environment torchrun sets
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``);
:func:`launch` is the port's own small launcher, which sets them for N
copies of a command and stops them all at a time limit:

    PYTHONPATH=src python -m repro_torch.launch.mesh --nproc 2 -- \\
        python -m repro_torch.launch.train --arch qwen2-0.5b --smoke \\
        --dist-backend gloo --device cpu --steps 4 --ckpt-dir /tmp/ck-mesh
"""
from __future__ import annotations

import argparse
import contextlib
import math
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")

# bytes this process copied to the host and back for its collectives, the
# seconds its collectives took (staging included), and of those the
# seconds spent making, faulting in and page-locking host buffers
staged_bytes = 0
collective_s = 0.0
buffer_s = 0.0


@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, no ranks: what the sharding rules read of a
    mesh (``mesh_dim_names``, ``shape``), as a ``DeviceMesh`` has them."""

    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"mesh shape {self.shape} and axes {self.mesh_dim_names} differ in rank")


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def make_abstract_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> AbstractMesh:
    return AbstractMesh(tuple(int(s) for s in shape), tuple(axes))


def world_size() -> int:
    """The process group's size, or the environment's before it exists (1
    without either)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def init_distributed(backend: str, *, timeout_s: float = 600.0) -> bool:
    """Join the process group the environment describes, once.

    Returns False when there is nothing to join (``WORLD_SIZE`` unset or
    1, no group yet). ``backend`` must be named: ``gloo`` or ``nccl``.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: name one of {BACKENDS}")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}, not {backend}")
        return True
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    import datetime

    dist.init_process_group(
        backend, init_method="env://",
        rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``shape`` over the process group's ranks (rank-
    major, the last axis fastest, as ``jax.make_mesh`` lays devices out).

    The group must exist (:func:`init_distributed`): ``init_device_mesh``
    would otherwise start one with the device type's default backend.
    """
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"a mesh of {n} ranks needs an initialised process group "
                           "(init_distributed with a named backend)")
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs world size {n}, "
                         f"have {dist.get_world_size()}")
    if device_type == "cuda":
        # ranks may share a card: the mesh would otherwise set LOCAL_RANK's
        # device, which need not exist
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count())
        torch.cuda.init()
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_host_mesh(shape: tuple[int, ...] | None = None, axes: tuple[str, ...] = ("data",),
                   *, device_type: str = "cpu"):
    """A small mesh over whatever ranks exist (tests, CPU runs): by
    default (world size,) over ``data``."""
    return make_mesh(shape or (world_size(),), axes, device_type=device_type)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """Single pod: (data=16, model=16) = 256 ranks. Multi-pod: (pod=2,
    data=16, model=16) = 512 ranks; the pod axis is data-parallel."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need, have = math.prod(shape), world_size()
    if have != need:
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} needs world "
                         f"size {need}; this run has {have}")
    return make_mesh(shape, axes, device_type=device_type)


# -- the current mesh --------------------------------------------------------------

_CURRENT: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Makes ``mesh`` the current one (:func:`current_mesh`) inside the block.

    Process-wide, not thread-local: autograd recomputes a rematerialised
    layer, its MoE among it, on its own thread for the device, and that
    recomputation must see the mesh the forward saw."""
    _CURRENT.append(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.pop()


def current_mesh():
    return _CURRENT[-1] if _CURRENT else None


# -- collectives along mesh axes -----------------------------------------------------

KINDS = ("all_gather", "reduce_scatter", "all_reduce", "all_to_all")


class _Segment:
    """A host buffer that every rank of one gloo group maps (a ``MAP_SHARED``
    file under ``/dev/shm``, unlinked once all have it), grown when a
    collective needs more. The ranks call the same collectives with the
    same sizes, so each grows it at the same call."""

    def __init__(self, group):
        self.group = group
        self.buf: torch.Tensor | None = None
        self.nbytes = 0
        self.pinned = False

    def _unpin(self) -> None:
        if self.pinned:
            torch.cuda.cudart().cudaHostUnregister(self.buf.data_ptr())
            self.pinned = False

    def bytes(self, nbytes: int, pin: bool = False) -> torch.Tensor:
        """The first ``nbytes`` of the buffer; with ``pin``, registered with
        the CUDA driver (page-locked), so that copies to and from the card
        run at the link's rate instead of through the driver's bounce
        buffers."""
        global buffer_s
        t0 = time.perf_counter()
        if nbytes > self.nbytes:
            self._unpin()
            size = max(nbytes, 2 * self.nbytes)
            first = dist.get_global_rank(self.group, 0)
            name = [f"/dev/shm/crum-mesh-{os.getpid()}-{first}-{size}-{time.time_ns()}"]
            dist.broadcast_object_list(name, src=first, group=self.group)
            if dist.get_rank() == first:
                with open(name[0], "wb") as f:
                    f.truncate(size)
            dist.barrier(group=self.group)
            self.buf = torch.from_file(name[0], shared=True, size=size, dtype=torch.uint8)
            dist.barrier(group=self.group)
            if dist.get_rank() == first:
                os.unlink(name[0])
            self.nbytes = size
        if pin and not self.pinned:
            err = torch.cuda.cudart().cudaHostRegister(self.buf.data_ptr(), self.nbytes, 0)
            if int(err) != 0:
                raise RuntimeError(f"cudaHostRegister of the {self.nbytes}-byte collective "
                                   f"buffer failed: {err}")
            self.pinned = True
        buffer_s += time.perf_counter() - t0
        return self.buf[:nbytes]


_SEGMENTS: dict = {}


def _segment(group) -> _Segment:
    seg = _SEGMENTS.get(group)
    if seg is None:
        hosts = [None] * dist.get_world_size(group)
        dist.all_gather_object(hosts, socket.gethostname(), group=group)
        if len(set(hosts)) != 1:
            raise RuntimeError(f"a gloo group over hosts {sorted(set(hosts))}: this layer's "
                               "collectives share a host buffer; use nccl across hosts")
        seg = _SEGMENTS[group] = _Segment(group)
    return seg


def host_staged(kind: str, x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The collective ``kind`` (:data:`KINDS`) of ``x`` over ``group`` along
    ``dim`` (blocks are cut and joined on it), as a new tensor on ``x``'s
    device. Every collective of this layer goes through here.

    Under nccl it is the library's call. Under gloo (which has none of
    these for CUDA tensors) the ranks share one host buffer (:class:`_Segment`): each copies its
    tensor into its own slot, and after a barrier each reads what it needs
    of the others' slots, summing in rank order where the kind sums (the
    same bits on every rank, run to run); another barrier frees the slots.
    The bytes copied to and from the buffer are added to ``staged_bytes``,
    the seconds to ``collective_s``."""
    global staged_bytes, collective_s
    if kind not in KINDS:
        raise ValueError(f"collective {kind!r}: one of {KINDS}")
    backend = dist.get_backend(group)
    if backend not in BACKENDS:
        raise RuntimeError(f"collectives over {backend!r} are not supported: use {BACKENDS}")
    n, me = dist.get_world_size(group), dist.get_group_rank(group, dist.get_rank())
    t0 = time.perf_counter()
    t = x.reshape(1) if x.dim() == 0 else x.movedim(dim, 0).contiguous()
    if backend == "nccl":
        out = _native(kind, t, group, n)
    else:
        nb = t.numel() * t.element_size()
        slots = _segment(group).bytes(n * nb, pin=t.is_cuda).view(t.dtype).view(
            (n,) + tuple(t.shape))
        slots[me].copy_(t)
        dist.barrier(group=group)
        rows = t.shape[0] // n
        if kind == "all_gather":
            out = slots.reshape((n * t.shape[0],) + tuple(t.shape[1:])).to(x.device, copy=True)
        elif kind == "all_to_all":
            out = slots[:, me * rows:(me + 1) * rows].reshape(t.shape).to(x.device, copy=True)
        else:
            part = slice(me * rows, (me + 1) * rows) if kind == "reduce_scatter" else slice(None)
            out = slots[0, part].to(x.device, copy=True)
            for j in range(1, n):
                out += slots[j, part].to(x.device)
        dist.barrier(group=group)
        staged_bytes += nb + out.numel() * out.element_size() * (n if kind in (
            "reduce_scatter", "all_reduce") else 1)
    collective_s += time.perf_counter() - t0
    return out.reshape(()) if x.dim() == 0 else out.movedim(0, dim).contiguous()


def _native(kind: str, t: torch.Tensor, group, n: int) -> torch.Tensor:
    if kind == "all_gather":
        out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t, group=group)
    elif kind == "reduce_scatter":
        out = t.new_empty((t.shape[0] // n,) + tuple(t.shape[1:]))
        dist.reduce_scatter_tensor(out, t, op=dist.ReduceOp.SUM, group=group)
    elif kind == "all_reduce":
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    else:
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=group)
    return out


def _collective(kind: str, x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    group = mesh.get_group(mesh.mesh_dim_names.index(axis))
    if dist.get_world_size(group) == 1:
        return x
    return host_staged(kind, x, group, dim)


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The blocks of ``x`` along mesh ``axis``, concatenated on ``dim`` in
    the axis's coordinate order."""
    return _collective("all_gather", x, mesh, axis, dim)


def reduce_scatter(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The sum of ``x`` over mesh ``axis``, this coordinate's block of it
    along ``dim``."""
    return _collective("reduce_scatter", x, mesh, axis, dim)


def all_reduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over mesh ``axis`` (a new tensor)."""
    return _collective("all_reduce", x, mesh, axis)


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Block i of ``x``'s dim 0 goes to coordinate i of mesh ``axis``;
    block i of the result came from coordinate i."""
    return _collective("all_to_all", x, mesh, axis)


class _SumGrad(torch.autograd.Function):
    """Identity forward; backward, the gradient summed over ``axis``."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.mesh, ctx.axis), None, None


class _Sum(torch.autograd.Function):
    """The sum over ``axis`` forward; backward, the gradient as it is."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x.contiguous(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def sum_grad_over(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x`` as it is, its gradient summed over ``axis``: for a tensor that
    every rank of the axis holds alike but uses for its own share of the
    work (Megatron's f), so that each holds the whole gradient."""
    return _SumGrad.apply(x, mesh, axis)


def sum_over(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` over ``axis``, whose gradient
    every rank holds alike (Megatron's g)."""
    return _Sum.apply(x, mesh, axis)


def coordinate(mesh, axis: str) -> int:
    return mesh.get_coordinate()[mesh.mesh_dim_names.index(axis)]


# -- the launcher ---------------------------------------------------------------------

def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(argv: Sequence[str], nproc: int, *, timeout: float | None = None,
           env: dict | None = None, cwd: str | None = None,
           capture: bool = False) -> list[subprocess.CompletedProcess]:
    """Runs ``nproc`` copies of ``argv`` as the ranks of one group on this
    host (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
    ``MASTER_PORT`` set for each, and ``OMP_NUM_THREADS`` to the host's
    cores over N unless set) and waits for all of them. Past
    ``timeout`` seconds, or once one rank has failed, the rest are killed
    (each rank leads its own process group), so a hang fails in seconds.
    With ``capture`` each rank's output is returned, else inherited."""
    base = dict(os.environ if env is None else env)
    base.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                WORLD_SIZE=str(nproc))
    # the host's cores shared out, unless the caller set it (torchrun's
    # default is 1): N ranks of a core count's threads each thrash
    base.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // nproc)))
    with contextlib.ExitStack() as stack:
        files = [(stack.enter_context(tempfile.TemporaryFile("w+")),
                  stack.enter_context(tempfile.TemporaryFile("w+")))
                 for _ in range(nproc)] if capture else [(None, None)] * nproc
        procs = []
        try:
            for r in range(nproc):
                procs.append(subprocess.Popen(
                    list(argv), env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                    cwd=cwd, stdout=files[r][0], stderr=files[r][1], text=True,
                    start_new_session=True))
            deadline = None if timeout is None else time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                if any(p.returncode not in (None, 0) for p in procs):
                    break
                if deadline is not None and time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    with contextlib.suppress(ProcessLookupError):
                        os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        outs = []
        for (fo, fe), p in zip(files, procs):
            text = []
            for f in (fo, fe):
                if f is not None:
                    f.seek(0)
                text.append(f.read() if f is not None else None)
            outs.append(subprocess.CompletedProcess(list(argv), p.returncode, *text))
        return outs


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="run N ranks of a command on this host (RANK, WORLD_SIZE, "
                    "MASTER_ADDR, MASTER_PORT set for each)")
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--timeout", type=float, default=None)
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cmd = args.command[1:] if args.command[:1] == ["--"] else args.command
    if not cmd:
        ap.error("no command to run")
    codes = [p.returncode for p in launch(cmd, args.nproc, timeout=args.timeout)]
    bad = [c for c in codes if c != 0]
    if bad:
        print(f"[mesh] rank exit codes {codes}", file=sys.stderr)
    return bad[0] if bad else 0


if __name__ == "__main__":
    sys.exit(main())
