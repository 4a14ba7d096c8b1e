"""Device layouts of the multi-device routes, and the one primitive by
which shards exchange rows.

The reference lays its devices out as a JAX ``Mesh``
(``nldsc_tpu/parallel/mesh.py``).  Here a layout is an explicit list of
``torch.device``s, one per shard, driven by one process: the SNP axis
and the sample axis take a list (:func:`snp_devices`), the 2-D grid a
list of rows of devices (:func:`grid_devices`).  A device may appear
more than once: several shards then share it, which is how the CPU
tests and a machine with one card run d shards.  Inside a process every
exchange goes through :func:`send`, a copy even between two shards of
one device, so that the shards never share a tensor; between the
processes of a ``torch.distributed`` process group (one chromosome's SNP
shards across ranks, ``distributed.estimate_lds_mesh``) through
:func:`exchange`.
"""

from __future__ import annotations

import contextlib
import datetime
import math

import torch

from ..core.errors import NLDSCParameterError

#: bytes moved between shards by :func:`send` and sent to other ranks by
#: :func:`exchange` (halo rows, per-tile products summed over sample
#: shards, partials gathered for the fold)
exchange_bytes = 0
#: seconds that :func:`exchange` waits for a message from another rank
#: before it raises: a rank that failed fails the others
RECV_TIMEOUT_S = 600.0


def send(x: torch.Tensor, dst: torch.device) -> torch.Tensor:
    """A copy of ``x`` on ``dst``, counted in :data:`exchange_bytes`."""
    global exchange_bytes
    exchange_bytes += x.numel() * x.element_size()
    return x.to(dst, copy=True)


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def exchange(outgoing: dict, incoming: dict, dev: torch.device) -> dict:
    """Point-to-point moves between the ranks of the process group:
    ``outgoing`` maps a rank to the tensors this rank sends it, packed
    into one message; ``incoming`` a rank to the ``(shape, dtype)`` of
    each tensor of the one message this rank receives from it.  Every
    rank plans both from what the ranks share (the run's geometry), so
    no sizes travel.  Returns ``{rank: [tensors]}`` on ``dev``.

    Under ``nccl`` the messages go from device to device; ``gloo`` sends
    host tensors only, so CUDA tensors are staged through the host
    (received into page-locked buffers).  Each wait fails after
    :data:`RECV_TIMEOUT_S`.  The bytes sent count in
    :data:`exchange_bytes`.  Nothing to move: nothing is done (in one
    process too)."""
    global exchange_bytes
    outgoing = {r: ts for r, ts in outgoing.items()
                if sum(t.numel() for t in ts)}
    incoming = {r: specs for r, specs in incoming.items()
                if sum(_nbytes(*x) for x in specs)}
    if not outgoing and not incoming:
        return {}
    dist = torch.distributed
    on_dev = dist.get_backend() == "nccl"
    stage = torch.device(dev) if on_dev else torch.device("cpu")
    ops = []
    for r, ts in outgoing.items():
        msg = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                         for t in ts]).to(stage)
        exchange_bytes += msg.numel()
        ops.append(dist.P2POp(dist.isend, msg, r))
    bufs = {}
    for r, specs in incoming.items():
        bufs[r] = torch.empty(
            sum(_nbytes(*x) for x in specs), dtype=torch.uint8, device=stage,
            pin_memory=not on_dev and torch.device(dev).type == "cuda")
        ops.append(dist.P2POp(dist.irecv, bufs[r], r))
    timeout = datetime.timedelta(seconds=RECV_TIMEOUT_S)
    with on_device(stage):                  # nccl's communicator device
        for work in dist.batch_isend_irecv(ops):
            work.wait(timeout)
    out = {}
    for r, specs in incoming.items():
        at, out[r] = 0, []
        for shape, dtype in specs:
            n = _nbytes(shape, dtype)
            piece = bufs[r][at:at + n]
            if at % dtype.itemsize:             # a view needs alignment
                piece = piece.clone()
            out[r].append(piece.view(dtype).reshape(shape).to(dev))
            at += n
    return out


def visible_devices(device="cuda") -> list[torch.device]:
    """The devices ``device`` names: ``cpu``, one indexed CUDA device, or
    for ``cuda`` every visible one, ``cuda:0 … cuda:k-1``."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")]
    if dev.type != "cuda":
        raise NLDSCParameterError(f"unsupported device {device!r}")
    k = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if k == 0:
        raise NLDSCParameterError(
            f"device {device!r} requested but no CUDA device is available")
    if dev.index is not None:
        return [dev]
    return [torch.device("cuda", i) for i in range(k)]


def snp_devices(n: int, device="cuda", share: bool = False
                ) -> list[torch.device]:
    """The devices of ``n`` shards: on the CPU ``n`` times the CPU; on
    CUDA one distinct device per shard (``cuda:0 … cuda:n-1``), raising
    when fewer are visible, or with ``share`` the visible devices taken
    round-robin, several shards to a device when there are fewer devices
    than shards."""
    if n < 1:
        raise NLDSCParameterError(f"need at least one shard, got {n}")
    vis = visible_devices(device)
    if vis[0].type == "cpu":
        return vis * n
    if n > len(vis) and not share:
        raise NLDSCParameterError(
            f"{n} shards on distinct devices, but {len(vis)} CUDA "
            "device(s) are visible")
    return [vis[i % len(vis)] for i in range(n)]


def grid_devices(rows: int, cols: int, device="cuda", share: bool = False
                 ) -> list[list[torch.device]]:
    """A ``rows`` x ``cols`` grid: rows shard the SNPs, the devices of a
    row its samples (:func:`snp_devices` of ``rows·cols``, row-major)."""
    flat = snp_devices(rows * cols, device, share)
    return [flat[r * cols:(r + 1) * cols] for r in range(rows)]


def on_device(dev: torch.device):
    """A context with ``dev`` current on CUDA (streams, events and
    launches of the work inside go to it); nothing on the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()
