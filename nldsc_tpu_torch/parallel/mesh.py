"""Device layouts of the multi-device routes, and the one primitive by
which shards exchange rows.

The reference lays its devices out as a JAX ``Mesh``
(``nldsc_tpu/parallel/mesh.py``).  Here a layout is an explicit list of
``torch.device``s, one per shard, driven by one process: the SNP axis
and the sample axis take a list (:func:`snp_devices`), the 2-D grid a
list of rows of devices (:func:`grid_devices`).  A device may appear
more than once: several shards then share it, which is how the CPU
tests and a machine with one card run d shards.  Every exchange goes
through :func:`send`, a copy even between two shards of one device, so
that the shards never share a tensor.
"""

from __future__ import annotations

import contextlib

import torch

from ..core.errors import NLDSCParameterError

#: bytes copied between shards by :func:`send` (halo rows, per-tile
#: products summed over sample shards, partials gathered for the fold)
exchange_bytes = 0


def send(x: torch.Tensor, dst: torch.device) -> torch.Tensor:
    """A copy of ``x`` on ``dst``, counted in :data:`exchange_bytes`."""
    global exchange_bytes
    exchange_bytes += x.numel() * x.element_size()
    return x.to(dst, copy=True)


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
