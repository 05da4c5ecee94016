"""Multi-device scaling: shard the ray or realization axis over a device mesh.

Counterpart of ``pygenray_tpu/parallel/sharding.py``.  Rays never
communicate, so a fan is pure data parallelism: a 1D mesh over the angle
axis (or, for an ensemble, the realization axis), the environment
replicated on every device, no collectives inside a trace.

The JAX package keeps its outputs sharded (``jax.sharding``); torch has no
sharded tensor outside ``torch.distributed``, which needs a process group.
Here a mesh is a 1D array of torch devices, ``shard_rays`` splits a batch
into one chunk per device (``ShardedBatch``), ``run_shards`` runs a
function once per shard, and the entry points concatenate the shards'
results on the mesh's first device.  A device may appear in a mesh more
than once: ``cpu`` eight times is the counterpart of the JAX tests' eight
virtual CPU devices, ``cuda:0`` four times checks a four-device split on
one card.

On a mesh of CUDA devices every shard runs in a worker thread, so one
shard's host synchronizations (the eigenray and Monte-Carlo loops check
"any candidate active" once an iteration) do not hold up the others; each
worker runs on its device's current stream as the calling thread sees it,
and no new stream is made.  Shards run one after another on the calling
thread on a CPU mesh (each CPU shard already runs torch's intra-op pool)
and whenever a derivative is taken (grad mode and ``torch.func``
transforms are thread-local).  A worker's exception re-raises in the
caller once every shard has ended.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

__all__ = ["Mesh", "ShardedBatch", "make_mesh", "shard_rays", "replicate_env",
           "pad_to_multiple", "run_shards", "RAY_AXIS"]

RAY_AXIS = "rays"


def _canon(device) -> torch.device:
    """``device`` with its index: a bare ``"cuda"`` names the current card."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """An array of torch devices with named axes, read as a JAX mesh is:
    ``mesh.devices`` (a numpy object array), ``mesh.axis_names`` and
    ``mesh.shape`` (``{axis name: size}``).  The entry points take 1D
    meshes only.  ``launches``: the kernel launches of each shard of the
    last ``run_shards`` call on this mesh (``{counter: launches}`` in shard
    order, the counters of ``ops/stepper.py``, counted on the thread that
    ran the shard)."""

    def __init__(self, devices, axis_names=(RAY_AXIS,)):
        given = np.asarray(devices, dtype=object)
        devs = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(given.shape):
            devs[idx] = _canon(given[idx])
        axis_names = tuple(axis_names)
        if devs.ndim != len(axis_names) or devs.size == 0:
            raise ValueError(f"a mesh of shape {devs.shape} needs {devs.ndim} axis names "
                             f"and at least one device (got {axis_names})")
        self.devices, self.axis_names = devs, axis_names
        self.launches = []

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device_list(self) -> tuple:
        """The devices in shard order."""
        return tuple(self.devices.reshape(-1))


def make_mesh(n_devices: int = None, devices=None) -> Mesh:
    """1D mesh over the ray axis: ``devices`` (a device may be named more
    than once), by default every CUDA device; ``n_devices`` keeps the first
    that many."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise ValueError("make_mesh found no CUDA device; name the devices "
                             "(e.g. devices=['cpu'] * 8)")
    devices = list(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"make_mesh: {n_devices} devices asked for, {len(devices)} "
                             "available; name a device more than once to repeat it")
        devices = devices[:n_devices]
    return Mesh(devices, (RAY_AXIS,))


def mesh_size(mesh: Mesh, who: str) -> int:
    """The device count of a 1D mesh: ``TypeError`` for what is not a
    ``Mesh``, ``ValueError`` naming ``who`` for a mesh of more axes."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"{who} takes a parallel.Mesh (make_mesh), not {type(mesh).__name__}")
    if len(mesh.axis_names) != 1:
        raise ValueError(f"{who} expects a 1D mesh")
    return mesh.shape[mesh.axis_names[0]]


def pad_to_multiple(arr, multiple: int, fill=0.0):
    """Pad the leading axis so it divides evenly across devices; returns
    ``(padded, n)``, ``n`` the original length (a tensor stays a tensor)."""
    n = arr.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    if isinstance(arr, torch.Tensor):
        pad = arr.new_full((rem, *arr.shape[1:]), fill)
        return torch.cat([arr, pad]), n
    arr = np.asarray(arr)
    pad = [(0, rem)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad, constant_values=fill), n


@dataclasses.dataclass(frozen=True)
class ShardedBatch:
    """A (B, ...) batch split over a mesh's ray axis: ``chunks[i]`` is the
    i-th B/n rows, on the mesh's i-th device."""

    mesh: Mesh
    chunks: tuple

    @property
    def shape(self) -> tuple:
        return (sum(c.shape[0] for c in self.chunks), *self.chunks[0].shape[1:])


def shard_rays(p0, mesh: Mesh) -> ShardedBatch:
    """Split a (B,) ray batch (a tensor or an array) over the mesh's ray
    axis, each chunk on its device.  B must divide by the device count
    (``pad_to_multiple``), else ``ValueError``, as JAX's ``device_put``."""
    n = mesh_size(mesh, "shard_rays")
    p0 = torch.as_tensor(p0)
    if p0.ndim == 0 or p0.shape[0] % n:
        raise ValueError(f"shard_rays: a batch of shape {tuple(p0.shape)} does not divide "
                         f"over the {n}-device mesh; pad it (pad_to_multiple)")
    parts = torch.split(p0, p0.shape[0] // n)
    return ShardedBatch(mesh, tuple(c.to(d) for c, d in zip(parts, mesh.device_list)))


def shard_like(x, batch: ShardedBatch) -> list:
    """``x`` per shard of ``batch``: the chunks of a ``ShardedBatch`` on the
    same mesh, a (B, ...) tensor or array split as ``batch``, a scalar (a
    0-d tensor moved to each shard's device) alike for every shard."""
    devs = batch.mesh.device_list
    if isinstance(x, ShardedBatch):
        if x.mesh.device_list != devs or [c.shape[0] for c in x.chunks] != [
                c.shape[0] for c in batch.chunks]:
            raise ValueError("two sharded batches of one trace must share the mesh and split")
        return list(x.chunks)
    if isinstance(x, (int, float)):
        return [x] * len(devs)
    t = torch.as_tensor(x)
    if t.ndim == 0:
        return [t.to(d) for d in devs]
    if t.shape[0] != batch.shape[0]:
        raise ValueError(f"a per-ray array of {t.shape[0]} rows for a batch of "
                         f"{batch.shape[0]}")
    parts = torch.split(t, [c.shape[0] for c in batch.chunks])
    return [c.to(d) for c, d in zip(parts, devs)]


def gather(mesh: Mesh, parts) -> torch.Tensor:
    """The shards' tensors concatenated along their leading axis on the
    mesh's first device (one shard's tensor as it is)."""
    if len(parts) == 1:
        return parts[0]
    dev = mesh.device_list[0]
    return torch.cat([p.to(dev) for p in parts])


_REPLICA_LOCK = threading.Lock()
# (id(env), kind, devices) -> one EnvData a shard, None where the shard takes
# the environment itself (an entry holds no reference to it); evicted when
# the environment is garbage-collected, as envdata._MIRROR_CACHE
_REPLICA_CACHE = {}


def _per_shard(env, mesh, kind, build, key):
    """Per-shard environments, memoized per environment object and mesh:
    ``build(env, i, device)`` for shard i, None for the environment itself,
    made once for each distinct ``key(i, device)``."""
    devs = mesh.device_list
    k = (id(env), kind, devs)
    with _REPLICA_LOCK:
        got = _REPLICA_CACHE.get(k)
    if got is None:
        made = {}
        for i, d in enumerate(devs):
            if key(i, d) not in made:
                made[key(i, d)] = build(env, i, d)
        got = tuple(made[key(i, d)] for i, d in enumerate(devs))
        with _REPLICA_LOCK:
            _REPLICA_CACHE[k] = got
        weakref.finalize(env, _REPLICA_CACHE.pop, k, None)
    return tuple(env if e is None else e for e in got)


def replicate_env(env, mesh: Mesh) -> tuple:
    """The environment on every device of the mesh, one ``EnvData`` a
    shard: the environment itself on its own device, one copy on each
    other distinct device (shards on one device share it)."""
    return _per_shard(env, mesh, "replica",
                      lambda e, i, d: None if e.device == d else e.to(d), lambda i, d: d)


def ensemble_shards(env_ens, mesh: Mesh) -> tuple:
    """An ensemble's realizations split over a 1D mesh: shard i holds
    realizations [i E/n, (i+1) E/n) on the mesh's i-th device.  ``E`` must
    divide evenly over the mesh, else ``ValueError`` (as the JAX package)."""
    from ..envdata import DATA_FIELDS

    n = mesh_size(mesh, "trace_ensemble")
    E = env_ens.c.shape[0]
    if E % n:
        raise ValueError(f"ensemble size {E} must divide evenly over the {n}-device mesh")
    El = E // n

    def part(e, i, d):
        return dataclasses.replace(
            e, **{f: getattr(e, f)[i * El:(i + 1) * El].to(d) for f in DATA_FIELDS})

    return _per_shard(env_ens, mesh, "ensemble", part, lambda i, d: i)


def run_shards(mesh: Mesh, fn, *per_shard, threads=None, kernels=True) -> list:
    """``fn(*args_i)`` for each shard i of ``mesh`` (``args_i``: the i-th
    entry of each ``per_shard`` sequence), the results in shard order.

    ``threads``: run the shards in worker threads; by default on a mesh of
    two or more CUDA devices (see the module's docstring).  ``kernels``:
    load the kernel libraries on the calling thread before any worker
    starts (they are built at first use).  A shard's exception re-raises
    here after every shard has ended.  Each shard's launches go to
    ``mesh.launches``."""
    from ..ops import stepper

    devs = mesh.device_list
    args = list(zip(*per_shard)) if per_shard else [()] * len(devs)
    if threads is None:
        threads = len(devs) > 1 and all(d.type == "cuda" for d in devs)
    streams = {d: torch.cuda.current_stream(d) for d in set(devs) if d.type == "cuda"}
    if threads and kernels and any(d.type == "cuda" for d in devs):
        stepper.load_kernels()
    grad = torch.is_grad_enabled()

    def one(i):
        with contextlib.ExitStack() as ctx:
            ctx.enter_context(torch.set_grad_enabled(grad))
            if devs[i].type == "cuda":
                ctx.enter_context(torch.cuda.device(devs[i]))
                ctx.enter_context(torch.cuda.stream(streams[devs[i]]))
            before = stepper.thread_launches()
            out = fn(*args[i])
            after = stepper.thread_launches()
        return out, {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}

    if threads:
        with ThreadPoolExecutor(max_workers=len(devs)) as pool:
            futures = [pool.submit(one, i) for i in range(len(devs))]
        done = [f.result() for f in futures]
    else:
        done = [one(i) for i in range(len(devs))]
    mesh.launches = [c for _, c in done]
    return [out for out, _ in done]
