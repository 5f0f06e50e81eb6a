"""Device meshes for the single-controller sharded paths (port of
control_gic_tpu/parallel/mesh.py).

The JAX package's `Mesh` serves two purposes: jit over a batch sharded on a
'data' axis (training, where XLA inserts the gradient psums) and shard_map
over the devices of one host (the tile mesh and the H-sharded codec). The
port keeps them apart. Training runs one process per card and does its
collectives through a process group (parallel/multihost.py). The inference
paths run in one process over a `Mesh`: an ordered array of
`torch.device`s with axis names, over which the sharded bodies run SPMD as a
list of per-device shards, their collectives written out (a halo is a copy of
the neighbour's rows, a psum a sum on one device handed back to each, an
all-gather a `torch.cat`).

`make_mesh(n)` takes the first n CUDA devices, as JAX takes the first n of
`jax.devices()`. `devices=` names the devices instead, repeats allowed: a
mesh of `["cuda:0"] * n` runs an n-shard program on one card, and
`["cpu"] * n` is the CPU tests' counterpart of JAX's virtual CPU devices.
"""
from __future__ import annotations

import copy
import weakref
from typing import Callable, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn


def _balanced_shape(n: int, k: int) -> tuple:
    """Factor n into k axis sizes, as even as possible (largest first).

    Greedy: for each remaining axis, pick the largest divisor of the
    remaining device count that is <= ceil(remaining ** (1/axes_left)),
    falling back to 1. Product always equals n (8 devices, 2 axes -> (4, 2);
    6, 2 -> (3, 2); 7, 2 -> (7, 1))."""
    factors = []
    rem = n
    for axes_left in range(k, 0, -1):
        if axes_left == 1:
            factors.append(rem)
            break
        target = int(np.ceil(rem ** (1 / axes_left)))
        d = next(c for c in range(target, 0, -1) if rem % c == 0)
        factors.append(d)
        rem //= d
    return tuple(sorted(factors, reverse=True))


class Mesh:
    """An n-D array of devices with named axes. `devices` is the numpy
    object array (as `jax.sharding.Mesh.devices`), `shape` maps each axis
    name to its size (as `Mesh.shape`)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str = "data") -> List[torch.device]:
        """The devices along `axis`, at index 0 of every other axis: where
        the shards of an array split over `axis` live."""
        a = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        idx[a] = slice(None)
        return list(self.devices[tuple(idx)])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("data",),
              devices: Optional[Sequence[Union[str, torch.device]]] = None
              ) -> Mesh:
    """1-D (default) or n-D mesh over the first n_devices CUDA devices, or
    over `devices` (repeats allowed; the first n_devices of them when both
    are given). n-D meshes factor the device count into as-even-as-possible
    axis sizes (8 devices / 2 axes -> 4x2). Raises when CUDA is missing and
    no devices are named: nothing falls back to the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh needs CUDA devices; name the "
                               "devices with devices= to run elsewhere")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"{n_devices} devices asked, {len(devices)} "
                             "available")
        devices = devices[:n_devices]
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    if len(axis_names) > 1:
        arr = arr.reshape(_balanced_shape(len(devices), len(axis_names)))
    return Mesh(arr, axis_names)


class Sharding(NamedTuple):
    """How an array lies on a mesh: dim 0 split over `axis`, or replicated
    (axis None) on every device of the mesh."""
    mesh: Mesh
    axis: Optional[str]

    def put(self, x) -> List[torch.Tensor]:
        """One tensor per device of the mesh (flattened order): the device's
        block of dim 0 (its index along `axis`), or the whole array."""
        x = torch.as_tensor(x)
        mesh = self.mesh
        if self.axis is None:
            return [x.to(d) for d in mesh.devices.flat]
        n = mesh.shape[self.axis]
        if x.shape[0] % n:
            raise ValueError(f"dim 0 of {tuple(x.shape)} does not divide "
                             f"over {n} devices")
        blocks = torch.chunk(x, n)
        a = mesh.axis_names.index(self.axis)
        return [blocks[pos[a]].to(d)
                for pos, d in np.ndenumerate(mesh.devices)]


def data_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    """Batch-dim sharding for [B, ...] arrays."""
    return Sharding(mesh, axis)


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def shard_batch(mesh: Mesh, batch, axis: str = "data") -> List[torch.Tensor]:
    """A host batch split on dim 0 over the mesh's `axis`: one tensor per
    device, on that device."""
    return data_sharding(mesh, axis).put(batch)


def _canon(d: Union[str, torch.device]) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def same_device(a: Union[str, torch.device],
                b: Union[str, torch.device]) -> bool:
    """Whether two device names are one device ("cuda" is the current
    card)."""
    return _canon(a) == _canon(b)


def weights_stamp(module: nn.Module) -> tuple:
    """Changes when a parameter or buffer of the module is replaced or
    changed in place."""
    return tuple((t.data_ptr(), t._version)
                 for t in (*module.parameters(), *module.buffers()))


# object -> (its weights' stamp, {device: copy}); entries go with the object
_REPLICAS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def replica(obj, device: Union[str, torch.device], weights: nn.Module,
            make: Callable[[torch.device], object]):
    """obj's copy on `device`, made by make(device) at the first call and
    again after the weights of `weights` change."""
    stamp = weights_stamp(weights)
    cached = _REPLICAS.get(obj)
    if cached is None or cached[0] != stamp:
        cached = _REPLICAS[obj] = (stamp, {})
    device = _canon(device)
    if device not in cached[1]:
        cached[1][device] = make(device)
    return cached[1][device]


def module_replicas(module: nn.Module,
                    devices: Sequence[torch.device]) -> List[nn.Module]:
    """The module on each of `devices`: itself where it lives, a copy
    elsewhere (`replica`). A mesh of one device repeated gets the module n
    times."""
    home = next(module.parameters()).device
    return [module if same_device(d, home) else
            replica(module, d, module,
                    lambda d: copy.deepcopy(module).to(d))
            for d in devices]
