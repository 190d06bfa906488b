"""Multi-process bring-up and the global mesh: port of
`kivi_tpu/parallel/multihost.py`.

One process per device.  Every process runs the same program:
`initialize` joins the processes into one `torch.distributed` world
(NCCL on CUDA, gloo on the CPU: chosen from the device, never by trying
one and falling back to the other), `global_mesh` lays a (data, model)
mesh over all of them, tensor parallelism within a host's devices where
it can, and each process feeds its own batch rows (`feed_batch`).

Nothing discovers a cluster: the caller gives the coordinator's address,
the process count and this process's id.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from kivi_tpu_torch.parallel.mesh import auto_mesh_shape, make_mesh
from kivi_tpu_torch.utils.device import resolve_device


def backend_for(device) -> str:
    """The collective backend of a device type: NCCL for CUDA, gloo for
    the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: int = 1, process_id: int = 0,
               device=None) -> torch.device:
    """Join this process to the world: `dist.init_process_group` over
    `coordinator_address`, "host:port" (TCP; process 0 listens there) or
    an init-method URL such as "file:///path" (a FileStore).  On CUDA
    (unless device says otherwise) the process first takes the card
    `process_id % device_count` and the backend is NCCL; on the CPU it
    is gloo.  Returns the device this process computes on."""
    if coordinator_address is None:
        raise ValueError("initialize needs coordinator_address: host:port "
                         "or an init-method URL (tcp://, file://)")
    device = resolve_device(device)
    if device.type == "cuda":
        device = torch.device("cuda",
                              process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend_for(device), init_method=url,
                            world_size=num_processes, rank=process_id)
    return device


def global_mesh(num_kv_heads: int, n_model: Optional[int] = None,
                device=None):
    """A (data, model) mesh over every process of the world.  `model`
    (tensor parallelism over KV heads) is kept within one host's devices
    when it can: by default the largest axis dividing both the host's
    device count (on the CPU: the world) and num_kv_heads; `data` takes
    the rest."""
    device = resolve_device(device)
    n = dist.get_world_size()
    local = torch.cuda.device_count() if device.type == "cuda" else n
    if n_model is None:
        _, n_model = auto_mesh_shape(min(local, n), num_kv_heads)
    if n % n_model:
        raise ValueError(f"{n} processes do not split into model axes of "
                         f"{n_model}")
    return make_mesh(n // n_model, n_model, device)


def feed_batch(mesh, local_tokens) -> torch.Tensor:
    """This process's batch rows (its data coordinate's shard of the
    global batch), on its device.  The global batch is never assembled:
    the engine works on the rows its rank holds (every rank of a model
    group feeds the same rows)."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device("cpu"))
    return torch.as_tensor(local_tokens, device=dev)

