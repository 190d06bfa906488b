"""Multi-process bring-up of the port (kivi_tpu_torch.parallel.multihost),
as tests/test_multihost.py drives the JAX package's: two REAL processes
join one gloo world through `initialize` (a FileStore under the test's
tmp_path: no free-port race), build the global mesh, feed their own
batch rows through `feed_batch` and all-reduce the global sum, which
both must agree on.  Single-process checks of the backend choice and the
refusals stay in this process.
"""

import numpy as np
import pytest
import torch

from kivi_tpu_torch.parallel import multihost
from torch_dist import spawn


def test_two_process_mesh_and_feed(tmp_path):
    outs = spawn("multihost", 2, tmp_path, {})
    # shard 0: sum(0..23); shard 1: the same + 1000 * 24
    expect = int(np.arange(24).sum() * 2 + 1000 * 24)
    for o in outs:
        assert str(o["backend"]) == "gloo" and str(o["device"]) == "cpu"
        # by default "model" takes the world (2 devices, 4 KV heads)
        assert tuple(o["auto"]) == (1, 2)
        assert tuple(o["mesh"]) == (2, 1)
        assert tuple(o["shape"]) == (4, 6)
        assert int(o["total"][0]) == expect


def test_backend_follows_the_device_and_initialize_refuses():
    assert multihost.backend_for("cuda") == "nccl"
    assert multihost.backend_for(torch.device("cuda", 3)) == "nccl"
    assert multihost.backend_for("cpu") == "gloo"
    with pytest.raises(ValueError, match="coordinator_address"):
        multihost.initialize(None, 1, 0, device="cpu")
    if not torch.cuda.is_available():
        # no silent run on the host: without CUDA and without device=
        # the entry point raises before joining anything
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            multihost.initialize("127.0.0.1:1", 1, 0)
