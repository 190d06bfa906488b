"""Parameters of the JAX package -> parameters of the port.

The JAX package's params pytree (`kivi_tpu/models/modeling.py:356-381`)
is {"embed" (V, Hd), "layers": {name: stacked (L, ...) array}, "ln_f"
(Hd,), "lm_head" (Hd, V)}.  Both packages compute `x @ W` with W of
shape (in, out), so no weight is transposed: the stacked layer arrays
are split into the port's list of per-layer dicts and moved to the
device in the requested dtype.  Pass the arrays as numpy (e.g.
`jax.tree_util.tree_map(np.asarray, params)`); this module never
imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(np_params: dict, device, dtype=torch.bfloat16) -> dict:
    """np_params: the JAX params pytree with numpy leaves.  Returns the
    port's params {"embed", "layers": [per-layer dict], "ln_f",
    "lm_head"} on `device` in `dtype`."""
    device = torch.device(device)

    def t(a) -> torch.Tensor:
        # bf16 numpy arrays (ml_dtypes) have no torch counterpart: go
        # through f32, which holds every bf16 value exactly
        a = np.array(a)             # a writable copy
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    stacked = np_params["layers"]
    n_layers = len(next(iter(stacked.values())))
    layers = [{name: t(arr[i]) for name, arr in stacked.items()}
              for i in range(n_layers)]
    return {"embed": t(np_params["embed"]), "layers": layers,
            "ln_f": t(np_params["ln_f"]), "lm_head": t(np_params["lm_head"])}
