"""`engine_jobs` for a block whose layers hold caches of two kinds (the
K-EXAONE block: bf16 rings in the sliding layers, the KIVI cache in the
full ones): the same jobs, window, counts and check, with two changes.

  * The check reads the windows of the KIVI layers alone, which the
    family names (`kivi_layers(cfg)`), in their order: `window_layers`
    and `window_kv` compare those with the reference's, which keeps the
    full layers' keys and values in the same order.  A ring has no
    window to flush and no quantized count.
  * The engine's expert log (`Engine.experts`: the tokens on each held
    expert at every expert-layer call) is cleared as each job starts, so
    that after a traced run it holds the profiled job's calls; they go
    to the trace's counters as `expert_calls`, read after the slice has
    closed, for `expert_roofline.gen`.

Traffic parameters: `engine_jobs`'.
"""

from __future__ import annotations

import importlib.util
import os

_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "engine_jobs.py")
_spec = importlib.util.spec_from_file_location("kvbench_driver_engine_jobs",
                                               _path)
base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(base)

State, inputs, release = base.State, base.inputs, base.release


def setup(cell, params):
    st = base.setup(cell, params)
    eng, prefill_prefix = st.eng, st.eng.prefill_prefix

    def cleared(*a, **kw):
        eng.experts.clear()
        return prefill_prefix(*a, **kw)

    eng.prefill_prefix = cleared
    return st


def window(st, cell, rec) -> None:
    base.window(st, cell, rec)
    if rec.profile is not None:
        rec.profile.counters["expert_calls"] = st.eng.experts.calls()


def check_items(st, cell, rec) -> list:
    if st.caches is not None:
        st.caches = [st.caches[i]
                     for i in cell.family.kivi_layers(cell.cfg)]
    return base.check_items(st, cell, rec)
