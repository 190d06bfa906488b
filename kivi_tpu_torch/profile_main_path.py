"""Where the time of the PyTorch/CUDA port's main path goes, on one GPU.

    python3 -m kivi_tpu_torch.profile_main_path [--path P] [--layers N]
                                                 [--steps S]

Builds kivi_tpu_torch's Engine at Llama-2-7B width with random bf16
weights (batch 8, 4096-token cache), a configuration chip_smoke.py
drives.  --path picks the cache and the prefill:

  * chunked (default): KIVI-2 (group 32, residual 128, v_flush 128),
    prompts prefilled in chunks of 128 through the extend path;
  * oneshot: KIVI-2, one-shot prefill (flash_attention, then ingest);
  * fp16: the fp16-cache baseline, one-shot prefill;
  * batcher: the continuous batcher over KIVI-2 slot caches (8 slots,
    bucketed admission), every slot at its own fill;
  * long: the long-context slice at Llama-3.1-8B width, batch 1, KIVI-2
    with group 32 and residual 32, a 16,384-token cache, a 12,000-token
    prompt left-padded to 12,032 in chunks of 128 (the split routes:
    flash_extend_qhist once the history passes SPLIT_MIN_HISTORY,
    qk_dequant_matmul + pv_dequant_matmul in every decode step).

Two windows, each run once without and once under torch.profiler:

  * prefill: 8 prompts of 1024 tokens (long: one of 12,032);
  * decode: S greedy steps after it (with KIVI-2, step 0 carries a
    V-window flush), each step a replay of the engine's CUDA graph (the
    first pass captures it).

With --path spec-self or spec-shallow the windows are two batch-1
generations of S tokens after a 1000-token prompt: the target Engine's
own generate(), then SpeculativeEngine.generate() (k = 8) with draft
"self" (the target's weights over an fp16 cache) or "shallow" (2 random
layers at the same width over KIVI-2), each run once to capture its
graphs, then timed, then profiled.
With --path batcher the one window is S batcher steps (one batched
decode step each, a replay of the batcher's CUDA graph for the step's
fill bound: the masked per-slot appends, whose quantizers launch every
step and load only the rows that flush, attention with per-row
counters, per-row sampling) after 8 requests of 100-1000 prompt tokens
were admitted.

For each window it prints the host wall time without the profiler, the
device busy time (union of all kernel and copy intervals, profiled),
the idle share 1 - busy/wall, the profiled span (first device start to
last end) with its own idle share, and the device time by category and
by kernel name with launch counts.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import re
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from kivi_tpu_torch.config import PRESETS, QuantConfig
from kivi_tpu_torch.models import modeling
from kivi_tpu_torch.serving.engine import Engine
from kivi_tpu_torch.utils.device import card

B, PROMPT, CHUNK, TMAX = 8, 1024, 128, 4096
LONG_PROMPT, LONG_PAD, LONG_TMAX = 12032, 32, 16384
# kernel name fragment -> wrapper; kdec::decode_kernel<R, ST, Ablation<V>,
# ROWS> is the host-int (wide) kernel at ROWS false, the per-row one at true
OURS = {"qpack_tile_kernel": "quantize_pack_k/v",
        "qpack_any_kernel": "quantize_pack_k/v",
        "Ablation<0>, false>": "fused_decode_attention_wide",
        "Ablation<0>, true>": "fused_decode_attention",
        # both entries (host-int and per-row) launch the one kernel
        "flash_extend_kernel": "flash_extend_attention",
        "flash_prefill_kernel": "flash_attention",
        "fp_decode_split_kernel": "fp_decode_attention_kernel",
        "qk_dequant_kernel": "qk_dequant_matmul",
        "pv_dequant_kernel": "pv_dequant_matmul",
        "qhist_split_kernel": "flash_extend_qhist",
        "qhist_merge_kernel": "flash_extend_qhist"}
QCFG = {"chunked": QuantConfig(2, 2, 32, 128, v_flush=128),
        "oneshot": QuantConfig(2, 2, 32, 128, v_flush=128),
        "fp16": QuantConfig(16, 16, 32, 128),
        "batcher": QuantConfig(2, 2, 32, 128, v_flush=128),
        "long": QuantConfig(2, 2, 32, 32),
        "spec-self": QuantConfig(2, 2, 32, 128, v_flush=128),
        "spec-shallow": QuantConfig(2, 2, 32, 128, v_flush=128)}
SPEC_PROMPT, SPEC_K = 1000, 8
GEMM = re.compile(r"gemm|nvjet|cutlass|xmma|cublas", re.I)
# the masked per-slot window appends (quant_pack.masked_store_write)
SCATTER = re.compile(r"scatter|gather", re.I)


def category(name: str) -> str:
    for prefix, label in OURS.items():
        if prefix in name:
            return label
    if GEMM.search(name):
        return "matmul (cuBLAS)"
    if SCATTER.search(name):
        return "masked slot writes (gather/scatter)"
    return "other torch ops"


def device_events(what: str, prof) -> list:
    """The profiled device events (kernels and copies, those launched by
    a CUDA graph's replay included); raises when there are none."""
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ev:
        raise RuntimeError(f"{what}: the profiler recorded no device "
                           "activity")
    return ev


def busy_span_us(ev) -> tuple:
    """(device busy, span) in µs: the union of the events' intervals,
    and the first start to the last end."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in ev)
    busy, (cur_s, cur_e) = 0.0, iv[0]
    for s, e in iv[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, max(e for _, e in iv) - iv[0][0]


def report(what: str, prof, wall_s: float) -> None:
    ev = device_events(what, prof)
    busy, span = busy_span_us(ev)
    # the profiler slows the host, which stretches the span; the idle
    # share against the unprofiled wall is the one a user sees
    print(f"[{what}] host wall {wall_s * 1e3:.3f} ms without the profiler | "
          f"device busy {busy / 1e3:.3f} ms | idle share "
          f"{1 - busy / 1e3 / (wall_s * 1e3):.4f} of that wall | profiled "
          f"span {span / 1e3:.3f} ms, idle share {1 - busy / span:.4f}")
    by_cat = collections.Counter()
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in ev:
        dt = e.time_range.end - e.time_range.start
        by_cat[category(e.name)] += dt
        by_name[e.name][0] += dt
        by_name[e.name][1] += 1
    for cat, t in by_cat.most_common():
        print(f"[{what}]   {cat:30s} {t / 1e3:10.3f} ms "
              f"({t / busy:.4f} of busy)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (t, n) in top:
        print(f"[{what}]     {t / 1e3:10.3f} ms {n:6d}x  {name[:110]}")


def profile_batcher(cfg, steps: int, smi: str) -> None:
    """The continuous batcher's decode step, every slot busy at its own
    fill: S steps timed without the profiler, then S under it."""
    from kivi_tpu_torch.serving.batcher import ContinuousBatcher, Request
    bat = ContinuousBatcher(cfg, QCFG["batcher"],
                            modeling.init_params(cfg, seed=0,
                                                 device="cuda"),
                            num_slots=B, max_seq_len=TMAX,
                            prompt_buckets=(128, 256, 512, 1024))
    gen = torch.Generator()
    gen.manual_seed(1)
    lens = (100, 137, 240, 400, 555, 640, 800, 1000)
    for i, n in enumerate(lens):
        bat.submit(Request(uid=i, prompt=torch.randint(
            0, cfg.vocab_size, (n,), generator=gen).tolist(),
            max_new_tokens=3 * steps + 8))
    bat.step()                         # admits all 8, decodes once
    for _ in range(steps):             # warm
        bat.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        bat.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            bat.step()
        torch.cuda.synchronize()
    fills = (bat.caches[0].seq_len - bat.pad_dev.to(torch.int32)).tolist()
    print(f"[config] llama2-7b width, {cfg.num_layers} layers, continuous "
          f"batcher over KIVI-2 slot caches, {B} slots, prompts {lens} "
          f"(bucketed), true fills at the end {fills}, {steps} steps, "
          f"CUDA graphs | card {smi}")
    report("decode", prof, wall)
    print(f"[decode] {B * steps / wall:.1f} tokens/s, "
          f"{wall / steps * 1e3:.3f} ms per step")


def profile_spec(cfg, path: str, steps: int, smi: str) -> None:
    """A batch-1 generation of `steps` tokens by the target Engine, then
    by SpeculativeEngine over the draft `path` names, each timed after a
    warm call (its captures) and then profiled."""
    from kivi_tpu_torch.serving.speculative import SpeculativeEngine
    qcfg = QCFG[path]
    params = modeling.init_params(cfg, seed=0, device="cuda")
    target = Engine(cfg=cfg, qcfg=qcfg, params=params, max_seq_len=TMAX,
                    batch_size=1)
    if path == "spec-self":
        draft = Engine(cfg=cfg, qcfg=QuantConfig(16, 16, 32, 128),
                       params=params, max_seq_len=TMAX, batch_size=1)
    else:
        dcfg = dataclasses.replace(cfg, num_layers=2)
        draft = Engine(cfg=dcfg, qcfg=qcfg,
                       params=modeling.init_params(dcfg, seed=11,
                                                   device="cuda"),
                       max_seq_len=TMAX, batch_size=1)
    spec = SpeculativeEngine(target, draft, k=SPEC_K)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    tokens = torch.randint(1, cfg.vocab_size, (1, SPEC_PROMPT),
                           generator=gen, device="cuda")
    print(f"[config] llama2-7b width, {cfg.num_layers} layers, KIVI-2 "
          f"target at batch 1, prompt {SPEC_PROMPT} one-shot, {steps} "
          f"tokens; draft {path[5:]}, k {SPEC_K}; CUDA graphs | card {smi}")
    for what, run in (("target", lambda: target.generate(tokens, steps)),
                      (path, lambda: spec.generate(tokens, steps))):
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        report(what, prof, wall)
        extra = ""
        if what != "target":
            acc = spec.last_acceptance
            extra = (f", {len(acc)} iterations, mean accepted "
                     f"{sum(acc) / len(acc):.3f}")
        print(f"[{what}] {steps / wall:.1f} tokens/s (prefill included)"
              f"{extra}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--path", choices=sorted(QCFG), default="chunked")
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--steps", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_main_path: CUDA is not available")
    smi = card()
    print(f"[card] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}")

    long = args.path == "long"
    preset = "llama3.1-8b" if long else "llama2-7b"
    cfg = dataclasses.replace(PRESETS[preset], num_layers=args.layers)
    if args.path == "batcher":
        profile_batcher(cfg, args.steps, smi)
        return
    if args.path.startswith("spec"):
        profile_spec(cfg, args.path, args.steps, smi)
        return
    Bp, prompt, tmax = (1, LONG_PROMPT, LONG_TMAX) if long else (B, PROMPT,
                                                                  TMAX)
    pad = [LONG_PAD] if long else None
    eng = Engine(cfg=cfg, qcfg=QCFG[args.path],
                 params=modeling.init_params(cfg, seed=0, device="cuda"),
                 max_seq_len=tmax, batch_size=Bp)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (Bp, prompt), generator=gen,
                           device="cuda")
    pos = torch.full((Bp, 1), prompt, device="cuda")
    if long:
        tokens[:, :LONG_PAD] = 0
        pos = pos - LONG_PAD

    def prefill():
        # into the engine's own caches, as generate() does: the decode
        # graph captured over them in the first pass is replayed after
        caches = eng.own_caches()
        if args.path in ("chunked", "long"):
            return eng.prefill_chunked(tokens, CHUNK, caches, pad_lens=pad)
        return eng._prefill(tokens, caches)

    def decode(logits, caches):
        first = logits.argmax(-1).to(torch.int32)[:, None]
        return eng.decode(first, pos, caches, steps=args.steps,
                          prompt_len=prompt, pad_lens=pad)

    walls = {}
    for rep in range(2):    # the first pass builds, warms and captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill()
        torch.cuda.synchronize()
        walls["prefill"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        decode(logits, caches)
        torch.cuda.synchronize()
        walls["decode"] = time.perf_counter() - t0

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as p_pre:
        logits, caches = prefill()
        torch.cuda.synchronize()
    with profile(activities=acts) as p_dec:
        decode(logits, caches)
        torch.cuda.synchronize()
    how = {"chunked": f"KIVI-2, prompt {PROMPT} in chunks of {CHUNK}",
           "oneshot": f"KIVI-2, prompt {PROMPT} one-shot",
           "fp16": f"fp16 cache, prompt {PROMPT} one-shot",
           "long": f"KIVI-2 (group 32, residual 32), prompt {prompt} (left "
                   f"pad {LONG_PAD}) in chunks of {CHUNK}, cache {tmax}"
           }[args.path]
    print(f"[config] {preset} width, {args.layers} layers, {how}, batch "
          f"{Bp}, {args.steps} decode steps, CUDA graphs | card {smi}")
    report("prefill", p_pre, walls["prefill"])
    report("decode", p_dec, walls["decode"])
    print(f"[decode] {Bp * args.steps / walls['decode']:.1f} tokens/s, "
          f"{walls['decode'] / args.steps * 1e3:.3f} ms per step")


if __name__ == "__main__":
    main()
