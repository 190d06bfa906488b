"""LongBench end-to-end runner: port of `kivi_tpu/evalsuite/run_longbench.py`
(the reference harness's `pred_long_bench.py` + `eval_long_bench.py`).

Air-gapped design: datasets come from local jsonl files
(`--data-dir/<task>.jsonl`, LongBench record format) and the model from a
local HF checkpoint directory (`models/hf_loader.py`).  Prompts are
left-padded to a bucket, as in the JAX runner: one Engine per cache
bucket, so its decode graphs are captured once per bucket and replayed
for every later prompt of that bucket.

`--impl` keeps the JAX runner's two values (`cli.IMPL_DEVICE`): "pallas"
runs on the card through the CUDA kernels and raises without CUDA;
"jnp" runs the kernels' plain PyTorch versions on the CPU.  The
tokenizer (`transformers.AutoTokenizer`) is imported by `predict`
only: `score` needs nothing beyond the standard library and numpy.

Usage:
  python -m kivi_tpu_torch.evalsuite.run_longbench predict \\
      --model-dir /ckpt/llama2-7b --data-dir /data/longbench \\
      --out-dir pred/llama2-7b-k2v2 --tasks hotpotqa,triviaqa \\
      --k-bits 2 --v-bits 2 --group-size 32 --residual 128
  python -m kivi_tpu_torch.evalsuite.run_longbench score --pred-dir pred/...
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from kivi_tpu_torch.cli import IMPL_DEVICE, add_quant_flags


def _bucket(n: int, buckets=(1024, 2048, 4096, 8192, 16384, 32768)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class BucketedGenerator:
    """`generate_fn(prompt, max_new) -> str` of `predict_task` over the
    port's Engine (kivi_tpu/evalsuite/run_longbench.py:50-75).

    The prompt's ids are left-padded to a bucket: with prefill_chunk C,
    the next multiple of C (prefilled through the chunked extend path);
    without, the next of `_bucket`'s sizes (one-shot prefill).  The
    cache is the bucket of prompt + max_new, and one batch-1 Engine is
    built per cache bucket (`engines`)."""

    def __init__(self, cfg, qcfg, params, tokenizer, device=None,
                 prefill_chunk: int = 0):
        self.cfg, self.qcfg, self.params = cfg, qcfg, params
        self.tok, self.device = tokenizer, device
        self.prefill_chunk = prefill_chunk
        self.engines: dict = {}

    def engine(self, cache_len: int):
        from kivi_tpu_torch.serving.engine import Engine
        if cache_len not in self.engines:
            self.engines[cache_len] = Engine(
                cfg=self.cfg, qcfg=self.qcfg, params=self.params,
                max_seq_len=cache_len, batch_size=1, device=self.device)
        return self.engines[cache_len]

    def __call__(self, prompt: str, max_new: int) -> str:
        import torch
        ids = list(self.tok.encode(prompt))
        C = self.prefill_chunk
        pbucket = (-(-len(ids) // C) * C if C else _bucket(len(ids)))
        cache_len = _bucket(pbucket + max_new)
        eng = self.engine(cache_len)
        pad, steps = pbucket - len(ids), min(max_new, cache_len - pbucket)
        tokens = torch.tensor([[0] * pad + ids], dtype=torch.int64,
                              device=eng.device)
        out = eng.generate(tokens, steps, eos_token_id=self.tok.eos_token_id,
                           pad_lens=[pad], prefill_chunk_size=C or None)
        return self.tok.decode(out[0].tolist(), skip_special_tokens=True)


def cmd_predict(args):
    from transformers import AutoTokenizer

    from kivi_tpu_torch.cli import quant_config_from_args
    from kivi_tpu_torch.evalsuite.longbench import (REFERENCE_TASKS,
                                                    load_jsonl, predict_task)
    from kivi_tpu_torch.models.hf_loader import load_hf_checkpoint
    from kivi_tpu_torch.utils.device import resolve_device

    # "pallas" asks for the card: resolve_device raises without CUDA
    device = resolve_device(None if IMPL_DEVICE[args.impl] == "cuda"
                            else "cpu")
    qcfg = quant_config_from_args(args)
    cfg, params = load_hf_checkpoint(args.model_dir, device=device)
    tok = AutoTokenizer.from_pretrained(args.model_dir)
    max_prompt = args.max_len - 512
    generate_fn = BucketedGenerator(cfg, qcfg, params, tok, device,
                                    prefill_chunk=args.prefill_chunk)

    tasks = (args.tasks.split(",") if args.tasks else REFERENCE_TASKS)
    for task in tasks:
        path = os.path.join(args.data_dir, f"{task}.jsonl")
        if not os.path.exists(path):
            print(f"[skip] {path} not found", file=sys.stderr)
            continue
        data = load_jsonl(path)
        if args.limit:
            data = data[:args.limit]
        predict_task(task, data, generate_fn, tok, max_prompt,
                     model_name=args.model_name or args.model_dir,
                     out_path=os.path.join(args.out_dir, f"{task}.jsonl"),
                     progress=True)


def cmd_score(args):
    from kivi_tpu_torch.evalsuite.longbench import score_dir
    results = score_dir(args.pred_dir, use_e=args.e)
    print(json.dumps(results, indent=2))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="run_longbench")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("predict")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--model-name", default="")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--tasks", default="")
    add_quant_flags(p)          # one flag surface (kivi_tpu_torch/cli.py)
    p.add_argument("--max-len", type=int, default=32768)
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help="prefill in chunks of this many tokens (0 = "
                        "one-shot per prompt bucket)")
    p.add_argument("--impl", default="pallas", choices=sorted(IMPL_DEVICE),
                   help="pallas: the CUDA kernels on the card; jnp: their "
                        "plain PyTorch versions on the CPU")
    p.add_argument("--limit", type=int, default=0)
    p.set_defaults(fn=cmd_predict)

    s = sub.add_parser("score")
    s.add_argument("--pred-dir", required=True)
    s.add_argument("--e", action="store_true")
    s.set_defaults(fn=cmd_score)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
