"""Text generation CLI on the dense Generator.

Counterpart of simplellminference_tpu/cli/generate.py in its no-model
path (:100-176): a random-weight TinyLlama (4 layers, the byte
tokenizer's 258-token vocabulary), optionally INT8- or INT4-quantized on
the device, with W8A8 prefill under ``--act-quant``, generating with the
Python loop and streaming detokenization.

Usage:
    python -m simplellminference_tpu_torch.cli.generate \\
        --prompt "..." --max-new-tokens 128 [--quant int8|int4] \\
        [--act-quant] [--temperature 0.8 --top-k 50 --top-p 0.95] [--cpu]

Checkpoint loading (``--model-dir``, ``--blob``) is not ported yet, so the
CLI has no options for it.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--prompt", default="Once upon a time")
    ap.add_argument("--max-new-tokens", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--min-p", type=float, default=0.0)
    ap.add_argument("--repetition-penalty", type=float, default=1.0)
    ap.add_argument("--frequency-penalty", type=float, default=0.0)
    ap.add_argument("--presence-penalty", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quant", default="none",
                    choices=["none", "int8", "int4"])
    ap.add_argument("--act-quant", action="store_true",
                    help="W8A8 prefill: per-token int8 activations against "
                         "INT8 weights for products of 128 rows or more "
                         "(takes --quant int8)")
    ap.add_argument("--group-size", type=int, default=128)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--max-seq", type=int, default=2048)
    ap.add_argument("--no-stream", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU")
    args = ap.parse_args(argv)

    import torch

    from simplellminference_tpu_torch.core.config import (ModelConfig,
                                                          QuantConfig,
                                                          SamplingParams)
    from simplellminference_tpu_torch.models import llama
    from simplellminference_tpu_torch.runtime.generator import Generator
    from simplellminference_tpu_torch.runtime.weights import quantize_params
    from simplellminference_tpu_torch.tokenizer import (ByteTokenizer,
                                                        StreamingDetokenizer)

    device = "cpu" if args.cpu else None
    quant = QuantConfig(mode=args.quant, group_size=args.group_size)
    t0 = time.perf_counter()
    print("[random TinyLlama + byte tokenizer]",
          file=sys.stderr)
    cfg = ModelConfig.tinyllama_1_1b(num_layers=4, dtype=args.dtype,
                                     vocab_size=258)
    params = llama.init_params(cfg, seed=args.seed, device=device)
    if quant.enabled:
        params = quantize_params(params, quant)
    tok = ByteTokenizer()
    load_s = time.perf_counter() - t0

    if args.act_quant:
        cfg = dataclasses.replace(cfg, act_quant="int8")
    gen = Generator(cfg, params, max_batch=1,
                    max_seq=min(args.max_seq, cfg.max_seq_len),
                    device=device)
    prompt_ids = tok.encode(args.prompt)
    if len(prompt_ids) + args.max_new_tokens > gen.max_seq:
        ap.error(f"prompt + --max-new-tokens exceed --max-seq {gen.max_seq}")
    sp = SamplingParams(max_new_tokens=args.max_new_tokens,
                        temperature=args.temperature, top_k=args.top_k,
                        top_p=args.top_p, min_p=args.min_p,
                        repetition_penalty=args.repetition_penalty,
                        frequency_penalty=args.frequency_penalty,
                        presence_penalty=args.presence_penalty,
                        seed=args.seed, stop_token_ids=(tok.eos_id,))

    print(args.prompt, end="", flush=True)
    stream = StreamingDetokenizer(tok)
    t1 = time.perf_counter()
    first_tok_t = None
    n = 0
    # Python-loop generation with streaming output
    cache = gen.new_cache(1)
    last_logits, cache, lens = gen.prefill(cache, [prompt_ids])
    pick = gen.sampler([prompt_ids], sp)
    pos = torch.tensor(lens, dtype=torch.int32, device=gen.device)
    nxt = pick(last_logits, pos - 1)
    while n < sp.max_new_tokens:
        tid = int(nxt.cpu()[0])
        if first_tok_t is None:
            first_tok_t = time.perf_counter()
        if tid in sp.stop_token_ids:
            break
        n += 1
        piece = stream.push(tid)
        if piece and not args.no_stream:
            print(piece, end="", flush=True)
        logits, cache = gen._decode_fn(nxt, pos, cache)
        nxt = pick(logits, pos)
        pos = pos + 1
    tail = stream.flush()
    if args.no_stream:
        print(tok.decode(stream._ids), end="")
    elif tail:
        print(tail, end="")
    print()
    el = time.perf_counter() - t1
    ttft = (first_tok_t - t1) if first_tok_t else 0.0
    print(f"[load {load_s:.1f}s | ttft {ttft*1e3:.0f}ms | "
          f"{n} tokens in {el:.2f}s = {n / max(el, 1e-9):.1f} tok/s]",
          file=sys.stderr)


if __name__ == "__main__":
    main()
