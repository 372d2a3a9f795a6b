"""Batched greedy serving: prefill a batch of prompts, then decode through
the caches (counterpart: ``examples/serve_decode.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch ARCH \
        [--layers N] [--batch 8] [--prompt-len 1024] [--tokens 32]

with ARCH one of ``SERVED_ARCHS`` (chatglm3-6b, recurrentgemma-2b,
falcon-mamba-7b, phi-3-vision-4.2b, qwen2-7b, stablelm-1.6b, starcoder2-3b,
whisper-small, dbrx-132b, llama4-maverick-400b-a17b); it runs the
configuration at its published widths with
random weights from ``--seed`` on the CUDA card and prints one JSON line of
timings, taken after a short untimed warm-up (which also builds the
kernels).  For phi-3-vision-4.2b each prompt of ``--prompt-len`` text tokens
comes after the config's 1024 image-patch embeddings, drawn standard normal
from the same seeded generator (the vision frontend is a stub, as in the
reference).  For whisper-small the encoder takes the config's 1500 frame
embeddings, drawn the same way (the conv frontend is a stub), and the
prompts are decoder tokens (448 positions is the published context).
The two MoE models outgrow one 80 GB card at full depth (about 264 and 800
GB of bf16 weights): ``--layers 8`` serves dbrx-132b and ``--layers 4``
llama4-maverick-400b-a17b (one period of its pattern: three chunked layers
and a global one, two of them MoE) at about 55 and 70 GB.
``--reduced --device cpu`` runs the test-size configuration on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs import SERVED_ARCHS, get_config, get_reduced
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models.transformer import Transformer


@dataclass
class Generation:
    tokens: torch.Tensor     # (B, max_new) greedy tokens
    logits: torch.Tensor     # (B, max_new, V) fp32: the logits each was chosen from
    prefill_s: float         # host seconds for the prefill, synchronised
    decode_s: float          # host seconds for the max_new - 1 decode steps


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: Transformer, prompts: torch.Tensor, max_new: int,
             img_embeds: Optional[torch.Tensor] = None,
             frames: Optional[torch.Tensor] = None) -> Generation:
    """Greedy continuation of ``prompts`` (B, S), after the image embeddings
    (B, N, d) of an ``img_tokens`` model: one prefill over the N + S
    positions, then ``max_new - 1`` decode steps from position N + S, each
    on the previous step's argmax.  An ``is_encdec`` model takes the frames
    (B, T, d) it encodes in the prefill; positions count the tokens only."""
    if max_new < 1:
        raise ValueError("max_new must be at least 1")
    # positions the prefill fills, image ones first
    S = prompts.shape[1] + (0 if img_embeds is None else img_embeds.shape[1])
    prefill = make_prefill_step(model, max_len=S + max_new)
    decode = make_decode_step(model)
    dev = prompts.device
    batch = {"tokens": prompts}
    if img_embeds is not None:
        batch["img_embeds"] = img_embeds
    if frames is not None:
        batch["frames"] = frames
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(batch)
    cur = logits[:, 0].argmax(-1, keepdim=True)
    _sync(dev)
    t1 = time.perf_counter()
    toks, lgs = [cur], [logits[:, 0]]
    for i in range(max_new - 1):
        logits, cache = decode({"token": cur, "pos": S + i, "caches": cache})
        cur = logits[:, 0].argmax(-1, keepdim=True)
        toks.append(cur)
        lgs.append(logits[:, 0])
    _sync(dev)
    t2 = time.perf_counter()
    return Generation(torch.cat(toks, 1), torch.stack(lgs, 1), t1 - t0, t2 - t1)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="chatglm3-6b", choices=SERVED_ARCHS)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to N layers (0: the config's own)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises when there is no card)")
    ap.add_argument("--reduced", action="store_true",
                    help="the test-size configuration of the same family")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = Transformer(cfg, device, seed=args.seed)
    g = torch.Generator(device=device).manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=g, device=device)
    img = frames = None
    if cfg.img_tokens:     # as the reference's train.py draws them
        img = torch.randn(args.batch, cfg.img_tokens, cfg.d_model,
                          generator=g, device=device).to(model.dtype)
    if cfg.is_encdec:      # likewise
        frames = torch.randn(args.batch, cfg.enc_seq, cfg.d_model,
                             generator=g, device=device).to(model.dtype)
    # not timed: the kernels' first-use build, cuBLAS handles, the allocator
    generate(model, prompts[:, :16], 2, None if img is None else img[:, :16],
             frames)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    out = generate(model, prompts, args.tokens, img, frames)
    summary = {
        "arch": cfg.name, "layers": cfg.n_layers, "device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "batch": args.batch, "prompt_len": args.prompt_len,
        "img_tokens": cfg.img_tokens,
        "enc_frames": cfg.enc_seq if cfg.is_encdec else 0,
        "tokens": args.tokens,
        "prefill_ms": out.prefill_s * 1e3,
        "decode_tok_per_s": args.batch * (args.tokens - 1) / out.decode_s
        if args.tokens > 1 else None,
        "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                        if device.type == "cuda" else None),
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
