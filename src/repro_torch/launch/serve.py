"""Batched serving driver: prefill + greedy decode with a KV cache.
Ported from the JAX package's ``repro/launch/serve.py``: plain-token
models (dense, MoE, recurrent, xLSTM), the encoder-decoder (Whisper: the
prompt length is its frame count, the decoder prompt ``S //
decoder_len_ratio`` tokens) and the vision model (InternVL2:
``num_prefix_embeds`` patch embeddings before ``S - P`` tokens); frames
and patches are random normals from ``--seed``, as the reference draws
them.

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve   # StableLM-1.6B, card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b \\
      --batch 2 --prompt-len 4096 --gen 32          # full width, on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b \\
      --smoke --device cpu --batch 2 --prompt-len 160 --gen 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \\
      --batch 2 --prompt-len 4096 --gen 32          # 57.3 GB, on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \\
      --smoke --device cpu --batch 2 --prompt-len 64 --gen 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \\
      --smoke --device cpu --batch 2 --prompt-len 256 --gen 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \\
      --batch 8 --prompt-len 1500 --gen 32     # 30 s of frames, on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-26b \\
      --smoke --device cpu --batch 2 --prompt-len 80 --gen 8

Parameters are random, from ``--seed``; prompts come from
``TokenStream``.  Prints the prefill time and the decode time per token.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.data.synthetic import TokenStream
from repro_torch.launch import steps as steps_lib
from repro_torch.models.model import build_model


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def serve_batch(cfg, batch: int, prompt_len: int, seed: int) -> dict:
    """The CLI's prefill batch, numpy arrays drawn as the reference draws
    them: ``TokenStream(seed)`` prompts of ``prompt_len`` tokens; for an
    encoder-decoder ``prompt_len`` frames of ``default_rng(seed)``
    normals and the first ``prompt_len // decoder_len_ratio`` tokens, for
    a vision model ``num_prefix_embeds`` patches of them and the first
    ``prompt_len - num_prefix_embeds`` tokens."""
    B, S = batch, prompt_len
    prompts = TokenStream(cfg.vocab_size, seed=seed).batch(B, S)["tokens"]
    if cfg.encoder_decoder:
        rng = np.random.default_rng(seed)
        return {"frames": rng.normal(0, 1, (B, S, cfg.d_model)).astype(
                    np.float32),
                "tokens": prompts[:, : S // cfg.decoder_len_ratio]}
    if cfg.frontend == "vision":
        P = cfg.num_prefix_embeds
        rng = np.random.default_rng(seed)
        return {"patches": rng.normal(0, 1, (B, P, cfg.d_model)).astype(
                    np.float32),
                "tokens": prompts[:, : S - P]}
    return {"tokens": prompts}


def generate(model, params, batch, gen: int) -> dict:
    """Prefill ``batch`` (a dict of the model's prefill inputs, or the
    prompts (B, S) alone) and decode ``gen`` tokens greedily, the first
    from the prefill logits.  Returns the tokens (B, gen) int32, the
    prefill seconds and the decode seconds per token (over the ``gen - 1``
    decode steps), both ended by a device synchronisation."""
    dev = model.device
    if not isinstance(batch, dict):
        batch = {"tokens": batch}
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    _sync(dev)
    t0 = time.perf_counter()
    logits, state = model.prefill(params, batch)
    next_tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    serve_step = steps_lib.make_serve_step(model)
    out = [next_tok]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        next_tok, state = serve_step(params, state, next_tok)
        out.append(next_tok)
    _sync(dev)
    decode_s = (time.perf_counter() - t0) / max(gen - 1, 1)
    return {"tokens": torch.cat(out, 1), "prefill_s": prefill_s,
            "decode_s_per_token": decode_s}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default="stablelm-1.6b", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg, device=args.device)
    params = model.init(args.seed)
    B, S = args.batch, args.prompt_len
    res = generate(model, params, serve_batch(cfg, B, S, args.seed),
                   args.gen)
    gen = res["tokens"]
    assert bool(((gen >= 0) & (gen < cfg.vocab_size)).all())
    print(f"prefill: B={B} S={S} in {res['prefill_s'] * 1e3:.1f} ms")
    print(f"decode:  {args.gen} tokens x {B} seqs, "
          f"{res['decode_s_per_token'] * 1e3:.2f} ms/token")
    print("sample:", gen[0, :16].tolist())
    return res


if __name__ == "__main__":
    main()
