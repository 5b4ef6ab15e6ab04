"""Serving CLI: prefill + greedy batched decode with CRUM lazy restore
(PyTorch port).

The inline runner of the reference's ``launch/serve.py``, with its flags
and printed lines, plus ``--device`` (default ``cuda``; it raises when
there is no card, and the CPU runs only when asked for). With ``--lazy``
the params materialize leaf by leaf with exponential read-ahead (paper
§4.2). A prompt of at least ``attn_chunked_threshold`` tokens (4096 at
full width) prefills through the chunked attention lowering, which on the
card is the hand-written flash kernel, in every layer.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        --ckpt-dir /tmp/ckpt --lazy --batch 2 --prompt-len 8192 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        --smoke --device cpu --ckpt-dir /tmp/ck --prompt-len 128 --gen 8

Not ported: ``--device-runner proxy`` (decode in a device proxy, with
``--proxy-endpoint``/``--transport``) raises; only dense text archs serve,
as ``models.build`` decides.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from repro_torch.checkpoint import ChunkStore
from repro_torch.configs import get_config, list_archs
from repro_torch.core import RestoreManager
from repro_torch.launch.train import resolve_device
from repro_torch.models import build

_PARAMS = "device/params/"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=list_archs(), required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=None, help="restore params from here")
    ap.add_argument("--lazy", action="store_true", help="lazy restore w/ read-ahead")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device-runner", choices=["inline", "proxy"], default="inline",
                    help="inline: decode in-process; proxy: not ported yet")
    ap.add_argument("--proxy-endpoint", default=None, metavar="HOST:PORT",
                    help="remote proxy-host daemon: not ported yet")
    ap.add_argument("--transport", choices=["segment", "stream"], default=None,
                    help="proxy data plane: not ported yet")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    return ap.parse_args(argv)


def _nest(flat: dict) -> dict:
    """{"blocks/attn/wq": leaf} -> nested dicts (params are dicts only)."""
    out: dict = {}
    for path, leaf in flat.items():
        *parents, name = path.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return out


def _restore_params(args, device: torch.device):
    """The params subtree of the newest committed image, placed on
    ``device``: eagerly, or leaf by lazy leaf. Returns (params, step)."""
    rm = RestoreManager(ChunkStore(args.ckpt_dir))

    def device_for(path, shape):
        return device if path.startswith(_PARAMS) else None

    if args.lazy:
        lazy, manifest = rm.restore(lazy=True, device_for=device_for)
        try:
            # materialize exactly the params subtree, leaf by leaf
            flat = {p[len(_PARAMS):]: lazy[p] for p in lazy.keys()
                    if p.startswith(_PARAMS)}
        finally:
            lazy.close()
        params = _nest(flat)
    else:
        state, manifest = rm.restore(device_for=device_for)
        params = state["device"]["params"]
    return params, int(manifest.step)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(argv=None) -> dict:
    """Run the CLI. Returns the generated tokens (B, gen), their logits
    (B, gen, V) f32 on the device, the prompt, the params, the restored
    step (None on a fresh init), and restore s, TTFT s and decode tok/s."""
    args = parse_args(argv)
    if args.device_runner != "inline" or args.proxy_endpoint or args.transport:
        raise NotImplementedError(
            "--device-runner proxy (--proxy-endpoint, --transport) is not ported yet"
        )
    device = resolve_device(args.device)
    if device.type == "cuda":
        # the same tokens run to run: cuBLAS reads the variable when the
        # process first uses it
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build(cfg)

    t0 = time.perf_counter()
    step = None
    if args.ckpt_dir:
        params, step = _restore_params(args, device)
        _sync(device)
        restore_s = time.perf_counter() - t0
        print(f"[serve] restored step {step} in {restore_s:.3f}s (lazy={args.lazy})")
    else:
        params = model.init(torch.Generator(device=device).manual_seed(0))
        _sync(device)
        restore_s = time.perf_counter() - t0
        print(f"[serve] fresh init in {restore_s:.3f}s")

    B, P, G = args.batch, args.prompt_len, args.gen
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)).to(device)

    with torch.no_grad():
        t1 = time.perf_counter()
        logits, cache = model.prefill(params, {"inputs": prompt}, P + G)
        _sync(device)
        ttft = time.perf_counter() - t1
        print(f"[serve] prefill({P} tokens) -> first logits in {ttft:.3f}s")

        toks = logits[:, -1].argmax(dim=-1).to(torch.int32)
        out, outs_logits = [toks], [logits[:, -1]]
        t2 = time.perf_counter()
        for _ in range(G - 1):
            logits, cache = model.decode(params, cache, toks)
            toks = logits.argmax(dim=-1).to(torch.int32)
            out.append(toks)
            outs_logits.append(logits)
        _sync(device)
        dt = time.perf_counter() - t2
    decode_tok_s = (G - 1) * B / max(dt, 1e-9)
    print(f"[serve] generated {G-1} steps in {dt:.3f}s ({decode_tok_s:.1f} tok/s)")
    tokens = torch.stack(out, dim=1).cpu().numpy()
    print(f"[serve] sample tokens: {tokens[:, 0].tolist()}")
    return {"tokens": tokens, "logits": torch.stack(outs_logits, dim=1),
            "prompt": prompt, "params": params, "step": step,
            "restore_s": restore_s, "ttft_s": ttft, "decode_tok_s": decode_tok_s}


def main(argv=None) -> int:
    serve(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
