"""Serving CLI: prefill + greedy batched decode with CRUM lazy restore
(PyTorch port).

The inline runner of the reference's ``launch/serve.py``, with its flags
and printed lines, plus ``--device`` (default ``cuda``; it raises when
there is no card, and the CPU runs only when asked for). With ``--lazy``
the params materialize leaf by leaf with exponential read-ahead (paper
§4.2). A prompt of at least ``attn_chunked_threshold`` tokens (4096 at
full width) prefills through the chunked attention lowering, which on the
card is the hand-written flash kernel, in every attention layer: every
layer of a transformer, every application of a hybrid's shared block
(none in the pure SSM model).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        --ckpt-dir /tmp/ckpt --lazy --batch 2 --prompt-len 8192 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        --smoke --device cpu --ckpt-dir /tmp/ck --prompt-len 128 --gen 8

With ``--device-runner proxy`` decode executes in a device-proxy process
via the ``decode_arch`` step program — and with ``--proxy-endpoint`` that
proxy is a *remote* one, served by a ``repro_torch.remote.host`` daemon
over the streamed chunk transport. This process restores the params onto
the CPU and never creates a CUDA context: the params ride the data plane
once, then the final SYNC moves only the chunks decode dirtied
(cache/toks), never the clean params. ``--device`` names the proxy's
device.

    PYTHONPATH=src python -m repro_torch.remote.host --port 7070  # machine B
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        --ckpt-dir /tmp/ckpt --lazy --device-runner proxy \\
        --proxy-endpoint 127.0.0.1:7070                           # machine A

Every arch serves inline, as ``models.build`` decides. The prompt is the
reference's draw from ``default_rng(0)``: token ids (B, P); for the vision
model first the image's patches (B, ``num_patches``, D) in bf16, which
join the cache's prefix ahead of the text (the prefill and TTFT count both);
for the audio model (B, P, K) codebook ids, decoded a frame (B, K) at a
time, greedy per codebook. The proxied runner decodes text only, as the
reference's ``decode_arch``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch paligemma-3b \
        --smoke --device cpu --prompt-len 48 --gen 8
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from repro_torch.checkpoint import ChunkStore
from repro_torch.checkpoint.manifest import committed_steps, load_manifest
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
                    help="proxy: decode in a device-proxy process "
                         "(decode_arch step program)")
    ap.add_argument("--proxy-endpoint", default=None, metavar="HOST:PORT",
                    help="connect to a remote proxy-host daemon instead of "
                         "spawning a local proxy (implies the streamed "
                         "transport)")
    ap.add_argument("--transport", choices=["segment", "stream"], default=None,
                    help="proxy data plane (default: stream when "
                         "--proxy-endpoint is given, else segment)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    return ap.parse_args(argv)


def _image_layers(ckpt_dir: str | None) -> int | None:
    """The depth of the params in the newest committed image under
    ``ckpt_dir``: the leading dimension of its stacked block leaves (None
    without an image or blocks). An image cut to its first layers, widths
    kept, serves at its own depth."""
    steps = committed_steps(ckpt_dir) if ckpt_dir else []
    if not steps:
        return None
    manifest = load_manifest(ckpt_dir, max(steps))
    for path, leaf in manifest.leaves.items():
        if path.startswith(_PARAMS + "blocks/"):
            return int(leaf.shape[0])
    return None


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


def _prompt(cfg, B: int, P: int, device: torch.device) -> dict:
    """The reference's prompt batch, drawn from ``default_rng(0)`` in its
    order: ``inputs`` (B, P) ids, or (B, P, K) for the audio model; for the
    vision model ``patches`` (B, num_patches, D) bf16 first."""
    rng = np.random.default_rng(0)
    if cfg.frontend == "audio":
        ids = rng.integers(0, cfg.vocab_size, (B, P, cfg.audio_codebooks))
        return {"inputs": torch.from_numpy(ids.astype(np.int32)).to(device)}
    batch = {}
    if cfg.frontend == "vision":
        patches = rng.standard_normal((B, cfg.num_patches, cfg.d_model))
        batch["patches"] = torch.from_numpy(patches.astype(np.float32)).to(
            device, torch.bfloat16)
    ids = rng.integers(0, cfg.vocab_size, (B, P))
    batch["inputs"] = torch.from_numpy(ids.astype(np.int32)).to(device)
    return batch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(argv=None) -> dict:
    """Run the CLI. Returns the generated tokens (B, gen), their logits
    (B, gen, V) f32 on the device (the audio model's: (B, gen, K) and (B,
    gen, K, V)), the prompt's ids, its patches (the vision model's, else
    None), the params, the restored step (None on a fresh init), and
    restore s, TTFT s and decode tok/s;
    with ``--device-runner proxy``, what :func:`_serve_proxy` returns."""
    args = parse_args(argv)
    if args.device_runner == "proxy":
        return _serve_proxy(args)
    if args.proxy_endpoint or args.transport:
        raise ValueError("--proxy-endpoint and --transport need --device-runner proxy")
    device = resolve_device(args.device)
    if device.type == "cuda":
        # the same tokens run to run: cuBLAS reads the variable when the
        # process first uses it
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    cfg = get_config(args.arch, smoke=args.smoke)
    layers = _image_layers(args.ckpt_dir)
    if layers is not None and layers != cfg.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
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
    batch = _prompt(cfg, B, P, device)
    prompt, patches = batch["inputs"], batch.get("patches")
    positions = P + (cfg.num_patches if patches is not None else 0)

    with torch.no_grad():
        t1 = time.perf_counter()
        logits, cache = model.prefill(params, batch, positions + G)
        _sync(device)
        ttft = time.perf_counter() - t1
        what = f"{cfg.num_patches} patches + {P} tokens" if patches is not None else \
            f"{P} tokens"
        print(f"[serve] prefill({what}) -> first logits in {ttft:.3f}s")

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
            "prompt": prompt, "patches": patches, "params": params, "step": step,
            "restore_s": restore_s, "ttft_s": ttft, "decode_tok_s": decode_tok_s}


def _serve_proxy(args) -> dict:
    """Decode through a (possibly remote) device proxy. Returns the
    generated tokens (B, gen), the synced cache, the prompt, the restored
    step (None on a fresh init), push s, decode tok/s, the proxy's
    restarts and the final sync's info (``chunks_synced``, ``phase_us``,
    ``transport``...)."""
    from repro_torch.proxy import ProxyRunner, host_program
    from repro_torch.proxy.programs import _program_device
    from repro_torch.remote.transport import endpoint_arg
    from repro_torch.utils.tree import flatten_with_paths

    spec = {
        "name": "decode_arch", "arch": args.arch, "smoke": bool(args.smoke),
        "batch": args.batch, "prompt_len": args.prompt_len, "gen": args.gen,
        "device": args.device,
    }
    layers = _image_layers(args.ckpt_dir)
    if layers is not None and layers != get_config(args.arch, smoke=args.smoke).num_layers:
        spec["num_layers"] = layers
    provider = None
    if args.proxy_endpoint:
        ep = endpoint_arg(args.proxy_endpoint)
        provider = lambda failed=False: ep  # noqa: E731 — static placement
    else:
        # a local proxy computes on this machine: refuse an absent card
        # before the spawn (a daemon checks its own at PROGRAM)
        _program_device(args.device)
    transport = args.transport or ("stream" if args.proxy_endpoint else "segment")
    prog = host_program(spec)  # the layout and host init; no device here
    step = None
    if args.ckpt_dir:
        t0 = time.perf_counter()
        # on the CPU: this process never creates a CUDA context
        params, step = _restore_params(args, torch.device("cpu"))
        print(f"[serve] restored step {step} in {time.perf_counter() - t0:.3f}s "
              f"(lazy={args.lazy})")
        want = set(flatten_with_paths(prog.meta_state()["params"])[0])
        have = set(flatten_with_paths(params)[0])
        if want - have:
            raise SystemExit(f"checkpoint lacks params for {sorted(want - have)[:3]}...")
        init = prog.init_state(params)
        del params
    else:
        init = prog.init_state()

    runner = ProxyRunner(spec, transport=transport, endpoint_provider=provider,
                         chunk_bytes=1 << 20, fused_digests=True)
    t0 = time.perf_counter()
    runner.start(device_state=init)
    push_s = time.perf_counter() - t0
    del init
    print(f"[serve] proxy={args.proxy_endpoint or 'local'} transport={transport} "
          f"device={args.device} state pushed in {push_s:.3f}s", flush=True)
    try:
        total = args.prompt_len + args.gen
        t1 = time.perf_counter()
        for n in range(1, total):
            runner.step(n)
        state, info = runner.sync_state()
        dt = time.perf_counter() - t1
        restarts = runner.restarts
    finally:
        runner.close()
    pos = int(state["cache"]["pos"])
    if pos != total - 1:
        raise RuntimeError(f"the proxy's cache/pos is {pos} after {total - 1} steps")
    tokens = np.asarray(state["toks"])[:, args.prompt_len:]
    decode_tok_s = (total - 1) * args.batch / max(dt, 1e-9)
    print(f"[serve] decoded {total - 1} steps in {dt:.3f}s "
          f"({decode_tok_s:.1f} tok/s, restarts={restarts})")
    tstats = info.get("transport", {})
    print(f"[serve] sync wire: chunks={info.get('chunks_synced')} "
          f"bytes={info.get('bytes_synced')} "
          f"wire_rx={tstats.get('wire_rx')} (params stay clean)")
    print(f"[serve] sample tokens: {tokens[:, 0].tolist()}")
    return {"tokens": tokens, "cache": state["cache"], "prompt": prog.prompt(), "step": step,
            "push_s": push_s, "decode_s": dt, "decode_tok_s": decode_tok_s,
            "restarts": restarts, "info": info}


def main(argv=None) -> int:
    serve(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
