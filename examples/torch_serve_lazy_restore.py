"""Serving restart with CRUM lazy restore, PyTorch port (the paper's
read-fault heuristic).

The twin of ``examples/serve_lazy_restore.py``: saves a model checkpoint,
then compares time-to-first-logits for an eager restore (everything up
front) vs lazy restore with exponential read-ahead (parameters
materialize as they are read), at the same 8-layer config. Both restores
place the params on the device and must give the same first logits.

    PYTHONPATH=src python examples/torch_serve_lazy_restore.py               # on the card
    PYTHONPATH=src python examples/torch_serve_lazy_restore.py --device cpu
"""
import argparse
import tempfile
import time

import torch

from repro_torch.checkpoint import ChunkStore
from repro_torch.core import ForkedCheckpointer, RestoreManager
from repro_torch.launch.train import resolve_device
from repro_torch.models import ModelConfig, build
from repro_torch.utils.tree import flatten_with_paths, unflatten_from_paths

cfg = ModelConfig(
    name="serve-demo", family="dense", num_layers=8, d_model=512,
    vocab_size=32000, num_heads=8, num_kv_heads=8, head_dim=64, d_ff=2048,
    param_dtype="float32", compute_dtype="float32",
)


def main(argv=None) -> dict:
    """Returns the two times to first logits (s) and the eager logits."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    model = build(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    batch = {"inputs": torch.ones((1, 16), dtype=torch.int32, device=device)}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def on_device(path, shape):
        return device if path.startswith("params/") else None

    with tempfile.TemporaryDirectory() as d, torch.no_grad():
        ck = ForkedCheckpointer(ChunkStore(d), chunk_bytes=4 << 20)
        ck.save_async(1, {"params": params}).wait()
        ck.close()
        rm = RestoreManager(ChunkStore(d))

        # eager: restore everything, then serve
        t0 = time.perf_counter()
        state, _ = rm.restore(device_for=on_device)
        logits, _cache = model.prefill(state["params"], batch, 32)
        sync()
        t_eager = time.perf_counter() - t0

        # lazy: leaves materialize on access; read-ahead window doubles
        t0 = time.perf_counter()
        lazy, _ = rm.restore(lazy=True, device_for=on_device)
        flat_shape, treedef = flatten_with_paths(params)
        try:
            p_lazy = unflatten_from_paths(
                treedef, {k: lazy[f"params/{k}"] for k in flat_shape})
        finally:
            lazy.close()
        logits_lazy, _cache = model.prefill(p_lazy, batch, 32)
        sync()
        t_lazy = time.perf_counter() - t0

    if not torch.equal(logits, logits_lazy):
        raise SystemExit("eager and lazy restore gave different first logits")
    print(f"eager restore -> first logits: {t_eager:.3f}s")
    print(f"lazy  restore -> first logits: {t_lazy:.3f}s "
          f"(read-ahead overlapped restore with the first layers)")
    return {"eager_s": t_eager, "lazy_s": t_lazy, "logits": logits}


if __name__ == "__main__":
    main()
