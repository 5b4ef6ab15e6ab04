"""Step programs — the replayable compute the proxy executes.

CRUM's proxy does not receive closures from the application; it receives
*API calls*. A step program is the analogue: a named factory plus a
MessagePack-able kwargs dict, reconstructible inside any proxy incarnation
(spawned processes share no closures) and inside replay. Determinism is
the contract: ``step(state, n)`` must be a pure function of (state, n) —
batches are derived from the step number, never streamed — so replaying
the API log into a fresh proxy reproduces device state bit for bit.

Built-ins:

    numpy_sgd   momentum-SGD-shaped numpy update (fast; tests); the
                reference's, copied
    torch_tiny  a 2-layer f32 dense transformer trained with AdamW (the
                twin of the reference's ``jax_tiny``)
    train_arch  a real config from ``repro_torch.configs``
                (``launch/train.py --device-runner proxy``)
    decode_arch greedy batched decode of such a config
                (``launch/serve.py --device-runner proxy``)

The torch programs take ``device`` in their spec (``"cuda"`` by default,
raising when there is no card). Their ``init_state`` runs on the host with
an explicit generator — the application builds it through
:func:`host_program`, without the card and without needing one — while the proxy allocates :meth:`StepProgram.empty_state` on its
device and lets the UPLOAD fill it, so no incarnation draws an init that
the upload overwrites anyway.
"""
from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.utils.dtypes import leaf_nbytes
from repro_torch.utils.tree import flatten_with_paths, unflatten_from_paths


class StepProgram:
    """Protocol: deterministic device-state transition, replayable by spec."""

    def init_state(self) -> Any:
        raise NotImplementedError

    def empty_state(self) -> Any:
        """Device state with :meth:`init_state`'s structure and undefined
        contents: what a proxy allocates at REGISTER for an UPLOAD to
        fill. Defaults to :meth:`init_state` where that is cheap."""
        return self.init_state()

    def step(self, device_state: Any, step: int) -> tuple[Any, dict]:
        """(new_device_state, metrics) — pure in (device_state, step)."""
        raise NotImplementedError

    def step_with_digests(
        self, device_state: Any, step: int, chunk_bytes: int
    ) -> tuple[Any, dict, dict[str, list[int]]]:
        """Step, then emit per-chunk digests of the new state as a fused
        final pass: (new_state, metrics, {path: [u64 digest, ...]}).

        The proxy service calls this (instead of :meth:`step`) when the
        runner registered with ``fused_digests=True``, and hands the
        digests of the *last* step before a SYNC to
        ``ShadowStateManager.sync(device_digests=...)`` — the boundary
        digest scan disappears because the step already paid for it: on the
        card one grouped ``chunk_digest`` launch over the state
        (``kernels.ops.tree_chunk_digests``).
        """
        from repro_torch.kernels.ops import tree_chunk_digests

        new_state, metrics = self.step(device_state, step)
        return new_state, metrics, tree_chunk_digests(new_state, chunk_bytes)

    def on_restore(self, device_state: Any) -> Any:
        """Adapt a freshly-uploaded state for this program."""
        return device_state

    def state_nbytes(self) -> int:
        """Total bytes of :meth:`init_state` without materializing it where
        possible. Fallback: build one and measure."""
        flat, _ = flatten_with_paths(self.init_state())
        return sum(leaf_nbytes(leaf) for leaf in flat.values())


_PROGRAMS: dict[str, Callable[..., StepProgram]] = {}


def register_step_program(
    name: str, factory: Callable[..., StepProgram], *, replace: bool = False
) -> None:
    if name in _PROGRAMS and not replace:
        raise ValueError(f"step program {name!r} already registered")
    _PROGRAMS[name] = factory


def list_step_programs() -> list[str]:
    return sorted(_PROGRAMS)


def make_program(spec: dict[str, Any]) -> StepProgram:
    """Build a program from its spec: {"name": ..., **kwargs}."""
    spec = dict(spec)
    name = spec.pop("name", None)
    try:
        factory = _PROGRAMS[name]
    except KeyError:
        raise KeyError(
            f"unknown step program {name!r}; have {sorted(_PROGRAMS)}"
        ) from None
    return factory(**spec)


def host_program(spec: dict[str, Any]) -> StepProgram:
    """The program as the application builds it: its layout, size and host
    init, never its device. A torch program is built for the CPU here, so
    an application without a card can ship a ``cuda`` spec to a proxy on
    another machine; only the process that computes (the proxy at PROGRAM,
    an inline loop) checks the spec's device, through :func:`make_program`.
    """
    factory = _PROGRAMS.get(spec.get("name"))
    if isinstance(factory, type) and issubclass(factory, _TorchProgram):
        spec = dict(spec, device="cpu")
    return make_program(spec)


# -- built-ins -----------------------------------------------------------------

class NumpySGD(StepProgram):
    """Deterministic momentum-SGD-shaped update (the reference's, copied)."""

    def __init__(self, *, rows: int = 16, width: int = 64, seed: int = 0,
                 step_time_s: float = 0.0):
        self.rows, self.width, self.seed = int(rows), int(width), int(seed)
        self.step_time_s = float(step_time_s)

    def init_state(self):
        rng = np.random.default_rng(self.seed)
        shape = (self.rows, self.width)
        return {
            "w": rng.standard_normal(shape).astype(np.float32),
            "m": np.zeros(shape, np.float32),
        }

    def step(self, d, step):
        g = np.sin(d["w"] * 0.05 + np.float32(step) * 0.001, dtype=np.float32)
        m = (0.9 * d["m"] + g).astype(np.float32)
        w = (d["w"] - 0.01 * m).astype(np.float32)
        if self.step_time_s:
            time.sleep(self.step_time_s)
        return {"w": w, "m": m}, {"w_norm": float(np.linalg.norm(w))}

    def state_nbytes(self) -> int:
        return 2 * self.rows * self.width * 4  # w + m, float32


def _program_device(device: str | torch.device) -> torch.device:
    """The device a torch program computes on; a CUDA device must exist.

    Checks availability only — the CUDA context is first created where the
    program first computes (in the proxy), never by this check.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"step program device {str(device)!r} asked for but no CUDA "
            "device is available (put device='cpu' in the spec to run on "
            "the CPU)"
        )
    return dev


class _TorchProgram(StepProgram):
    """A torch program's device handling: ``self.device`` and
    ``meta_state()`` (the state's structure on the meta device) give the
    proxy's empty state, the restore placement and the state's size."""

    device: torch.device

    def meta_state(self):
        raise NotImplementedError

    def empty_state(self):
        flat, treedef = flatten_with_paths(self.meta_state())
        return unflatten_from_paths(treedef, {
            p: torch.empty(t.shape, dtype=t.dtype, device=self.device)
            for p, t in flat.items()
        })

    def on_restore(self, d):
        flat, treedef = flatten_with_paths(d)
        return unflatten_from_paths(treedef, {
            p: (leaf if isinstance(leaf, torch.Tensor)
                else torch.from_numpy(np.array(leaf))).to(self.device)
            for p, leaf in flat.items()
        })

    def state_nbytes(self) -> int:
        flat, _ = flatten_with_paths(self.meta_state())
        return sum(leaf_nbytes(t) for t in flat.values())


class TorchTrain(_TorchProgram):
    """A model of ``repro_torch.models`` trained by ``make_train_step``.

    State ``{"params", "opt", "step"}`` with the reference's paths; the
    batch at step n is a pure function of ``(seed, n)``, drawn with numpy
    (the reference's jax stream cannot be reproduced), ``inputs ==
    targets`` as in the reference. The optimizer updates in place, so a
    step consumes the state it is given.
    """

    def __init__(self, cfg, lr, *, batch: int, seq: int, seed: int,
                 device: str | torch.device):
        from repro_torch.models import build
        from repro_torch.optim import get_optimizer
        from repro_torch.runtime.steps import make_train_step

        self.device = _program_device(device)
        self.cfg = cfg
        self.batch, self.seq, self.seed = int(batch), int(seq), int(seed)
        self.vocab = cfg.vocab_size
        self.model = build(cfg)
        self.opt = get_optimizer(cfg.optimizer, lr)
        self.step_fn = make_train_step(self.model, self.opt)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """The step's tokens, on the host: a pure function of (seed, step)."""
        rng = np.random.default_rng([self.seed, int(step)])
        toks = rng.integers(0, self.vocab, (self.batch, self.seq), dtype=np.int32)
        return {"inputs": toks, "targets": toks}

    def _state(self, params, device) -> dict:
        return {
            "params": params,
            "opt": self.opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device),
        }

    def init_state(self):
        """A fresh state on the host, from an explicit CPU generator."""
        return self._state(
            self.model.init(torch.Generator().manual_seed(self.seed)), "cpu")

    def meta_state(self):
        """The state's structure on the meta device: shapes and dtypes, no
        storage and no random draws."""
        return self._state(self.model.init(torch.Generator(), device="meta"), "meta")

    def step(self, d, step):
        b = {k: torch.from_numpy(v).to(self.device) for k, v in self.batch_at(step).items()}
        d2, metrics = self.step_fn(d, b)
        return d2, {"loss": float(metrics["loss"])}


class TorchTiny(TorchTrain):
    """A 2-layer f32 dense transformer, AdamW at 1e-3 (the twin of the
    reference's ``jax_tiny``)."""

    def __init__(self, *, width: int = 64, seed: int = 0, batch: int = 2,
                 seq: int = 32, device: str = "cuda"):
        from repro_torch.models import ModelConfig

        cfg = ModelConfig(
            name="proxy-tiny", family="dense", num_layers=2,
            d_model=width, vocab_size=256, num_heads=4, num_kv_heads=2,
            head_dim=max(width // 4, 8), d_ff=2 * width,
            param_dtype="float32", compute_dtype="float32",
        )
        super().__init__(cfg, 1e-3, batch=batch, seq=seq, seed=seed, device=device)


class TrainArch(TorchTrain):
    """A real architecture from ``repro_torch.configs`` with AdamW on
    ``warmup_cosine(lr, 10, total_steps)`` — what ``launch/train.py
    --device-runner proxy`` ships to its proxy instead of a closure.
    ``num_layers`` cuts the config's depth and keeps its widths."""

    def __init__(self, *, arch: str, smoke: bool = True, batch: int = 8,
                 seq: int = 128, lr: float = 3e-4, total_steps: int = 100,
                 seed: int = 0, device: str = "cuda", num_layers: int | None = None):
        import dataclasses

        from repro_torch.configs import get_config
        from repro_torch.optim import warmup_cosine

        cfg = get_config(arch, smoke=smoke)
        if num_layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=int(num_layers))
        super().__init__(cfg, warmup_cosine(lr, 10, total_steps),
                         batch=batch, seq=seq, seed=seed, device=device)


class DecodeArch(_TorchProgram):
    """Greedy batched decode as a replayable step program — the *serving*
    workload proxied (``launch/serve.py --device-runner proxy``).

    Device state is ``{params, cache: {k, v, pos}, toks}``, the reference's
    tree leaf for leaf: ``toks`` is the (B, P+G) int32 token buffer holding
    the deterministic synthetic prompt in its first P positions, and
    ``cache/pos`` a 0-d int32 tensor (the model's own decode takes a
    Python int). Step ``n`` feeds ``toks[:, n-1]`` through one decode step
    at position ``n - 1`` (known on the host: no device read per step),
    stores ``pos + 1`` and writes the argmax token at position ``n`` when
    that position is in the generated region. Pure in (state, n), so a
    proxy death mid-decode replays to bit-identical tokens — and a SYNC
    after decoding moves only the chunks decode dirtied (cache/toks, never
    the params). ``cache/pos`` equals the last step run, which the serve
    CLI checks against its step count. ``num_layers`` cuts the config's
    depth and keeps its widths. Text frontends only, as the reference.
    """

    def __init__(self, *, arch: str, smoke: bool = True, batch: int = 2,
                 prompt_len: int = 32, gen: int = 16, seed: int = 0,
                 device: str = "cuda", num_layers: int | None = None):
        import dataclasses

        from repro_torch.configs import get_config
        from repro_torch.models import build

        self.device = _program_device(device)
        cfg = get_config(arch, smoke=smoke)
        if num_layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=int(num_layers))
        if cfg.frontend not in (None, "none", "text"):
            raise ValueError(
                f"decode_arch proxies text decode; arch {arch!r} has "
                f"frontend {cfg.frontend!r}"
            )
        self.cfg = cfg
        self.model = build(cfg)
        self.batch, self.seed = int(batch), int(seed)
        self.prompt_len, self.gen = int(prompt_len), int(gen)
        self.total = self.prompt_len + self.gen

    def prompt(self) -> np.ndarray:
        """The (B, P) int32 prompt: the reference's draw from ``seed``."""
        rng = np.random.default_rng(self.seed)
        return rng.integers(
            0, self.cfg.vocab_size, (self.batch, self.prompt_len)
        ).astype(np.int32)

    def _state(self, params, device) -> dict:
        cache = self.model.init_cache(self.batch, self.total, device=device)
        cache["pos"] = torch.zeros((), dtype=torch.int32, device=device)
        return {
            "params": params,
            "cache": cache,
            "toks": torch.zeros((self.batch, self.total), dtype=torch.int32,
                                device=device),
        }

    def init_state(self, params=None):
        """A fresh state on the host: ``params`` (host tensors, e.g.
        restored from an image) or params from an explicit CPU generator,
        a zero cache, the prompt in ``toks``."""
        if params is None:
            params = self.model.init(torch.Generator().manual_seed(self.seed))
        state = self._state(params, "cpu")
        state["toks"][:, : self.prompt_len] = torch.from_numpy(self.prompt())
        return state

    def meta_state(self):
        """The state's structure on the meta device: shapes and dtypes, no
        storage and no random draws."""
        return self._state(self.model.init(torch.Generator(), device="meta"), "meta")

    def step(self, d, step):
        n = int(step)
        cache = {"k": d["cache"]["k"], "v": d["cache"]["v"], "pos": n - 1}
        with torch.no_grad():
            logits, cache = self.model.decode(d["params"], cache, d["toks"][:, n - 1])
        nxt = logits.argmax(dim=-1).to(torch.int32)
        toks = d["toks"]
        if self.prompt_len <= n < self.total:
            toks[:, n] = nxt
        new_cache = {"k": cache["k"], "v": cache["v"], "pos": d["cache"]["pos"] + 1}
        # tok0 stays a device scalar: read on the host only at a SYNC
        return ({"params": d["params"], "cache": new_cache, "toks": toks},
                {"tok0": nxt[0].to(torch.float32)})


register_step_program("numpy_sgd", NumpySGD)
register_step_program("torch_tiny", TorchTiny)
register_step_program("train_arch", TrainArch)
register_step_program("decode_arch", DecodeArch)
