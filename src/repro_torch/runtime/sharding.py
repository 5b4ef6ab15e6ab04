"""Sharding rules: each leaf's partition spec per architecture family, and
its DTensor placements on a mesh.

The reference's ``runtime/sharding.py``, rule for rule. Mesh axes
(``launch/mesh.py``): one pod ("data", "model") = (16, 16), two pods
("pod", "data", "model") = (2, 16, 16), the pod axis data-parallel.

Param rules are (regex over path) -> spec maker, the first match wins;
FSDP additionally shards the first replicated non-trivial dim over the
data axes. GQA archs whose kv heads do not divide the model axis replicate
the KV projections and shard the *head_dim* of the KV cache instead.

A spec (:class:`Spec`) is a tuple with one entry per tensor dim: an axis
name, a tuple of names (one tensor dim over several mesh axes, the first
named the major one), or None. :func:`placements` turns it into one DTensor
placement per mesh dim: ``Shard(d)`` where the mesh axis names dim ``d``,
else ``Replicate()``. A tuple of axes must follow the mesh's own axis
order, because DTensor splits a dim over several mesh dims in mesh order:
then the local blocks are where JAX puts them.

The reference's ``constrain`` (GSPMD's sharding hints inside the models)
has no counterpart: under a mesh each rank runs the model on plain
tensors of its own rows, heads and experts (``runtime/steps.py``), so
there is nothing to hint.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any

from repro_torch.launch.mesh import axis_sizes
from repro_torch.models.config import ModelConfig
from repro_torch.utils.tree import flatten_with_paths


class Spec(tuple):
    """A partition spec: one entry per tensor dim (axis name, tuple of
    names, or None). ``Spec("data", None)``; compares equal to the plain
    tuple of its entries."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"Spec{tuple(self)!r}"


def fit_spec(mesh, spec: tuple, shape: tuple[int, ...]) -> Spec:
    """Drop spec axes that over-index or don't divide the dim (replicate)."""
    sizes = axis_sizes(mesh)
    spec = tuple(spec)[: len(shape)]
    out = []
    for dim, ax in zip(shape, spec + (None,) * (len(shape) - len(spec))):
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        if any(a not in sizes for a in axes):
            out.append(None)
            continue
        n = math.prod(sizes[a] for a in axes)
        out.append(ax if (n and dim % n == 0) else None)
    return Spec(*out)


def placements(mesh, spec: tuple) -> tuple:
    """One DTensor placement per mesh dim for ``spec``."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of dim {dim} are not in the mesh's order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


# -- parameter rules -----------------------------------------------------------------

_LAYER = "LAYER"  # sentinel: the stacked-layer axis, never sharded, never FSDP'd


@dataclass(frozen=True)
class ShardingRules:
    """The resolved rule set for one (config, mesh) pair."""

    cfg: ModelConfig
    mesh: Any
    fsdp: bool = True

    @property
    def _sizes(self) -> dict[str, int]:
        return axis_sizes(self.mesh)

    @property
    def data_axes(self) -> tuple[str, ...]:
        """Axes carrying the batch. Without tensor parallelism the "model"
        axis joins them (DP over the full mesh)."""
        names = ("pod", "data") if self.cfg.tensor_parallel else ("pod", "data", "model")
        return tuple(a for a in names if a in self._sizes)

    @property
    def model_axis(self) -> str | None:
        if not self.cfg.tensor_parallel:
            return None
        return "model" if "model" in self._sizes else None

    def _model_size(self) -> int:
        return self._sizes["model"] if self.model_axis else 1

    # -- core decisions -----------------------------------------------------------
    def kv_heads_shardable(self) -> bool:
        return self.cfg.num_kv_heads % max(self._model_size(), 1) == 0

    def ssm_heads_shardable(self) -> bool:
        return self.cfg.ssm_heads % max(self._model_size(), 1) == 0 and self.cfg.ssm_heads > 0

    def _data_group(self):
        return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]

    def _fsdp_axis(self, dim: int):
        """Axis group for FSDP-sharding a dim, or None if not divisible."""
        if not self.fsdp:
            return None
        n = math.prod(self._sizes[a] for a in self.data_axes)
        if n > 1 and dim % n == 0:
            return self._data_group()
        return None

    def param_rules(self) -> list[tuple[str, Any]]:
        """(regex, spec maker) pairs; the first match wins. A maker takes
        the leaf's shape, so FSDP can check divisibility per leaf."""
        model = self.model_axis
        attn_model = None if self.cfg.attn_over_model else model
        kv_model = attn_model if self.kv_heads_shardable() else None
        ssm_model = model if self.ssm_heads_shardable() else None
        L = _LAYER

        def _clean(ax):
            return [None if a == L else a for a in ax]

        def s(*axes):
            return lambda shape: Spec(*_clean(list(axes[: len(shape)])))

        def fsdp_last(*axes):
            # FSDP: shard the first unsharded (non-layer) dim over the data axes
            def mk(shape):
                ax = list(axes[: len(shape)])
                for i, a in enumerate(ax):
                    if a is None and shape[i] > 1:
                        f = self._fsdp_axis(shape[i])
                        if f is not None:
                            ax[i] = f
                            break
                return Spec(*_clean(ax))

            return mk

        return [
            # embeddings / lm head: vocab over model, d_model over fsdp
            (r".*(embed|lm_head|codebook_embed|codebook_head).*", fsdp_last(model, None)),
            # attention projections
            (r".*attn/wq$", fsdp_last(L, None, attn_model)),
            (r".*attn/wk$", fsdp_last(L, None, kv_model)),
            (r".*attn/wv$", fsdp_last(L, None, kv_model)),
            (r".*attn/wo$", fsdp_last(L, attn_model, None)),
            (r".*attn/b(q)$", s(L, model)),
            (r".*attn/b(k|v)$", s(L, kv_model)),
            # shared attention block (hybrid): no leading L
            (r".*shared/attn/wq$", fsdp_last(None, model)),
            (r".*shared/attn/w(k|v)$", fsdp_last(None, kv_model)),
            (r".*shared/attn/wo$", fsdp_last(model, None)),
            (r".*shared/mlp/w(i|g)$", fsdp_last(None, model)),
            (r".*shared/mlp/wo$", fsdp_last(model, None)),
            # dense MLP
            (r".*mlp/w(i|g)$", fsdp_last(L, None, model)),
            (r".*mlp/wo$", fsdp_last(L, model, None)),
            # MoE: experts over model; expert matrices fsdp over D
            (r".*moe/router$", s(L, None, None)),
            (r".*moe/w(i|g)$", fsdp_last(L, model, None, None)),
            (r".*moe/wo$", fsdp_last(L, model, None, None)),
            (r".*moe/dense/w(i|g)$", fsdp_last(L, None, model)),
            (r".*moe/dense/wo$", fsdp_last(L, model, None)),
            # mamba2: per-segment projections shard on their own dims
            (r".*ssm/w_(z|x)$", fsdp_last(L, None, ssm_model)),
            (r".*ssm/w_(B|C)$", fsdp_last(L, None, None)),
            (r".*ssm/w_dt$", fsdp_last(L, None, ssm_model)),
            (r".*ssm/w_out$", fsdp_last(L, ssm_model, None)),
            (r".*ssm/conv_x$", s(L, None, ssm_model)),
            (r".*ssm/conv_(B|C)$", s(L, None, None)),
            (r".*ssm/conv_xb$", s(L, ssm_model)),
            (r".*ssm/(conv_Bb|conv_Cb|norm_w)$", s(L, None)),
            (r".*ssm/(A_log|D|dt_bias)$", s(L, None)),
            # vision stub projection
            (r".*vision_proj$", fsdp_last(None, model)),
            # norms & everything else: replicated
            (r".*", s(L, None, None, None, None)),
        ]

    # -- public API -----------------------------------------------------------------
    def spec_for(self, path: str, shape: tuple[int, ...]) -> Spec:
        for pat, mk in self.param_rules():
            if re.fullmatch(pat, path):
                return mk(tuple(shape))
        return Spec()

    def params_specs(self, params: Any) -> dict[str, Spec]:
        """{path: fitted spec} of every leaf of a params tree (tensors on
        any device, the meta device included)."""
        return {p: fit_spec(self.mesh, self.spec_for(p, tuple(leaf.shape)), tuple(leaf.shape))
                for p, leaf in flatten_with_paths(params)[0].items()}

    def opt_state_specs(self, params: Any) -> dict[str, Spec]:
        """Optimizer moments mirror param specs (ZeRO via fsdp=True)."""
        return self.params_specs(params)

    # -- activations / batch / cache ------------------------------------------------
    def batch_spec(self) -> Spec:
        return Spec(self._data_group())

    def batch_sharding_for(self, leaf_shape: tuple[int, ...]) -> Spec:
        n = math.prod(self._sizes[a] for a in self.data_axes)
        if leaf_shape and leaf_shape[0] % n == 0:
            return Spec(self._data_group(), *([None] * (len(leaf_shape) - 1)))
        return Spec()

    def cache_spec(self) -> Spec:
        """KV cache (L, B, Hkv, S, Dh): batch over "data" only; the model
        axis takes kv heads when they divide it, else head_dim — also for
        tensor_parallel=False archs, whose weights replicate over "model"
        but whose cache must still shard."""
        sizes = self._sizes
        model = "model" if "model" in sizes else None
        data = "data" if "data" in sizes else None
        msize = sizes.get("model", 1) if model else 1
        n_kv = self.cfg.num_kv_heads
        if n_kv and msize > 1 and n_kv % msize == 0:
            return Spec(None, data, model, None, None)
        if self.cfg.head_dim and msize > 1 and self.cfg.head_dim % msize == 0:
            return Spec(None, data, None, None, model)
        return Spec(None, data, None, None, None)

    def decode_batch_axes(self) -> tuple[str, ...]:
        """Token batch for decode: data axes only (see cache_spec)."""
        return tuple(a for a in ("pod", "data") if a in self._sizes)

    def ssm_state_spec(self) -> Spec:
        """SSM decode state (L, B, H, P, N): batch over data only; heads
        over model when divisible."""
        sizes = self._sizes
        data = "data" if "data" in sizes else None
        model = "model" if "model" in sizes else None
        msize = sizes.get("model", 1) if model else 1
        h = self.cfg.ssm_heads
        model = model if (h and msize > 1 and h % msize == 0) else None
        return Spec(None, data, model, None, None)
