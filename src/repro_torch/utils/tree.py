"""Tree path utilities for nested dict/list/tuple trees of tensors.

Checkpoint state is addressed by *path strings* — stable, human-readable keys
derived from the tree structure (e.g. ``params/blocks/attn/wq``). All
checkpoint formats key chunks by (path, global offset), never by flatten
order, so adding/removing leaves does not invalidate unrelated chunks.

The rules match the JAX reference's pytree flattening, so both packages
name and order the leaves of the same state identically: dict keys flatten
in **sorted** order, list/tuple items by index, ``None`` is an empty
subtree (no leaf), and anything else — a tensor, a numpy array or scalar,
a Python number — is a leaf.
"""
from __future__ import annotations

import hashlib
from typing import Any

import numpy as np
import torch

from repro_torch.utils.dtypes import byte_view, dtype_name, leaf_shape

# treedef node kinds
_DICT, _LIST, _TUPLE, _NONE, _LEAF = "d", "l", "t", "n", "*"


def _treedef(tree: Any) -> tuple:
    if isinstance(tree, dict):
        keys = sorted(tree)
        return (_DICT, tuple(keys), tuple(_treedef(tree[k]) for k in keys))
    if isinstance(tree, (list, tuple)):
        kind = _TUPLE if isinstance(tree, tuple) else _LIST
        return (kind, len(tree), tuple(_treedef(v) for v in tree))
    if tree is None:
        return (_NONE,)
    return (_LEAF,)


def _walk(tree: Any, prefix: tuple, out: list) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _walk(tree[k], prefix + (str(k),), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _walk(v, prefix + (str(i),), out)
    elif tree is not None:
        out.append(("/".join(prefix), tree))


def flatten_with_paths(tree: Any) -> tuple[dict[str, Any], tuple]:
    """Flatten ``tree`` to an ordered {path_str: leaf} dict + treedef."""
    leaves: list = []
    _walk(tree, (), leaves)
    out: dict[str, Any] = {}
    for key, leaf in leaves:
        if key in out:
            raise ValueError(f"duplicate path key {key!r} in tree")
        out[key] = leaf
    return out, _treedef(tree)


def _build(treedef: tuple, prefix: tuple, flat: dict[str, Any]) -> Any:
    kind = treedef[0]
    if kind == _DICT:
        return {
            k: _build(sub, prefix + (str(k),), flat)
            for k, sub in zip(treedef[1], treedef[2])
        }
    if kind in (_LIST, _TUPLE):
        items = [_build(sub, prefix + (str(i),), flat)
                 for i, sub in enumerate(treedef[2])]
        return tuple(items) if kind == _TUPLE else items
    if kind == _NONE:
        return None
    key = "/".join(prefix)
    if key not in flat:
        raise KeyError(f"missing leaf {key!r} during unflatten")
    return flat[key]


def unflatten_from_paths(treedef: tuple, flat: dict[str, Any]) -> Any:
    """Inverse of :func:`flatten_with_paths` for the same treedef."""
    return _build(treedef, (), flat)


def leaf_bytes(leaf: Any) -> np.ndarray:
    """A leaf's C-order bytes as a host u8 array (copies device tensors)."""
    if isinstance(leaf, torch.Tensor):
        return byte_view(leaf).cpu().numpy()
    return np.ascontiguousarray(np.asarray(leaf)).reshape(-1).view(np.uint8)


def _leaf_signature(leaf: Any) -> tuple:
    return tuple(leaf_shape(leaf)), dtype_name(leaf)


def tree_digest(tree: Any) -> str:
    """Order-stable content hash of a tree of tensors/arrays.

    Two states digest equal iff every leaf's bytes are equal, independent
    of dict insertion order.
    """
    flat, _ = flatten_with_paths(tree)
    h = hashlib.sha256()
    for path in sorted(flat):
        h.update(path.encode())
        h.update(leaf_bytes(flat[path]).tobytes())
    return h.hexdigest()[:16]


def tree_equal(a: Any, b: Any) -> bool:
    """Structural + bitwise equality of two trees of tensors/arrays."""
    fa, da = flatten_with_paths(a)
    fb, db = flatten_with_paths(b)
    if da != db or fa.keys() != fb.keys():
        return False
    for k in fa:
        x, y = fa[k], fb[k]
        if _leaf_signature(x) != _leaf_signature(y):
            return False
        if (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)
                and x.device == y.device):
            # compare where the bytes live: no device->host copy
            same = torch.equal(byte_view(x), byte_view(y))
        else:
            same = np.array_equal(leaf_bytes(x), leaf_bytes(y))
        if not same:
            return False
    return True
