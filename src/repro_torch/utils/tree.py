"""Trees of tensors in JAX's flatten order.

The port keeps a model's parameters, and a training state built on
them, as nested dicts (``dict`` or ``nn.ParameterDict``) and lists with
tensors (or arrays) at the leaves: the reference's pytrees. JAX flattens
a dict in sorted key order and a list in index order, and the trainer
sums the leaves (``global_norm``) and the checkpoint shards and names
them in that order, so these helpers walk a tree the same way.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Mapping, Tuple

from torch import nn

_DICTS = (Mapping, nn.ParameterDict)


def _children(tree) -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, _DICTS):
        for k in sorted(tree.keys()):
            yield str(k), tree[k]
    else:
        for i, v in enumerate(tree):
            yield str(i), v


def _is_node(tree) -> bool:
    return isinstance(tree, (*_DICTS, list, tuple))


def tree_flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in JAX's order; a path joins the dict keys
    and list indices with ``/`` (``params/layers/0/attn/wq``)."""
    if not _is_node(tree):
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for key, child in _children(tree):
        out.extend(tree_flatten_with_paths(
            child, f"{prefix}/{key}" if prefix else key))
    return out


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_flatten_with_paths(tree)]


def tree_map(fn: Callable[..., Any], tree, *rest,
             is_leaf: Callable[[Any], bool] = lambda x: False):
    """A tree of plain dicts and lists of the same layout, ``fn`` applied
    to every leaf, with the leaves of ``rest`` (trees of ``tree``'s
    layout) beside it. ``is_leaf`` stops the walk at a node (a tuple
    that is a leaf, say)."""
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, _DICTS):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in tree.keys()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
