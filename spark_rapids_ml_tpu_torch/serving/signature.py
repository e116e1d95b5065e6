"""The serving contract a model family declares: kernel, weights, specs.

Port of the reference's ``serving/signature.py``. Every servable model
implements ``serving_signature()`` returning one :class:`ServingSignature`:
the row-wise serving kernel (the same function object its own
``predict``/``transform`` runs through ``core/serving``), the weights the
kernel computes with, the static config it takes as keywords, and an
output-spec callable.

:meth:`ServingSignature.cost` is the analytic count of the kernel's work
at a bucket (``observability/costs.register_cost``, the count the cost
ledger records for its programs).

``output_spec(n, dtype)`` returns the kernel's output for an ``n``-row
batch at ``dtype`` as tensors on the ``"meta"`` device, torch's
counterpart of ``jax.ShapeDtypeStruct``: shapes and dtypes, no storage.
``select`` runs on them directly, as ``jax.eval_shape`` runs it on specs.

Weight trees are tuples (nested tuples, named tuples such as a forest's
``Forest``, lists or dicts) of tensors; :func:`tree_leaves` and
:func:`tree_map` walk them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a tuple/list/dict/named-tuple tree, in order."""
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    return [tree]


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``tree`` with ``fn`` applied to every leaf, its containers kept."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, item) for item in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, item) for item in tree)
    if isinstance(tree, dict):
        return {key: tree_map(fn, value) for key, value in tree.items()}
    return fn(tree)


@dataclass
class ServingSignature:
    """One model's serving declaration.

    ``weights`` are the tensors the kernel takes positionally after the
    batch, as the family's own route passes them for a tensor batch.
    ``host_weights``, where set, are the ones its route for host input
    computes with, where that differs: the logistic model's host route
    computes in float64 whatever dtype it was fitted in, its tensor route
    in the fitted dtype. ``None`` means ``weights`` serve both.
    """

    kernel: Callable
    weights: Tuple[Any, ...]
    static: Dict[str, Any]
    name: str
    n_features: int
    output_spec: Callable[[int, Any], Any]
    # The stage's transform-on-array contract as a function of the
    # kernel's output (None = the output IS the contract): the logistic
    # forward kernel yields (labels, probabilities, raw) but ``transform``
    # on a plain array yields labels, and ``select`` picks them. The fuser
    # applies it inside the composite, on the device. It must be a
    # module-level function: its identity keys the composite kernel cache.
    select: Optional[Callable[[Any], Any]] = None
    host_weights: Optional[Tuple[Any, ...]] = None
    # Host copies of the weights, made once on first use.
    _cpu_weights: Optional[Tuple[Any, ...]] = field(default=None, repr=False, compare=False)
    # Copies of the weights on other devices than their own, by device.
    _moved: Dict[Tuple[str, bool], Tuple[Any, ...]] = field(default_factory=dict, repr=False, compare=False)

    def cost(self, bucket: int, d: Optional[int] = None, dtype: Any = None) -> Optional[dict]:
        """The kernel's counted work for ``bucket`` rows of ``d`` features
        (default: its own) in ``dtype`` (default: the weights'):
        ``{"flops", "transcendentals", "bytes_accessed"}``, or None when
        the kernel has no registered count."""
        from spark_rapids_ml_tpu_torch.observability.costs import kernel_cost

        return kernel_cost(self.kernel, bucket, self.n_features if d is None else d,
                           self.weights_dtype() if dtype is None else dtype, self.weights, self.static)

    def weights_dtype(self) -> torch.dtype:
        """Dtype of the first floating weight leaf (float32 if none)."""
        for leaf in tree_leaves(self.weights):
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
                return leaf.dtype
        return torch.float32

    def weights_bytes(self) -> int:
        """Bytes of the weight tensors where they live."""
        return int(sum(leaf.numel() * leaf.element_size()
                       for leaf in tree_leaves(self.weights) if isinstance(leaf, torch.Tensor)))

    def cpu_weights(self) -> Tuple[Any, ...]:
        """The weights as CPU tensors, copied once and reused."""
        if self._cpu_weights is None:
            self._cpu_weights = tree_map(
                lambda a: a.detach().cpu() if isinstance(a, torch.Tensor) else a, self.weights
            )
        return self._cpu_weights

    def weights_on(self, device: torch.device, host: bool = False) -> Tuple[Any, ...]:
        """The weights the kernel takes on ``device``: ``host_weights``
        (if set) for host input, else ``weights``; copied to ``device``
        once where they live elsewhere."""
        weights = self.host_weights if host and self.host_weights is not None else self.weights
        leaves = [a for a in tree_leaves(weights) if isinstance(a, torch.Tensor)]
        if all(a.device == device for a in leaves):
            return weights
        key = (str(device), host)
        if key not in self._moved:
            self._moved[key] = tree_map(
                lambda a: a.to(device) if isinstance(a, torch.Tensor) else a, weights
            )
        return self._moved[key]


def spec(shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    """One output leaf's spec: a tensor of ``shape`` and ``dtype`` on the
    ``"meta"`` device."""
    return torch.empty(shape, dtype=dtype, device="meta")


def spec_bytes(spec_tree: Any) -> int:
    """Total bytes of a tree of spec tensors."""
    return int(sum(s.numel() * s.element_size() for s in tree_leaves(spec_tree)))
