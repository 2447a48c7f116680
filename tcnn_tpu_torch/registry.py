"""Case-insensitive ``otype`` registries.

PyTorch counterpart of ``tcnn_tpu/registry.py``: encodings, networks,
losses and optimizers.
"""

from __future__ import annotations

from typing import Any, Callable, Dict


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._factories: Dict[str, Callable[..., Any]] = {}

    def register(self, names, factory: Callable[..., Any]) -> None:
        if isinstance(names, str):
            names = [names]
        for name in names:
            key = name.lower()
            if key in self._factories:
                raise ValueError(
                    f"Can not register {self.kind} '{name}': name already exists.")
            self._factories[key] = factory

    def create(self, otype: str, *args, **kwargs) -> Any:
        key = otype.lower()
        if key not in self._factories:
            raise ValueError(
                f"Invalid {self.kind} name: {otype}. "
                f"Known: {sorted(self._factories)}")
        return self._factories[key](*args, **kwargs)


encodings = Registry("encoding")
networks = Registry("network")
losses = Registry("loss")
optimizers = Registry("optimizer")

register_encoding = encodings.register
register_network = networks.register
register_loss = losses.register
register_optimizer = optimizers.register
